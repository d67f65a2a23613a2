"""Error-feedback int8 gradient compression (``repro_torch.optim.
grad_compress``) against the reference's ``compressed_psum`` under
``_psum_sim`` (``tests/test_optim.py``: ``vmap`` over a named axis of n
members).

The port's quantize / combine / residual functions, run on the members'
stacked inputs with no processes, give the reference's int8 codes and
int32 sums bit for bit (the codes read off the reference's residuals on
its grid; round half to even in both) and its outputs and residuals to
float32 on the leaf's scale (1e-6 of its largest gradient: XLA rounds the
shared scale and the dequantising product in its own order; seen 1 ulp).  A two-process gloo run of ``compressed_psum``
(``FileStore`` under ``tmp_path``) equals that simulation bit for bit step
for step, residual carried, and so the reference to float32.
Error feedback cancels the bias, as in the reference's test.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from repro.optim import CompressorState as JaxState  # noqa: E402
from repro.optim import compressed_psum as jax_compressed_psum  # noqa: E402
from repro_torch.optim import compress_init  # noqa: E402
from repro_torch.optim.grad_compress import dequantize_sum, quantize, residual  # noqa: E402
from repro_torch.parallel.spawn import spawn  # noqa: E402
from test_optim import _psum_sim  # noqa: E402

N = 2
SHAPES = {"w": (64,), "b": (3, 5)}
STEPS, CONST_STEPS = 3, 30


def _grads(seed):
    rng = np.random.default_rng(seed)
    return [{k: (rng.standard_normal(s) * 10.0 ** -(i + 1)).astype(np.float32)
             for i, (k, s) in enumerate(SHAPES.items())} for _ in range(N)]


def _reference_steps(grads, steps):
    """The reference under ``_psum_sim``: per step, every member's
    outputs and residuals (numpy, ``[N, ...]`` a leaf)."""
    g = {k: jnp.stack([grads[r][k] for r in range(N)]) for k in SHAPES}
    res = {k: jnp.zeros_like(v) for k, v in g.items()}

    def body(g_m, r_m):
        out, st = jax_compressed_psum(g_m, "pod", JaxState(r_m))
        return out, st.residual

    fn = jax.jit(lambda a, b: _psum_sim(body, a, b, n=N))
    hist = []
    for _ in range(steps):
        out, res = fn(g, res)
        hist.append(({k: np.asarray(v) for k, v in out.items()},
                     {k: np.asarray(v) for k, v in res.items()}))
    return hist


def _port_sim(grads, steps):
    """The port's pure functions over the stacked members, the
    collectives done by hand: per step (outputs, residuals, codes, sums)."""
    res = {k: torch.zeros(N, *s) for k, s in SHAPES.items()}
    hist = []
    for _ in range(steps):
        outs, new_res, codes, sums = {}, {}, {}, {}
        for k in SHAPES:
            gf = torch.from_numpy(np.stack([grads[r][k] for r in range(N)])) + res[k]
            amax = gf.abs().reshape(N, -1).max(1).values.max()  # the MAX all-reduce
            q, scale = quantize(gf, amax)
            q_sum = q.to(torch.int32).sum(0, dtype=torch.int32)  # the int32 SUM all-reduce
            outs[k] = dequantize_sum(q_sum, scale, N).expand(N, *SHAPES[k])
            new_res[k] = residual(gf, q, scale)
            codes[k], sums[k] = q, q_sum
        res = new_res
        hist.append((outs, new_res, codes, sums))
    return hist


def _close(got, want, mag):
    """float32 agreement on the leaf's scale ``mag`` (its gradients'
    largest magnitude): XLA rounds the shared scale and the dequantising
    product in its own order (seen: 1 ulp of the scale), and a residual is
    a difference of numbers of that size."""
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * mag)


def _mag(grads, k):
    return max(float(np.abs(g[k]).max()) for g in grads)


def test_codes_sums_outputs_and_residuals_equal_the_reference():
    grads = _grads(0)
    want = _reference_steps(grads, STEPS)
    got = _port_sim(grads, STEPS)
    prev = {k: np.zeros((N, *s), np.float32) for k, s in SHAPES.items()}
    for (w_out, w_res), (g_out, g_res, codes, sums) in zip(want, got):
        for k in SHAPES:
            _close(g_out[k].numpy(), w_out[k], _mag(grads, k))
            _close(g_res[k].numpy(), w_res[k], _mag(grads, k))
            gf = np.stack([grads[r][k] for r in range(N)]) + prev[k]
            amax = np.float32(np.abs(gf).max())
            scale = np.float32(amax / np.float32(127.0))
            # the reference's codes: what its residual left of gf, on its grid
            ref_codes = np.rint((gf - w_res[k]) / scale).astype(np.int64)
            assert np.array_equal(codes[k].numpy().astype(np.int64), ref_codes), k
            assert np.array_equal(sums[k].numpy(), ref_codes.sum(0).astype(np.int32)), k
            assert codes[k].dtype == torch.int8 and sums[k].dtype == torch.int32
        prev = w_res


def test_quantize_edges():
    q, scale = quantize(torch.zeros(4), torch.tensor(0.0))
    assert float(scale) == 1.0 and not q.any()
    q, _ = quantize(torch.tensor([1.0, -1.0, 0.5 / 127, 1.5 / 127]), torch.tensor(1.0))
    assert q.tolist() == [127, -127, 0, 2]  # half to even, as jnp.round
    st = compress_init({"w": torch.ones(3, dtype=torch.bfloat16)})
    assert st.residual["w"].dtype == torch.float32


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("compress"))
    grads = _grads(1)
    rng = np.random.default_rng(2)
    g0 = (rng.standard_normal(64) * 1e-3).astype(np.float32)  # small grads stress the grid
    const = [g0, -g0 * 0.5]
    spawn(W.compress_rank, N, out, grads, STEPS, const, CONST_STEPS, threads=1, store_dir=out)
    runs = [torch.load(os.path.join(out, f"compress_{r}.pt")) for r in range(N)]
    return grads, const, runs


def test_two_process_run_equals_the_simulation(two_ranks):
    """Bit for bit against the port's simulation, to float32 against the
    reference's."""
    grads, _, runs = two_ranks
    want = _reference_steps(grads, STEPS)
    sim = _port_sim(grads, STEPS)
    for step, ((w_out, w_res), (s_out, s_res, _, _)) in enumerate(zip(want, sim)):
        for r in range(N):
            for k in SHAPES:
                out, res = runs[r]["outs"][step][k], runs[r]["res"][step][k]
                assert torch.equal(out, s_out[k][r]) and torch.equal(res, s_res[k][r]), (step, r)
                _close(out.numpy(), w_out[k][r], _mag(grads, k))
                _close(res.numpy(), w_res[k][r], _mag(grads, k))


def test_error_feedback_cancels_bias(two_ranks):
    _, const, runs = two_ranks
    true_mean = (const[0] + const[1]) / 2
    for r in range(N):
        avg = runs[r]["ef_mean"].numpy()
        assert np.linalg.norm(avg - true_mean) / np.linalg.norm(true_mean) < 0.01
