"""The binary tensor-core route of the stochastic GEMM, on the CPU.

``csrc/stoch_gemm_sm90.cu`` multiplies int8 codes against int8 codes: each
code becomes the sign planes of its stream (``P`` = the stream of ``|c|``
from :func:`~repro_torch.kernels.stoch_matmul.ops.stream_table` when ``c >=
0``, ``N`` when ``c < 0``), and a weight row ``[P_w | N_w]`` dotted against
``[P_x | N_x]`` and ``[N_x | P_x]`` gives ``same - opp``.  Held here:

* that arithmetic over the wrapper's tables, for every pair of magnitudes
  0..128 with every sign and all 9 generator pairings, against the
  reference's popcount of ``encode``d streams;
* the plain version (``ref.stoch_gemm_codes_ref``, which the entries run
  on a CPU tensor) against the reference's ``stoch_matmul`` (the Pallas
  kernel in interpret mode) at ragged shapes, every code -127..127 and
  zero; code -128, which quantize never gives, against the same reference
  (whose ``encode_signed`` takes ``abs`` in int8, where -128 stays -128:
  the table's row 128 is that stream, not the full one);
* the prepared ``sc`` weight cache: ``quantize_weight_t``'s codes and
  scales, nothing else;
* the kernel and K split each shape takes, and the launch counters.

The CUDA kernels are held against the same plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import bitstream as jbits  # noqa: E402
from repro.core.quant import QTensor as JaxQTensor  # noqa: E402
from repro.kernels.stoch_matmul.ops import stoch_matmul as jax_stoch_matmul  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.astra_layer import quantize_weight_t  # noqa: E402
from repro_torch.core.bitstream import GENERATORS, encode_signed, popcount  # noqa: E402
from repro_torch.core.ossm import WeightCodes  # noqa: E402
from repro_torch.kernels import kernel_wrappers, launch_counts, reset_launches  # noqa: E402
from repro_torch.kernels.bts_encode.ref import bts_encode_ref  # noqa: E402
from repro_torch.kernels.stoch_matmul import ops as sm_ops  # noqa: E402
from repro_torch.kernels.stoch_matmul import ref as sm_ref  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402

PAIRS = list(itertools.product(GENERATORS, GENERATORS))


def _kernel_planes(codes: torch.Tensor, gen: str):
    """The planes the kernels stage for int8 ``codes``: row ``|c|`` of the
    wrapper's table, split by the code's sign mask (all ones when c < 0)."""
    words = sm_ops.stream_table(gen)[codes.to(torch.int64).abs()]
    mask = torch.where(codes < 0, -1, 0).to(torch.int32)[..., None]
    return words & ~mask, words & mask


@pytest.mark.parametrize("x_gen,w_gen", PAIRS)
def test_sign_plane_products_equal_reference_popcount(x_gen, w_gen):
    """same - opp of every code pair (-128..127 on both sides: every
    magnitude 0..127 with both signs, and -128) equals the signed popcount
    of the reference's ``encode_signed`` streams of the two codes."""
    c = np.arange(-128, 128)
    xw, sx = (np.asarray(a) for a in jbits.encode_signed(jnp.asarray(c, jnp.int8), x_gen))
    ww, sw = (np.asarray(a) for a in jbits.encode_signed(jnp.asarray(c, jnp.int8), w_gen))
    pair = np.vectorize(lambda v: bin(int(v)).count("1"))(
        xw[:, None, :] & ww[None, :, :]).sum(-1)  # [256, 256]
    codes = torch.arange(-128, 128).to(torch.int8)
    px, nx = _kernel_planes(codes, x_gen)
    pw, nw = _kernel_planes(codes, w_gen)
    px, nx, pw, nw = px[:, None], nx[:, None], pw[None], nw[None]
    same = popcount(px & pw) + popcount(nx & nw)
    opp = popcount(nx & pw) + popcount(px & nw)
    want = sx[:, None] * sw[None, :] * pair
    np.testing.assert_array_equal((same - opp).numpy(), want)
    # the plain version's planes are the kernels', and its signed bits'
    # products the same table
    for gen in (x_gen, w_gen):
        planes = sm_ref.sign_planes(codes, gen)
        assert all(torch.equal(a, b) for a, b in zip(planes, _kernel_planes(codes, gen)))
    prod = sm_ref.signed_bits(x_gen) @ sm_ref.signed_bits(w_gen).T
    np.testing.assert_array_equal(prod.numpy(), want.astype(np.float32))


# ragged (M, K, N): one row (the decode kernel), K past a 16-code run and
# a 4-code word, N past an n8 group, M past 16 (the wgmma kernel)
RAGGED = [(1, 17, 5), (8, 40, 33), (9, 33, 17), (16, 64, 9), (17, 24, 40), (40, 255, 3)]


def _want(xq: np.ndarray, wq: np.ndarray, x_gen: str, w_gen: str) -> np.ndarray:
    """The reference's ``stoch_matmul`` of codes ``xq [M, K]`` and ``wq [K,
    N]`` as int32 accumulators (x scale 1/128, w scale 1: exact)."""
    out = jax_stoch_matmul(JaxQTensor(jnp.asarray(xq), jnp.float32(1.0 / 128)),
                           JaxQTensor(jnp.asarray(wq), jnp.float32(1.0)), x_gen, w_gen,
                           interpret=True)
    return np.asarray(out).astype(np.int32)


@pytest.mark.parametrize("mkn", RAGGED, ids=[f"{m}x{k}x{n}" for m, k, n in RAGGED])
def test_plain_version_equals_reference_stoch_matmul(rng, mkn):
    """The codes x codes entries on CPU tensors (their plain version) against
    the reference kernel: every code -127..127 and zero among the
    activations, under a pairing chosen by the shape; no launch counted."""
    m, k, n = mkn
    x_gen, w_gen = PAIRS[(m * 7 + k + n) % len(PAIRS)]
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    flat = xq.reshape(-1)
    flat[:min(255, flat.size)] = np.arange(-127, 128)[:min(255, flat.size)]
    wq[0] = 0
    want = _want(xq, wq, x_gen, w_gen)
    before = launch_counts()
    tx, tw = torch.from_numpy(xq), torch.from_numpy(wq.T.copy())
    got = sm_ops.stoch_gemm_codes(tx, tw, x_gen, w_gen)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sm_ops.stoch_matmul_codes_batched(tx[None], tw[None], x_gen, w_gen)[0].numpy(), want)
    assert launch_counts() == before


@pytest.mark.parametrize("x_gen,w_gen", [("thermometer", "bresenham"), ("lfsr", "thermometer"),
                                         ("bresenham", "bresenham")])
def test_plain_version_on_code_minus_128(x_gen, w_gen):
    """Every int8 code on both sides, -128 included, against the
    reference's ``stoch_matmul`` (the Pallas kernel in interpret mode, its
    operands from the reference's ``encode_signed``, where -128's
    magnitude wraps), and the port's entries on CPU tensors."""
    codes = torch.arange(-128, 128).to(torch.int8)
    xq = torch.stack([codes, codes.flip(0), codes.roll(37)])
    wq = torch.stack([codes, codes.flip(0), codes.roll(-5), torch.zeros_like(codes)])
    want = _want(xq.numpy(), wq.numpy().T.copy(), x_gen, w_gen)
    np.testing.assert_array_equal(sm_ref.stoch_gemm_codes_ref(xq, wq, x_gen, w_gen).numpy(),
                                  want)
    np.testing.assert_array_equal(sm_ops.stoch_gemm_codes(xq, wq, x_gen, w_gen).numpy(), want)
    ws, sw = encode_signed(wq, w_gen)
    np.testing.assert_array_equal(
        sm_ops.stoch_matmul_codes(xq, ws, sw.to(torch.int8), x_gen).numpy(), want)
    assert (want[:, 3] == 0).all()
    # bts_encode keeps the Pallas encoder's full stream at -128, so the
    # packed product over its streams differs from the reference's there
    xs, sx = bts_encode_ref(xq, x_gen)
    full = sm_ref.stoch_matmul_packed_ref(xs, sx, *bts_encode_ref(wq, w_gen))
    assert not np.array_equal(full.numpy(), want)


def test_plain_version_walks_n_in_chunks(rng, monkeypatch):
    """The walk over N in chunks gives the integers of one step, a batch
    each product on its own."""
    xq = torch.from_numpy(rng.integers(-128, 128, (3, 5, 21)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-128, 128, (3, 11, 21)).astype(np.int8))
    whole = sm_ref.stoch_gemm_codes_ref(xq, wq, "lfsr", "bresenham")
    for b in range(3):
        assert torch.equal(sm_ref.stoch_gemm_codes_ref(xq[b], wq[b], "lfsr", "bresenham"),
                           whole[b])
    monkeypatch.setattr(sm_ref, "_BITS_CHUNK", 21 * 128 * 3 * 2)  # two rows a step
    assert torch.equal(sm_ref.stoch_gemm_codes_ref(xq, wq, "lfsr", "bresenham"), whole)


@pytest.mark.parametrize("plan", ["sc", "mixed", '{"*_proj": {"mode": "sc", "w_gen": "lfsr"}, '
                                  '"default": "int8"}'])
def test_prepared_sc_cache_holds_quantize_codes(plan):
    """Every ``sc`` weight is cached as exactly ``quantize_weight_t``'s int8
    codes ``[N, K]`` and scales ``[1, N]``, tagged with the site's
    ``w_gen``: one byte a code, no streams."""
    cfg = get_arch("stablelm-1.6b").reduced(dtype="float32")
    model = Model(cfg, ModelOptions(plan=plan), device="cpu")
    params = model.init(0)
    prep = model.prepare(params)
    seen = []

    def walk(tree):
        if isinstance(tree, dict):
            if "wsc_t" in tree:
                seen.append((tree["w"], tree["wsc_t"]))
            for v in tree.values():
                walk(v)
        elif isinstance(tree, list):
            for v in tree:
                walk(v)

    walk(prep)
    assert seen
    for w, cache in seen:
        assert isinstance(cache, WeightCodes) and set(cache._fields) == {"q", "scale", "gen"}
        want = quantize_weight_t(w)
        assert cache.q.dtype == torch.int8 and cache.q.shape == (w.shape[1], w.shape[0])
        assert torch.equal(cache.q, want.q) and torch.equal(cache.scale, want.scale)
    gens = {cache.gen for _, cache in seen}
    assert gens == ({"lfsr"} if plan.startswith("{") else {"bresenham"})


@pytest.mark.parametrize("m,n,k,b", [(8, 2048, 2048, 1), (8, 5632, 2048, 1), (8, 2048, 5632, 1),
                                     (8, 100352, 2048, 1), (16, 47, 130, 1), (1, 512, 64, 256),
                                     (17, 16, 64, 1), (640, 5632, 2048, 1), (640, 2048, 2048, 1),
                                     (640, 100352, 2048, 1), (40, 20, 100, 3), (1, 5, 17, 1)])
def test_stoch_gemm_plan_kernel_and_splits(m, n, k, b):
    """At most 16 rows take the decode kernel, more the wgmma kernel; the K
    splits cover K once in whole steps of the kernel, fit the grid, and
    leave the lm_head's many tiles unsplit."""
    kernel, kps, splits = sm_ops.stoch_gemm_plan(m, n, k, 132, b)
    assert kernel == ("stream" if m <= 16 else "wgmma")
    step = 64 if kernel == "stream" else 8
    assert kps % step == 0 and (splits - 1) * kps < k <= splits * kps
    assert 1 <= splits <= 8 and b * splits <= 65535
    if n == 100352:
        assert splits == 1


def test_wave_splits_fill_the_last_wave():
    """80 tiles on 132 SMs: three splits (240 blocks, two waves of a third
    of K each) beat one (one wave of all of K); 3920 tiles take none."""
    assert sm_ops._wave_splits(80, 2048, 8, 132)[1] == 3
    assert sm_ops._wave_splits(3920, 2048, 8, 132)[1] == 1
    assert sm_ops._wave_splits(1, 16, 8, 132) == (16, 1)  # one step: nothing to split


def test_launch_counters_report_the_binary_kernels():
    """Both codes x codes entries count their launches, and by kernel."""
    wrappers = kernel_wrappers()
    assert wrappers["stoch_gemm_codes"] is sm_ops.stoch_gemm_codes
    sm_ops.stoch_gemm_codes.paths["wgmma"] = 2
    sm_ops.stoch_matmul_codes_batched.paths["stream"] = 1
    counts = launch_counts()
    assert counts["stoch_gemm_codes_wgmma"] == 2
    assert counts["stoch_matmul_codes_batched_stream"] == 1
    reset_launches()
    counts = launch_counts()
    assert all(counts[f"{e}_{p}"] == 0 for e in ("stoch_gemm_codes", "stoch_matmul_codes_batched")
               for p in sm_ops.GEMM_KERNELS)
