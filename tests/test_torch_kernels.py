"""The port's kernel wrappers against the reference's kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the reference's Pallas kernels run in interpret
mode (as ``tests/test_kernels.py`` runs them), on the same numpy inputs:

* paged decode and causal suffix prefill — G in {1, 2}, softcap, kv_len
  edges (0, 1, bs, bs+1, full table), mid-block and block-edge starts,
  table entries at scratch block 0.  float32 to 1e-5 (both sides compute
  in float32; only summation order differs); bfloat16 to 2e-2 (the
  reference kernel rounds p to bf16 before the PV product, the plain
  version does not).
* int8 GEMM — int32 accumulators and dequantized float32 bit-exact
  against ``int8_matmul`` (interpret) and ``int8_matmul_exact``.

The CUDA kernels themselves are held against the same plain versions on
the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quant import QTensor as JaxQTensor  # noqa: E402
from repro.core.quant import int8_matmul_exact as jax_int8_matmul_exact  # noqa: E402
from repro.kernels.int8_matmul.ops import int8_matmul as jax_int8_matmul  # noqa: E402
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention_decode as jax_paged_decode,
    paged_attention_prefill as jax_paged_prefill,
)
from repro_torch.core.quant import QTensor, int8_matmul_exact  # noqa: E402
from repro_torch.kernels.int8_matmul import ops as int8_ops  # noqa: E402
from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402


def _paged_inputs(rng, b, kvh, g, hd, bs, w, n_blocks):
    q = rng.standard_normal((b, kvh * g, hd)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, kvh, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, kvh, bs, hd)).astype(np.float32)
    table = rng.integers(1, n_blocks, (b, w)).astype(np.int32)
    table[0, -1] = 0  # an entry at scratch block 0
    return q, kp, vp, table


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_paged_decode_plain_matches_reference_kernel(rng, g, softcap):
    kvh, hd, bs, w = 2, 16, 4, 3
    kv_len = np.asarray([0, 1, bs, bs + 1, w * bs], np.int32)
    q, kp, vp, table = _paged_inputs(rng, kv_len.shape[0], kvh, g, hd, bs, w, 16)
    want = jax_paged_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(table), jnp.asarray(kv_len), softcap=softcap,
                            interpret=True)
    before = pa_ops.paged_attention_decode.launches
    got = pa_ops.paged_attention_decode(*_t(q, kp, vp, table, kv_len), softcap=softcap)
    assert pa_ops.paged_attention_decode.launches == before  # CPU: no kernel launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert not got[0].any()  # kv_len == 0 -> zeros


@pytest.mark.parametrize("g,softcap", [(1, 0.0), (2, 3.0)])
def test_paged_prefill_plain_matches_reference_kernel(rng, g, softcap):
    """Starts at 0, mid-block, one before a block edge, on it, and past it."""
    kvh, hd, bs, w, s = 2, 16, 4, 4, 3
    start = np.asarray([0, 2, bs - 1, bs, 2 * bs + 1], np.int32)
    _, kp, vp, table = _paged_inputs(rng, start.shape[0], kvh, g, hd, bs, w, 24)
    qs = rng.standard_normal((start.shape[0], kvh * g, s, hd)).astype(np.float32)
    want = jax_paged_prefill(jnp.asarray(qs), jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(table), jnp.asarray(start), softcap=softcap,
                             interpret=True)
    got = pa_ops.paged_attention_prefill(*_t(qs, kp, vp, table, start), softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_paged_decode_plain_bf16(rng):
    kvh, g, hd, bs, w = 2, 2, 16, 4, 3
    kv_len = np.asarray([3, 9], np.int32)
    q, kp, vp, table = _paged_inputs(rng, 2, kvh, g, hd, bs, w, 8)
    want = jax_paged_decode(*(jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp)),
                            jnp.asarray(table), jnp.asarray(kv_len), interpret=True)
    tq, tk, tv = (x.to(torch.bfloat16) for x in _t(q, kp, vp))
    got = pa_ops.paged_attention_decode(tq, tk, tv, *_t(table, kv_len))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)


def test_paged_wrappers_refuse_int8_pools(rng):
    q, kp, vp, table = _paged_inputs(rng, 2, 2, 1, 16, 4, 3, 8)
    kq = torch.zeros(kp.shape, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="kv_quant"):
        pa_ops.paged_attention_decode(*_t(q), kq, kq, *_t(table, np.ones(2, np.int32)))


@pytest.mark.parametrize("m,k,n", [(8, 64, 96), (33, 128, 40), (1, 17, 5), (130, 256, 128)])
def test_int8_plain_bit_exact_against_reference(rng, m, k, n):
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xs = np.float32(rng.uniform(0.001, 0.1))
    ws = rng.uniform(0.001, 0.1, (1, n)).astype(np.float32)
    jxq = JaxQTensor(jnp.asarray(x), jnp.asarray(xs))
    jwq = JaxQTensor(jnp.asarray(w), jnp.asarray(ws))
    want_acc = np.asarray(x, np.int64) @ np.asarray(w, np.int64)
    acc = int8_matmul_acc_ref(*_t(x), torch.from_numpy(np.ascontiguousarray(w.T)))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    txq = QTensor(torch.from_numpy(x), torch.tensor(xs))
    twq = QTensor(torch.from_numpy(w), torch.from_numpy(ws))
    twq_t = QTensor(torch.from_numpy(np.ascontiguousarray(w.T)), torch.from_numpy(ws))
    before = int8_ops.int8_gemm.launches
    for got in (int8_ops.int8_matmul_t(txq, twq_t), int8_matmul_exact(txq, twq)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jax_int8_matmul(jxq, jwq, interpret=True)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jax_int8_matmul_exact(jxq, jwq)))
    assert int8_ops.int8_gemm.launches == before


def test_int8_split_plan_covers_k():
    """Split-K plans cover K exactly once with 64-aligned chunks."""
    for m, n, k in [(8, 2048, 2048), (8, 2048, 5632), (8, 100352, 2048), (3000, 5632, 2048),
                    (8, 5, 17)]:
        cfg, kps, splits = int8_ops.split_plan(m, n, k, 132)
        assert cfg == (0 if m <= 16 else 1)
        assert kps % 64 == 0 and (splits - 1) * kps < k <= splits * kps
