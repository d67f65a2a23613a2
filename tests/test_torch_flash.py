"""The dense layout's kernel wrappers against the reference's kernels.

On the CPU each wrapper runs its plain version; these tests hold that
version against the reference's Pallas kernels in interpret mode (as
``tests/test_kernels.py`` runs them), on the same numpy inputs:

* ``flash_attention`` — causal, sliding window, softcap, GQA folds
  (Hq != Hkv, folded rows not a multiple of the reference's tiles), Sq =
  Sk not a multiple of the tiles, a non-causal case over whole tiles, and
  the refusal of non-causal input over padded keys on both sides.
* ``dense_attention_decode`` — S not a multiple of the reference's key
  block (its ragged trailing block), kv_len 0, 1, a block edge and S,
  GQA, softcap.

float32 to 1e-5 (both sides compute in float32; only the summation order
and the streaming rescales differ); bfloat16 to 2e-2 (p rounded to bf16
against the running max in the reference's tiles, against the row's
final max in the plain version).  The CUDA kernels are held against the
same plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.paged_attention.ops import (  # noqa: E402
    dense_attention_decode as jax_dense_decode,
)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _qkv(rng, b, hq, hkv, sq, sk, d):
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


@pytest.mark.parametrize("hq,hkv,s,window,softcap", [
    (2, 2, 64, 0, 0.0),
    (4, 2, 70, 0, 0.0),     # ragged S; folded rows 140
    (4, 1, 37, 16, 0.0),    # window + fold, rows straddle tiles
    (6, 3, 72, 0, 5.0),     # softcap; folded rows 144 (pad path)
    (4, 2, 100, 24, 3.0),   # window + softcap + ragged
])
def test_flash_plain_matches_reference_kernel(rng, hq, hkv, s, window, softcap):
    q, k, v = _qkv(rng, 2, hq, hkv, s, s, 16)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                     window=window, softcap=softcap, bq=64, bk=64, interpret=True)
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(*_t(q, k, v), causal=True, window=window, softcap=softcap)
    assert fa_ops.flash_attention.launches == before  # CPU: no kernel launch
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_flash_plain_non_causal_and_padding_refusal(rng):
    """Non-causal attention over whole key tiles matches; over padded keys
    both sides refuse it with NotImplementedError."""
    q, k, v = _qkv(rng, 1, 4, 2, 50, 128, 16)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                     interpret=True)
    got = fa_ops.flash_attention(*_t(q, k, v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    q, k, v = _qkv(rng, 1, 2, 2, 40, 40, 16)
    with pytest.raises(NotImplementedError, match="non-causal padding"):
        jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                  interpret=True)
    with pytest.raises(NotImplementedError, match="non-causal padding"):
        fa_ops.flash_attention(*_t(q, k, v), causal=False)


def test_flash_plain_bf16(rng):
    q, k, v = _qkv(rng, 1, 4, 2, 96, 96, 16)
    want = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True,
                     bq=64, bk=64, interpret=True)
    got = fa_ops.flash_attention(*(x.to(torch.bfloat16) for x in _t(q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize("g,softcap", [(1, 0.0), (2, 4.0)])
@pytest.mark.parametrize("s,bk", [(20, 8), (64, 128)])
def test_dense_decode_plain_matches_reference_kernel(rng, g, softcap, s, bk):
    """kv_len 0 (zeros), 1, a block edge, one past it, and S; S = 20 with
    8-key blocks leaves a ragged trailing block in the reference kernel."""
    kvh, hd = 2, 16
    kv_len = np.asarray([0, 1, 8, 9, s], np.int32)
    q = rng.standard_normal((5, kvh * g, hd)).astype(np.float32)
    k = rng.standard_normal((5, kvh, s, hd)).astype(np.float32)
    v = rng.standard_normal((5, kvh, s, hd)).astype(np.float32)
    want = jax_dense_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(kv_len), softcap=softcap, bk=bk, interpret=True)
    before = pa_ops.dense_attention_decode.launches
    got = pa_ops.dense_attention_decode(*_t(q, k, v, kv_len), softcap=softcap)
    assert pa_ops.dense_attention_decode.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert not got[0].any()  # kv_len == 0 -> zeros


def test_dense_decode_plain_casts_queries_to_the_cache_dtype(rng):
    """float32 queries over a bf16 cache: both wrappers cast q to bf16
    first and return the query dtype."""
    kvh, g, hd, s = 2, 2, 16, 24
    kv_len = np.asarray([5, 24], np.int32)
    q = rng.standard_normal((2, kvh * g, hd)).astype(np.float32)
    k = rng.standard_normal((2, kvh, s, hd)).astype(np.float32)
    v = rng.standard_normal((2, kvh, s, hd)).astype(np.float32)
    want = jax_dense_decode(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                            jnp.asarray(v, jnp.bfloat16), jnp.asarray(kv_len),
                            bk=8, interpret=True)
    tq, tk, tv, tl = _t(q, k, v, kv_len)
    got = pa_ops.dense_attention_decode(tq, tk.to(torch.bfloat16), tv.to(torch.bfloat16), tl)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=0)
