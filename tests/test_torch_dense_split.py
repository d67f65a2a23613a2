"""Dense decode split over the cache, against the reference kernel.

The CUDA decode kernel cuts each slot's live keys into splits of whole
16-key chunks (``decode_split_ranges``), computes one ``(o, m, l)``
triple per split and merges them (``decode_merge_ref`` is that merge in
plain PyTorch).  Here the reference's ``dense_attention_kernel`` (interpret mode,
as ``tests/test_kernels.py`` runs it) gives each split's own triple over
that split's key range, the port's helpers merge them, and the result is
held against the reference's unsplit ``dense_attention_decode`` within
1e-5 (float32 on both sides; only the summation order and the rescales
differ).  ``decode_split_plan``, which picks the split count from shapes
alone, is tested directly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention.kernel import dense_attention_kernel  # noqa: E402
from repro.kernels.paged_attention.ops import (  # noqa: E402
    dense_attention_decode as jax_dense_decode,
)
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    DECODE_CHUNK, DECODE_WAVES, decode_split_plan,
)
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    decode_merge_ref, decode_split_ranges, dense_decode_ref,
)

S = 40  # cache positions: 3 chunks of 16, the last ragged
# kv_len 0 (all splits empty), 1, a chunk edge and either side of it, the
# next chunk edge and past it, and S
KV_LEN = np.asarray([0, 1, 15, 16, 17, 32, 33, S], np.int32)


def _reference_split_merge(q, k, v, kv_len, splits, softcap):
    """Each split's (o, m, l) from the reference kernel over that split's
    keys (one batch row per (slot, split), padded to the longest range),
    merged by the port's helper.  Returns [B, H, hd] float32."""
    b, h, hd = q.shape
    kvh, s = k.shape[1], k.shape[2]
    lo, hi = (x.numpy() for x in decode_split_ranges(torch.from_numpy(kv_len), s, splits))
    span = max(1, int((hi - lo).max()))
    kp = np.zeros((b, splits, kvh, span, hd), np.float32)
    vp = np.zeros_like(kp)
    for i in range(b):
        for j in range(splits):
            n = max(0, hi[i, j] - lo[i, j])
            kp[i, j, :, :n] = k[i, :, lo[i, j]:lo[i, j] + n]
            vp[i, j, :, :n] = v[i, :, lo[i, j]:lo[i, j] + n]
    lens = np.maximum(hi - lo, 0).astype(np.int32).reshape(-1)
    qg = np.repeat(q.reshape(b, 1, kvh, h // kvh, hd), splits, axis=1)
    o, m, l = dense_attention_kernel(
        jnp.asarray(qg.reshape(b * splits, kvh, h // kvh, hd)),
        jnp.asarray(kp.reshape(b * splits, kvh, span, hd)),
        jnp.asarray(vp.reshape(b * splits, kvh, span, hd)), jnp.asarray(lens),
        scale=hd ** -0.5, bk=min(16, span), softcap=softcap, interpret=True)
    # [B * splits, KVH, G, ...] -> [B, KVH, G, splits, ...]
    o, m, l = (torch.from_numpy(np.array(x)).reshape(b, splits, kvh, h // kvh, -1)
               .permute(0, 2, 3, 1, 4) for x in (o, m, l))
    return decode_merge_ref(o, m[..., 0], l[..., 0]).reshape(b, h, hd)


@pytest.mark.parametrize("g,hd,splits,softcap", [
    (1, 16, 1, 0.0),     # one split: the unsplit walk
    (10, 16, 2, 5.0),    # two splits, recurrentgemma's G, softcap
    (1, 64, 8, 0.0),     # more splits than chunks: most are empty
    (10, 64, 3, 2.0),    # one chunk a split, splits cut at chunk edges
    (2, 16, 40, 0.0),    # as many splits as positions
])
def test_split_merge_matches_reference_kernel(g, hd, splits, softcap):
    rng = np.random.default_rng(7 + splits)
    kvh = 2
    b = KV_LEN.size
    q = rng.standard_normal((b, kvh * g, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, kvh, S, hd)).astype(np.float32) for _ in range(2))
    got = _reference_split_merge(q, k, v, KV_LEN, splits, softcap)
    want = jax_dense_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(KV_LEN), softcap=softcap, bk=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert not got[0].any()  # kv_len 0: every split empty, zeros
    plain = dense_decode_ref(*(torch.from_numpy(x) for x in (q, k, v, KV_LEN)),
                             softcap=softcap)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("s,splits", [(40, 1), (40, 2), (40, 5), (2048, 33), (100, 7)])
def test_split_ranges_cover_the_live_keys_in_whole_chunks(s, splits):
    """The non-empty ranges tile [0, min(kv_len, S)) in order, each but the
    last a whole number of chunks, all of one length."""
    kv_len = torch.tensor([0, 1, 15, 16, 17, 33, s - 1, s, s + 5], dtype=torch.int32)
    lo, hi = decode_split_ranges(kv_len, s, splits)
    assert lo.shape == hi.shape == (kv_len.numel(), splits)
    for i, n in enumerate(kv_len.clamp(max=s).tolist()):
        live = [(a, c) for a, c in zip(lo[i].tolist(), hi[i].tolist()) if a < c]
        assert sum(c - a for a, c in live) == n
        ends = [0] + [c for _, c in live]
        assert all(a == e for (a, _), e in zip(live, ends))  # contiguous from 0
        assert all(a % DECODE_CHUNK == 0 for a, _ in live)
        assert len({c - a for a, c in live[:-1]}) <= 1  # equal whole shares


@pytest.mark.parametrize("b,kvh,s,n_sm", [
    (8, 1, 2048, 132),    # recurrentgemma rings: many splits
    (8, 32, 512, 132),    # stablelm: two
    (1, 1, 2048, 132),    # one slot: capped by the cache's chunks
    (64, 32, 512, 132),   # the grid is full without splitting
    (3, 2, 20, 132),      # a cache of 2 chunks
    (8, 1, 5, 132),       # shorter than one chunk
    (8, 1, 2048, 0),      # no SM count: one split
])
def test_dense_split_plan(b, kvh, s, n_sm):
    splits = decode_split_plan(b, kvh, s, n_sm)
    chunks = -(-s // DECODE_CHUNK)
    assert 1 <= splits <= chunks
    target = DECODE_WAVES * n_sm
    if splits < chunks:  # S allows more: the grid reaches its target
        assert b * kvh * splits >= target
    if splits > 1:  # and does not overshoot by a whole split
        assert b * kvh * (splits - 1) < target
