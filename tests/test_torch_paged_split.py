"""Paged decode split over the table's keys, against the reference kernel.

The CUDA decode kernel (``csrc/decode.cu``) cuts each slot's live keys
into splits of whole 16-key chunks (``decode_split_ranges`` over the
table's ``W * BS`` positions), reads each split's keys through its slice
of the slot's table row (``paged_split_rows`` is that walk in Python),
computes one ``(o, m, l)`` triple per split and merges them
(``decode_merge_ref``).  Here the reference's ``paged_attention_kernel``
(interpret mode, as ``tests/test_torch_dense_split.py`` runs the dense
one) gives each split's own triple over that split's keys: through the
table slice itself where the split starts on a block edge, and through a
gathered view of its keys, re-blocked into fresh pool blocks, where it
does not (a split starts at a multiple of 16, which is no block edge at
block size 12).  The port's merge of those triples is held against the
reference's unsplit ``paged_attention_decode`` within 1e-5 on float32 and
int8 pools (float32 on both sides; only the summation order and the
rescales differ) at block sizes 8, 12 and 16.  The walk is held against
``table[b, kp // BS], kp % BS`` for every key.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_attention.kernel import paged_attention_kernel  # noqa: E402
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention_decode as jax_paged_decode,
)
from repro_torch.kernels.paged_attention.ops import DECODE_CHUNK  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    decode_merge_ref, decode_split_ranges, paged_decode_ref, paged_split_rows,
)

KVH, HD = 2, 16


def _kv_len(bs: int, w: int) -> np.ndarray:
    """kv_len 0 (every split empty), 1, either side of a block edge, either
    side of a 16-key chunk edge, the next chunk edge, and the whole table."""
    return np.asarray(sorted({0, 1, bs - 1, bs, bs + 1, 15, 16, 17, 32, 33, w * bs}), np.int32)


def _width(bs: int) -> int:
    """Table width: at least 48 positions, and a block past them."""
    return -(-48 // bs) + 1


def _table(rng, b: int, w: int) -> np.ndarray:
    """Distinct pool blocks per slot, with entries at scratch block 0."""
    table = (rng.permutation(b * w)[: b * w].reshape(b, w) + 1).astype(np.int32)
    table[2, 0] = 0
    table[-1, w // 2] = 0
    return table


def _slice_cap(s: int, splits: int, bs: int) -> int:
    """The kernel's table-slice room a block: ceil(span / BS) + 1 entries
    for the longest split's span of keys."""
    per = -(-(-(-s // DECODE_CHUNK)) // splits)
    return -(-(per * DECODE_CHUNK) // bs) + 1


@pytest.mark.parametrize("bs", [8, 12, 16, 128])
@pytest.mark.parametrize("splits", [1, 2, 5, 40])
def test_split_rows_walk_the_table(bs, splits):
    """Every key of every split is read from ``table[b, kp // BS]``, row
    ``kp % BS``, through a table slice no longer than the kernel's room."""
    rng = np.random.default_rng(bs + splits)
    w = _width(bs)
    kv_len = _kv_len(bs, w)
    table = _table(rng, kv_len.size, w)
    lo, hi = (x.numpy() for x in decode_split_ranges(torch.from_numpy(kv_len), w * bs, splits))
    for i in range(kv_len.size):
        for a, c in zip(lo[i].tolist(), hi[i].tolist()):
            if a >= c:
                continue
            tbl, rows = paged_split_rows(table[i], a, c, bs)
            assert rows == [(int(table[i, kp // bs]), kp % bs) for kp in range(a, c)]
            assert len(tbl) <= -(-(c - a) // bs) + 1 <= _slice_cap(w * bs, splits, bs)


def _reference_split_merge(q, k_pool, v_pool, table, kv_len, splits, softcap, scales):
    """Each split's (o, m, l) from the reference kernel over that split's
    keys (one batch row per (slot, split)), merged by the port's helper.
    Returns [B, H, hd] float32."""
    b, h, hd = q.shape
    bs, w = k_pool.shape[2], table.shape[1]
    lo, hi = (x.numpy() for x in decode_split_ranges(torch.from_numpy(kv_len), w * bs, splits))
    span = max(1, int((hi - lo).max()))
    wide = -(-span // bs) + 1
    rows = np.zeros((b, splits, wide), np.int32)
    extra_k, extra_v = [], []  # gathered blocks of the splits that start inside a block
    nb = k_pool.shape[0]
    for i in range(b):
        for j in range(splits):
            a, c = int(lo[i, j]), int(hi[i, j])
            if a >= c:
                continue
            if a % bs == 0:  # the split's table slice, as it stands
                part = table[i, a // bs:(c - 1) // bs + 1]
            else:  # its keys gathered from the table and re-blocked
                view_k = k_pool[table[i]].transpose(1, 0, 2, 3).reshape(KVH, w * bs, hd)
                view_v = v_pool[table[i]].transpose(1, 0, 2, 3).reshape(KVH, w * bs, hd)
                n_new = -(-(c - a) // bs)
                for x, view in ((extra_k, view_k), (extra_v, view_v)):
                    blk = np.zeros((KVH, n_new * bs, hd), k_pool.dtype)
                    blk[:, :c - a] = view[:, a:c]
                    x.append(blk.reshape(KVH, n_new, bs, hd).transpose(1, 0, 2, 3))
                part = np.arange(nb, nb + n_new, dtype=np.int32)
                nb += n_new
            rows[i, j, :len(part)] = part
    kp = np.concatenate([k_pool] + extra_k) if extra_k else k_pool
    vp = np.concatenate([v_pool] + extra_v) if extra_v else v_pool
    lens = np.maximum(hi - lo, 0).astype(np.int32).reshape(-1)
    qg = np.repeat(q.reshape(b, 1, KVH, h // KVH, hd), splits, axis=1)
    o, m, l = paged_attention_kernel(
        jnp.asarray(qg.reshape(b * splits, KVH, h // KVH, hd)), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(rows.reshape(b * splits, wide)), jnp.asarray(lens),
        *(jnp.asarray(s) for s in scales), scale=hd ** -0.5, softcap=softcap,
        interpret=True)
    # [B * splits, KVH, G, ...] -> [B, KVH, G, splits, ...]
    o, m, l = (torch.from_numpy(np.array(x)).reshape(b, splits, KVH, h // KVH, -1)
               .permute(0, 2, 3, 1, 4) for x in (o, m, l))
    return decode_merge_ref(o, m[..., 0], l[..., 0]).reshape(b, h, hd)


@pytest.mark.parametrize("pool,bs,splits,g,softcap", [
    ("float32", 8, 1, 1, 0.0),    # one split: the unsplit walk
    ("int8", 8, 3, 4, 0.0),       # splits on block edges (16 is two blocks of 8)
    ("float32", 12, 2, 2, 5.0),   # splits inside blocks: the gathered view
    ("int8", 12, 40, 1, 0.0),     # more splits than chunks: most are empty
    ("float32", 16, 5, 10, 2.0),  # one chunk a split, recurrentgemma's G
    ("int8", 16, 2, 1, 30.0),     # softcap on the int8 pool
])
def test_split_merge_matches_reference_kernel(pool, bs, splits, g, softcap):
    rng = np.random.default_rng(11 + splits)
    w = _width(bs)
    kv_len = _kv_len(bs, w)
    b = kv_len.size
    table = _table(rng, b, w)
    q = rng.standard_normal((b, KVH * g, HD)).astype(np.float32)
    shape = (b * w + 1, KVH, bs, HD)
    if pool == "int8":
        k_pool, v_pool = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        scales = tuple(rng.uniform(0.005, 0.03, KVH).astype(np.float32) for _ in range(2))
    else:
        k_pool, v_pool = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        scales = ()
    got = _reference_split_merge(q, k_pool, v_pool, table, kv_len, splits, softcap, scales)
    want = jax_paged_decode(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
                            jnp.asarray(table), jnp.asarray(kv_len),
                            *(jnp.asarray(s) for s in scales), softcap=softcap, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert not got[0].any()  # kv_len 0: every split empty, zeros
    kw = dict(zip(("k_scale", "v_scale"), (torch.from_numpy(s) for s in scales)))
    plain = paged_decode_ref(*(torch.from_numpy(x) for x in (q, k_pool, v_pool, table, kv_len)),
                             softcap=softcap, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
