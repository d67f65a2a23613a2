"""Plain PyTorch version of the paged-attention kernel.

Port of ``repro.kernels.paged_attention.ref``: deliberately gather-then-
mask (``pool[table]`` -> dense logical view -> masked softmax in float32),
the memory-hungry formulation the kernel streams away.  An int8 pool is
dequantized right after the gather (``k.float() * k_scale`` per KV head).
``dense_decode_ref`` is the same masked softmax over dense per-slot
caches, with no table.  ``paged_prefill_tiles`` is the causal kernels'
tile walk, ``decode_split_ranges``/``decode_merge_ref`` the decode
kernel's split and merge (both layouts), and ``paged_split_rows`` its walk
through a split's table slice, for the tests to hold against the
reference.
"""
from __future__ import annotations

import torch


def _gather(pool: torch.Tensor, table: torch.Tensor, scale=None) -> torch.Tensor:
    """pool [n_blocks, KVH, bs, hd], table [B, W] -> [B, KVH, W*bs, hd];
    ``scale [KVH]`` dequantizes an int8 pool into the float32 view."""
    b, w = table.shape
    g = pool[table.long()]  # [B, W, KVH, bs, hd]
    out = g.movedim(2, 1).reshape(b, pool.shape[1], -1, pool.shape[3])
    if scale is not None:
        out = out.to(torch.float32) * scale.to(torch.float32)[None, :, None, None]
    return out


def _softcap(s: torch.Tensor, softcap: float) -> torch.Tensor:
    return torch.tanh(s / softcap) * softcap if softcap > 0 else s


def _masked_attn(qg, k, v, mask, scale, softcap):
    """qg [B,KVH,G,Sq,hd], k/v [B,KVH,L,hd], mask [B,Sq,L] -> [B,KVH,G,Sq,hd]."""
    qg, k, v = (x.to(torch.float32) for x in (qg, k, v))
    s = _softcap(torch.einsum("bhgsd,bhld->bhgsl", qg, k) * scale, softcap)
    m = mask[:, None, None]
    s = torch.where(m, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(m, p, torch.zeros_like(p))
    denom = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return torch.einsum("bhgsl,bhld->bhgsd", p / denom, v)


def paged_decode_ref(q, k_pool, v_pool, table, kv_len, *, softcap=0.0,
                     k_scale=None, v_scale=None):
    """q [B, H, hd] -> [B, H, hd] float32: keys at positions >= kv_len[b]
    are invisible; kv_len == 0 yields zeros (matching the kernel)."""
    b, h, hd = q.shape
    kvh = k_pool.shape[1]
    k = _gather(k_pool, table, k_scale)
    v = _gather(v_pool, table, v_scale)
    kv_len = kv_len.to(q.device)
    mask = torch.arange(k.shape[2], device=q.device)[None, None] < kv_len[:, None, None]
    qg = q.reshape(b, kvh, h // kvh, 1, hd)
    o = _masked_attn(qg, k, v, mask, hd ** -0.5, softcap).reshape(b, h, hd)
    return torch.where(kv_len[:, None, None] > 0, o, torch.zeros_like(o))


def paged_prefill_ref(q, k_pool, v_pool, table, start, *, softcap=0.0,
                      k_scale=None, v_scale=None):
    """q [B, H, S, hd] -> [B, H, S, hd] float32: causal against absolute
    positions ``start[b] + i`` over the gathered context view."""
    b, h, s, hd = q.shape
    kvh = k_pool.shape[1]
    k = _gather(k_pool, table, k_scale)
    v = _gather(v_pool, table, v_scale)
    q_pos = start.to(q.device)[:, None] + torch.arange(s, device=q.device)[None]
    mask = q_pos[:, :, None] >= torch.arange(k.shape[2], device=q.device)[None, None]
    qg = q.reshape(b, kvh, h // kvh, s, hd)
    return _masked_attn(qg, k, v, mask, hd ** -0.5, softcap).reshape(b, h, s, hd)


def paged_prefill_tiles(start, q_len: int, g: int, ctx: int, rows: int = 64,
                        keys: int = 64):
    """The causal prefill kernels' tile walk (``csrc/paged_prefill.cu``):
    for each slot and each ``rows``-row tile of its ``R = g * q_len`` query
    rows (row ``r`` at absolute position ``start[b] + r % q_len``), a tuple
    ``(r0, r1, k_hi, masked)``: the tile holds rows ``[r0, r1)``, visits
    keys ``[0, k_hi)`` in ``keys``-key tiles (``k_hi`` = one past its last
    row position, at most ``ctx`` = the table's ``W * BS`` positions), and
    ``masked[t]`` says whether key tile ``t`` takes the causal mask; the
    others are seen whole by every row of the tile.  A tile spanning a
    fold boundary holds every suffix index.  The bf16 kernel walks 64-key
    tiles, the float32 one 32-key tiles."""
    out = []
    for n in (int(x) for x in start):
        tiles = []
        for r0 in range(0, g * q_len, rows):
            r1 = min(r0 + rows, g * q_len)
            i_lo, i_hi = r0 % q_len, (r1 - 1) % q_len
            if r0 // q_len != (r1 - 1) // q_len:
                i_lo, i_hi = 0, q_len - 1
            k_hi = max(0, min(n + i_hi + 1, ctx))
            masked = tuple(not (kb + keys <= k_hi and kb + keys - 1 <= n + i_lo)
                           for kb in range(0, k_hi, keys))
            tiles.append((r0, r1, k_hi, masked))
        out.append(tiles)
    return out


def dense_decode_ref(q, k, v, kv_len, *, softcap=0.0):
    """q [B, H, hd], k/v [B, KVH, S, hd] -> [B, H, hd] float32: keys at
    positions >= kv_len[b] are invisible; kv_len == 0 yields zeros."""
    b, h, hd = q.shape
    kvh = k.shape[1]
    kv_len = kv_len.to(q.device)
    mask = torch.arange(k.shape[2], device=q.device)[None, None] < kv_len[:, None, None]
    qg = q.reshape(b, kvh, h // kvh, 1, hd)
    o = _masked_attn(qg, k, v, mask, hd ** -0.5, softcap).reshape(b, h, hd)
    return torch.where(kv_len[:, None, None] > 0, o, torch.zeros_like(o))


def decode_split_ranges(kv_len, s: int, splits: int, chunk: int = 16):
    """The key ranges ``[lo, hi)`` of each slot's ``splits`` splits, as the
    decode kernel cuts them on the device: the live keys ``[0,
    min(kv_len, s))`` (``s`` a dense cache's length or the table's ``W *
    BS``) in whole ``chunk``-key chunks, ``ceil(chunks / splits)`` chunks a
    split; ``lo >= hi`` marks an empty split.  Returns two int64 tensors
    ``[B, splits]``."""
    n = kv_len.to(torch.int64).clamp(0, s)
    per = -(-(-(-n // chunk)) // splits)  # chunks per split, ceil(ceil(n / chunk) / splits)
    lo = torch.arange(splits, device=n.device)[None] * (per * chunk)[:, None]
    return lo, torch.minimum(n[:, None], lo + (per * chunk)[:, None])


def paged_split_rows(table_row, lo: int, hi: int, bs: int, chunk: int = 16):
    """Where the decode kernel reads the keys ``lo <= kp < hi`` of one
    split from the pool (``csrc/decode.cu``, ``KeyWalk<Paged>``): it reads
    the split's table slice ``table_row[lo // bs : (hi - 1) // bs + 1]``
    once, then the owner of key ``j`` of each ``chunk``-key chunk starts
    at slice entry ``(lo % bs + j) // bs``, row ``(lo % bs + j) % bs`` and
    steps ``chunk`` rows on per chunk by subtraction, dividing by ``bs``
    never again.  Returns (the slice, ``[(pool block, row)]`` for ``kp =
    lo .. hi - 1``)."""
    tbl = [int(x) for x in table_row[lo // bs:(hi - 1) // bs + 1]]
    rows = {}
    for j in range(chunk):
        blk, r = divmod(lo % bs + j, bs)
        for kp in range(lo + j, hi, chunk):
            rows[kp] = (tbl[blk], r)
            r += chunk
            while r >= bs:
                r -= bs
                blk += 1
    return tbl, [rows[kp] for kp in range(lo, hi)]


def decode_merge_ref(o, m, l):
    """Merge per-split partials as the decode kernel does: ``o [...,
    splits, hd]`` unnormalised float32 sums, ``m``/``l [..., splits]``
    running max and denominator, an empty split at ``m <= -1e30 / 2``.
    Returns ``sum e^(m_i - M) o_i / max(sum e^(m_i - M) l_i, 1e-30)`` over
    the non-empty splits, ``M = max m_i`` (zeros when all are empty)."""
    live = m > -1e30 / 2
    w = torch.where(live, torch.exp(m - m.amax(dim=-1, keepdim=True)), torch.zeros_like(m))
    den = torch.clamp((w * l).sum(-1, keepdim=True), min=1e-30)
    return (w[..., None] * o).sum(-2) / den
