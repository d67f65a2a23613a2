"""Global causal GQA attention over the paged KV pool (``attn`` kind).

Port of ``repro.models.attention`` for this slice:

* ``attn_seq``           — full-sequence pass (``_sdpa``), optionally
  emitting a dense per-slot cache;
* ``attn_decode``        — one token per slot against the paged pool;
* ``attn_prefill_paged`` — packed multi-token suffixes against the pool,
  starts anywhere inside a block (the prefix-cache admission path).

The paged pool is ``PagedKVCache(k, v)`` with ``[n_blocks, n_kv, bs, hd]``
tensors shared by every slot through per-slot block tables.  Block 0 is
the scratch sink for padded and overrun writes.  The port writes the pool
**in place** (``index_put_``): a functional copy of a full-width pool per
layer per step would cost more than the step itself.  Where several rows
write one position — only ever the scratch block — every duplicate
writes the value of the last such row, which is what the reference's
scatter keeps, so even scratch contents match it.

``use_kernel`` routes decode and suffix prefill through
``kernels.paged_attention`` (the hand-written CUDA kernel on the card, its
plain version on the CPU); otherwise the gathered ``_paged_view`` plus
``_sdpa`` runs, which also serves as the in-port oracle.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.astra_layer import (
    BoundSite, ComputeConfig, EXACT, astra_batched_matmul, runs_exact,
)
from repro_torch.core.plan import SiteBinding, as_binding
from repro_torch.device import torch_dtype
from repro_torch.models.layers import apply_rope, dense, dense_init

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, n_kv, S_cache, hd]
    v: torch.Tensor


class PagedKVCache(NamedTuple):
    """Pooled KV storage: physical blocks shared by every slot."""

    k: torch.Tensor  # [n_blocks, n_kv, block_size, hd]
    v: torch.Tensor


class BlockTables(NamedTuple):
    """Per-slot logical->physical block mapping shared across layers;
    unallocated entries point at scratch block 0."""

    table: torch.Tensor  # [B, W] int32


def attn_init(gen: torch.Generator, cfg: ArchConfig, device=None):
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, bias=cfg.qkv_bias, device=device),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, bias=cfg.qkv_bias, device=device),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, bias=cfg.qkv_bias, device=device),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, device=device),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)  # [B, n, S, hd]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, n, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, n * hd)


def _dyn_exact(bound: Optional[BoundSite]) -> bool:
    return bound is None or runs_exact(bound)


def _qk_scores(qg, k, bound):
    """[B,KV,G,Sq,hd] x [B,KV,Sk,hd] -> float32 [B,KV,G,Sq,Sk]; operands in
    their storage dtype, products accumulated in float32."""
    if _dyn_exact(bound):
        kt = k.to(qg.dtype).to(torch.float32)[:, :, None].transpose(-1, -2)
        return torch.matmul(qg.to(torch.float32), kt)
    b, kvh, g, sq, hd = qg.shape
    out = astra_batched_matmul(qg.reshape(b, kvh, g * sq, hd), k.transpose(-1, -2), bound)
    return out.reshape(b, kvh, g, sq, -1).to(torch.float32)


def _pv_out(p, v, bound):
    """[B,KV,G,Sq,Sk] x [B,KV,Sk,hd] -> float32 [B,KV,G,Sq,hd]."""
    if _dyn_exact(bound):
        return torch.matmul(p.to(v.dtype).to(torch.float32), v.to(torch.float32)[:, :, None])
    b, kvh, g, sq, sk = p.shape
    out = astra_batched_matmul(p.reshape(b, kvh, g * sq, sk).to(v.dtype), v, bound)
    return out.reshape(b, kvh, g, sq, -1).to(torch.float32)


def _sdpa(q, k, v, *, causal: bool, window: int, q_offset=0,
          kv_len: Optional[torch.Tensor] = None, softcap: float = 0.0,
          qk: Optional[BoundSite] = None, pv: Optional[BoundSite] = None) -> torch.Tensor:
    """Plain attention.  q [B,H,Sq,hd], k/v [B,KV,Sk,hd]; GQA via head
    groups; masked scores are -1e30.  ``kv_len`` and ``q_offset`` may be
    per-slot ``[B]`` tensors (continuous batching, paged suffix prefill)."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    qg = q.reshape(b, kvh, g, sq, hd)
    s = _qk_scores(qg, k, qk) * (hd ** -0.5)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    k_pos = torch.arange(sk, device=dev)
    if torch.is_tensor(q_offset) and q_offset.dim() == 1:
        q_pos = torch.arange(sq, device=dev)[None, :, None] + q_offset.to(dev)[:, None, None]
        m = q_pos >= k_pos[None, None] if causal else torch.ones(1, sq, sk, dtype=torch.bool, device=dev)
    else:
        q_pos = (torch.arange(sq, device=dev) + int(q_offset))[:, None]
        m = torch.ones(sq, sk, dtype=torch.bool, device=dev)
        if causal:
            m = m & (q_pos >= k_pos[None])
        m = m[None]  # [1, sq, sk]
    if window > 0:
        m = m & ((q_pos - k_pos) < window)
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, device=dev)
        m = m & (k_pos < (kl[:, None, None] if kl.dim() == 1 else kl))
    s = torch.where(m[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = _pv_out(p, v, pv)
    return o.reshape(b, h, sq, hd).to(q.dtype)


def attn_seq(p, x: torch.Tensor, cfg: ArchConfig, *, kind: str = "attn",
             sites: Union[ComputeConfig, SiteBinding] = EXACT, use_flash: bool = False,
             positions: Optional[torch.Tensor] = None, return_cache: bool = False,
             max_len: Optional[int] = None) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full-sequence causal attention through ``_sdpa``."""
    if kind != "attn":
        raise NotImplementedError(f"{kind!r} blocks are not ported yet "
                                  "(ROADMAP queue 1: other block kinds)")
    if use_flash and x.device.type == "cuda":
        raise NotImplementedError("the flash_attention kernel is not ported yet "
                                  "(ROADMAP queue 1: dense layout)")
    b, s, _ = x.shape
    sites = as_binding(sites)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q = _split_heads(dense(p["wq"], x, sites("q_proj")), cfg.n_heads, cfg.head_dim)
    k = _split_heads(dense(p["wk"], x, sites("kv_proj")), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(dense(p["wv"], x, sites("kv_proj")), cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_pct, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_pct, cfg.rope_theta)
    o = _sdpa(q, k, v, causal=True, window=0, softcap=cfg.logit_softcap,
              qk=sites("qk"), pv=sites("pv"))
    out = dense(p["wo"], _merge_heads(o), sites("o_proj"))
    cache = None
    if return_cache:
        pad = max(max_len or 0, s + 1) - s
        cache = KVCache(torch.nn.functional.pad(k, (0, 0, 0, pad)),
                        torch.nn.functional.pad(v, (0, 0, 0, pad)))
    return out, cache


def init_paged_cache(cfg: ArchConfig, n_blocks: int, block_size: int,
                     device=None) -> PagedKVCache:
    """Zeroed block pool for one attention layer, in the model dtype."""
    shape = (n_blocks, cfg.n_kv_heads, block_size, cfg.head_dim)
    dt = torch_dtype(cfg.dtype)
    return PagedKVCache(torch.zeros(shape, dtype=dt, device=device),
                        torch.zeros(shape, dtype=dt, device=device))


def _paged_view(cache: PagedKVCache, table: torch.Tensor):
    """Gather each slot's logical KV: table [B, W] -> k/v [B, n_kv, W*bs, hd]."""
    def gather(pool):
        nb, kvh, bs, hd = pool.shape
        g = pool[table.long()]  # [B, W, kv, bs, hd]
        return g.movedim(1, 2).reshape(table.shape[0], kvh, -1, hd)

    return gather(cache.k), gather(cache.v)


def _last_writer(pb: torch.Tensor, off: torch.Tensor, bs: int, n_blocks: int) -> torch.Tensor:
    """For each write (flattened), the index of the LAST write that targets
    the same (block, offset) — computed on the device, no host sync."""
    key = pb.long() * bs + off.long()
    idx = torch.arange(key.numel(), device=key.device)
    last = torch.full((n_blocks * bs,), -1, dtype=torch.long, device=key.device)
    last.scatter_reduce_(0, key, idx, reduce="amax")
    return last[key]


def _pool_write(pool: torch.Tensor, pb: torch.Tensor, off: torch.Tensor,
                vals: torch.Tensor) -> None:
    """pool[pb[i], :, off[i]] = vals[i] in place, last write winning."""
    nb, _, bs, _ = pool.shape
    src = vals.to(pool.dtype)[_last_writer(pb, off, bs, nb)]
    pool[pb.long(), :, off.long()] = src


def _paged_write_token(cache: PagedKVCache, table: torch.Tensor, slot: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor) -> PagedKVCache:
    """Write one token per batch row at logical position ``slot [B]``;
    k_new/v_new [B, n_kv, 1, hd].  In place; returns the same cache."""
    bs = cache.k.shape[2]
    b = slot.shape[0]
    pb = table[torch.arange(b, device=slot.device), (slot // bs).long()]
    off = slot % bs
    _pool_write(cache.k, pb, off, k_new[:, :, 0])
    _pool_write(cache.v, pb, off, v_new[:, :, 0])
    return cache


def _paged_write_span(pool: torch.Tensor, table: torch.Tensor, start: torch.Tensor,
                      new: torch.Tensor) -> torch.Tensor:
    """Write ``new [B, kv, S, hd]`` at logical positions ``start[b] + t``
    (any in-block offset); positions past the table width go to scratch
    block 0.  In place; returns ``pool``."""
    b, kvh, s, hd = new.shape
    bs = pool.shape[2]
    w = table.shape[1]
    pos = start.to(table.device)[:, None].long() + torch.arange(s, device=table.device)[None]
    blk = pos // bs
    pb = torch.gather(table.long(), 1, torch.clamp(blk, max=w - 1))
    pb = torch.where(blk < w, pb, torch.zeros_like(pb))  # overrun -> scratch
    vals = new.movedim(1, 2).reshape(b * s, kvh, hd)
    _pool_write(pool, pb.reshape(-1), (pos % bs).reshape(-1), vals)
    return pool


def attn_decode(p, x: torch.Tensor, cache, pos: torch.Tensor, cfg: ArchConfig, *,
                kind: str = "attn", sites: Union[ComputeConfig, SiteBinding] = EXACT,
                tables: Optional[BlockTables] = None, use_kernel: bool = False):
    """One token per slot (``x [B, 1, D]``, ``pos [B]`` absolute positions)
    against the paged pool.  Returns (out [B, 1, D], cache)."""
    if kind != "attn":
        raise NotImplementedError(f"{kind!r} blocks are not ported yet "
                                  "(ROADMAP queue 1: other block kinds)")
    if not isinstance(cache, PagedKVCache):
        raise NotImplementedError("decode over dense per-slot caches arrives with the "
                                  "dense layout (ROADMAP queue 1)")
    assert tables is not None, "paged decode needs a BlockTables"
    b = x.shape[0]
    sites = as_binding(sites)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    if pos.dim() == 0:
        pos = pos.expand(b)
    posb = pos[:, None]
    q = _split_heads(dense(p["wq"], x, sites("q_proj")), cfg.n_heads, cfg.head_dim)
    k_new = _split_heads(dense(p["wk"], x, sites("kv_proj")), cfg.n_kv_heads, cfg.head_dim)
    v_new = _split_heads(dense(p["wv"], x, sites("kv_proj")), cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, posb, cfg.rope_pct, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_pct, cfg.rope_theta)
    qk_b, pv_b = sites("qk"), sites("pv")
    kv_len = pos + 1
    cache = _paged_write_token(cache, tables.table, pos, k_new, v_new)
    if use_kernel and _dyn_exact(qk_b) and _dyn_exact(pv_b):
        from repro_torch.kernels.paged_attention import paged_attention_decode

        o = paged_attention_decode(q[:, :, 0], cache.k, cache.v, tables.table, kv_len,
                                   softcap=cfg.logit_softcap)[:, :, None]
    else:
        k_log, v_log = _paged_view(cache, tables.table)
        o = _sdpa(q, k_log, v_log, causal=False, window=0, kv_len=kv_len,
                  softcap=cfg.logit_softcap, qk=qk_b, pv=pv_b)
    return dense(p["wo"], _merge_heads(o), sites("o_proj")), cache


def attn_prefill_paged(p, x: torch.Tensor, cache: PagedKVCache, table: torch.Tensor,
                       start: torch.Tensor, cfg: ArchConfig, *,
                       sites: Union[ComputeConfig, SiteBinding] = EXACT,
                       ctx_blocks: int, use_kernel: bool = False):
    """Suffix prefill with past: causal attention of the packed suffixes
    (``x [B, S_suf, D]`` starting at ``start [B]``) against prefix KV
    already resident in the pool.  ``ctx_blocks`` bounds the context view
    and must cover the longest ``start + S_suf``."""
    b, s, _ = x.shape
    sites = as_binding(sites)
    start = start.to(x.device)
    positions = start[:, None].long() + torch.arange(s, device=x.device)[None]
    q = _split_heads(dense(p["wq"], x, sites("q_proj")), cfg.n_heads, cfg.head_dim)
    k = _split_heads(dense(p["wk"], x, sites("kv_proj")), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(dense(p["wv"], x, sites("kv_proj")), cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_pct, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_pct, cfg.rope_theta)
    _paged_write_span(cache.k, table, start, k)
    _paged_write_span(cache.v, table, start, v)
    ctx_tbl = table[:, :ctx_blocks]
    qk_b, pv_b = sites("qk"), sites("pv")
    if use_kernel and _dyn_exact(qk_b) and _dyn_exact(pv_b):
        from repro_torch.kernels.paged_attention import paged_attention_prefill

        o = paged_attention_prefill(q, cache.k, cache.v, ctx_tbl, start,
                                    softcap=cfg.logit_softcap)
    else:
        k_log, v_log = _paged_view(cache, ctx_tbl)
        o = _sdpa(q, k_log, v_log, causal=True, window=0, q_offset=start,
                  softcap=cfg.logit_softcap, qk=qk_b, pv=pv_b)
    return dense(p["wo"], _merge_heads(o), sites("o_proj")), cache
