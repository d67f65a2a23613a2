"""Causal GQA attention over dense or paged KV: global (``attn``) and
sliding-window (``local``) kinds.

Port of ``repro.models.attention`` for this slice:

* ``attn_seq``           — full-sequence pass (``_sdpa``, or the flash
  kernel when qk/pv are exact), optionally emitting a dense per-slot
  cache: padded to the serving length (global) or the ``window``-sized
  ring (local);
* ``attn_decode``        — one token per slot against dense per-slot
  caches (``KVCache``) or the paged pool (global layers only);
* ``attn_prefill_paged`` — packed multi-token suffixes against the pool,
  starts anywhere inside a block (the prefix-cache admission path).

A dense cache is ``KVCache(k, v)`` with ``[B, n_kv, S_cache, hd]``
tensors, one row of ``S_cache`` positions per slot; decode writes the new
token **in place** at each row's ``pos``, which must be < ``S_cache``
where the write is kept (``transformer.decode_step`` asserts it).  A row
whose write is gated off may sit past the cache; its write lands at
``S_cache - 1``, where the reference's ``dynamic_update_slice`` clamps it,
and is put back afterwards.  A
local layer's cache is a ring of ``S_cache = min(max_len, window)``
positions: absolute position ``t`` lives at ``t % S_cache`` and every
resident entry is inside the window, so decode attends to the first
``min(pos + 1, S_cache)`` entries.  ``write`` (a per-slot mask) keeps
the in-place write only for its rows: the masked-scan prefill's padded
steps must leave a ring as it was.

The paged pool is ``PagedKVCache(k, v)`` with ``[n_blocks, n_kv, bs, hd]``
tensors shared by every slot through per-slot block tables, or
``QuantPagedKVCache`` with int8 blocks and calibrated per-KV-head scales
(writes quantize, the gathered view dequantizes, the kernel dequantizes
each streamed block).  Block 0 is the scratch sink for padded and
overrun writes.  The port writes the pool
**in place** (``index_put_``): a functional copy of a full-width pool per
layer per step would cost more than the step itself.  Where several rows
write one position — only ever the scratch block — every duplicate
writes the value of the last such row, which is what the reference's
scatter keeps, so even scratch contents match it.

``use_kernel`` routes decode and suffix prefill through
``kernels.paged_attention`` (the hand-written CUDA kernels on the card —
paged, or dense for ``KVCache`` — their plain versions on the CPU), and
``use_flash`` the full-sequence pass through ``kernels.flash_attention``;
otherwise ``_sdpa`` runs (over the gathered ``_paged_view`` for a pool),
which also serves as the in-port oracle.  Both kernels take exact qk/pv
only: a quantized qk or pv site, or a calibration pass (which observes
them), takes ``_sdpa``, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.astra_layer import (
    BoundSite, ComputeConfig, EXACT, astra_batched_matmul, runs_exact,
)
from repro_torch.core.plan import SiteBinding, as_binding, observe_kv
from repro_torch.core.quant import MAG_MAX
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


class QuantPagedKVCache(NamedTuple):
    """Int8 block pool plus static per-KV-head scales (the plan's
    calibrated ``L{li}.kv.{k,v}`` sites): every stored block is a pure
    function of the token path, so prefix reuse stays legal."""

    k: torch.Tensor  # [n_blocks, n_kv, block_size, hd] int8
    v: torch.Tensor
    k_scale: torch.Tensor  # [n_kv] float32
    v_scale: torch.Tensor


AnyPagedKVCache = Union[PagedKVCache, QuantPagedKVCache]


def kv_quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 codes of a KV tensor with KV heads on axis -3
    (``[..., n_kv, S, hd]``) against per-head ``scale [n_kv]``."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)[..., None, None]
    q = torch.round(x.to(torch.float32) / s)
    return torch.clamp(q, -MAG_MAX, MAG_MAX).to(torch.int8)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`kv_quantize` (up to the <= scale/2 rounding)."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=q.device)[..., None, None]
    return q.to(torch.float32) * s


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
    """Full-sequence causal attention (within ``cfg.window`` for a
    ``local`` layer): the flash kernel when ``use_flash`` and qk/pv are
    exact, else ``_sdpa``.  ``return_cache`` gives the dense per-slot
    ``KVCache`` (see :func:`_make_cache`)."""
    _check_kind(kind)
    window = cfg.window if kind == "local" else 0
    b, s, _ = x.shape
    sites = as_binding(sites)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q = _split_heads(dense(p["wq"], x, sites("q_proj")), cfg.n_heads, cfg.head_dim)
    k = _split_heads(dense(p["wk"], x, sites("kv_proj")), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(dense(p["wv"], x, sites("kv_proj")), cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_pct, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_pct, cfg.rope_theta)
    observe_kv(sites, k, v)  # calibration tap: what the pool would store
    qk_b, pv_b = sites("qk"), sites("pv")
    if use_flash and _dyn_exact(qk_b) and _dyn_exact(pv_b):
        from repro_torch.kernels.flash_attention import flash_attention

        o = flash_attention(q, k, v, causal=True, window=window, softcap=cfg.logit_softcap)
    else:
        o = _sdpa(q, k, v, causal=True, window=window, softcap=cfg.logit_softcap,
                  qk=qk_b, pv=pv_b)
    out = dense(p["wo"], _merge_heads(o), sites("o_proj"))
    return out, (_make_cache(k, v, s, max_len, window) if return_cache else None)


def _check_kind(kind: str) -> None:
    if kind not in ("attn", "local"):
        raise NotImplementedError(f"{kind!r} blocks are not ported yet "
                                  "(ROADMAP queue 1: other block kinds)")


def _make_cache(k: torch.Tensor, v: torch.Tensor, s: int, max_len: Optional[int],
                window: int = 0) -> KVCache:
    """The serving cache of the ``s`` positions' K/V.  Global (``window
    == 0``): zero-padded to ``max(max_len, s + 1)`` (decode writes at
    ``pos``).  Local: the ring of ``window`` positions where absolute
    position ``t`` lives at ``t % window`` — the last ``window`` positions
    rolled by ``s % window`` when ``s >= window``, else zero-padded."""
    if window:
        if s >= window:
            shift = s % window
            return KVCache(torch.roll(k[:, :, -window:], shift, dims=2),
                           torch.roll(v[:, :, -window:], shift, dims=2))
        pad = window - s
    else:
        pad = max(max_len or 0, s + 1) - s
    return KVCache(torch.nn.functional.pad(k, (0, 0, 0, pad)),
                   torch.nn.functional.pad(v, (0, 0, 0, pad)))


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None,
               kind: str = "attn") -> KVCache:
    """Zeroed dense decode cache, ``[batch, n_kv, max_len, hd]`` in the
    model dtype (what a full-sequence prefill emits, so the two agree bit
    for bit); a ``local`` layer's ring holds ``min(max_len, window)``
    positions."""
    if kind == "local" and cfg.window:
        max_len = min(max_len, cfg.window)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    dt = torch_dtype(cfg.dtype)
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


def init_paged_cache(cfg: ArchConfig, n_blocks: int, block_size: int,
                     device=None) -> PagedKVCache:
    """Zeroed block pool for one attention layer, in the model dtype."""
    shape = (n_blocks, cfg.n_kv_heads, block_size, cfg.head_dim)
    dt = torch_dtype(cfg.dtype)
    return PagedKVCache(torch.zeros(shape, dtype=dt, device=device),
                        torch.zeros(shape, dtype=dt, device=device))


def init_paged_quant_cache(cfg: ArchConfig, n_blocks: int, block_size: int,
                           k_scale, v_scale, device=None) -> QuantPagedKVCache:
    """Zeroed int8 block pool with calibrated per-KV-head scales."""
    shape = (n_blocks, cfg.n_kv_heads, block_size, cfg.head_dim)
    return QuantPagedKVCache(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.as_tensor(k_scale, dtype=torch.float32, device=device),
        torch.as_tensor(v_scale, dtype=torch.float32, device=device))


def _paged_view(cache: AnyPagedKVCache, table: torch.Tensor):
    """Gather each slot's logical KV: table [B, W] -> k/v [B, n_kv, W*bs, hd];
    an int8 pool is dequantized after the gather."""
    def gather(pool):
        nb, kvh, bs, hd = pool.shape
        g = pool[table.long()]  # [B, W, kv, bs, hd]
        return g.movedim(1, 2).reshape(table.shape[0], kvh, -1, hd)

    k, v = gather(cache.k), gather(cache.v)
    if isinstance(cache, QuantPagedKVCache):
        k, v = kv_dequantize(k, cache.k_scale), kv_dequantize(v, cache.v_scale)
    return k, v


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


def _paged_write_token(cache: AnyPagedKVCache, table: torch.Tensor, slot: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor) -> AnyPagedKVCache:
    """Write one token per batch row at logical position ``slot [B]``;
    k_new/v_new [B, n_kv, 1, hd], quantized first for an int8 pool.  In
    place; returns the same cache."""
    if isinstance(cache, QuantPagedKVCache):
        k_new, v_new = kv_quantize(k_new, cache.k_scale), kv_quantize(v_new, cache.v_scale)
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
                tables: Optional[BlockTables] = None, use_kernel: bool = False,
                write: Optional[torch.Tensor] = None):
    """One token per slot (``x [B, 1, D]``, ``pos [B]`` absolute positions)
    against dense per-slot caches (``KVCache``; global: ``pos < S_cache``
    for a kept write, a gated row's write clamped to ``S_cache - 1`` as the
    reference's is; local: the ring at ``pos % S_cache``) or the paged pool
    (``tables`` required; global layers only).  ``write [B]`` bool, on dense caches:
    only those rows keep their token's entry; the others attend with it
    and then get their old entry back (None = all keep it).  Returns
    (out [B, 1, D], cache)."""
    _check_kind(kind)
    dense_cache = isinstance(cache, KVCache)
    assert dense_cache or tables is not None, "paged decode needs a BlockTables"
    if kind == "local" and not dense_cache:
        raise NotImplementedError("local layers on the paged pool are not ported yet "
                                  "(ROADMAP queue 1: paged stateful stacks)")
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
    kernel = use_kernel and _dyn_exact(qk_b) and _dyn_exact(pv_b)
    if dense_cache:
        s_cache = cache.k.shape[2]
        if kind == "local":  # the ring wraps; every resident entry is in the window
            slot, kv_len = pos % s_cache, torch.clamp(kv_len, max=s_cache)
        else:
            # a gated row can sit past the cache (a chunked-prefill window
            # narrower than its bucket, a row riding along): the reference's
            # dynamic_update_slice clamps its write to S_cache - 1, and its
            # kv_len = pos + 1 masks nothing past the cache, which
            # kv_len = S_cache says without reading past it
            slot, kv_len = torch.clamp(pos, max=s_cache - 1), torch.clamp(kv_len, max=s_cache)
        rows = torch.arange(b, device=x.device)
        # rows that must not keep their write still attend with it, as in
        # the reference (whose caller selects the old state afterwards):
        # under dynamic activation scales their outputs feed every row's
        # scale.  Their old entries are restored after the attention.
        old = None if write is None else [c[rows, :, slot] for c in cache]  # copies
        cache.k[rows, :, slot] = k_new[:, :, 0].to(cache.k.dtype)  # in place
        cache.v[rows, :, slot] = v_new[:, :, 0].to(cache.v.dtype)
        if kernel:
            from repro_torch.kernels.paged_attention import dense_attention_decode

            o = dense_attention_decode(q[:, :, 0], cache.k, cache.v, kv_len,
                                       softcap=cfg.logit_softcap)[:, :, None]
        else:
            o = _sdpa(q, cache.k, cache.v, causal=False, window=0, kv_len=kv_len,
                      softcap=cfg.logit_softcap, qk=qk_b, pv=pv_b)
        if old is not None:
            keep = write.to(x.device)[:, None, None]
            for c, o_c in zip(cache, old):
                c[rows, :, slot] = torch.where(keep, c[rows, :, slot], o_c)
    else:
        cache = _paged_write_token(cache, tables.table, pos, k_new, v_new)
        if kernel:
            from repro_torch.kernels.paged_attention import paged_attention_decode

            o = paged_attention_decode(q[:, :, 0], cache.k, cache.v, tables.table, kv_len,
                                       *_scales(cache), softcap=cfg.logit_softcap)[:, :, None]
        else:
            k_log, v_log = _paged_view(cache, tables.table)
            o = _sdpa(q, k_log, v_log, causal=False, window=0, kv_len=kv_len,
                      softcap=cfg.logit_softcap, qk=qk_b, pv=pv_b)
    return dense(p["wo"], _merge_heads(o), sites("o_proj")), cache


def _scales(cache: AnyPagedKVCache):
    """(k_scale, v_scale) of an int8 pool, (None, None) of a float one."""
    if isinstance(cache, QuantPagedKVCache):
        return cache.k_scale, cache.v_scale
    return None, None


def attn_prefill_paged(p, x: torch.Tensor, cache: AnyPagedKVCache, table: torch.Tensor,
                       start: torch.Tensor, cfg: ArchConfig, *,
                       sites: Union[ComputeConfig, SiteBinding] = EXACT,
                       ctx_blocks: int, use_kernel: bool = False):
    """Suffix prefill with past: causal attention of the packed suffixes
    (``x [B, S_suf, D]`` starting at ``start [B]``) against prefix KV
    already resident in the pool.  ``ctx_blocks`` bounds the context view
    and must cover the longest ``start + S_suf``.  On an int8 pool the
    suffix is quantized, written, and read back quantized by its own
    attention."""
    b, s, _ = x.shape
    sites = as_binding(sites)
    start = start.to(x.device)
    positions = start[:, None].long() + torch.arange(s, device=x.device)[None]
    q = _split_heads(dense(p["wq"], x, sites("q_proj")), cfg.n_heads, cfg.head_dim)
    k = _split_heads(dense(p["wk"], x, sites("kv_proj")), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(dense(p["wv"], x, sites("kv_proj")), cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_pct, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_pct, cfg.rope_theta)
    if isinstance(cache, QuantPagedKVCache):
        k, v = kv_quantize(k, cache.k_scale), kv_quantize(v, cache.v_scale)
    _paged_write_span(cache.k, table, start, k)
    _paged_write_span(cache.v, table, start, v)
    ctx_tbl = table[:, :ctx_blocks]
    qk_b, pv_b = sites("qk"), sites("pv")
    if use_kernel and _dyn_exact(qk_b) and _dyn_exact(pv_b):
        from repro_torch.kernels.paged_attention import paged_attention_prefill

        o = paged_attention_prefill(q, cache.k, cache.v, ctx_tbl, start, *_scales(cache),
                                    softcap=cfg.logit_softcap)
    else:
        k_log, v_log = _paged_view(cache, ctx_tbl)
        o = _sdpa(q, k_log, v_log, causal=True, window=0, q_offset=start,
                  softcap=cfg.logit_softcap, qk=qk_b, pv=pv_b)
    return dense(p["wo"], _merge_heads(o), sites("o_proj")), cache
