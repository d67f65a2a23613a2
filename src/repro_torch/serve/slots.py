"""Slot lifecycle and per-slot tensor helpers (port of ``repro.serve.slots``).

The slot state enum, the dense-layout scatter of a prefill's states
(caches, rings, recurrent states) into the engine's slots, its paged
counterpart (a stateful stack's dense prefill block-scattered into the
pools through the admitted slots' table rows, recurrent states by slot),
the per-slot select used by the masked-scan prefill, and the finiteness
check the decode loop reduces over a chunk.  A pure global-attention
stack never takes the paged scatter: its suffix prefill writes the pools
directly.  The helpers walk state trees generically: a recurrent state is
any NamedTuple of tensors with the slot on axis 0 (``RGLRUState``,
``MLSTMState``, ``SLSTMState``), scattered, selected and checked by slot
like a dense cache.
"""
from __future__ import annotations

import enum

import torch


class SlotState(enum.Enum):
    """Lifecycle state of an occupied serve-engine slot."""

    PREFILLING = "prefilling"  # prompt chunks still being fed (chunked prefill)
    DECODING = "decoding"      # in the decode loop, generating tokens


def scatter_states(big, small, slot_ids: torch.Tensor):
    """Install a prefill's per-layer states ``small = {"layers": [...]}``
    (batch k: ``KVCache``s, rings, slot-indexed recurrent states) into the engine's
    ``big`` (batch B, same structure) at ``slot_ids [k]``, in place: each
    slot's whole row of every leaf is overwritten, cast to the engine's
    dtype (the cast the decode path applies on every cache write).
    Returns ``big``."""
    for dst, src in zip(big["layers"], small["layers"], strict=True):
        for d, s in zip(dst, src, strict=True):
            if s.shape[1:] != d.shape[1:]:
                raise ValueError(f"prefill state {tuple(s.shape)} does not fit the "
                                 f"engine's {tuple(d.shape)}")
            d[slot_ids] = s.to(d.dtype)
    return big


def _block_scatter(pool: torch.Tensor, dense: torch.Tensor, rows: torch.Tensor) -> None:
    """Write a dense per-request cache ``dense [n, kv, L, hd]`` into the
    pool ``[n_blocks, kv, bs, hd]`` through ``rows [n, nb]`` (logical
    blocks ``0..nb-1``; ``L`` zero-padded to ``nb * bs``), in place.
    Entries past a request's allocation point at scratch block 0, so
    several rows may write it: each duplicate takes the value of the last
    such row, as the reference's scatter leaves it."""
    n, kvh, length, hd = dense.shape
    bs = pool.shape[2]
    nb = rows.shape[1]
    d = torch.nn.functional.pad(dense, (0, 0, 0, nb * bs - length))
    vals = d.reshape(n, kvh, nb, bs, hd).movedim(2, 1).reshape(n * nb, kvh, bs, hd)
    flat = rows.reshape(-1).long()
    idx = torch.arange(flat.numel(), device=flat.device)
    last = torch.full((pool.shape[0],), -1, dtype=torch.long, device=flat.device)
    last.scatter_reduce_(0, flat, idx, reduce="amax")
    pool[flat] = vals.to(pool.dtype)[last[flat]]


def paged_scatter_states(big, small, slot_ids: torch.Tensor, rows: torch.Tensor):
    """Install a stateful stack's dense prefill ``small = {"layers": [...]}``
    (batch n) into the paged engine state ``big``, in place: each
    attn/local layer's dense cache or ring block-scatters into its pool
    through ``rows [n, W]`` (the admitted slots' table rows), its first
    ``nb = min(W, ceil(L / bs))`` blocks, quantized first against an int8
    pool's scales; every other leaf (a recurrent state) scatters at
    ``slot_ids [n]`` as :func:`scatter_states` does.  Returns ``big``."""
    from repro_torch.models.attention import (
        KVCache, PagedKVCache, QuantPagedKVCache, kv_quantize,
    )

    for dst, src in zip(big["layers"], small["layers"], strict=True):
        if isinstance(dst, (PagedKVCache, QuantPagedKVCache)):
            assert isinstance(src, KVCache)
            nb = min(rows.shape[1], -(-src.k.shape[2] // dst.k.shape[2]))
            k, v = src.k, src.v
            if isinstance(dst, QuantPagedKVCache):
                k, v = kv_quantize(k, dst.k_scale), kv_quantize(v, dst.v_scale)
            _block_scatter(dst.k, k, rows[:, :nb])
            _block_scatter(dst.v, v, rows[:, :nb])
        else:
            scatter_states({"layers": [dst]}, {"layers": [src]}, slot_ids)
    return big


def select_states(new, old, active: torch.Tensor):
    """Per-slot select over per-slot leaves (batch axis 0): ``new`` where
    ``active [B]`` else ``old``.  Dicts, lists and NamedTuples recurse; a
    leaf that decode updated in place (``new is old``, a dense cache whose
    write the caller gated) is taken as it is."""
    if isinstance(new, dict):
        return {k: select_states(new[k], old[k], active) for k in new}
    if isinstance(new, (list, tuple)):
        vals = [select_states(n, o, active) for n, o in zip(new, old)]
        return type(new)(*vals) if hasattr(new, "_fields") else type(new)(vals)
    if new is old:
        return new
    shape = (-1,) + (1,) * (new.dim() - 1)
    return torch.where(active.reshape(shape), new, old)


def finite_mask(logits: torch.Tensor) -> torch.Tensor:
    """``[B, ...]`` logits -> ``[B]`` bool: all of the slot's logits finite."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(dim=1)
