"""Slot lifecycle and per-slot tensor helpers (port of ``repro.serve.slots``).

The slot state enum, the dense-layout scatter of a prefill's states
(caches, rings, recurrent states) into the engine's slots, the per-slot
select used by the masked-scan prefill, and the finiteness check the
decode loop reduces over a chunk.  Paged pools have
no batch axis (block tables carry slot identity), so the suffix prefill
writes them directly and the reference's paged scatter has no
counterpart.
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
    (batch k: ``KVCache``s, rings, ``RGLRUState``s) into the engine's
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
