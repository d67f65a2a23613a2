"""Slot lifecycle and per-slot tensor helpers (port of ``repro.serve.slots``).

Paged pools have no batch axis (block tables carry slot identity), so the
reference's paged/dense scatters have no counterpart in this slice; what
remains is the slot state enum, the per-slot select used by gated decode,
and the finiteness check the decode loop reduces over a chunk.
"""
from __future__ import annotations

import enum

import torch


class SlotState(enum.Enum):
    """Lifecycle state of an occupied serve-engine slot."""

    PREFILLING = "prefilling"  # prompt chunks still being fed (chunked prefill)
    DECODING = "decoding"      # in the decode loop, generating tokens


def select_states(new, old, active: torch.Tensor):
    """Per-slot select over per-slot leaves (batch axis 0): ``new`` where
    ``active [B]`` else ``old``.  Dicts, lists and NamedTuples recurse."""
    if isinstance(new, dict):
        return {k: select_states(new[k], old[k], active) for k in new}
    if isinstance(new, (list, tuple)):
        vals = [select_states(n, o, active) for n, o in zip(new, old)]
        return type(new)(*vals) if hasattr(new, "_fields") else type(new)(vals)
    shape = (-1,) + (1,) * (new.dim() - 1)
    return torch.where(active.reshape(shape), new, old)


def finite_mask(logits: torch.Tensor) -> torch.Tensor:
    """``[B, ...]`` logits -> ``[B]`` bool: all of the slot's logits finite."""
    return torch.isfinite(logits).reshape(logits.shape[0], -1).all(dim=1)
