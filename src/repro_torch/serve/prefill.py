"""Prefill packing, the dense prefills and the paged suffix prefill
(port of ``repro.serve.prefill``).

Prompts are right-padded to the longest one in the admitted group (pad id
0) and run in one call; per-request true lengths pick each row's last
logits.  Under a plan with dynamic activation scales the padded rows count
toward the scale exactly as in the reference, so the packed grid is kept
as is.  Two dense strategies, chosen per architecture by
:func:`packed_prefill`:

* **full-seq** — one parallel pass over the packed grid.  Exact for pure
  global-attention stacks at any length mix: padded positions write
  garbage KV into the writer's own future positions (or the scratch
  block), and decode overwrites position ``pos`` before its ``kv_len =
  pos + 1`` mask reaches it.  Exact for any stack when every prompt has
  the same length (no padding at all).
* **masked scan** (:func:`prefill_scan`) — the packed prompts fed token by
  token through ``decode_step`` with per-slot updates gated on ``t <
  length``: recurrent states and sliding-window rings would absorb the
  padding under a full-sequence pass (a short prompt's real KV rolled out
  of its ring).  The dense caches are written in place, so the gate goes
  into decode itself (``write``): a gated row attends with its new entry,
  as in the reference, and its old entry is put back afterwards.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.serve.slots import select_states

FULL_SEQ_KINDS = ("attn", "xattn")


def pack_prompts(prompts: Sequence[np.ndarray], cfg: ArchConfig, pad_id: int = 0,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Right-pad ``[S_i]`` prompts -> (tokens ``[B, S_max]``, lengths ``[B]``)."""
    if not prompts:
        raise ValueError("pack_prompts needs at least one prompt")
    lens = [int(np.asarray(p).shape[-1]) for p in prompts]
    if any(l == 0 for l in lens):
        raise ValueError(f"empty prompt at index {lens.index(0)}: prompts "
                         "must contain at least one token")
    s_max = max(lens)
    rows = np.full((len(prompts), s_max), pad_id, np.int32)
    for i, p in enumerate(prompts):
        rows[i, : lens[i]] = np.asarray(p, np.int32)
    return (torch.as_tensor(rows, device=device),
            torch.as_tensor(np.asarray(lens, np.int32), device=device))


def _last_logits(logits: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """logits [B, S, V] -> each row's logits at ``lengths - 1``: [B, 1, V]."""
    idx = (lengths.to(logits.device).long() - 1)[:, None, None]
    return torch.gather(logits, 1, idx.expand(-1, 1, logits.shape[-1]))


def full_seq_packable(cfg: ArchConfig, lengths: Sequence[int]) -> bool:
    """Whether the padded full-sequence prefill is exact for this workload."""
    if len(set(int(l) for l in lengths)) <= 1:
        return True  # no padding, any architecture
    return all(k in FULL_SEQ_KINDS for k in cfg.layer_kinds)


def prefill_full_seq(model, params, tokens: torch.Tensor, lengths: torch.Tensor,
                     max_len: int):
    """One parallel prefill over the packed grid.  Returns (last_logits
    [B, 1, V], per-layer serving states: dense caches padded to
    ``max_len``, rings, recurrent states)."""
    logits, states = model.prefill(params, {"tokens": tokens}, max_len=max_len)
    return _last_logits(logits, lengths), {"layers": states}


def prefill_scan(model, params, tokens: torch.Tensor, lengths: torch.Tensor, max_len: int):
    """Token-by-token prefill from zeroed states with per-slot masked
    updates: step ``t`` feeds every row its token ``t`` at position ``t``;
    rows with ``t >= length`` keep their states (decode puts their cache
    entries back, their recurrent states are selected back) and their last
    logits.  Returns (last_logits [B, 1, V], states of batch B)."""
    b, s = tokens.shape
    states = model.init_decode_state(b, max_len)
    lengths = lengths.to(tokens.device)
    last = torch.zeros((b, 1, model.cfg.vocab), dtype=torch.float32, device=tokens.device)
    for t in range(s):
        active = t < lengths
        logits, new = model.decode(params, tokens[:, t:t + 1], states,
                                   torch.full((b,), t, dtype=torch.int64, device=tokens.device),
                                   write=active)
        states = select_states(new, states, active)
        last = torch.where((t == lengths - 1)[:, None, None], logits, last)
    return last, states


def packed_prefill(model, params, tokens: torch.Tensor, lengths: torch.Tensor, max_len: int,
                   force_scan: bool = False):
    """The exact dense prefill for this architecture and length mix: the
    full-sequence pass where :func:`full_seq_packable` allows it, else the
    masked scan.  ``force_scan`` takes the scan even then: the engine sets
    it when a sliding-window ring is larger than ``max_len`` (the
    full-sequence pass emits ``window``-sized rings, the scan the clamped
    rings of ``init_decode_state``).  Returns (last_logits, states)."""
    if not force_scan and full_seq_packable(model.cfg, lengths.tolist()):
        return prefill_full_seq(model, params, tokens, lengths, max_len)
    return prefill_scan(model, params, tokens, lengths, max_len)


def prefill_paged_suffix(model, params, tokens: torch.Tensor, lengths: torch.Tensor,
                         states, rows: torch.Tensor, starts: torch.Tensor,
                         ctx_blocks: int):
    """Prefix-aware admission prefill against the paged pool: ``tokens
    [n, S_suf]`` are the admitted requests' unprefilled suffixes, ``rows
    [n, W]`` their block-table rows, ``starts [n]`` the prefix lengths
    already resident.  Returns (last_logits [n, 1, V], states)."""
    logits, states = model.prefill_suffix(params, tokens, states, rows, starts, ctx_blocks)
    return _last_logits(logits, lengths), states
