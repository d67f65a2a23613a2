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

The chunked-prefill scheduler adds :func:`prefill_window`, the masked
scan windowed over the engine's own state with a start per slot; the
paged layout chunks through :func:`prefill_paged_suffix`, whose starts may
sit anywhere inside a block.
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
    updates: :func:`prefill_window` from position 0 over fresh states of
    batch B.  Returns (last_logits [B, 1, V], states)."""
    b = tokens.shape[0]
    starts = torch.zeros(b, dtype=torch.int64, device=tokens.device)
    return prefill_window(model, params, tokens, starts, lengths,
                          model.init_decode_state(b, max_len))


def prefill_window(model, params, tokens: torch.Tensor, starts: torch.Tensor,
                   lengths: torch.Tensor, states):
    """One chunked-prefill window over the engine's whole dense state (the
    windowed :func:`prefill_scan`): step ``t`` feeds row ``b`` its token
    ``tokens[b, t]`` at position ``starts[b] + t``, its cache write kept
    and its recurrent states taken only while ``t < lengths[b]``.  Every
    row runs, decoding and free ones included (``lengths[b] == 0``): under
    dynamic int8 scales the activation absmax spans all of them, as in the
    reference.  A gated row past the dense cache writes at its last
    position and gets it back (``attention.attn_decode``).  ``tokens [B,
    L]`` is right-padded per row.  Returns (logits at each row's ``t ==
    lengths[b] - 1`` ``[B, 1, V]``, meaningful only where a chunk ends
    there; the states, updated in place where they can be)."""
    b, s = tokens.shape
    dev = tokens.device
    starts = starts.to(dev).long()
    lengths = lengths.to(dev)
    last = torch.zeros((b, 1, model.cfg.vocab), dtype=torch.float32, device=dev)
    for t in range(s):
        active = t < lengths
        logits, new = model.decode(params, tokens[:, t:t + 1], states, starts + t,
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
