"""Prefill packing, the dense full-sequence prefill and the paged suffix
prefill (port of ``repro.serve.prefill``).

Prompts are right-padded to the longest one in the admitted group (pad id
0) and run in one pass; per-request true lengths pick each row's last
logits.  Padded positions write garbage KV into the writer's own future
positions or the scratch block, never where a mask exposes it: decode
overwrites position ``pos`` before its ``kv_len = pos + 1`` mask reaches
it.  Under a plan with dynamic activation scales the padded rows count
toward the scale exactly as in the reference, so the packed grid is kept
as is.  The padded full-sequence pass is exact for the pure
global-attention stacks the port serves, at any length mix; the
reference's choice between it and its masked-scan prefill
(``packed_prefill``, for recurrent and windowed stacks) comes with those
block kinds.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


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


def prefill_full_seq(model, params, tokens: torch.Tensor, lengths: torch.Tensor,
                     max_len: int):
    """One parallel prefill over the packed grid.  Returns (last_logits
    [B, 1, V], per-layer dense caches padded to ``max_len``)."""
    logits, states = model.prefill(params, {"tokens": tokens}, max_len=max_len)
    return _last_logits(logits, lengths), states


def prefill_paged_suffix(model, params, tokens: torch.Tensor, lengths: torch.Tensor,
                         states, rows: torch.Tensor, starts: torch.Tensor,
                         ctx_blocks: int):
    """Prefix-aware admission prefill against the paged pool: ``tokens
    [n, S_suf]`` are the admitted requests' unprefilled suffixes, ``rows
    [n, W]`` their block-table rows, ``starts [n]`` the prefix lengths
    already resident.  Returns (last_logits [n, 1, V], states)."""
    logits, states = model.prefill_suffix(params, tokens, states, rows, starts, ctx_blocks)
    return _last_logits(logits, lengths), states
