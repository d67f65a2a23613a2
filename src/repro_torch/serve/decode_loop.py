"""Chunked decode: ``steps`` serving steps per engine round.

Port of ``repro.serve.decode_loop``.  The reference compiles a chunk into
one ``lax.scan``; here ``make_fused_decode`` is a Python loop that keeps
every token and the per-slot finite flag on the device until the chunk
ends (one host sync per chunk), and ``unfused_decode`` — its oracle —
brings each step's tokens to the host as it goes.  Both return
``(toks [B, steps], finite [B], (next_tok, states, pos, gen))``.
Positions advance for every slot, free ones included, as in the
reference: their writes land in the scratch block.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.serve.sampling import SamplerConfig, sample_next_token
from repro_torch.serve.slots import finite_mask


def _step(model, params, tok, states, pos, gen, sampler, tables):
    logits, states = model.decode(params, tok, states, pos, block_tables=tables)
    nxt = sample_next_token(logits, sampler, gen, model.cfg)
    return nxt, states, finite_mask(logits)


def make_fused_decode(model):
    """``fused(params, tok, states, pos, gen, steps, sampler, tables=None)``
    for ``model``."""

    def fused(params, tok, states, pos, gen: Optional[torch.Generator], steps: int,
              sampler: SamplerConfig, tables=None):
        finite = torch.ones(tok.shape[0], dtype=torch.bool, device=tok.device)
        out = []
        for _ in range(steps):
            tok, states, fin = _step(model, params, tok, states, pos, gen, sampler, tables)
            finite &= fin
            out.append(tok)
            pos = pos + 1
        toks = torch.cat(out, dim=-1) if out else tok.new_zeros((tok.shape[0], 0))
        return toks, finite, (tok, states, pos, gen)

    return fused


def unfused_decode(model, params, tok, states, pos, gen, steps: int,
                   sampler: SamplerConfig, tables=None):
    """The oracle loop: each step's tokens reach the host before the next."""
    finite = torch.ones(tok.shape[0], dtype=torch.bool, device=tok.device)
    out = []
    for _ in range(steps):
        tok, states, fin = _step(model, params, tok, states, pos, gen, sampler, tables)
        finite &= fin
        out.append(tok.cpu())
        pos = pos + 1
    toks = (torch.cat(out, dim=-1) if out
            else torch.zeros((tok.shape[0], 0), dtype=torch.int32))
    return toks.to(tok.device), finite, (tok, states, pos, gen)
