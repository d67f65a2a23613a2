"""Chunked decode: ``steps`` serving steps per engine round.

Port of ``repro.serve.decode_loop``.  The reference compiles a chunk into
one ``lax.scan``; here ``make_fused_decode`` is a Python loop that keeps
every token and the per-slot finite flag on the device until the chunk
ends (one host sync per chunk), and ``unfused_decode`` — its oracle —
brings each step's tokens to the host as it goes.  Both return
``(toks [B, steps], finite [B], (next_tok, states, pos, gen))``, tokens
``[B, C, steps]`` for a multi-codebook model.
Positions advance for every slot, free ones included, as in the
reference: their writes land in the scratch block.

``active`` (optional ``[B]`` bool) gates each slot's state updates: an
inactive slot's dense cache writes are put back (``decode(write=...)``)
and its recurrent states selected back, so its state stays exactly as it
was.  The engine passes it on dense caches while a ``PREFILLING`` slot is
present, so ride-along decode cannot touch a half-prefilled slot; on the
paged pool a prefilling slot's table row points at the scratch block.

``poison`` (optional ``[B]`` bool) NaNs the flagged slots' logits at every
step of the chunk, before the finite flag and sampling: the injected
``nonfinite_logits`` fault (``serve/faults.py``).  ``poison=None`` adds no
operation.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.serve.sampling import SamplerConfig, sample_next_token
from repro_torch.serve.slots import finite_mask, select_states


def _poisoned(logits: torch.Tensor, poison: torch.Tensor) -> torch.Tensor:
    """NaN out the logits of the slots flagged in ``poison [B]``."""
    shape = (-1,) + (1,) * (logits.dim() - 1)
    return torch.where(poison.reshape(shape), torch.full_like(logits, float("nan")), logits)


def _step(model, params, tok, states, pos, gen, sampler, tables, active, poison):
    logits, new = model.decode(params, tok, states, pos, block_tables=tables, write=active)
    if poison is not None:
        logits = _poisoned(logits, poison)
    states = new if active is None else select_states(new, states, active)
    nxt = sample_next_token(logits, sampler, gen, model.cfg)
    return nxt, states, finite_mask(logits)


def make_fused_decode(model):
    """``fused(params, tok, states, pos, gen, steps, sampler, tables=None,
    active=None, poison=None)`` for ``model``."""

    def fused(params, tok, states, pos, gen: Optional[torch.Generator], steps: int,
              sampler: SamplerConfig, tables=None, active: Optional[torch.Tensor] = None,
              poison: Optional[torch.Tensor] = None):
        finite = torch.ones(tok.shape[0], dtype=torch.bool, device=tok.device)
        out = []
        for _ in range(steps):
            tok, states, fin = _step(model, params, tok, states, pos, gen, sampler, tables,
                                     active, poison)
            finite &= fin
            out.append(tok)
            pos = pos + 1
        toks = torch.cat(out, dim=-1) if out else tok.new_zeros(tok.shape[:-1] + (0,))
        return toks, finite, (tok, states, pos, gen)

    return fused


def unfused_decode(model, params, tok, states, pos, gen, steps: int,
                   sampler: SamplerConfig, tables=None, active: Optional[torch.Tensor] = None,
                   poison: Optional[torch.Tensor] = None):
    """The oracle loop: each step's tokens reach the host before the next."""
    finite = torch.ones(tok.shape[0], dtype=torch.bool, device=tok.device)
    out = []
    for _ in range(steps):
        tok, states, fin = _step(model, params, tok, states, pos, gen, sampler, tables,
                                 active, poison)
        finite &= fin
        out.append(tok.cpu())
        pos = pos + 1
    toks = (torch.cat(out, dim=-1) if out
            else torch.zeros(tok.shape[:-1] + (0,), dtype=torch.int32))
    return toks.to(tok.device), finite, (tok, states, pos, gen)
