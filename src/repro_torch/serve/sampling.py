"""Token sampling: greedy, temperature, top-k (port of ``repro.serve.sampling``).

Greedy is ``torch.argmax``, which returns the first maximum exactly as
``jnp.argmax`` does, so greedy tokens match the reference.  Temperature
and top-k draw from an explicit ``torch.Generator`` (the reference draws
from ``jax.random``; the two streams differ by design).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """temperature == 0 -> greedy argmax; top_k == 0 -> full distribution."""

    temperature: float = 0.0
    top_k: int = 0

    def __post_init__(self):
        if self.temperature < 0.0 or self.top_k < 0:
            raise ValueError(f"bad sampler {self}: temperature and top_k must be >= 0")


GREEDY = SamplerConfig()


def empty_tokens(prompt: np.ndarray) -> np.ndarray:
    """No generated tokens in ``prompt``'s format: ``(0,)``, or ``(C, 0)``
    for a ``[C, S]`` codebook grid."""
    return np.zeros(prompt.shape[:-1] + (0,), np.int32)


def sample_logits(logits: torch.Tensor, sampler: SamplerConfig,
                  gen: Optional[torch.Generator]) -> torch.Tensor:
    """``logits [..., V]`` -> int32 ids ``[...]``."""
    if sampler.temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.to(torch.float32) / sampler.temperature
    if 0 < sampler.top_k < lg.shape[-1]:
        kth = torch.topk(lg, sampler.top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -float("inf")), lg)
    probs = torch.softmax(lg, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=gen)[:, 0]
    return ids.reshape(probs.shape[:-1]).to(torch.int32)


def sample_next_token(logits: torch.Tensor, sampler: SamplerConfig,
                      gen: Optional[torch.Generator], cfg: ArchConfig) -> torch.Tensor:
    """Last-position logits ``[B, S, V]`` (``[B, S, C, V]`` multi-codebook)
    -> the next input token ``[B, 1]`` (``[B, C, 1]``), what decode takes."""
    return sample_logits(logits[:, -1], sampler, gen)[..., None]
