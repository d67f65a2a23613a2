"""Scenario suites: what the requests in a traffic trace look like.

A :class:`Scenario` is a seeded distribution over (prompt, gen length)
pairs; a **suite** is a weighted mixture of scenarios (port of
``repro.traffic.scenarios``, the same suites).  The shipped suites mirror
the serving workloads the engine's machinery was built for:

* ``chat`` — short prompts, mid-length generations; the latency-critical
  interactive mix.
* ``longdoc`` — long prompts, short generations (summarization): the
  prefill-heavy workload the chunked-prefill scheduler exists for.
* ``agent`` — shared-prefix fan-out: many requests extend one of a few
  long common prefixes (a system prompt / tool preamble), the workload
  the radix-tree prefix cache turns from O(prompt) into O(suffix).
* ``mixed`` — all three, weighted toward chat.

Prompts are drawn from a caller-owned ``numpy.random.Generator`` — fully
deterministic under a fixed seed, no wall clock.  Shared prefixes are
derived from a scenario-local generator seeded by ``prefix_seed`` so the
*same* prefix pool is regenerated for every trace built from the suite
(prefix-cache hits survive across traces with different arrival seeds).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One request population inside a suite.

    ``prompt_lens`` / ``gen_lens`` are the discrete choice sets sampled
    uniformly per request.  ``shared_prefix_len > 0`` makes every request
    start with one of ``n_prefixes`` fixed token prefixes (chosen
    uniformly), regenerated deterministically from ``prefix_seed``.
    """

    name: str
    prompt_lens: Tuple[int, ...]
    gen_lens: Tuple[int, ...]
    weight: float = 1.0
    shared_prefix_len: int = 0
    n_prefixes: int = 1
    prefix_seed: int = 0x5EED

    def __post_init__(self):
        if not self.prompt_lens or min(self.prompt_lens) < 1:
            raise ValueError(f"{self.name}: prompt_lens {self.prompt_lens} "
                             "must be non-empty and >= 1")
        if not self.gen_lens or min(self.gen_lens) < 0:
            raise ValueError(f"{self.name}: gen_lens {self.gen_lens} "
                             "must be non-empty and >= 0")
        if self.shared_prefix_len >= min(self.prompt_lens):
            if self.shared_prefix_len > 0:
                raise ValueError(
                    f"{self.name}: shared_prefix_len {self.shared_prefix_len} "
                    f"must leave at least one suffix token below the shortest "
                    f"prompt ({min(self.prompt_lens)})"
                )
        if self.weight <= 0:
            raise ValueError(f"{self.name}: weight {self.weight} must be > 0")

    @property
    def max_total_len(self) -> int:
        return max(self.prompt_lens) + max(self.gen_lens)


SUITES: Dict[str, Tuple[Scenario, ...]] = {
    "chat": (
        Scenario("chat", prompt_lens=(8, 12, 16, 24), gen_lens=(12, 16, 24)),
    ),
    "longdoc": (
        Scenario("summarize", prompt_lens=(96, 128, 160), gen_lens=(6, 10)),
    ),
    "agent": (
        Scenario("fanout", prompt_lens=(48, 56, 64), gen_lens=(8, 12),
                 shared_prefix_len=32, n_prefixes=2),
    ),
    "mixed": (
        Scenario("chat", prompt_lens=(8, 12, 16, 24), gen_lens=(12, 16, 24),
                 weight=3.0),
        Scenario("summarize", prompt_lens=(96, 128, 160), gen_lens=(6, 10),
                 weight=1.0),
        Scenario("fanout", prompt_lens=(48, 56, 64), gen_lens=(8, 12),
                 weight=2.0, shared_prefix_len=32, n_prefixes=2),
    ),
}


def suite_max_total_len(suite: Tuple[Scenario, ...]) -> int:
    """Worst-case ``prompt + gen`` over the suite — the floor for the
    engine's ``max_len``."""
    return max(s.max_total_len for s in suite)


def _prefix_pool(scenario: Scenario, vocab: int,
                 n_codebooks: int) -> List[np.ndarray]:
    """The scenario's fixed shared prefixes, regenerated from its seed."""
    rng = np.random.default_rng(scenario.prefix_seed)
    shape = ((n_codebooks, scenario.shared_prefix_len) if n_codebooks
             else (scenario.shared_prefix_len,))
    return [rng.integers(0, vocab, shape, dtype=np.int32)
            for _ in range(scenario.n_prefixes)]


def sample_requests(suite: Tuple[Scenario, ...], n: int, vocab: int,
                    rng: np.random.Generator,
                    n_codebooks: int = 0) -> List[Tuple[str, np.ndarray, int]]:
    """Draw ``n`` requests from the suite mixture.

    Returns ``[(scenario_name, prompt, max_new_tokens)]`` in draw order —
    deterministic given the generator's state.
    """
    weights = np.asarray([s.weight for s in suite], np.float64)
    weights = weights / weights.sum()
    pools = {s.name: _prefix_pool(s, vocab, n_codebooks)
             for s in suite if s.shared_prefix_len > 0}
    out: List[Tuple[str, np.ndarray, int]] = []
    for _ in range(n):
        s = suite[int(rng.choice(len(suite), p=weights))]
        p_len = int(rng.choice(np.asarray(s.prompt_lens)))
        g_len = int(rng.choice(np.asarray(s.gen_lens)))
        tail_len = p_len - s.shared_prefix_len
        shape = (n_codebooks, tail_len) if n_codebooks else (tail_len,)
        tail = rng.integers(0, vocab, shape, dtype=np.int32)
        if s.shared_prefix_len > 0:
            prefix = pools[s.name][int(rng.choice(s.n_prefixes))]
            prompt = np.concatenate([prefix, tail], axis=-1)
        else:
            prompt = tail
        out.append((s.name, prompt, g_len))
    return out
