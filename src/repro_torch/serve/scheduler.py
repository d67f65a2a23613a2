"""Token-budget scheduler and the degraded-mode ladder (port of
``repro.serve.scheduler``; pure host-side policy, the same in both
packages).

Chunked prefill: each engine round (one ``ServeEngine.step()``) admits
waiting requests into free slots as ``PREFILLING``, runs at most one
bounded prefill dispatch, then one decode chunk over the ``DECODING``
slots.  The round's token budget is shared: decode claims one token per
active slot and prefill gets the rest,

    prefill_budget = max(token_budget - n_active_decode, 0)

split over the ``PREFILLING`` slots oldest first (FCFS: a later prompt gets
budget only once every earlier prompt's remaining need is covered this
round).  Chunk widths are padded to powers of two (:func:`pow2_bucket`).

The ladder is the paged engine's answer to a stalled admission round:
flush the prefix tree, then stop prefix admission, then shed the queue
head as a terminal ``pool_pressure`` output, one level per stalled round,
relaxing one level per round with admission progress.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


def pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= ``n``, clamped to ``cap`` (0 for n <= 0)."""
    if n <= 0:
        return 0
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """``token_budget``: the per-round cap shared by decode (priority) and
    prefill (the CLI's ``--prefill-chunk-tokens``).  A budget at or below
    the live decode count starves prefill until slots retire."""

    token_budget: int

    def __post_init__(self):
        if self.token_budget < 1:
            raise ValueError(
                f"token_budget must be >= 1, got {self.token_budget} "
                "(0 selects the blocking admission path at the engine level)")


class TokenBudgetScheduler:
    """FCFS chunked-prefill planner with decode priority; keeps the counters
    ``ServeEngine.scheduler_stats`` reports."""

    def __init__(self, config: SchedulerConfig):
        self.config = config
        self.rounds = 0
        self.chunks = 0
        self.prefill_tokens = 0
        self.starved_rounds = 0  # rounds where decode took the whole budget

    def prefill_budget(self, n_active_decode: int) -> int:
        """Tokens left for prefill after decode's per-round claim."""
        return max(self.config.token_budget - n_active_decode, 0)

    def plan_chunks(self, needs: Sequence[Tuple[int, int]],
                    n_active_decode: int) -> List[Tuple[int, int]]:
        """``needs``: ``[(slot_id, remaining_prompt_tokens)]`` in admission
        order -> ``[(slot_id, chunk_len)]`` for the slots that get work this
        round (possibly none); the head is served fully before the next."""
        if not needs:
            return []
        self.rounds += 1
        budget = self.prefill_budget(n_active_decode)
        if budget == 0:
            self.starved_rounds += 1
            return []
        plan: List[Tuple[int, int]] = []
        for slot_id, need in needs:
            if budget <= 0:
                break
            take = min(need, budget)
            if take > 0:
                plan.append((slot_id, take))
                budget -= take
        self.chunks += len(plan)
        self.prefill_tokens += sum(t for _, t in plan)
        return plan

    @property
    def stats(self) -> Dict[str, int]:
        return {
            "token_budget": self.config.token_budget,
            "rounds": self.rounds,
            "prefill_chunks": self.chunks,
            "prefill_tokens": self.prefill_tokens,
            "starved_rounds": self.starved_rounds,
        }


class DegradedLadder:
    """Pool-pressure response: ``normal`` -> ``flush_prefix`` (evict every
    evictable interned block) -> ``no_prefix_admission`` (no prefix
    matching or interning) -> ``shed_load`` (the queue head ends as a
    ``pool_pressure`` output, one a stalled round).  Every transition is
    recorded as ``(engine_step, new_level)``."""

    NORMAL, FLUSH_PREFIX, NO_PREFIX_ADMISSION, SHED_LOAD = range(4)
    LEVEL_NAMES = ("normal", "flush_prefix", "no_prefix_admission", "shed_load")

    def __init__(self):
        self.level = self.NORMAL
        self.transitions: List[Tuple[int, str]] = []

    @property
    def level_name(self) -> str:
        return self.LEVEL_NAMES[self.level]

    def escalate(self, step: int) -> int:
        """One stalled admission round: one level up (saturating)."""
        if self.level < self.SHED_LOAD:
            self.level += 1
            self.transitions.append((step, self.level_name))
        return self.level

    def relax(self, step: int) -> int:
        """One round with admission progress: one level down."""
        if self.level > self.NORMAL:
            self.level -= 1
            self.transitions.append((step, self.level_name))
        return self.level
