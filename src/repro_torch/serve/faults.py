"""Serving fault classes and deterministic fault injection (port of
``repro.serve.faults``).

A fault names the engine slots it implicates (``slots``); every other slot
committed its work before the fault was raised (or never started it) and
stays identical to a fault-free run.  The port's engine ends the named
slots' requests before it raises — their pre-fault tokens, ``fault_reason``
the fault class, their exclusively held pool blocks zeroed — so a
:class:`~repro_torch.serve.supervisor.EngineSupervisor`'s later
``quarantine_slot`` of such a slot does nothing and counts nothing.
Without a supervisor the fault propagates to the caller, who may go on
calling ``run()``.

Fault classes (``FaultSpec.kind``):

* ``step_error``       — the decode chunk raises before any state commit
  (stands in for a device error).  Retryable.
* ``nonfinite_logits`` — one slot's logits go NaN inside the chunk; the
  per-chunk finite flag attributes it to that slot.  Retryable.
* ``pool_pressure``    — the supervisor holds free KV blocks for
  ``duration`` engine steps, so admission falls short and the engine walks
  its degraded-mode ladder (which sheds a queue head with this reason).
  Retryable.
* ``slow_step``        — the (virtual) clock advances by ``delay_s``
  before the step runs; latencies feel it, tokens do not.

The injector never touches the engine: the supervisor pops the specs due
at each step and routes them.  Its schedule is the reference's inline LCG,
so a seed gives the reference's faults; no ambient RNG is read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

FAULT_STEP_ERROR = "step_error"
FAULT_NONFINITE = "nonfinite_logits"
FAULT_POOL_PRESSURE = "pool_pressure"
FAULT_SLOW_STEP = "slow_step"
FAULT_KINDS: Tuple[str, ...] = (
    FAULT_STEP_ERROR, FAULT_NONFINITE, FAULT_POOL_PRESSURE, FAULT_SLOW_STEP,
)

# terminal reasons that come from the client, not from a fault
CANCELLED = "cancelled"
DEADLINE_EXCEEDED = "deadline_exceeded"

# fault classes worth resubmitting (transient by construction); the
# cancel class is client intent and never retried
RETRYABLE_FAULTS = frozenset({FAULT_STEP_ERROR, FAULT_NONFINITE, FAULT_POOL_PRESSURE})
CANCEL_CLASS = frozenset({CANCELLED, DEADLINE_EXCEEDED})


class ServeFault(RuntimeError):
    """A per-step serving fault attributable to the engine slots ``slots``."""

    reason = "fault"

    def __init__(self, message: str, slots: Sequence[int] = ()):
        super().__init__(message)
        self.slots: Tuple[int, ...] = tuple(slots)


class InjectedStepError(ServeFault):
    """Injected whole-chunk failure, raised before any state commit."""

    reason = FAULT_STEP_ERROR


class NonFiniteLogitsError(ServeFault):
    """Non-finite logits (injected or organic) on the named slots."""

    reason = FAULT_NONFINITE


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.  ``step`` is the supervisor step it fires at;
    ``slot`` a victim hint the engine maps onto the slots decoding that
    step (``hint % n_active``; None = the first); ``duration``/``blocks``
    shape a pool-pressure hold (``blocks=0``: every free block) and
    ``delay_s`` a slow step."""

    step: int
    kind: str
    slot: Optional[int] = None
    duration: int = 1
    blocks: int = 0
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.step < 0 or self.duration < 1 or self.delay_s < 0:
            raise ValueError(f"invalid FaultSpec timing: {self}")


class ServeFaultInjector:
    """A replayable schedule of :class:`FaultSpec`, popped step by step;
    ``fired`` keeps everything delivered."""

    def __init__(self, schedule: Sequence[FaultSpec] = ()):
        self.schedule: Tuple[FaultSpec, ...] = tuple(sorted(schedule, key=lambda s: s.step))
        self._by_step: Dict[int, List[FaultSpec]] = {}
        for spec in self.schedule:
            self._by_step.setdefault(spec.step, []).append(spec)
        self.fired: List[FaultSpec] = []

    def pop(self, step: int) -> List[FaultSpec]:
        """Specs due at ``step`` (each delivered exactly once)."""
        specs = self._by_step.pop(step, [])
        self.fired.extend(specs)
        return specs

    @property
    def n_pending(self) -> int:
        return sum(len(v) for v in self._by_step.values())

    @classmethod
    def periodic(cls, n_steps: int, every: int,
                 kinds: Sequence[str] = (FAULT_STEP_ERROR, FAULT_NONFINITE),
                 seed: int = 0, duration: int = 2,
                 delay_s: float = 0.25) -> "ServeFaultInjector":
        """One fault every ``every`` steps over ``n_steps``, kind and victim
        hint drawn from an inline LCG: a pure function of the arguments."""
        if every < 1:
            raise ValueError("every must be >= 1")
        state = (seed ^ 0x9E3779B9) & 0xFFFFFFFF

        def nxt() -> int:
            nonlocal state
            state = (1664525 * state + 1013904223) & 0xFFFFFFFF
            return state >> 8

        specs = []
        for step in range(every - 1, n_steps, every):
            kind = kinds[nxt() % len(kinds)]
            specs.append(FaultSpec(step=step, kind=kind, slot=nxt() % 64,
                                   duration=duration, delay_s=delay_s))
        return cls(specs)
