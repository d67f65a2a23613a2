"""Fault-isolating supervisor around ``ServeEngine.step()`` (port of
``repro.serve.supervisor``).

The engine fails loudly: an injected or organic per-step fault raises a
:class:`~repro_torch.serve.faults.ServeFault` naming the slots it ended.
:class:`EngineSupervisor` contains it: it catches exactly those faults,
quarantines the named slots (a no-op in the port, whose engine has already
ended them; counted once here), and lets every other slot go on decoding
as in a fault-free run.

It also delivers the faults of a
:class:`~repro_torch.serve.faults.ServeFaultInjector`:

* decode faults (``step_error``, ``nonfinite_logits``) go into
  ``engine.step(faults=...)``;
* ``pool_pressure`` allocates and holds free pool blocks for ``duration``
  steps, so admission falls short and the engine's degraded-mode ladder
  acts;
* ``slow_step`` advances the injected clock before the step (latency only;
  a wall clock cannot be stalled).

Every ``audit_every`` steps it runs ``engine.audit()`` with its held blocks
declared as external refs, so a leaked block or a refcount drift fails the
run at once.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.serve.engine import RequestOutput, ServeEngine
from repro_torch.serve.faults import (
    FAULT_POOL_PRESSURE, FAULT_SLOW_STEP, FaultSpec, ServeFault, ServeFaultInjector,
)


class EngineSupervisor:
    """Wrap one engine; ``step()`` is a drop-in for ``engine.step()``."""

    def __init__(self, engine: ServeEngine, injector: Optional[ServeFaultInjector] = None,
                 audit_every: int = 1):
        if audit_every < 0:
            raise ValueError("audit_every must be >= 0 (0 disables)")
        self.engine = engine
        self.injector = injector
        self.audit_every = audit_every
        self._step_no = 0
        self._held: List[Tuple[int, List[int]]] = []  # (release_at_step, block ids)
        self.n_faults_injected = 0
        self.n_quarantined = 0
        self.audits_run = 0

    def step(self) -> List[RequestOutput]:
        step = self._step_no
        self._step_no += 1
        decode_faults: List[FaultSpec] = []
        for spec in (self.injector.pop(step) if self.injector else []):
            self.n_faults_injected += 1
            if spec.kind == FAULT_SLOW_STEP:
                advance = getattr(self.engine.clock, "advance", None)
                if advance is not None:
                    advance(spec.delay_s)
            elif spec.kind == FAULT_POOL_PRESSURE:
                self._hold_blocks(spec, step)
            else:
                decode_faults.append(spec)
        # expired holds go before the step: the engine sees pressure exactly
        # while a hold is live
        self._release_expired(step)
        try:
            outs = self.engine.step(faults=decode_faults)
        except ServeFault as e:
            for slot_i in e.slots:
                self.engine.quarantine_slot(slot_i, e.reason)
                self.n_quarantined += 1
            outs = self.engine._drain()
        if self.audit_every and (step + 1) % self.audit_every == 0:
            self.engine.audit(external_refs=self.held_blocks)
            self.audits_run += 1
        return outs

    def run(self) -> List[RequestOutput]:
        """Drive to completion (like ``engine.run()``), fault-isolated."""
        outs: List[RequestOutput] = []
        while self.engine.has_work():
            outs.extend(self.step())
        self.release_all()
        return sorted(outs, key=lambda o: o.request_id)

    # ---------------------------------------------------- pool pressure
    @property
    def held_blocks(self) -> List[int]:
        return [b for _, blocks in self._held for b in blocks]

    def _hold_blocks(self, spec: FaultSpec, step: int) -> None:
        pool = self.engine._pool
        if pool is None:  # dense engine: no pool to pressure
            return
        n = min(spec.blocks or pool.n_free, pool.n_free)
        if n <= 0:
            return
        self._held.append((step + spec.duration, pool.alloc(n)))

    def _release_expired(self, step: int) -> None:
        live = []
        for release_at, blocks in self._held:
            if release_at <= step:
                for b in blocks:
                    self.engine._pool.decref(b)
            else:
                live.append((release_at, blocks))
        self._held = live

    def release_all(self) -> None:
        """Drop every outstanding pressure hold (end of run)."""
        for _, blocks in self._held:
            for b in blocks:
                self.engine._pool.decref(b)
        self._held = []

    @property
    def stats(self) -> Dict[str, int]:
        return {
            "steps": self._step_no,
            "faults_injected": self.n_faults_injected,
            "quarantined": self.n_quarantined,
            "audits_run": self.audits_run,
            "held_blocks": len(self.held_blocks),
            "faults_pending": self.injector.n_pending if self.injector else 0,
        }
