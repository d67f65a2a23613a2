"""Fault-tolerant execution loop: checkpoint/restart with injected faults.

Port of ``repro.runtime.fault``.

At 1000+ node scale the mean time between node failures drops below job
length, so the control plane must treat "a step died" as a normal event.
This module provides the single-controller version of that logic (the same
state machine a multi-controller launcher runs per slice):

* :class:`FaultInjector` — deterministic fault schedule for tests/demos
  (raise at given steps, once each), standing in for hardware failures.
* :func:`run_with_restarts` — drives ``step_fn`` from the last checkpoint,
  catching faults, restoring state, and replaying.  Because the data
  pipeline is step-addressable (``repro_torch.data``) and checkpoints are atomic,
  recovery is *bit-exact*: the restarted trajectory equals the fault-free
  one (asserted in tests/test_torch_train_driver.py).
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterable, Optional, Set, Tuple

from repro_torch.serve.clock import resolve_clock

log = logging.getLogger("repro_torch.runtime")


class SimulatedFault(RuntimeError):
    """Stands in for a device error or host loss in tests and demos."""


class FaultInjector:
    def __init__(self, fail_at_steps: Iterable[int] = ()):  # each fires once
        self._pending: Set[int] = set(fail_at_steps)
        self.fired: list = []

    def check(self, step: int):
        if step in self._pending:
            self._pending.discard(step)
            self.fired.append(step)
            raise SimulatedFault(f"injected fault at step {step}")


def run_with_restarts(
    *,
    init_state: Callable[[], Any],
    step_fn: Callable[[Any, int], Tuple[Any, Dict[str, float]]],
    n_steps: int,
    ckpt_manager=None,
    ckpt_every: int = 0,
    restore_fn: Optional[Callable[[int, Any], Any]] = None,
    max_restarts: int = 10,
    on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None,
    clock: Optional[Callable[[], float]] = None,
) -> Dict[str, Any]:
    """Run ``n_steps`` of ``step_fn`` with checkpoint/restart recovery.

    ``step_fn(state, step)`` may raise (fault); the loop then restores from
    the newest checkpoint (via ``restore_fn(step, state_template)`` if
    given, else ``ckpt_manager.restore``) and replays from there.  Returns
    summary: final state, per-step metrics, restart count, wall time.

    ``clock`` follows the serving stack's injected-clock discipline
    (``repro_torch.serve.clock``): ``wall_s`` is measured on it, so tests can
    run the whole recovery loop on a virtual clock.  ``None`` uses the
    sanctioned ambient wall clock.
    """
    clock = resolve_clock(clock)
    t0 = clock()
    state = init_state()
    start = 0
    if ckpt_manager is not None:
        last = ckpt_manager.latest_step()
        if last is not None:
            state = _restore(ckpt_manager, restore_fn, last, state)
            start = last + 1
            log.info("resuming from checkpoint step %d", last)

    metrics_hist: Dict[int, Dict[str, float]] = {}
    restarts = 0
    step = start
    while step < n_steps:
        try:
            state, metrics = step_fn(state, step)
            metrics_hist[step] = {k: float(v) for k, v in metrics.items()}
            if on_metrics:
                on_metrics(step, metrics_hist[step])
            if ckpt_manager is not None and ckpt_every and (step + 1) % ckpt_every == 0:
                ckpt_manager.save(step, state, metadata={"step": step})
            step += 1
        except Exception as e:  # noqa: BLE001 — any step failure is recoverable
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(f"exceeded max_restarts={max_restarts}") from e
            log.warning("step %d failed (%s); restart %d", step, e, restarts)
            if ckpt_manager is not None:
                last = ckpt_manager.latest_step()
                if last is not None:
                    state = _restore(ckpt_manager, restore_fn, last, state)
                    step = last + 1
                    continue
            # no checkpoint yet: restart from scratch
            state = init_state()
            step = 0
    return {
        "state": state,
        "metrics": metrics_hist,
        "restarts": restarts,
        "wall_s": clock() - t0,
    }


def _restore(ckpt_manager, restore_fn, step: int, state_template):
    if restore_fn is not None:
        return restore_fn(step, state_template)
    restored, _ = ckpt_manager.restore(step, state_template)
    return restored
