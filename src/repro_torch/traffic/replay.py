"""Trace replay: drive a ``ServeFrontend`` with a traffic trace (port of
``repro.traffic.replay``).

The replay loop is the only place in the traffic stack where time
*passes*; everything upstream (arrivals, scenarios, trace generation) is
pure.  Two clock modes:

* **virtual** — the engine, front-end, and replay all share one
  :class:`VirtualClock`.  Each front-end pump advances the clock by a
  fixed ``step_s`` (a stand-in for the engine round's service time), and
  idle gaps jump straight to the next arrival.  The entire latency
  trajectory — queue waits, TTFT, ITL, timeout rejections — becomes a
  deterministic function of ``(trace, engine config, step_s)``: two
  replays of the same trace are bit-identical.
* **wall** — no virtual clock; the replay paces arrivals with
  ``time.sleep`` against the real clock and the engine stamps real
  timestamps.  Latencies are honest but machine-dependent; token
  streams are still deterministic (greedy sampling).

Either way the replay captures every request's incremental token stream
through the front-end's ``on_tokens`` path, so callers can check the
streamed tokens against the terminal ``RequestOutput``s.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.engine import RequestOutput
from repro_torch.serve.frontend import ServeFrontend
from repro_torch.traffic.trace import TrafficTrace


class VirtualClock:
    """A manually advanced clock, callable like ``time.time``.

    Pass one instance as ``ServeEngine(clock=...)`` (the front-end
    inherits it) and to :func:`replay_trace`; the replay advances it,
    and every timing the stack records becomes deterministic.
    """

    def __init__(self, start_s: float = 0.0):
        self._t = float(start_s)

    def __call__(self) -> float:
        return self._t

    def now(self) -> float:
        return self._t

    def advance(self, dt_s: float) -> None:
        if dt_s < 0:
            raise ValueError(f"cannot advance clock by dt_s={dt_s} < 0")
        self._t += dt_s


@dataclasses.dataclass
class ReplayResult:
    """Everything one replayed trace produced.

    ``outputs`` are the terminal :class:`RequestOutput`s (completions
    *and* rejections) in finish order; ``request_ids[i]`` is the engine
    request id assigned to ``trace.requests[i]``; ``token_streams``
    maps request id -> the concatenation of every streamed chunk (equal
    to the terminal ``tokens`` for completed requests, empty for
    rejected ones); ``stats`` is the front-end counter snapshot
    (submitted/completed/rejected/queue high-water).
    """

    outputs: List[RequestOutput]
    request_ids: List[int]
    token_streams: Dict[int, np.ndarray]
    duration_s: float
    stats: Dict

    @property
    def outputs_by_id(self) -> Dict[int, RequestOutput]:
        return {o.request_id: o for o in self.outputs}


def replay_trace(frontend: ServeFrontend, trace: TrafficTrace,
                 virtual_step_s: Optional[float] = None) -> ReplayResult:
    """Feed ``trace`` through ``frontend`` on its arrival schedule.

    ``virtual_step_s`` selects the clock mode: a positive float runs in
    virtual time (the front-end's clock must be a :class:`VirtualClock`;
    each pump advances it by ``virtual_step_s``), ``None`` runs in wall
    time (arrival gaps are slept for real).
    """
    clock = frontend.clock
    if virtual_step_s is not None:
        if virtual_step_s <= 0:
            raise ValueError(
                f"virtual_step_s={virtual_step_s} must be > 0 (or None "
                "for wall-clock replay)")
        if not isinstance(clock, VirtualClock):
            raise ValueError(
                "virtual replay needs the front-end (and engine) built on "
                "a VirtualClock; pass clock=VirtualClock() to ServeEngine")

    chunks: Dict[int, List[np.ndarray]] = {}

    def _sink_for(rid_box: List[int]):
        def _sink(toks: np.ndarray) -> None:
            chunks.setdefault(rid_box[0], []).append(np.asarray(toks))
        return _sink

    # when the front-end retries a faulted attempt, its partial stream is
    # withdrawn — drop our copy too so `token_streams` stays equal to the
    # terminal output for retried-then-completed requests
    prev_on_retry = frontend.on_retry

    def _on_retry(rid: int) -> None:
        chunks.pop(rid, None)
        if prev_on_retry is not None:
            prev_on_retry(rid)

    frontend.on_retry = _on_retry

    t0 = clock()
    reqs = trace.requests
    rids: List[int] = []
    i = 0
    while i < len(reqs) or frontend.busy():
        now = clock() - t0
        while i < len(reqs) and reqs[i].arrival_s <= now + 1e-12:
            box: List[int] = [-1]
            sink = _sink_for(box)
            rid = frontend.submit(reqs[i].prompt, reqs[i].max_new_tokens,
                                  on_tokens=sink)
            box[0] = rid
            rids.append(rid)
            i += 1
        if frontend.busy():
            # each engine round costs step_s of virtual time; advancing
            # *before* the pump puts the round's timestamps (admission,
            # first token, chunk arrivals) at round end, so TTFT/ITL are
            # nonzero multiples of the round time
            if virtual_step_s is not None:
                clock.advance(virtual_step_s)
            frontend.pump()
        elif i < len(reqs):
            gap = (t0 + reqs[i].arrival_s) - clock()
            if virtual_step_s is not None:
                clock.advance(max(gap, 0.0))
            elif gap > 0:
                time.sleep(gap)
    outputs = frontend.drain()
    duration = clock() - t0

    streams: Dict[int, np.ndarray] = {}
    for idx, rid in enumerate(rids):
        parts = chunks.get(rid, [])
        if parts:
            streams[rid] = np.concatenate(parts, axis=-1)
        else:
            p = np.asarray(reqs[idx].prompt)
            shape = p.shape[:-1] + (0,)
            streams[rid] = np.zeros(shape, np.int32)
    return ReplayResult(outputs=outputs, request_ids=rids,
                        token_streams=streams, duration_s=duration,
                        stats=dict(frontend.stats))
