"""SLO evaluation: fold per-request timings into a serving scorecard.

The serving layer is judged on *percentile latency at offered load*, not
mean throughput: p50/p95/p99 time-to-first-token (TTFT) and inter-token
latency (ITL), the rejection rate, and **SLO-goodput** — the rate of
requests that completed *and* met their latency bounds (rejected or
SLO-violating work counts for nothing).  This module (port of
``repro.traffic.slo``) turns a replayed trace's
:class:`~repro_torch.serve.engine.RequestOutput` list (each carrying its
``RequestTiming``) into exactly that scorecard.

Percentile conventions: TTFT percentiles are over completed requests'
``ttft_s``; ITL percentiles are over completed requests' ``mean_itl_s``
(per-request mean), with the worst single gap tracked separately as
``itl_max_s``.  A request meets its SLO iff it completed with
``ttft_s <= slo.ttft_s`` **and** ``max_itl_s <= slo.itl_s`` (max, not
mean — a single long stall is a violation the user saw).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.engine import RequestOutput
from repro_torch.serve.faults import CANCEL_CLASS

PERCENTILES = (50, 95, 99)


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Per-request latency bounds (seconds).  ``ttft_s`` bounds submission
    to first token; ``itl_s`` bounds the worst inter-token gap."""

    ttft_s: float
    itl_s: float

    def __post_init__(self):
        if self.ttft_s <= 0:
            raise ValueError(f"ttft_s={self.ttft_s} must be > 0")
        if self.itl_s <= 0:
            raise ValueError(f"itl_s={self.itl_s} must be > 0")

    def met_by(self, out: RequestOutput) -> bool:
        if out.reject_reason is not None or out.fault_reason is not None \
                or out.timing is None:
            return False
        return (out.timing.ttft_s <= self.ttft_s
                and out.timing.max_itl_s <= self.itl_s)


def _pcts(xs: Sequence[float]) -> Dict[str, float]:
    if not xs:
        return {f"p{p}": 0.0 for p in PERCENTILES}
    arr = np.asarray(xs, np.float64)
    return {f"p{p}": float(np.percentile(arr, p)) for p in PERCENTILES}


def evaluate(outputs: Sequence[RequestOutput], duration_s: float,
             slo: Optional[SLOConfig] = None,
             offered_rps: Optional[float] = None) -> Dict:
    """Score one replayed trace.

    ``outputs`` is everything the front-end delivered — completions and
    rejections; ``duration_s`` is the replay span (virtual or wall) used
    as the rate denominator.  Returns a flat JSON-ready dict.
    """
    done: List[RequestOutput] = [
        o for o in outputs
        if o.reject_reason is None and o.fault_reason is None
    ]
    rejected = [o for o in outputs if o.reject_reason is not None]
    # terminal faults (quarantined / shed / deadline / cancelled) are not
    # completions and not rejections: the engine accepted them but could
    # not (or was told not to) finish them — scored separately
    faulted = [o for o in outputs if o.fault_reason is not None]
    by_reason: Dict[str, int] = {}
    for o in rejected:
        by_reason[o.reject_reason] = by_reason.get(o.reject_reason, 0) + 1
    faults_by_reason: Dict[str, int] = {}
    for o in faulted:
        faults_by_reason[o.fault_reason] = faults_by_reason.get(o.fault_reason, 0) + 1
    n_cancelled = sum(1 for o in faulted
                      if o.fault_reason in CANCEL_CLASS)
    ttfts = [o.timing.ttft_s for o in done if o.timing is not None]
    itls = [o.timing.mean_itl_s for o in done if o.timing is not None]
    queue = [o.timing.queue_time_s for o in outputs if o.timing is not None]
    n = len(outputs)
    dur = max(duration_s, 1e-9)
    n_good = sum(1 for o in done if slo.met_by(o)) if slo is not None else len(done)
    rep = {
        "n_offered": n,
        "n_completed": len(done),
        "n_rejected": len(rejected),
        "rejected_by_reason": by_reason,
        "n_faulted": len(faulted) - n_cancelled,
        "n_cancelled": n_cancelled,
        "faulted_by_reason": faults_by_reason,
        "rejection_rate": len(rejected) / max(n, 1),
        "duration_s": duration_s,
        "offered_rps": (offered_rps if offered_rps is not None else n / dur),
        "completed_rps": len(done) / dur,
        "completed_tok_s": sum(o.gen_len for o in done) / dur,
        "queue_p50_s": float(np.percentile(queue, 50)) if queue else 0.0,
        **{f"ttft_{k}_s": v for k, v in _pcts(ttfts).items()},
        **{f"itl_{k}_s": v for k, v in _pcts(itls).items()},
        "itl_max_s": max((o.timing.max_itl_s for o in done
                          if o.timing is not None), default=0.0),
    }
    if slo is not None:
        rep.update({
            "slo_ttft_s": slo.ttft_s,
            "slo_itl_s": slo.itl_s,
            "n_slo_met": n_good,
            "slo_attainment": n_good / max(n, 1),
            "goodput_rps": n_good / dur,
        })
    return rep
