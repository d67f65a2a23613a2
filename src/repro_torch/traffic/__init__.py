"""Deterministic open-loop traffic generation, replay, and SLO scoring
(port of ``repro.traffic``; a trace is the reference's bit for bit).

The package splits cleanly into a *pure* half and a *time-passing* half:

* pure — :mod:`repro_torch.traffic.arrivals` (Poisson / bursty arrival
  processes), :mod:`repro_torch.traffic.scenarios` (chat / longdoc / agent
  fan-out suites), :mod:`repro_torch.traffic.trace` (materialized replayable
  traces; JSON round-trip; CLI spec parsing).  No wall clock anywhere:
  a trace is a pure function of ``(suite, rate, n, seed)``.
* time-passing — :mod:`repro_torch.traffic.replay` drives a
  :class:`~repro_torch.serve.frontend.ServeFrontend` with a trace on either a
  :class:`VirtualClock` (fully deterministic latency trajectories) or
  the wall clock; :mod:`repro_torch.traffic.slo` folds the resulting
  ``RequestTiming``s into p50/p95/p99 TTFT + ITL, rejection rate, and
  SLO-goodput.
"""
from repro_torch.traffic.arrivals import (
    ARRIVAL_PROCESSES, bursty_arrivals, poisson_arrivals,
)
from repro_torch.traffic.replay import ReplayResult, VirtualClock, replay_trace
from repro_torch.traffic.scenarios import SUITES, Scenario, suite_max_total_len
from repro_torch.traffic.slo import PERCENTILES, SLOConfig, evaluate
from repro_torch.traffic.trace import (
    TracedRequest, TrafficTrace, generate_trace, parse_trace_spec,
    suite_engine_max_len, trace_max_len,
)

__all__ = [
    "ARRIVAL_PROCESSES", "bursty_arrivals", "poisson_arrivals",
    "ReplayResult", "VirtualClock", "replay_trace",
    "SUITES", "Scenario", "suite_max_total_len",
    "PERCENTILES", "SLOConfig", "evaluate",
    "TracedRequest", "TrafficTrace", "generate_trace", "parse_trace_spec",
    "suite_engine_max_len", "trace_max_len",
]
