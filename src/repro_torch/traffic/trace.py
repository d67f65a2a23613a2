"""Traffic traces: a fully materialized, replayable request schedule.

A :class:`TrafficTrace` is the load generator's output — every request's
arrival offset, prompt tokens, generation budget, and scenario label,
fixed before any serving happens.  Generation is a pure function of
``(suite, rate, n, seed, arrival process)``: one seeded
``numpy.random.Generator`` drives both the arrival gaps and the request
sampling, so two calls with the same arguments produce bit-identical
traces (and the replay of a trace never consults the generator again).

Traces round-trip through JSON (``save``/``load``) so a trace can be
pinned as a CLI artifact (``repro_torch.launch.serve --traffic-trace
trace.json``)
or regenerated on the fly from a spec string like ``"chat:rate=2,n=64"``
(:func:`parse_trace_spec`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

import numpy as np

from repro_torch.traffic.arrivals import (
    ARRIVAL_PROCESSES, bursty_arrivals, poisson_arrivals,
)
from repro_torch.traffic.scenarios import SUITES, sample_requests, suite_max_total_len


@dataclasses.dataclass(frozen=True)
class TracedRequest:
    arrival_s: float  # offset from trace start (virtual or wall — replay decides)
    prompt: np.ndarray  # [S] or [C, S] int32
    max_new_tokens: int
    scenario: str

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[-1])


@dataclasses.dataclass(frozen=True)
class TrafficTrace:
    suite: str
    rate_rps: float  # offered load the arrivals were drawn at
    seed: int
    arrival: str  # "poisson" | "bursty"
    requests: List[TracedRequest]

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def duration_s(self) -> float:
        """Span of the arrival schedule (last arrival offset)."""
        return self.requests[-1].arrival_s if self.requests else 0.0

    @property
    def max_total_len(self) -> int:
        return max((r.prompt_len + r.max_new_tokens for r in self.requests),
                   default=0)

    # ------------------------------------------------------------- JSON
    def to_dict(self) -> Dict:
        return {
            "suite": self.suite, "rate_rps": self.rate_rps, "seed": self.seed,
            "arrival": self.arrival,
            "requests": [
                {"arrival_s": r.arrival_s, "prompt": np.asarray(r.prompt).tolist(),
                 "max_new_tokens": r.max_new_tokens, "scenario": r.scenario}
                for r in self.requests
            ],
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "TrafficTrace":
        reqs = [TracedRequest(float(r["arrival_s"]),
                              np.asarray(r["prompt"], np.int32),
                              int(r["max_new_tokens"]), str(r["scenario"]))
                for r in d["requests"]]
        return cls(str(d["suite"]), float(d["rate_rps"]), int(d["seed"]),
                   str(d.get("arrival", "poisson")), reqs)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "TrafficTrace":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def generate_trace(suite: str, rate_rps: float, n: int, seed: int, vocab: int,
                   arrival: str = "poisson", n_codebooks: int = 0,
                   burst_size: int = 8) -> TrafficTrace:
    """Build a deterministic trace: ``n`` requests from ``SUITES[suite]``
    arriving at offered load ``rate_rps``.

    One generator seeded with ``seed`` drives arrivals *then* request
    sampling, so the trace is a pure function of the arguments.
    """
    if suite not in SUITES:
        raise ValueError(f"unknown suite {suite!r}; available: "
                         f"{', '.join(sorted(SUITES))}")
    if arrival not in ARRIVAL_PROCESSES:
        raise ValueError(f"unknown arrival process {arrival!r}; available: "
                         f"{', '.join(ARRIVAL_PROCESSES)}")
    rng = np.random.default_rng(seed)
    if arrival == "poisson":
        times = poisson_arrivals(rate_rps, n, rng)
    else:
        times = bursty_arrivals(rate_rps, n, rng, burst_size=burst_size)
    reqs = sample_requests(SUITES[suite], n, vocab, rng, n_codebooks)
    return TrafficTrace(suite, rate_rps, seed, arrival, [
        TracedRequest(float(t), p, g, name)
        for t, (name, p, g) in zip(times, reqs)
    ])


def parse_trace_spec(spec: str) -> Dict:
    """Parse a ``suite[:key=value,...]`` CLI spec into generate_trace kwargs.

    Example: ``"chat:rate=2.0,n=64,seed=1,arrival=bursty"``.  Returns a
    dict with ``suite``/``rate_rps``/``n``/``seed``/``arrival`` keys
    (missing keys defaulted); raises ``ValueError`` on unknown suites,
    keys, or processes so the CLI can report the offending value.
    """
    head, _, tail = spec.partition(":")
    if head not in SUITES:
        raise ValueError(f"unknown suite {head!r}; available: "
                         f"{', '.join(sorted(SUITES))}")
    out: Dict = {"suite": head, "rate_rps": 1.0, "n": 32, "seed": 0,
                 "arrival": "poisson"}
    if tail:
        for item in tail.split(","):
            k, sep, v = item.partition("=")
            if not sep:
                raise ValueError(f"bad trace spec item {item!r} "
                                 "(expected key=value)")
            if k == "rate":
                out["rate_rps"] = float(v)
            elif k == "n":
                out["n"] = int(v)
            elif k == "seed":
                out["seed"] = int(v)
            elif k == "arrival":
                if v not in ARRIVAL_PROCESSES:
                    raise ValueError(f"unknown arrival process {v!r}; "
                                     f"available: {', '.join(ARRIVAL_PROCESSES)}")
                out["arrival"] = v
            else:
                raise ValueError(f"unknown trace spec key {k!r} "
                                 "(known: rate, n, seed, arrival)")
    if out["rate_rps"] <= 0:
        raise ValueError(f"trace spec rate={out['rate_rps']} must be > 0")
    if out["n"] < 1:
        raise ValueError(f"trace spec n={out['n']} must be >= 1")
    return out


def trace_max_len(trace: TrafficTrace, headroom: int = 1) -> int:
    """Engine ``max_len`` floor for a trace (worst prompt+gen, plus slack)."""
    return trace.max_total_len + headroom


def suite_engine_max_len(suite: str, headroom: int = 1) -> int:
    """Engine ``max_len`` floor covering *any* trace from the suite."""
    return suite_max_total_len(SUITES[suite]) + headroom
