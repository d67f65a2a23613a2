"""Deterministic arrival processes for the open-loop load generator
(port of ``repro.traffic.arrivals``).

Every function here is a pure map ``(parameters, rng) -> arrival times``:
times are offsets in seconds from the start of the trace, produced by a
caller-owned ``numpy.random.Generator`` — **no wall clock anywhere**.
Two calls with equally seeded generators produce bit-identical traces;
what "a second" means
is decided later, by the replay clock (``repro_torch.traffic.replay``).

* :func:`poisson_arrivals` — the classic open-loop model: exponential
  i.i.d. inter-arrival gaps at ``rate_rps`` requests/second.  Memoryless,
  so instantaneous load fluctuates around the offered rate.
* :func:`bursty_arrivals` — an on/off burst process: burst *epochs*
  arrive Poisson at ``rate_rps / burst_size``, and each epoch releases
  ``burst_size`` requests over a short intra-burst spread.  Same average
  offered load as the Poisson trace, far worse peak-to-mean ratio — the
  trace that exercises bounded-queue backpressure and queue-timeout
  rejection.
"""
from __future__ import annotations

import numpy as np


def poisson_arrivals(rate_rps: float, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """``n`` Poisson arrival times (seconds from trace start), float64."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps={rate_rps} must be > 0")
    if n < 0:
        raise ValueError(f"n={n} must be >= 0")
    return np.cumsum(rng.exponential(1.0 / rate_rps, n))


def bursty_arrivals(rate_rps: float, n: int, rng: np.random.Generator,
                    burst_size: int = 8,
                    burst_spread_s: float = 0.0) -> np.ndarray:
    """``n`` bursty arrival times with the same mean rate as Poisson.

    Burst epochs are Poisson at ``rate_rps / burst_size``; each epoch
    contributes ``burst_size`` arrivals (the last burst is truncated to
    reach exactly ``n``) spaced uniformly within ``burst_spread_s``
    seconds of the epoch.  ``burst_spread_s=0`` packs each burst into a
    single instant — the hardest case for the admission queue.
    """
    if burst_size < 1:
        raise ValueError(f"burst_size={burst_size} must be >= 1")
    if burst_spread_s < 0:
        raise ValueError(f"burst_spread_s={burst_spread_s} must be >= 0")
    n_bursts = -(-n // burst_size)
    epochs = poisson_arrivals(rate_rps / burst_size, n_bursts, rng)
    times = []
    for e in epochs:
        k = min(burst_size, n - len(times))
        offs = (rng.uniform(0.0, burst_spread_s, k) if burst_spread_s > 0
                else np.zeros(k))
        times.extend(e + np.sort(offs))
    return np.asarray(times[:n])


ARRIVAL_PROCESSES = ("poisson", "bursty")
