"""Measured per-request serving latency (port of the timing half of
``repro.serve.accounting``; the modeled chip cost comes with the chip
model).  All times are anchored at submission."""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class RequestTiming:
    """queue_time_s: submit -> admission; ttft_s: submit -> first token on
    the host; wall_time_s: submit -> completion; mean_itl_s: (last - first
    token) / (n_tokens - 1); max_itl_s: worst gap between token events (a
    decode chunk delivers its tokens as one event)."""

    queue_time_s: float
    ttft_s: float
    wall_time_s: float
    mean_itl_s: float
    max_itl_s: float
    n_token_events: int = 0


def request_timing(t_submit: float, t_admit: float, t_first: float,
                   token_events: Sequence[Tuple[float, int]],
                   t_done: float) -> RequestTiming:
    """Fold raw engine timestamps into a :class:`RequestTiming`;
    ``token_events`` is ``[(host_time, n_tokens)]`` in arrival order."""
    n_tokens = sum(n for _, n in token_events)
    gaps = [b[0] - a[0] for a, b in zip(token_events, token_events[1:])]
    span = token_events[-1][0] - token_events[0][0] if token_events else 0.0
    return RequestTiming(
        queue_time_s=max(t_admit - t_submit, 0.0),
        ttft_s=max(t_first - t_submit, 0.0),
        wall_time_s=max(t_done - t_submit, 0.0),
        mean_itl_s=span / max(n_tokens - 1, 1),
        max_itl_s=max(gaps, default=0.0),
        n_token_events=len(token_events),
    )
