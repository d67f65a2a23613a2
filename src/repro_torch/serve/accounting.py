"""Per-request serving accounting (port of ``repro.serve.accounting``):
the modeled ASTRA chip cost of each request's own workload, from
``core.simulator.simulate``, beside its measured latency.

The chip cost is the photonic accelerator's, as the paper models it: a
prefill over the prompt's uncached suffix plus ``gen_len`` single-token
forwards, amortized at the final sequence length; energy is attributed
per GEMM site class (``attn.qk``, ``rglru.in_proj``, ...).  It is not a
measurement of the card that serves the port.  All measured times are
anchored at submission.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Sequence, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.energy import AstraChipConfig
from repro_torch.core.plan import site_class
from repro_torch.core.simulator import simulate


@dataclasses.dataclass(frozen=True)
class RequestHardwareReport:
    """Modeled ASTRA latency and energy of one request.  Prompt tokens
    served from the paged prefix cache (``cached_prompt_tokens``) are
    billed at zero: their KV was paid for by the request that interned it."""

    latency_s: float
    energy_j: float
    macs: int
    energy_per_mac_j: float
    # energy per site class (layer-stripped op id), descending
    energy_by_site: Tuple[Tuple[str, float], ...] = ()
    prompt_tokens: int = 0
    cached_prompt_tokens: int = 0

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["energy_by_site"] = dict(self.energy_by_site)
        return d


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


@lru_cache(maxsize=4096)
def _simulate_cached(cfg: ArchConfig, chip: AstraChipConfig, seq: int):
    rep = simulate(cfg, chip, seq=seq, batch=1)
    by_site: Dict[str, float] = {}
    for c in rep.op_costs:
        key = site_class(c.name)
        by_site[key] = by_site.get(key, 0.0) + c.total_energy_j
    return rep.latency_s, rep.total_energy_j, rep.macs, tuple(sorted(by_site.items()))


def request_hardware_report(cfg: ArchConfig, chip: AstraChipConfig,
                            prompt_len: int, gen_len: int,
                            cached_prompt_len: int = 0) -> RequestHardwareReport:
    """Modeled chip cost of one request: one forward over the uncached
    prompt suffix (at least one token), then ``gen_len`` decode steps
    approximated, as the paper's methodology does, by one forward at the
    final sequence length scaled by ``gen_len / (prompt_len + gen_len)``."""
    lat = en = macs = 0.0
    sites: Dict[str, float] = {}
    billed_prompt = max(prompt_len - cached_prompt_len, 1)
    p_lat, p_en, p_macs, p_sites = _simulate_cached(cfg, chip, billed_prompt)
    lat, en, macs = lat + p_lat, en + p_en, macs + p_macs
    for k, v in p_sites:
        sites[k] = sites.get(k, 0.0) + v
    if gen_len > 0:
        d_lat, d_en, d_macs, d_sites = _simulate_cached(cfg, chip, prompt_len + gen_len)
        scale = gen_len / max(prompt_len + gen_len, 1)
        lat += d_lat * scale
        en += d_en * scale
        macs += d_macs * scale
        for k, v in d_sites:
            sites[k] = sites.get(k, 0.0) + v * scale
    by_site = tuple(sorted(sites.items(), key=lambda kv: -kv[1]))
    return RequestHardwareReport(lat, en, int(macs), en / max(macs, 1.0), by_site,
                                 prompt_tokens=prompt_len,
                                 cached_prompt_tokens=cached_prompt_len)
