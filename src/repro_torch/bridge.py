"""Carry the reference's parameters across into the port.

The reference keeps a param pytree with each pattern slot stacked under a
leading unit axis (``units/slot{i}``) plus an unrolled remainder list
(``rem``).  :func:`params_from_reference` takes that pytree as numpy
arrays — ``jax.tree.map(np.asarray, params)`` on the reference side — and
returns the port's per-layer layout (``models.transformer``) as float32
tensors on ``device``.  :func:`plan_from_reference` carries a calibrated
reference plan's scales (its ``act_scales`` and ``kv_scales`` tuples) into
a port plan, so both packages can run on identical scales.  No reference
module is imported here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import ExecutionPlan


def _tensors(tree, device, pick=None):
    if isinstance(tree, dict):
        return {k: _tensors(v, device, pick) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device, pick) for v in tree]
    a = np.asarray(tree)
    if pick is not None:
        a = a[pick]
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def params_from_reference(tree: Dict[str, Any], cfg: ArchConfig, device) -> Dict[str, Any]:
    """Reference pytree (numpy leaves) -> port params on ``device``."""
    p = len(cfg.block_pattern)
    n_units = cfg.n_pattern_units
    layers = []
    for li in range(cfg.n_layers):
        if li < n_units * p:
            layers.append(_tensors(tree["units"][f"slot{li % p}"], device, pick=li // p))
        else:
            layers.append(_tensors(tree["rem"][li - n_units * p], device))
    return {
        "embedding": _tensors(tree["embedding"], device),
        "head": _tensors(tree.get("head", {}), device),
        "final_norm": _tensors(tree["final_norm"], device),
        "layers": layers,
    }


def plan_from_reference(act_scales: Sequence[Tuple[str, float]],
                        kv_scales: Sequence[Tuple[str, Sequence[float]]],
                        base_plan) -> ExecutionPlan:
    """``base_plan`` (any ``ExecutionPlan.from_spec`` form) with the
    reference plan's calibrated scales: ``act_scales`` as ``(site,
    scale)`` pairs and ``kv_scales`` as ``(site, per-KV-head scales)``,
    taken over as plain Python floats."""
    return dataclasses.replace(
        ExecutionPlan.from_spec(base_plan),
        act_scales=tuple((str(s), float(a)) for s, a in act_scales),
        kv_scales=tuple((str(s), tuple(float(x) for x in v)) for s, v in kv_scales))
