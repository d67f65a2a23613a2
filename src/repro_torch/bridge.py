"""Carry the reference's parameters across into the port.

The reference keeps a param pytree with each pattern slot stacked under a
leading unit axis (``units/slot{i}``) plus an unrolled remainder list
(``rem``).  :func:`params_from_reference` takes that pytree as numpy
arrays — ``jax.tree.map(np.asarray, params)`` on the reference side — and
returns the port's per-layer layout (``models.transformer``) as float32
tensors on ``device``.  No reference module is imported here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


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
