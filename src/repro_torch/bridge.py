"""Carry the reference's parameters across into the port.

The reference keeps a param pytree with each pattern slot stacked under a
leading unit axis (``units/slot{i}``) plus an unrolled remainder list
(``rem``).  :func:`params_from_reference` takes that pytree as numpy
arrays — ``jax.tree.map(np.asarray, params)`` on the reference side — and
returns the port's per-layer layout (``models.transformer``) as float32
tensors on ``device``; it takes any tree of the params' structure, so
``jax.grad``'s tree crosses the same way.  :func:`opt_state_from_reference`
does the same for AdamW's ``m``/``v`` and carries ``step``, and
:func:`checkpoint_from_reference` reads a checkpoint the reference's
``save_checkpoint`` wrote (its stacked ``units.slot{i}`` leaves) into the
port's params and optimizer state.  :func:`plan_from_reference` carries a calibrated
reference plan's scales (its ``act_scales`` and ``kv_scales`` tuples) into
a port plan, so both packages can run on identical scales.  No reference
module is imported here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import read_checkpoint
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


def opt_state_from_reference(tree: Dict[str, Any], cfg: ArchConfig, device) -> Dict[str, Any]:
    """The reference's AdamW state ``{"m", "v", "step"}`` (numpy leaves) ->
    the port's: ``m``/``v`` unstacked as params are, ``step`` an int32
    tensor on ``device``."""
    return {"m": params_from_reference(tree["m"], cfg, device),
            "v": params_from_reference(tree["v"], cfg, device),
            "step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                                 device=device)}


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Dotted names -> nested dicts, a dict whose keys are all indices
    becoming a list (the reference's ``rem``)."""
    root: Dict[str, Any] = {}
    for name, leaf in flat.items():
        node = root
        *parents, last = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def checkpoint_from_reference(ckpt_dir: str, step: int, cfg: ArchConfig,
                              device) -> Tuple[Dict[str, Any], Dict]:
    """A checkpoint the reference's ``save_checkpoint`` wrote of its train
    state ``{"params", "opt"}`` -> (the port's ``{"params", "opt"}`` on
    ``device``, the manifest's metadata).  Reads the files only."""
    flat, metadata = read_checkpoint(ckpt_dir, step)
    tree = _nest({k: v.to(torch.float32).numpy() if v.is_floating_point() else v.numpy()
                  for k, v in flat.items()})
    return ({"params": params_from_reference(tree["params"], cfg, device),
             "opt": opt_state_from_reference(tree["opt"], cfg, device)}, metadata)


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
