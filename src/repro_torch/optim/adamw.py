"""AdamW with float32 moments, global-norm clipping and decoupled decay.

Port of ``repro.optim.adamw``: functional over the port's param tree
(nested dicts and lists of tensors).  ``adamw_update`` returns new
params and state and leaves its inputs as they were; the moments ``m``,
``v`` are float32 whatever the param dtype, and ``step`` is an int32
tensor on the params' device, so a step makes no host sync.  The
per-leaf arithmetic runs as ``torch._foreach_*`` calls over every leaf
at once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch import tree as tree_util


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params) -> Dict[str, Any]:
    flat = tree_util.leaves(params)
    device = flat[0].device if flat else None
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"m": tree_util.map_leaves(zeros, params),
            "v": tree_util.map_leaves(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    flat = [leaf.to(torch.float32) for leaf in tree_util.leaves(tree)]
    return torch.sqrt(torch.stack([torch.sum(torch.square(leaf)) for leaf in flat]).sum())


def adamw_update(params, grads, state, cfg: AdamWConfig,
                 lr_scale: Union[torch.Tensor, float] = 1.0,
                 gnorm: Optional[torch.Tensor] = None,
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One step: gradients scaled by ``min(1, clip_norm / |g|)``, moments
    updated, the bias-corrected step plus ``weight_decay * p`` taken at
    ``lr * lr_scale``.  Returns (params, state, {"grad_norm"}).  ``gnorm``
    is ``|g|`` when the caller has it (a sharded step: ``grads`` are this
    rank's shards), else ``global_norm(grads)``."""
    p = tree_util.leaves(params)
    g = [leaf.to(torch.float32) for leaf in tree_util.leaves(grads)]
    m, v = tree_util.leaves(state["m"]), tree_util.leaves(state["v"])
    if not (len(p) == len(g) == len(m) == len(v)):
        raise ValueError(f"adamw_update: {len(p)} params, {len(g)} grads, {len(m)} m, "
                         f"{len(v)} v")
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=gnorm.device)

    g = torch._foreach_mul(g, scale)
    m2 = torch._foreach_mul(m, cfg.b1)
    torch._foreach_add_(m2, torch._foreach_mul(g, 1 - cfg.b1))
    v2 = torch._foreach_mul(v, cfg.b2)
    torch._foreach_add_(v2, torch._foreach_mul(torch._foreach_mul(g, 1 - cfg.b2), g))
    denom = torch._foreach_div(v2, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    update = torch._foreach_div(m2, bc1)
    torch._foreach_div_(update, denom)
    pf = [leaf.to(torch.float32) for leaf in p]
    torch._foreach_add_(update, torch._foreach_mul(pf, cfg.weight_decay))
    torch._foreach_mul_(update, lr)
    p2 = [new.to(old.dtype) for new, old in zip(torch._foreach_sub(pf, update), p)]
    return (tree_util.unflatten(params, p2),
            {"m": tree_util.unflatten(state["m"], m2), "v": tree_util.unflatten(state["v"], v2),
             "step": step},
            {"grad_norm": gnorm})
