"""A sharded ZeRO-3 (FSDP) train step over ``torch.distributed`` process
groups.

Params, AdamW's ``m``/``v`` and the batch are stored as the rule table
says (``parallel.sharding``): params, ``m`` and ``v`` as DTensors under
``param_specs``, the batch's rows split by ``batch_specs``.  In the step
each param is gathered in full, ``Model.loss`` runs on this rank's rows
(with a :class:`~repro_torch.parallel.dp.DataParallel`, so the loss is the
global batch's), the gradients are summed over the data-parallel axes only
and cut back to each leaf's placements, the clip norm is taken over every
element once, and AdamW runs on the local shards.  The ``model`` axis
shards storage only: every rank computes on full weights.

The step takes three collectives on the DeviceMesh's groups: gathers by
``all_gather_into_tensor`` over each mesh dim's group, innermost first;
gradients by ``reduce_scatter_tensor`` (``all_reduce`` where the leaf is
not split) over each data-parallel mesh dim's group, outermost first.
Every sum is of distinct terms.  :func:`probe_collectives` checks up
front that the process group takes all three on the step's device
(gloo on the CPU and on CUDA tensors, and NCCL, do) and raises, naming
the refused one and the device, where it does not.  They are
``torch.distributed``'s own calls, not DTensor's functional ones (on
torch 2.11 DTensor's ``full_tensor`` over gloo on a CUDA tensor crashes
its process).

Each rank gathers every param in full float32 for the forward pass and
keeps full float32 gradients until they are reduced: at least 8 bytes a
param a rank (:func:`gathered_bytes`).  The builder refuses, naming the
bytes, a model whose 8 bytes a param exceed the card's memory.

A MoE layer's dispatch groups must not be cut: a rank's token count must
be a multiple of the one-process step's group length, else the split is
refused (regrouping changes the capacity, and with it which tokens drop).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from repro_torch import tree as tree_util
from repro_torch.models.model import Model
from repro_torch.models.moe import group_len
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.parallel.dp import DataParallel
from repro_torch.parallel.sharding import (
    Spec, _axes, axis_sizes, batch_specs, distribute_tree, holds_first_copy, leaves_with_paths,
    local_block, mesh_coords, mesh_device, param_specs, placements, zip_map,
)

COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")


def probe_collectives(device) -> str:
    """Try each collective of the step once on a tiny tensor on ``device``
    over the default group; raise, naming the refused collectives and the
    device, unless the group takes all three.  Returns the line that says
    so."""
    import torch.distributed as dist

    n = dist.get_world_size()
    x = torch.ones(n, device=device)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(n * n, device=device), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(1, device=device), x.clone()),
    }
    refused = []
    for name, call in calls.items():
        try:
            call()
        except (RuntimeError, NotImplementedError, ValueError) as e:
            refused.append(f"{name} ({e})")
    if refused:
        raise RuntimeError(f"the {dist.get_backend()} group refuses on {device}: "
                           + "; ".join(refused))
    return ", ".join(f"{name} yes" for name in COLLECTIVES)


def gathered_bytes(model: Model) -> int:
    """Bytes a rank holds in the step beyond its shards and activations:
    every param gathered in full float32 and its full float32 gradient."""
    return 8 * sum(t.numel() for t in tree_util.leaves(model.param_shapes()))


def refuse_unless_fits(model: Model, capacity: int) -> None:
    """Raise, naming the bytes, when :func:`gathered_bytes` exceeds
    ``capacity`` (a card's memory in bytes)."""
    need = gathered_bytes(model)
    if need > capacity:
        raise ValueError(
            f"{model.cfg.name}: the sharded step gathers every param in full on each rank, "
            f"{need} B of float32 params and gradients, more than the card's {capacity} B")


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


class ShardedTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "aux", "grad_norm"})`` on ``mesh``: ``params``, ``opt_state["m"]`` and
    ``["v"]`` DTensor trees (:meth:`shard_state`), ``batch`` the global
    batch (every rank passes the same; each takes its rows).  Functional,
    as the one-process step."""

    def __init__(self, model: Model, ocfg: AdamWConfig, mesh, strategy: str,
                 total_steps: int, warmup: int, probe: str):
        self.model, self.ocfg, self.mesh, self.strategy = model, ocfg, mesh, strategy
        self.total_steps, self.warmup = total_steps, warmup
        self.probe = probe
        self.sizes = axis_sizes(mesh)
        self.coords = mesh_coords(mesh)
        self.device = mesh_device(mesh)

    # ------------------------------------------------------------- state
    def specs(self, params):
        return param_specs(params, self.sizes, self.strategy)

    def shard_state(self, state) -> Dict[str, Any]:
        """A full ``{"params", "opt": {"m", "v", "step"}}`` (every rank
        holds the same) -> this rank's: params, ``m``, ``v`` as DTensors,
        ``step`` a tensor on the mesh's device."""
        specs = self.specs(state["params"])
        opt = state["opt"]
        return {"params": distribute_tree(state["params"], specs, self.mesh),
                "opt": {"m": distribute_tree(opt["m"], specs, self.mesh),
                        "v": distribute_tree(opt["v"], specs, self.mesh),
                        "step": _local(opt["step"]).to(self.device)}}

    def gather(self, x) -> torch.Tensor:
        """The full tensor of a DTensor leaf, on every rank."""
        import torch.distributed as dist
        from torch.distributed.tensor import Shard

        t = x.to_local()
        for i in reversed(range(len(self.sizes))):  # innermost split first
            p, n = x.placements[i], self.mesh.size(i)
            if isinstance(p, Shard) and n > 1:
                src = t.movedim(p.dim, 0).contiguous()
                out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                                  dtype=src.dtype, device=src.device)
                dist.all_gather_into_tensor(out, src, group=self.mesh.get_group(i))
                t = out.movedim(0, p.dim)
        return t.contiguous()

    def full_state(self, state) -> Dict[str, Any]:
        """The full arrays of a sharded state (collective: every rank calls
        it), in the one-process layout: a checkpoint of either loads into
        the other."""
        opt = state["opt"]
        full = lambda t: tree_util.map_leaves(self.gather, t)  # noqa: E731
        return {"params": full(state["params"]),
                "opt": {"m": full(opt["m"]), "v": full(opt["v"]),
                        "step": _local(opt["step"])}}

    # ------------------------------------------------------------- batch
    def dp_axes(self, batch) -> tuple:
        """The mesh axes the batch's rows are split over (``batch_specs``)."""
        spec = batch_specs({"tokens": batch["tokens"]}, self.sizes, self.strategy)["tokens"]
        return _axes(spec[0])

    def shard_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global ``batch``, on the mesh's device;
        a split that would cut a MoE dispatch group is refused."""
        specs = batch_specs(batch, self.sizes, self.strategy)
        cfg = self.model.cfg
        if cfg.moe is not None:
            tok = batch["tokens"]
            seq = tok.shape[-1]
            total = tok.shape[0] * seq
            n = math.prod(self.sizes[a] for a in self.dp_axes(batch))
            g = group_len(total)
            if (total // n) % g:
                raise ValueError(
                    f"{cfg.name}: {n} data-parallel ranks split {total} tokens into "
                    f"{total // n} a rank, which cuts the one-process step's MoE dispatch "
                    f"groups of {g} tokens (a rank must hold whole groups)")
        return zip_map(lambda t, s: local_block(torch.as_tensor(t), s, self.sizes, self.coords)
                       .to(self.device), batch, specs)

    # -------------------------------------------------------------- step
    def reduce_grad(self, g: torch.Tensor, spec, dp_axes) -> torch.Tensor:
        """This rank's block of the gradient summed over the DP ranks."""
        import torch.distributed as dist
        from torch.distributed.tensor import Shard

        t = g
        for i, (name, p) in enumerate(zip(self.sizes, placements(spec, self.sizes))):
            n = self.mesh.size(i)  # outermost split first
            if name in dp_axes and n > 1 and isinstance(p, Shard):
                src = t.movedim(p.dim, 0).contiguous()
                out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                                  dtype=src.dtype, device=src.device)
                dist.reduce_scatter_tensor(out, src, group=self.mesh.get_group(i))
                t = out.movedim(0, p.dim)
            elif name in dp_axes and n > 1:
                t = t.contiguous()
                dist.all_reduce(t, group=self.mesh.get_group(i))
            elif isinstance(p, Shard):
                t = t.chunk(n, dim=p.dim)[self.coords[name]]
        return t.contiguous()

    def global_norm(self, grads: List[torch.Tensor], specs: List[Spec]) -> torch.Tensor:
        """|g| over every element once: each block's squares counted by its
        first holder, summed over the world."""
        import torch.distributed as dist

        sq = torch.stack([torch.sum(torch.square(g.to(torch.float32)))
                          * float(holds_first_copy(s, self.sizes, self.coords))
                          for g, s in zip(grads, specs)]).sum()
        dist.all_reduce(sq)
        return torch.sqrt(sq)

    def loss_and_grads(self, params, batch):
        """(the global batch's loss, ``{"loss", "aux"}``, per leaf
        ``(this rank's block of the gradient, its spec, the leaf's full
        shape)``)."""
        local_batch = self.shard_batch(batch)  # refuses a cut dispatch group first
        specs = [s for _, s in leaves_with_paths(self.specs(params))]
        leaves = tree_util.leaves(params)
        live = [self.gather(p).detach().requires_grad_(True) for p in leaves]
        dp = DataParallel(self.dp_axes(batch), self.sizes, self.coords)
        loss, metrics = self.model.loss(tree_util.unflatten(params, live), local_batch, dp=dp)
        grads = torch.autograd.grad(loss, live)
        del live
        return loss.detach(), metrics, [(self.reduce_grad(g, s, dp.axes), s, tuple(p.shape))
                                         for g, s, p in zip(grads, specs, leaves)]

    def __call__(self, params, opt_state, batch):
        from torch.distributed.tensor import DTensor

        loss, metrics, grads = self.loss_and_grads(params, batch)
        g_local = [g for g, _, _ in grads]
        gnorm = self.global_norm(g_local, [s for _, s, _ in grads])
        leaves = tree_util.leaves(params)
        step = _local(opt_state["step"])
        lr_scale = cosine_schedule(step, self.warmup, self.total_steps)
        p_local = [p.to_local() for p in leaves]
        m_local = [m.to_local() for m in tree_util.leaves(opt_state["m"])]
        v_local = [v.to_local() for v in tree_util.leaves(opt_state["v"])]
        p2, o2, stats = adamw_update(
            p_local, g_local, {"m": m_local, "v": v_local, "step": step},
            self.ocfg, lr_scale, gnorm=gnorm)

        def wrap(tree, new):
            return tree_util.unflatten(tree, [
                DTensor.from_local(n, self.mesh, old.placements, run_check=False,
                                   shape=old.shape, stride=old.stride())
                for n, old in zip(new, tree_util.leaves(tree))])

        return (wrap(params, p2),
                {"m": wrap(opt_state["m"], o2["m"]), "v": wrap(opt_state["v"], o2["v"]),
                 "step": o2["step"]},
                {"loss": loss.detach(), "aux": metrics["aux"].detach(), **stats})


def build_sharded_train_step(model: Model, ocfg: AdamWConfig, mesh, strategy: str = "tp_fsdp",
                             total_steps: int = 100, warmup: int = 20):
    """The train step on ``mesh`` (a ``DeviceMesh``): a
    :class:`ShardedTrainStep`, once the group takes its collectives on
    the model's device and, on a card, the gathered params and gradients
    fit its memory.  ``mesh=None`` is the one-process step,
    ``launch.train.build_train_step``, as it is."""
    if mesh is None:
        from repro_torch.launch.train import build_train_step

        return build_train_step(model, ocfg, total_steps, warmup)
    if model.device.type == "cuda":
        refuse_unless_fits(model, torch.cuda.get_device_properties(model.device).total_memory)
    probe = probe_collectives(model.device)
    return ShardedTrainStep(model, ocfg, mesh, strategy, total_steps, warmup, probe)
