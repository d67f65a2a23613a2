"""Single-device training driver: data -> model -> AdamW -> checkpoint/restart.

Port of ``repro.launch.train`` on one device.  The train step is
``Model.loss`` (cross entropy with z-loss, the MoE load-balance loss,
each pattern period under activation checkpointing) and its gradient,
then the cosine schedule and ``adamw_update``; float32 masters, compute
in the config's dtype.  Around it: step-addressable synthetic data
(optionally prefetched with a straggler deadline), atomic async
checkpoints every ``--ckpt-every`` steps with automatic resume from the
newest, and an injected fault schedule (``--fail-at 12,27``) to show
recovery.  The data and the checkpoints are exact, so a resumed run
reproduces the fault-free loss trajectory bit for bit on one device and
one set of kernels.

Runs on the card unless ``--device cpu``.  ``--production-mesh`` trains
sharded over the 16 x 16 ``("data", "model")`` mesh (``parallel.step``:
ZeRO-3 storage by the rule table, ``tp_fsdp``) on every rank of a
launcher's world, which must be the mesh's size (``WORLD_SIZE``; the
group comes from the launcher's ``env://``, or is the one already
initialised); rank 0 writes the checkpoints, full arrays that a
one-process run reads as its own.

Usage (a reduced model on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \
      --device cpu --steps 24 --batch 2 --seq 32 --ckpt-every 8 --ckpt-dir /tmp/ck \
      --fail-at 17
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, Prefetcher, SyntheticLMDataset, batch_to
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import MeshShape, make_mesh, mesh_shape
from repro_torch.models.model import Model
from repro_torch.models.transformer import ModelOptions
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from repro_torch.parallel.step import build_sharded_train_step
from repro_torch.runtime import FaultInjector, run_with_restarts
from repro_torch.runtime.elastic import ShardedCheckpoints


def _join_world(spec: MeshShape, cuda: bool) -> None:
    """Join the launcher's group (``env://``; NCCL with one card a rank,
    at ``LOCAL_RANK``) unless one is initialised; the world must be the
    mesh's size."""
    import torch.distributed as dist

    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != spec.size:
        raise SystemExit(f"mesh {spec.label} over {spec.mesh_dim_names}: needs a world of "
                         f"{spec.size} ranks; the launcher's world size is {world}")
    if not dist.is_initialized():
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if cuda else "gloo", init_method="env://")


def build_train_step(model: Model, ocfg: AdamWConfig, total_steps: int, warmup: int):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: the loss and its gradient with respect to
    every leaf of ``params``, then one AdamW step at the cosine schedule's
    rate.  Functional: the inputs are left as they were."""

    def train_step(params, opt_state, batch):
        live = [p.detach().requires_grad_(True) for p in tree_util.leaves(params)]
        loss, _ = model.loss(tree_util.unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
        lr_scale = cosine_schedule(opt_state["step"], warmup, total_steps)
        params2, opt2, stats = adamw_update(params, tree_util.unflatten(params, list(grads)),
                                            opt_state, ocfg, lr_scale)
        return params2, opt2, {"loss": loss.detach(), **stats}

    return train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", default="", help="comma-separated steps to inject faults")
    ap.add_argument("--production-mesh", action="store_true",
                    help="shard over the 16 x 16 mesh (a launcher's world of 256)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--prefetch", action="store_true",
                    help="background data prefetch w/ straggler deadline+backup")
    ap.add_argument("--prefetch-timeout", type=float, default=30.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    spec = mesh_shape() if args.production_mesh else None
    if spec is not None:
        _join_world(spec, cuda=resolve_device(args.device).type == "cuda")
    device = resolve_device(args.device)
    mesh = None if spec is None else make_mesh(spec, device.type)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, ModelOptions(), device=device)
    ocfg = AdamWConfig(lr=args.lr)

    dcfg = DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=args.seed,
        n_codebooks=cfg.n_codebooks, vision_tokens=cfg.vision_tokens, d_model=cfg.d_model,
    )
    dataset = SyntheticLMDataset(dcfg)
    prefetcher = (Prefetcher(dataset, timeout_s=args.prefetch_timeout).start()
                  if args.prefetch else None)
    injector = FaultInjector(int(s) for s in args.fail_at.split(",") if s)
    train_step = build_sharded_train_step(model, ocfg, mesh, "tp_fsdp", args.steps, args.warmup)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    def init_state():
        params = model.init(args.seed)
        state = {"params": params, "opt": adamw_init(params)}
        return state if mesh is None else train_step.shard_state(state)

    if mesh is not None and mgr is not None:
        shapes = model.param_shapes()
        mgr = ShardedCheckpoints(CheckpointManager(args.ckpt_dir, async_write=False),
                                 train_step, {"params": shapes, "opt": adamw_init(shapes)})

    t_last = [time.time()]

    def step_fn(state, step):
        injector.check(step)
        batch = prefetcher.get(step) if prefetcher else dataset.batch_at(step)
        params, opt, metrics = train_step(state["params"], state["opt"],
                                          batch_to(batch, device) if mesh is None else batch)
        return {"params": params, "opt": opt}, metrics

    quiet = mesh is not None and torch.distributed.get_rank() != 0

    def on_metrics(step, m):
        if quiet:
            return
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t_last[0]
            t_last[0] = time.time()
            print(f"step {step:5d}  loss {m['loss']:.4f}  gnorm {m.get('grad_norm', 0):.3f}  "
                  f"({dt:.2f}s)", flush=True)

    try:
        summary = run_with_restarts(
            init_state=init_state, step_fn=step_fn, n_steps=args.steps,
            ckpt_manager=mgr, ckpt_every=args.ckpt_every, on_metrics=on_metrics,
        )
        if mgr:
            mgr.save(args.steps - 1, summary["state"], metadata={"final": True})
            mgr.wait()
    finally:
        if prefetcher:
            prefetcher.stop()
    if prefetcher and prefetcher.substituted_steps:
        print(f"straggler substitutions at steps {prefetcher.substituted_steps}")
    losses = [m["loss"] for m in summary["metrics"].values()]
    if quiet:
        return summary
    print(f"done: {len(losses)} steps, restarts={summary['restarts']}, "
          f"first-loss {losses[0]:.4f} last-loss {losses[-1]:.4f}, wall {summary['wall_s']:.1f}s")
    return summary


if __name__ == "__main__":
    main()
