"""Rank functions for the port's multi-process tests (gloo on the CPU,
spawned by ``repro_torch.parallel.spawn``).  No JAX here: each rank
imports only this module and the port.  Each function writes what rank 0
saw to a file under ``out`` for the test to hold; any rank that fails an
assertion fails the spawn."""
import os

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import get_arch
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw_init

LR, TOTAL, WARMUP = 1e-3, 5, 1
SHARDED_STEP = 2  # the one-process steps taken before the sharded cases' step


def small_cfg(name):
    return get_arch(name).reduced(dtype="float32", n_layers=2)


def make_batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def one_process_state(cfg, seed=0):
    params = Model(cfg, device="cpu").init(seed)
    return {"params": params, "opt": adamw_init(params)}


def mid_run_state(cfg, b, s):
    """The state after ``SHARDED_STEP`` one-process steps on other batches:
    moments that are not zero, so Adam's step is not the sign of a
    gradient, and a learning rate past the warmup's 0."""
    from repro_torch.launch.train import build_train_step

    state = one_process_state(cfg)
    step = build_train_step(Model(cfg, device="cpu"), AdamWConfig(lr=LR), TOTAL, WARMUP)
    for i in range(SHARDED_STEP):
        batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, b, s, seed=10 + i).items()}
        p, o, _ = step(state["params"], state["opt"], batch)
        state = {"params": p, "opt": o}
    return state


def _mesh_on(shape, device_type):
    from repro_torch.launch.mesh import MeshShape, make_mesh

    return make_mesh(MeshShape(shape, ("data", "model")), device_type)


def _mesh(shape):
    return _mesh_on(shape, "cpu")


def _full_grads(step, grads):
    """Each rank's gradient blocks gathered to full tensors."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import placements

    out = []
    for g, spec, shape in grads:
        dt = DTensor.from_local(g, step.mesh, placements(spec, step.mesh), run_check=False,
                                shape=shape, stride=torch.empty(shape, device="meta").stride())
        out.append(step.gather(dt))
    return out


def sharded_cases(rank, world, out, cases):
    """One step per case on a 2 x 2 mesh; rank 0 saves loss, aux, grad
    norm, every full gradient and every full updated leaf."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel.sharding import local_block, mesh_coords, placements
    from repro_torch.parallel.step import build_sharded_train_step, probe_collectives

    mesh = _mesh((2, 2))
    coords = mesh_coords(mesh)
    results = {"probe": probe_collectives(torch.device("cpu")),
               "coords": {r: None for r in range(world)}}
    # the rank's block of a dim split over (data, model): row-major, as
    # numpy slicing gives it and as DTensor's own distribution gives it
    full = torch.arange(8 * 8, dtype=torch.float32).reshape(8, 8)
    for spec in ((("data", "model"), None), ("data", "model"), (None, ("data", "model"))):
        mine = local_block(full, spec, mesh, coords)
        dt = distribute_tensor(full, mesh, placements(spec, mesh), src_data_rank=None)
        assert torch.equal(dt.to_local(), mine), (spec, rank)
        assert torch.equal(dt.full_tensor(), full)
        idx = coords["data"] * 2 + coords["model"]
        if spec[0] == ("data", "model"):
            assert torch.equal(mine, torch.from_numpy(full.numpy()[idx * 2:(idx + 1) * 2]))
    try:
        make_production_mesh(device_type="cpu")
        raise AssertionError("a 16 x 16 mesh on 4 ranks was not refused")
    except ValueError as e:
        results["mesh_refusal"] = str(e)
    for key, (arch, strategy, b, s) in cases.items():
        cfg = small_cfg(arch)
        model = Model(cfg, device="cpu")
        step = build_sharded_train_step(model, AdamWConfig(lr=LR), mesh, strategy, TOTAL, WARMUP)
        state = step.shard_state(torch.load(os.path.join(out, f"start_{arch}.pt")))
        batch = make_batch(cfg, b, s)
        try:
            loss, metrics, grads = step.loss_and_grads(state["params"], batch)
        except ValueError as e:
            results[key] = {"refused": str(e)}
            continue
        p2, o2, m = step(state["params"], state["opt"], batch)
        full = step.full_state({"params": p2, "opt": o2})
        results[key] = {
            "loss": float(m["loss"]), "aux": float(m["aux"]), "grad_norm": float(m["grad_norm"]),
            "loss_direct": float(loss), "aux_direct": float(metrics["aux"].detach()),
            "grads": _full_grads(step, grads),
            "params": tree_util.leaves(full["params"]), "m": tree_util.leaves(full["opt"]["m"]),
            "v": tree_util.leaves(full["opt"]["v"]), "step": int(full["opt"]["step"]),
            "n_shards": sum(int(l.to_local().numel() < l.numel())
                            for l in tree_util.leaves(p2)),
        }
    dist.barrier()
    if rank == 0:
        torch.save(results, os.path.join(out, "sharded.pt"))


# ------------------------------------------------------------------ elastic
ELASTIC = dict(arch="qwen1.5-0.5b", strategy="tp_fsdp", seq=32, batch=8, steps=5, saved=2)


def _elastic_steps(step, state, ds, steps):
    losses = []
    for s in steps:
        p, o, m = step(state["params"], state["opt"], ds.batch_at(s))
        state = {"params": p, "opt": o}
        losses.append(float(m["loss"]))
    return state, losses


def elastic_phase(rank, world, out, ckpt_dir, phase):
    """``a`` (2 x 2): an uninterrupted run of ``steps`` steps, then a run
    of ``saved + 1`` steps whose state rank 0 checkpoints; ``b`` (2 x 1):
    that checkpoint restored through ``elastic_restore`` and the remaining
    steps run."""
    import json

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.runtime.elastic import ShardedCheckpoints, elastic_restore, train_state_specs
    from repro_torch.parallel.step import build_sharded_train_step

    e = ELASTIC
    cfg = small_cfg(e["arch"])
    model = Model(cfg, device="cpu")
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=e["seq"], global_batch=e["batch"],
                                       seed=0))
    mesh = _mesh((2, 2) if phase == "a" else (2, 1))
    step = build_sharded_train_step(model, AdamWConfig(lr=LR), mesh, e["strategy"], e["steps"],
                                    WARMUP)
    mgr = CheckpointManager(ckpt_dir, async_write=False)
    rec = {}
    if phase == "a":
        _, rec["ref"] = _elastic_steps(step, step.shard_state(one_process_state(cfg)), ds,
                                       range(e["steps"]))
        state, rec["before"] = _elastic_steps(step, step.shard_state(one_process_state(cfg)), ds,
                                              range(e["saved"] + 1))
        ShardedCheckpoints(mgr, step, None).save(e["saved"], state)
        rec["driver"] = _driver_runs(ckpt_dir)
    else:
        shapes = model.param_shapes()
        template = {"params": shapes, "opt": adamw_init(shapes)}
        state, meta = elastic_restore(mgr, e["saved"], template, mesh,
                                      train_state_specs(e["strategy"]))
        assert all(l.device_mesh.size() == 2 for l in tree_util.leaves(state["params"]))
        _, rec["after"] = _elastic_steps(step, state, ds, range(e["saved"] + 1, e["steps"]))
    if rank == 0:
        with open(os.path.join(out, f"elastic_{phase}.json"), "w") as f:
            json.dump(rec, f)


DRIVER_ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--steps", "6",
               "--batch", "4", "--seq", "16", "--ckpt-every", "2", "--log-every", "100"]
DRIVER_FAIL_AT = 3


def _driver_runs(root):
    """``launch.train.main --production-mesh`` with the production mesh's
    shape swapped for 2 x 2 (the world here), clean and with a fault: the
    per-step losses and restarts of each; the clean run's checkpoints stay
    under ``root/driver_clean``."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import MeshShape

    train.mesh_shape = lambda multi_pod=False: MeshShape((2, 2), ("data", "model"))
    out = {}
    for label, extra in (("clean", []), ("faulted", ["--fail-at", str(DRIVER_FAIL_AT)])):
        summary = train.main(DRIVER_ARGS + ["--production-mesh", "--ckpt-dir",
                                            os.path.join(root, f"driver_{label}")] + extra)
        out[label] = {"losses": [summary["metrics"][s]["loss"] for s in range(6)],
                      "restarts": summary["restarts"]}
    return out


# -------------------------------------------------------------- compression
def compress_rank(rank, world, out, grads_by_rank, n_steps, const_grads, n_const):
    """``compressed_psum`` over the world: ``n_steps`` steps of each rank's
    ``grads_by_rank[rank]`` with the residual carried, then the error-feedback
    run (``n_const`` steps of a constant gradient); rank ``r`` saves its
    outputs and residuals."""
    from repro_torch.optim import CompressorState, compress_init, compressed_psum

    g = {k: torch.from_numpy(v) for k, v in grads_by_rank[rank].items()}
    st = compress_init(g)
    outs, res = [], []
    for _ in range(n_steps):
        o, st = compressed_psum(g, None, st)
        outs.append(o)
        res.append(st.residual)
    c = {"w": torch.from_numpy(const_grads[rank])}
    cst = CompressorState({"w": torch.zeros_like(c["w"])})
    acc = torch.zeros_like(c["w"])
    for _ in range(n_const):
        o, cst = compressed_psum(c, None, cst)
        acc = acc + o["w"]
    torch.save({"outs": outs, "res": res, "ef_mean": acc / n_const},
               os.path.join(out, f"compress_{rank}.pt"))


# --------------------------------------------------------------------- card
def card_two_ranks(rank, world, out):
    """One sharded step of reduced float32 qwen1.5-0.5b on two ranks
    sharing ``cuda:0`` (data 2 x model 1), from the state in
    ``out/start.pt``; rank 0 saves the loss and the full updated state."""
    from repro_torch.parallel.step import build_sharded_train_step

    cfg = small_cfg("qwen1.5-0.5b")
    mesh = _mesh_on((2, 1), "cuda")
    step = build_sharded_train_step(Model(cfg, device="cuda"), AdamWConfig(lr=LR), mesh,
                                    "tp_fsdp", TOTAL, WARMUP)
    state = step.shard_state(torch.load(os.path.join(out, "start.pt")))
    batch = make_batch(cfg, 8, 32)
    grads = [t.cpu() for t in _full_grads(step, step.loss_and_grads(state["params"], batch)[2])]
    p, o, m = step(state["params"], state["opt"], batch)
    full = step.full_state({"params": p, "opt": o})
    if rank == 0:
        torch.save({"loss": float(m["loss"]), "probe": step.probe, "grads": grads,
                    "params": [t.cpu() for t in tree_util.leaves(full["params"])],
                    "m": [t.cpu() for t in tree_util.leaves(full["opt"]["m"])],
                    "v": [t.cpu() for t in tree_util.leaves(full["opt"]["v"])]},
                   os.path.join(out, "card.pt"))
