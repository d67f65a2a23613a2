"""Elastic restore (``repro_torch.runtime.elastic``) and the sharded
driver's checkpoints.

A gloo group of four CPU processes (``FileStore`` under ``tmp_path``)
trains reduced float32 qwen1.5-0.5b on a 2 x 2 mesh (``tp_fsdp``) for 5
steps uninterrupted, then again for 3 steps and checkpoints (rank 0
writes the full arrays); a group of two resumes that checkpoint on a 2 x
1 mesh through ``elastic_restore`` and runs steps 3 and 4 on the same
global batch.  Against the uninterrupted 2 x 2 run the first 3 losses are
bit-identical and the last 2 within 1e-5 (the reference's test allows
1e-3; seen here: equal).  The same four ranks run ``launch.train.main
--production-mesh`` (the mesh's shape swapped for 2 x 2) clean and with a
fault at step 3: one restart, losses
equal at every step; its checkpoints are the one-process layout, so a
one-process run of the driver resumes from them, and its losses sit
within 2e-2 of the one-process driver's (bf16 compute, sums in another
order).
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.parallel.spawn import spawn  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("elastic"))
    ckpt = os.path.join(out, "ckpt")
    spawn(W.elastic_phase, 4, out, ckpt, "a", threads=1, store_dir=out)
    spawn(W.elastic_phase, 2, out, ckpt, "b", threads=1, store_dir=out)
    with open(os.path.join(out, "elastic_a.json")) as f:
        a = json.load(f)
    with open(os.path.join(out, "elastic_b.json")) as f:
        b = json.load(f)
    return {"ref": a["ref"], "elastic": a["before"] + b["after"], "driver": a["driver"],
            "ckpt": ckpt}


def test_losses_before_the_reshard_are_bit_identical(runs):
    n = W.ELASTIC["saved"] + 1
    assert len(runs["ref"]) == len(runs["elastic"]) == W.ELASTIC["steps"]
    assert runs["ref"][:n] == runs["elastic"][:n]


def test_losses_after_the_reshard_continue(runs):
    n = W.ELASTIC["saved"] + 1
    for a, b in zip(runs["ref"][n:], runs["elastic"][n:]):
        assert abs(a - b) <= 1e-5, (runs["ref"], runs["elastic"])


def test_sharded_driver_recovers_bit_for_bit(runs):
    clean, faulted = runs["driver"]["clean"], runs["driver"]["faulted"]
    assert clean["restarts"] == 0 and faulted["restarts"] == 1
    assert clean["losses"] == faulted["losses"]


def test_sharded_checkpoints_are_the_one_process_layout(runs, tmp_path):
    """The sharded driver's final checkpoint loads into a one-process
    state's tree, and the one-process driver resumes from it."""
    d = os.path.join(runs["ckpt"], "driver_clean")
    assert latest_step(d) == 5
    cfg = get_arch("qwen1.5-0.5b").reduced()
    shapes = Model(cfg, device="meta").param_shapes()
    state, meta = restore_checkpoint(d, 5, {"params": shapes, "opt": adamw_init(shapes)})
    assert meta == {"final": True} and int(state["opt"]["step"]) == 6
    assert all(torch.isfinite(t).all() for t in tree_util.leaves(state["params"]))
    resumed = train.main(W.DRIVER_ARGS[:W.DRIVER_ARGS.index("--steps")] + [
        "--steps", "8"] + W.DRIVER_ARGS[W.DRIVER_ARGS.index("--steps") + 2:]
        + ["--ckpt-dir", d])
    assert sorted(resumed["metrics"]) == [6, 7]
    one = train.main(W.DRIVER_ARGS)
    for s in range(6):
        assert abs(one["metrics"][s]["loss"] - runs["driver"]["clean"]["losses"][s]) < 2e-2
