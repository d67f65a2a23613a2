"""Production dry run: per-rank argument bytes of every (arch x shape x
mesh) cell, from the rule table alone.

Port of ``repro.launch.dryrun`` as meta-device accounting.  For each cell
the model's params (``Model.param_shapes``) and inputs (``input_specs``)
are built on the meta device, so nothing is drawn or allocated; the specs
come from ``repro_torch.parallel.sharding`` on the production mesh's shape
(``launch.mesh.mesh_shape``, no process group), and each leaf counts the
bytes of one rank's block.  The arguments are those the reference lowers:

* train: params + AdamW ``m`` + ``v`` (float32, as params) + the int32
  step + the batch;
* prefill: params + the batch;
* decode: params + the token + the serving states + the int32 ``pos``.

The report keeps the reference's JSON keys where the port has the number
(``arch``, ``shape``, ``mesh``, ``params``, ``active_params``,
``strategy``, ``kv_layout``, ``status``/``reason``,
``memory.argument_size_in_bytes``) and adds ``argument_bytes`` per group.
What only XLA's compile gives (``hlo_flops``, ``temp_size_in_bytes``, the
collective schedule) is left out, never estimated.

This entry point computes nothing on a device, so it is the one that does
not default to the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-110b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --strategy auto
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Any, Dict, Tuple

from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_applicable
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.model import Model, input_specs
from repro_torch.parallel.sharding import (
    _axes, batch_specs, leaves_with_paths, param_specs, state_specs,
)

STRATEGY_CHOICES = ("tp_fsdp", "fsdp", "ep_dp", "tp", "auto")
DEFAULT_OUT = os.path.join("artifacts", "torch", "dryrun")


def resolve_auto(shape, cfg=None, model_axis: int = 16, n_devices: int = 256) -> Tuple[str, str]:
    """Per-shape defaults, the reference's: train -> pure ZeRO-3 when the
    batch covers every device (else tp_fsdp); decode -> TP-only weights,
    KV by heads when the kv heads divide the model axis, else by sequence;
    prefill and the rest -> tp_fsdp with KV by heads."""
    if shape.kind == "train":
        if shape.global_batch % n_devices == 0:
            return "fsdp", "heads"
        return "tp_fsdp", "heads"
    if shape.name.startswith("decode"):
        if cfg is not None and cfg.n_kv_heads % model_axis == 0:
            return "tp", "heads"
        return "tp", "seq"
    return "tp_fsdp", "heads"


def leaf_bytes(leaf, spec, sizes: Dict[str, int]) -> int:
    """One rank's block of ``leaf`` under ``spec``, in bytes."""
    n = 1
    for dim, entry in zip(leaf.shape, spec):
        n *= dim // math.prod(sizes[a] for a in _axes(entry))
    return n * leaf.element_size()


def tree_bytes(tree, specs, sizes: Dict[str, int]) -> int:
    spec_list = [s for _, s in leaves_with_paths(specs)]
    leaves = [leaf for _, leaf in leaves_with_paths(tree)]
    assert len(spec_list) == len(leaves)
    return sum(leaf_bytes(leaf, s, sizes) for leaf, s in zip(leaves, spec_list))


def argument_bytes(cfg, shape, sizes: Dict[str, int], strategy: str,
                   kv_layout: str) -> Dict[str, int]:
    """Per-rank bytes of each argument group of the cell's step."""
    params = Model(cfg, device="meta").param_shapes()
    p_bytes = tree_bytes(params, param_specs(params, sizes, strategy), sizes)
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        # m and v: float32 like the masters, the params' specs
        return {"params": p_bytes, "m": p_bytes, "v": p_bytes, "step": 4,
                "batch": tree_bytes(specs, batch_specs(specs, sizes, strategy), sizes)}
    if shape.kind == "prefill":
        return {"params": p_bytes,
                "batch": tree_bytes(specs, batch_specs(specs, sizes, strategy), sizes)}
    tok = {"token": specs["token"]}
    return {"params": p_bytes,
            "token": tree_bytes(tok, batch_specs(tok, sizes), sizes),
            "states": tree_bytes(specs["states"],
                                 state_specs(specs["states"], sizes, shape.global_batch,
                                             kv_layout=kv_layout), sizes),
            "pos": 4}


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, strategy: str = "tp_fsdp",
             kv_layout: str = "heads") -> Dict[str, Any]:
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    mesh = mesh_shape(multi_pod)
    ok, why = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh.label,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "strategy": strategy, "kv_layout": kv_layout,
    }
    if strategy == "auto":
        strategy, kv_layout = resolve_auto(shape, cfg, model_axis=mesh.sizes()["model"],
                                           n_devices=mesh.size)
        rec["strategy"], rec["kv_layout"] = strategy, kv_layout
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    groups = argument_bytes(cfg, shape, mesh.sizes(), strategy, kv_layout)
    rec.update(status="ok", memory={"argument_size_in_bytes": sum(groups.values())},
               argument_bytes=groups, n_devices=mesh.size)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--strategy", default="tp_fsdp", choices=STRATEGY_CHOICES)
    ap.add_argument("--kv-layout", default="heads", choices=["heads", "seq"])
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) else [args.multi_pod]
    records = []
    for a in archs:
        for s in shapes:
            for mp in meshes:
                rec = run_cell(a, s, mp, args.strategy, args.kv_layout)
                tag = f"{a}__{s}__{rec['mesh']}"
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=2)
                if rec["status"] == "ok":
                    n = rec["memory"]["argument_size_in_bytes"]
                    print(f"[dryrun] {tag} ({rec['strategy']}, kv {rec['kv_layout']}): {n} B "
                          f"per rank ({n / 1e9:.2f} GB) {rec['argument_bytes']}", flush=True)
                else:
                    print(f"[dryrun] {tag}: skipped ({rec['reason']})", flush=True)
                records.append(rec)
    return records


if __name__ == "__main__":
    main()
