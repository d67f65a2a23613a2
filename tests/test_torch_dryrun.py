"""The port's dry run (``repro_torch.launch.dryrun``): per-rank argument
bytes from the rule table on the meta device, against the reference.

qwen1.5-110b ``train_4k`` on 16 x 16 under ``tp_fsdp`` comes to exactly
the committed XLA record's ``memory.argument_size_in_bytes``,
5229568004.  For every (arch, shape) on both production meshes under
``auto``, ``resolve_auto`` equals the reference's and the bytes equal
those computed from the reference's own specs and shapes (its
``param_specs``/``batch_specs``/``state_specs`` on ``AbstractMesh``es,
each leaf's block of its ``ShapeDtypeStruct``).  The CLI writes the
reference's keys and nothing XLA alone gives; nothing is allocated.
"""
import functools
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch.dryrun import resolve_auto as jax_resolve_auto  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.model import input_specs as jax_input_specs  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro.parallel import sharding as ref  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _abstract(*pairs):
    try:
        return AbstractMesh(tuple(pairs))
    except TypeError:
        return AbstractMesh(tuple(s for _, s in pairs), tuple(n for n, _ in pairs))


MESHES = {False: _abstract(("data", 16), ("model", 16)),
          True: _abstract(("pod", 2), ("data", 16), ("model", 16))}


def _ref_bytes(tree, shardings, mesh):
    total = 0
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(shardings)
    assert len(leaves) == len(specs)
    for leaf, sh in zip(leaves, specs):
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(tuple(sh.spec)))
        n = 1
        for dim, entry in zip(leaf.shape, spec):
            axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            n *= dim // math.prod(mesh.shape[a] for a in axes)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return JaxModel(jax_get_arch(arch), JaxOptions()).param_shapes()


def _reference_cell(arch, shape_name, multi_pod):
    """(strategy, kv_layout, per-rank argument bytes) from the reference's
    own specs, as its ``build_step`` lays out the arguments."""
    cfg, shape, mesh = jax_get_arch(arch), JAX_SHAPES[shape_name], MESHES[multi_pod]
    strategy, kv = jax_resolve_auto(shape, cfg, n_devices=512 if multi_pod else 256)
    params = _ref_params(arch)
    total = _ref_bytes(params, ref.param_specs(params, mesh, strategy), mesh)
    specs = jax_input_specs(cfg, shape)
    if shape.kind == "train":
        total = 3 * total + 4 + _ref_bytes(specs, ref.batch_specs(specs, mesh, strategy), mesh)
    elif shape.kind == "prefill":
        total += _ref_bytes(specs, ref.batch_specs(specs, mesh, strategy), mesh)
    else:
        tok = {"token": specs["token"]}
        total += (_ref_bytes(tok, ref.batch_specs(tok, mesh), mesh) + 4
                  + _ref_bytes(specs["states"], ref.state_specs(
                      specs["states"], mesh, shape.global_batch, kv_layout=kv), mesh))
    return strategy, kv, total


def test_qwen110b_train_4k_matches_the_xla_record_exactly():
    rec = dryrun.run_cell("qwen1.5-110b", "train_4k", False, "tp_fsdp")
    assert rec["memory"]["argument_size_in_bytes"] == 5229568004
    assert rec["argument_bytes"] == {"params": 1743101952, "m": 1743101952, "v": 1743101952,
                                     "step": 4, "batch": 262144}
    with open(os.path.join(ROOT, "artifacts", "dryrun",
                           "qwen1.5-110b__train_4k__16x16.json")) as f:
        xla = json.load(f)
    assert rec["memory"]["argument_size_in_bytes"] == xla["memory"]["argument_size_in_bytes"]
    for k in ("arch", "shape", "mesh", "params", "active_params", "strategy", "kv_layout"):
        assert rec[k] == xla[k], k


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_cell_under_auto_equals_the_reference_specs(arch):
    for shape_name in SHAPES:
        for multi_pod in (False, True):
            rec = dryrun.run_cell(arch, shape_name, multi_pod, "auto")
            strategy, kv, want = _reference_cell(arch, shape_name, multi_pod)
            assert (rec["strategy"], rec["kv_layout"]) == (strategy, kv)
            if rec["status"] == "skipped":
                assert shape_name == "long_500k" and "sub-quadratic" in rec["reason"]
                continue
            assert rec["memory"]["argument_size_in_bytes"] == want, (shape_name, multi_pod)
            assert sum(rec["argument_bytes"].values()) == want


def test_cli_writes_the_reference_keys_and_no_xla_numbers(tmp_path):
    recs = dryrun.main(["--arch", "xlstm-125m", "--both-meshes", "--strategy", "auto",
                        "--kv-layout", "seq", "--out", str(tmp_path)])
    assert len(recs) == 2 * len(SHAPES)
    names = sorted(os.listdir(tmp_path))
    assert "xlstm-125m__train_4k__2x16x16.json" in names and len(names) == len(recs)
    with open(tmp_path / "xlstm-125m__decode_32k__16x16.json") as f:
        rec = json.load(f)
    assert {"arch", "shape", "mesh", "params", "active_params", "strategy", "kv_layout",
            "status", "memory"} <= set(rec)
    assert set(rec["argument_bytes"]) == {"params", "token", "states", "pos"}
    assert not {"hlo_flops", "collectives", "flops"} & set(rec)
    assert set(rec["memory"]) == {"argument_size_in_bytes"}
    assert dryrun.DEFAULT_OUT == os.path.join("artifacts", "torch", "dryrun")
