"""The sharded ZeRO-3 train step (``repro_torch.parallel.step``) against
the port's one-process step.

One gloo group of four CPU processes on a 2 x 2 ``("data", "model")``
mesh (``FileStore`` under ``tmp_path``, no port) runs every case once:
reduced float32 qwen1.5-0.5b and qwen3-moe-30b-a3b (EP + FSDP + TP
storage, the MoE case of the reference's 8-device test) under
``tp_fsdp``, ``fsdp``, ``ep_dp`` and ``tp`` (params split over ``model``
only: their gradients are all-reduced over ``data``, then sliced).  The one-process
step is held against the reference by ``test_torch_train_grads.py``; here
the sharded step is held against it: loss within 1e-5, aux within 1e-6,
the grad norm within 1e-5 relative, every gradient and every updated param,
``m`` and ``v`` leaf within 1e-5 of the leaf's largest magnitude (seen:
loss 4.8e-7, aux equal, leaves 1.1e-6; the ranks sum in another order).  The step starts from the state
two one-process steps left (moments not zero, so Adam's step is not the
sign of a gradient, and a learning rate past the warmup's 0).  A split that cuts a MoE
dispatch group is refused; the ranks' blocks of a dim split over two axes
are row-major, as numpy slicing and DTensor's own distribution give them;
a 16 x 16 mesh on four ranks is refused with both sizes named; the group
takes the step's three collectives; a model whose full float32 params
and gradients exceed a card is refused, the bytes named.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.launch.train import build_train_step  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.parallel.spawn import spawn  # noqa: E402

QWEN, MOE = "qwen1.5-0.5b", "qwen3-moe-30b-a3b"
# key -> (arch, strategy, batch, seq); the MoE batch holds 2048 tokens, four
# dispatch groups of 512, so four data-parallel ranks (fsdp) each hold one
# whole group
CASES = {
    "qwen-tp_fsdp": (QWEN, "tp_fsdp", 8, 32),
    "qwen-fsdp": (QWEN, "fsdp", 8, 32),
    "qwen-ep_dp": (QWEN, "ep_dp", 8, 32),
    "qwen-tp": (QWEN, "tp", 8, 32),
    "moe-tp_fsdp": (MOE, "tp_fsdp", 16, 128),
    "moe-fsdp": (MOE, "fsdp", 16, 128),
    "moe-ep_dp": (MOE, "ep_dp", 16, 128),
    "moe-tp": (MOE, "tp", 16, 128),
    # 512 tokens are one dispatch group: two data-parallel ranks would cut it
    "moe-cut": (MOE, "tp_fsdp", 8, 64),
}
HELD = [k for k in CASES if k != "moe-cut"]


_START = {}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded"))
    for arch, b, s in {(a, b, s) for a, _, b, s in CASES.values()}:
        if arch not in _START:  # one start state an arch, every case starts from it
            _START[arch] = W.mid_run_state(W.small_cfg(arch), b, s)
            torch.save(_START[arch], os.path.join(out, f"start_{arch}.pt"))
    spawn(W.sharded_cases, 4, out, CASES, threads=1, store_dir=out)
    return torch.load(os.path.join(out, "sharded.pt"), weights_only=False)


_ONE = {}


def _one_process(arch, b, s):
    """The one-process step's loss, aux, grad norm, gradients and updated
    state from the same state on the same batch."""
    if (arch, b, s) not in _ONE:
        cfg = W.small_cfg(arch)
        model = Model(cfg, device="cpu")
        st = _START[arch]
        batch = {k: torch.from_numpy(v) for k, v in W.make_batch(cfg, b, s).items()}
        live = [p.detach().requires_grad_(True) for p in tree_util.leaves(st["params"])]
        loss, m = model.loss(tree_util.unflatten(st["params"], live), batch)
        grads = torch.autograd.grad(loss, live)
        step = build_train_step(model, AdamWConfig(lr=W.LR), W.TOTAL, W.WARMUP)
        p2, o2, stats = step(st["params"], st["opt"], batch)
        _ONE[(arch, b, s)] = dict(
            loss=float(loss.detach()), aux=float(m["aux"].detach()),
            grad_norm=float(stats["grad_norm"]),
            grads=list(grads), params=tree_util.leaves(p2), m=tree_util.leaves(o2["m"]),
            v=tree_util.leaves(o2["v"]), step=int(o2["step"]))
    return _ONE[(arch, b, s)]


def _hold_leaves(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= 1e-5 * scale + 1e-12, (what, i, err, scale)


@pytest.mark.parametrize("key", HELD)
def test_sharded_loss_and_aux_equal_one_process(sharded, key):
    arch, _, b, s = CASES[key]
    got, want = sharded[key], _one_process(arch, b, s)
    assert abs(got["loss"] - want["loss"]) < 1e-5
    assert abs(got["loss_direct"] - want["loss"]) < 1e-5
    assert abs(got["aux"] - want["aux"]) <= 1e-6 * max(1.0, abs(want["aux"]))
    if arch == MOE:
        assert want["aux"] > 0
    assert abs(got["grad_norm"] - want["grad_norm"]) <= 1e-5 * want["grad_norm"]


@pytest.mark.parametrize("key", HELD)
def test_sharded_gradients_and_update_equal_one_process(sharded, key):
    arch, _, b, s = CASES[key]
    got, want = sharded[key], _one_process(arch, b, s)
    _hold_leaves(got["grads"], want["grads"], "grad")
    for part in ("params", "m", "v"):
        _hold_leaves(got[part], want[part], part)
    assert got["step"] == want["step"] == W.SHARDED_STEP + 1
    # the params moved, and the rule table split some of them over the mesh
    before = tree_util.leaves(_START[arch]["params"])
    assert any(not torch.equal(a, b) for a, b in zip(got["params"], before))
    assert got["n_shards"] > 0


def test_a_cut_dispatch_group_is_refused(sharded):
    msg = sharded["moe-cut"]["refused"]
    assert "dispatch groups of 512 tokens" in msg and "256 a rank" in msg


def test_collectives_probe_and_mesh_refusal(sharded):
    assert sharded["probe"] == ("all_reduce yes, all_gather_into_tensor yes, "
                                "reduce_scatter_tensor yes")
    msg = sharded["mesh_refusal"]
    assert "256 ranks" in msg and "the world has 4" in msg


def test_one_process_path_is_build_train_step():
    from repro_torch.parallel.step import build_sharded_train_step

    cfg = W.small_cfg(QWEN)
    model = Model(cfg, device="cpu")
    st = W.mid_run_state(cfg, 4, 16)
    batch = {k: torch.from_numpy(v) for k, v in W.make_batch(cfg, 4, 16).items()}
    a = build_sharded_train_step(model, AdamWConfig(lr=W.LR), None, "tp_fsdp", W.TOTAL,
                                 W.WARMUP)(st["params"], st["opt"], batch)
    b = build_train_step(model, AdamWConfig(lr=W.LR), W.TOTAL, W.WARMUP)(
        st["params"], st["opt"], batch)
    assert float(a[2]["loss"]) == float(b[2]["loss"])
    assert all(torch.equal(x, y) for x, y in zip(tree_util.leaves(a[0]),
                                                 tree_util.leaves(b[0])))
    assert np.isfinite(float(a[2]["grad_norm"]))


def test_a_model_past_the_card_is_refused():
    from repro_torch.configs import get_arch
    from repro_torch.parallel.step import gathered_bytes, refuse_unless_fits

    card = 80 * 10**9
    small = Model(get_arch(QWEN), device="cpu")
    assert gathered_bytes(small) == 8 * sum(
        p.numel() for p in tree_util.leaves(small.param_shapes()))
    refuse_unless_fits(small, card)  # 464M params: 3.7 GB
    big = Model(get_arch("qwen1.5-110b"), device="cpu")
    need = gathered_bytes(big)
    assert need > card
    with pytest.raises(ValueError, match=f"{need} B of float32 params and gradients"):
        refuse_unless_fits(big, card)
