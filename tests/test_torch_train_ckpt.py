"""Checkpoints and the restart loop, beside the reference's.

The port writes the reference's layout (one ``.npy`` per leaf under its
dotted path, ``manifest.json``, bfloat16 as a uint16 view, ``.tmp`` then
rename), so each side reads what the other wrote: a reference
checkpoint of a reduced float32 qwen's train state restores into the port
through ``bridge.checkpoint_from_reference`` exactly, and three steps
from it on both sides agree within float32 rounding (loss within 1e-5,
every param leaf within 1e-4 of its largest magnitude: Adam divides by
the gradients' root mean square, so a last-bit difference in a small
gradient moves its step by more than a last bit).  ``run_with_restarts``
is driven beside the reference's on one toy step function.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JaxManager  # noqa: E402
from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.launch.train import build_train_step as jax_build_train_step  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.runtime import FaultInjector as JaxFaultInjector  # noqa: E402
from repro.runtime import run_with_restarts as jax_run_with_restarts  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    checkpoint_from_reference, opt_state_from_reference, params_from_reference,
)
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import batch_to  # noqa: E402
from repro_torch.launch.train import build_train_step  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import FaultInjector, SimulatedFault, run_with_restarts  # noqa: E402


def _state(dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    # keys in sorted order: the reference visits a dict's leaves so
    return {"opt": {"step": torch.tensor(7, dtype=torch.int32)},
            "params": {"embedding": {"table": torch.randn(5, 3, generator=g).to(dtype)},
                       "layers": [{"w": torch.randn(2, 2, generator=g).to(dtype)},
                                  {"w": torch.randn(3, generator=g).to(dtype)}]}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_is_exact(tmp_path, dtype):
    st = _state(dtype)
    path = save_checkpoint(str(tmp_path), 12, st, metadata={"note": "x"})
    assert os.path.basename(path) == "step_00000012" and latest_step(str(tmp_path)) == 12
    got, meta = restore_checkpoint(str(tmp_path), 12, _state(dtype, seed=1))
    assert meta == {"note": "x"}
    for (name, a), b in zip(tree_util.paths(st), tree_util.leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    stored = np.load(os.path.join(path, "params.layers.0.w.npy"))
    assert stored.dtype == (np.uint16 if dtype == torch.bfloat16 else np.float32)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 12, {**st, "opt": {"step": torch.zeros(2)}})


def test_each_side_reads_what_the_other_wrote(tmp_path):
    """Leaf names and dtypes are the reference's: the reference restores
    a port checkpoint, and the port one of the reference's."""
    st = _state(torch.bfloat16)
    save_checkpoint(str(tmp_path / "port"), 3, st)
    target = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.bfloat16 if t.dtype == torch.bfloat16
                                              else jnp.int32), st)
    got, _ = jax_restore(str(tmp_path / "port"), 3, target)
    for a, b in zip(tree_util.leaves(st), jax.tree.leaves(got)):
        assert np.array_equal(a.to(torch.float32).numpy(), np.asarray(b, np.float32))
    jax_save(str(tmp_path / "ref"), 4, got)
    back, _ = restore_checkpoint(str(tmp_path / "ref"), 4, st)
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(st), tree_util.leaves(back)))


def test_tmp_directories_are_never_read(tmp_path):
    save_checkpoint(str(tmp_path), 2, _state())
    os.makedirs(tmp_path / "step_00000009.tmp")  # a write that died
    open(tmp_path / "step_00000009.tmp" / "manifest.json", "w").close()
    os.makedirs(tmp_path / "step_00000010")  # no manifest: never finished either
    assert latest_step(str(tmp_path)) == 2
    assert latest_step(str(tmp_path / "absent")) is None


def test_manager_writes_async_and_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st, saved = _state(), {}
    for step in range(5):
        mgr.save(step, st, metadata={"step": step})
        saved[step] = st["params"]["layers"][1]["w"].clone()
        # a new tensor after each save: the saved host copy is unaffected
        st["params"]["layers"][1]["w"] = st["params"]["layers"][1]["w"] + 1
    assert mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    got, meta = mgr.restore(3, st)
    assert meta == {"step": 3}
    assert torch.equal(got["params"]["layers"][1]["w"], saved[3])
    assert not torch.equal(saved[3], st["params"]["layers"][1]["w"])


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """A reference train state after 2 jitted steps of reduced qwen, saved
    by the reference, and 3 more steps from it."""
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    jcfg = jax_get_arch("qwen1.5-0.5b").reduced(dtype="float32")
    model = JaxModel(jcfg)
    ocfg = JaxAdamWConfig(lr=2e-3)
    ds = JaxDataset(JaxDataConfig(vocab=jcfg.vocab, seq_len=32, global_batch=2, seed=4))
    step = jax.jit(jax_build_train_step(model, ocfg, total_steps=8, warmup=2))
    params = model.init(jax.random.PRNGKey(4))
    opt = jax_adamw_init(params)
    for s in range(5):
        if s == 2:
            jax_save(d, 1, {"params": params, "opt": opt}, metadata={"step": 1})
            saved = jax.tree.map(np.asarray, (params, opt))
        params, opt, m = step(params, opt, {"tokens": jnp.asarray(ds.batch_at(s)["tokens"])})
        if s == 2:
            losses = []
        if s >= 2:
            losses.append(float(m["loss"]))
    return d, saved, losses, jax.tree.map(np.asarray, params)


def test_reference_checkpoint_restores_into_the_port(ref_ckpt):
    d, (params, opt), _, _ = ref_ckpt
    cfg = get_arch("qwen1.5-0.5b").reduced(dtype="float32")
    state, meta = checkpoint_from_reference(d, 1, cfg, "cpu")
    assert meta == {"step": 1} and int(state["opt"]["step"]) == 2
    want = {"params": params_from_reference(params, cfg, "cpu"),
            "opt": opt_state_from_reference(opt, cfg, "cpu")}
    assert [n for n, _ in tree_util.paths(state)] == [n for n, _ in tree_util.paths(want)]
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(state),
                                                 tree_util.leaves(want)))


def test_training_on_from_a_reference_checkpoint_matches_reference(ref_ckpt):
    d, _, ref_losses, ref_params = ref_ckpt
    cfg = get_arch("qwen1.5-0.5b").reduced(dtype="float32")
    state, _ = checkpoint_from_reference(d, 1, cfg, "cpu")
    ds = JaxDataset(JaxDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2, seed=4))
    step = build_train_step(Model(cfg, device="cpu"), AdamWConfig(lr=2e-3), 8, 2)
    params, opt = state["params"], state["opt"]
    for s, want in zip(range(2, 5), ref_losses):
        params, opt, m = step(params, opt, batch_to(ds.batch_at(s), "cpu"))
        assert abs(float(m["loss"]) - want) < 1e-5, s
    for got, want in zip(tree_util.leaves(params),
                         tree_util.leaves(params_from_reference(ref_params, cfg, "cpu"))):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _step(state, s, inj):
    """The toy step on either side: ``x`` gains ``s + 1``, reported as the loss."""
    inj.check(s)
    x = state["x"] + s + 1
    return {"x": x}, {"loss": x}


def _run(lib, tmp_path, fail_at, ckpt_every=3, max_restarts=10, n_steps=8):
    init = (lambda: {"x": jnp.zeros(())}) if lib == "ref" else (lambda: {"x": torch.zeros(())})
    inj = (JaxFaultInjector if lib == "ref" else FaultInjector)(fail_at)
    mgr = None
    if ckpt_every:
        d = str(tmp_path / lib)
        mgr = (JaxManager if lib == "ref" else CheckpointManager)(d, keep=2)
    out = (jax_run_with_restarts if lib == "ref" else run_with_restarts)(
        init_state=init, step_fn=lambda st, s: _step(st, s, inj), n_steps=n_steps,
        ckpt_manager=mgr, ckpt_every=ckpt_every, max_restarts=max_restarts,
        clock=iter(range(100)).__next__)
    return out, inj


@pytest.mark.parametrize("fail_at,ckpt_every", [([4, 7], 3), ([5], 0)],
                         ids=["replay-from-checkpoint", "no-checkpoint"])
def test_restarts_replay_like_reference(tmp_path, fail_at, ckpt_every):
    ref, ref_inj = _run("ref", tmp_path, fail_at, ckpt_every)
    port, port_inj = _run("port", tmp_path, fail_at, ckpt_every)
    clean, _ = _run("port", tmp_path / "clean", [], ckpt_every)
    assert port["restarts"] == ref["restarts"] == len(fail_at)
    assert port_inj.fired == ref_inj.fired == fail_at  # each fault fires once
    assert port["metrics"] == {s: {"loss": m["loss"]} for s, m in ref["metrics"].items()}
    assert port["metrics"] == clean["metrics"] and float(port["state"]["x"]) == 36.0
    assert port["wall_s"] == ref["wall_s"]  # both on the injected clock


def test_restarts_stop_at_max_restarts(tmp_path):
    def init():
        return {"x": torch.zeros(())}

    def always(state, s):
        raise SimulatedFault(f"step {s}")

    with pytest.raises(RuntimeError, match="exceeded max_restarts=2") as e:
        run_with_restarts(init_state=init, step_fn=always, n_steps=3, max_restarts=2)
    assert isinstance(e.value.__cause__, SimulatedFault)
    inj = FaultInjector([1])
    with pytest.raises(SimulatedFault):
        inj.check(1)
    inj.check(1)  # fired once: the replayed step passes
    assert inj.fired == [1]
