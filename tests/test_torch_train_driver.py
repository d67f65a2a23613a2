"""The training loop and driver against the reference's mesh-free loop.

Six steps of reduced qwen from the bridged init (``build_train_step``
on both sides, the reference's jitted, the same ``batch_at`` batches)
agree at float32 within 1e-5 on the loss and 1e-6 relative on the
gradient norm, ending with every param leaf within 1e-4 of its largest
magnitude; at bf16 (the reference loop's own dtype) the loss within 1e-3
and the gradient norm within 1e-3 relative (bf16 GEMM inputs round at
2^-8; Adam then amplifies a small gradient's rounding in its step, so
params are not compared there).  ``main`` with an injected fault
reproduces its clean run bit for bit (step-addressable data and exact
checkpoints), refuses ``--production-mesh`` when the launcher's world is
not the mesh's size and runs on the card unless told otherwise.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.launch.train import build_train_step as jax_build_train_step  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.bridge import opt_state_from_reference, params_from_reference  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import batch_to  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402

ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--steps", "12", "--batch",
        "2", "--seq", "32", "--ckpt-every", "4", "--log-every", "100"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_six_steps_match_the_reference_loop(dtype):
    jcfg = jax_get_arch("qwen1.5-0.5b").reduced(dtype=dtype)
    cfg = get_arch("qwen1.5-0.5b").reduced(dtype=dtype)
    jmodel = JaxModel(jcfg)
    # the reference's e2e loop: a low-entropy task, lr 2e-3, warmup 5
    ds = JaxDataset(JaxDataConfig(vocab=jcfg.vocab, seq_len=64, global_batch=4, seed=0,
                                  menu_size=4, greedy_p=0.95, copy_len=16))
    jstep = jax.jit(jax_build_train_step(jmodel, JaxAdamWConfig(lr=2e-3), 6, 5))
    jp = jmodel.init(jax.random.PRNGKey(0))
    jo = jax_adamw_init(jp)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    to = opt_state_from_reference(jax.tree.map(np.asarray, jo), cfg, "cpu")
    tstep = train.build_train_step(Model(cfg, device="cpu"), AdamWConfig(lr=2e-3), 6, 5)
    loss_tol, norm_rtol = (1e-5, 1e-6) if dtype == "float32" else (1e-3, 1e-3)
    for s in range(6):
        batch = ds.batch_at(s)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(batch["tokens"])})
        tp, to, tm = tstep(tp, to, batch_to(batch, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) < loss_tol, s
        assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) < norm_rtol, s
    assert int(to["step"]) == int(jo["step"]) == 6
    if dtype == "float32":
        want = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
        for got, w in zip(tree_util.leaves(tp), tree_util.leaves(want)):
            assert float((got - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_fault_replay_equals_the_clean_run_bit_for_bit(tmp_path, capsys):
    clean = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "a")])
    faulty = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "b"), "--fail-at", "6,9",
                                "--prefetch"])
    assert sorted(faulty) == sorted(clean) == ["metrics", "restarts", "state", "wall_s"]
    assert clean["restarts"] == 0 and faulty["restarts"] == 2
    assert list(faulty["metrics"]) == list(range(12))
    assert faulty["metrics"] == clean["metrics"]  # every loss and grad norm, exactly
    for a, b in zip(tree_util.leaves(clean["state"]), tree_util.leaves(faulty["state"])):
        assert torch.equal(a, b)
    # the final save: the clean state, under the reference's metadata
    assert latest_step(str(tmp_path / "b")) == 11
    saved, meta = restore_checkpoint(str(tmp_path / "b"), 11, faulty["state"])
    assert meta == {"final": True}
    assert all(torch.equal(a, b) for a, b in zip(tree_util.leaves(saved),
                                                 tree_util.leaves(clean["state"])))
    out = capsys.readouterr().out
    assert "restarts=2" in out and out.count("done:") == 2


def test_production_mesh_is_refused(monkeypatch):
    """Refused only when the launcher's world is not the mesh's size, with
    both sizes named (here one process against 16 x 16)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="needs a world of 256 ranks") as e:
        train.main(ARGS + ["--production-mesh"])
    assert "world size is 1" in str(e.value)
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(SystemExit, match="16x16 .* 256 ranks; the launcher's world size is 8"):
        train.main(ARGS + ["--production-mesh"])


def test_main_runs_on_the_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        train.main(argv + ["--ckpt-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)  # refused before anything was written
