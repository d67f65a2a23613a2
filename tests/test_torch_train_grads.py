"""The port's training loss and its gradient against the reference's.

Weights are the reference's own, bridged (``repro_torch.bridge``), and
the batch comes from numpy; the reference's ``Model.loss`` and
``jax.grad`` of it run once per arch (module-scoped fixture, jitted, at
``reduced(dtype="float32")``), and ``jax.grad``'s tree crosses through
``params_from_reference`` like the params.  Tolerances: float32 loss and
aux within 1e-5 absolute, every gradient leaf within 1e-4 of that leaf's
largest magnitude (same math in another summation order: the largest
seen is 1.8e-5, xLSTM's down projection); bf16 loss within 1e-3 and each
leaf within 5e-2 of its largest magnitude (bf16 rounds every GEMM input,
2^-8 relative, in two frameworks that fuse differently; seen 1.3e-2).
Remat on and off give bit-identical gradients.  An RG-LRU block's
gradient through the scan's ``autograd.Function`` is held against
autograd through the plain loop within 1e-5 of the largest gradient.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.model import cross_entropy as jax_cross_entropy  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro_torch.models import rglru as rglru_mod  # noqa: E402
from repro_torch.models.model import Model, cross_entropy  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402

ARCHS = ["qwen1.5-0.5b", "granite-moe-1b-a400m", "recurrentgemma-2b", "xlstm-125m",
         "llama-3.2-vision-90b", "musicgen-large"]
B, S = 2, 16
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 5e-2)}  # (loss abs, grad / max|leaf|)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32)}
    if cfg.vision_tokens:
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _case(name, dtype="float32"):
    jcfg = dataclasses.replace(jax_get_arch(name).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_arch(name).reduced(), dtype=dtype)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    batch = _batch(jcfg)

    def loss_aux(p, b):
        loss, m = jmodel.loss(p, b)
        return loss, m["aux"]

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_aux, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    want = params_from_reference(jax.tree.map(np.asarray, grads), tcfg, "cpu")
    return dict(cfg=tcfg, params=params, batch=batch, loss=float(loss), aux=float(aux),
                grads=want, dtype=dtype)


def _port_grads(case, opts=ModelOptions()):
    live = [p.detach().requires_grad_(True) for p in tree_util.leaves(case["params"])]
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    loss, m = Model(case["cfg"], opts, device="cpu").loss(
        tree_util.unflatten(case["params"], live), batch)
    return loss.detach(), m["aux"].detach(), torch.autograd.grad(loss, live)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    c = _case(request.param)
    c["port"] = _port_grads(c)
    return c


@pytest.fixture(scope="module")
def bf16_case():
    c = _case("qwen1.5-0.5b", "bfloat16")
    c["port"] = _port_grads(c)
    return c


def _hold_grads(case):
    loss_tol, grad_tol = TOL[case["dtype"]]
    loss, aux, grads = case["port"]
    assert abs(float(loss) - case["loss"]) < loss_tol
    names = [n for n, _ in tree_util.paths(case["grads"])]
    assert len(names) == len(grads)
    for name, want, got in zip(names, tree_util.leaves(case["grads"]), grads):
        assert got.shape == want.shape, name
        scale = float(want.abs().max())
        err = float((got.to(torch.float32) - want).abs().max())
        assert err <= grad_tol * scale + 1e-12, (name, err, scale)


def test_loss_and_aux_match_reference(case):
    loss, aux, _ = case["port"]
    assert abs(float(loss) - case["loss"]) < TOL["float32"][0]
    assert abs(float(aux) - case["aux"]) < TOL["float32"][0]
    if case["cfg"].moe is not None:
        assert float(aux) > 0  # the load-balance loss reaches the total
    else:
        assert float(aux) == 0.0


def test_every_gradient_leaf_matches_reference(case):
    _hold_grads(case)
    assert all(float(g.abs().max()) > 0 for g in case["port"][2])  # no leaf cut off


def test_bf16_loss_and_gradients_match_reference(bf16_case):
    _hold_grads(bf16_case)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "granite-moe-1b-a400m", "recurrentgemma-2b"])
def test_remat_gives_bit_identical_gradients(name):
    cfg = get_arch(name).reduced(dtype="float32")
    c = dict(cfg=cfg, params=Model(cfg, device="cpu").init(0), batch=_batch(cfg, 1))
    on = _port_grads(c, ModelOptions(remat=True))
    off = _port_grads(c, ModelOptions(remat=False))
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[2], off[2]))


def test_remat_checkpoints_each_pattern_period_only_under_grad(monkeypatch):
    """The periods of the scanned units run under checkpoint while
    autograd records, remainder layers never, and serving passes not."""
    from repro_torch.models import transformer

    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda fn, lo, hi, x, **kw: calls.append((lo, hi)) or real(
                            fn, lo, hi, x, **kw))
    cfg = get_arch("recurrentgemma-2b").reduced(dtype="float32", n_layers=4)  # 1 unit + 1
    c = dict(cfg=cfg, params=Model(cfg, device="cpu").init(0), batch=_batch(cfg))
    _port_grads(c)
    assert calls == [(0, len(cfg.block_pattern))] and cfg.n_layers > len(cfg.block_pattern)
    calls.clear()
    with torch.no_grad():
        Model(cfg, device="cpu").loss(c["params"], {"tokens": torch.from_numpy(c["batch"]["tokens"])})
    Model(cfg, device="cpu").prefill(c["params"], torch.from_numpy(c["batch"]["tokens"]))
    assert calls == []


def test_rglru_block_gradient_matches_plain_loop_autograd(monkeypatch):
    cfg = get_arch("recurrentgemma-2b").reduced(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = rglru_mod.rglru_init(gen, cfg)
    x = torch.randn(2, 19, cfg.d_model, generator=gen)

    def grads():
        live = [t.detach().requires_grad_(True) for t in tree_util.leaves(p)]
        xl = x.clone().requires_grad_(True)
        out, _ = rglru_mod.rglru_seq(tree_util.unflatten(p, live), xl, cfg)
        return torch.autograd.grad((out * out).sum(), live + [xl])

    got = grads()
    from repro_torch.kernels import rglru_scan as pkg

    monkeypatch.setattr(pkg, "rglru_scan", rglru_scan_ref)  # autograd through the loop
    want = grads()
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_cross_entropy_masks_labels_like_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 6] = -1
    for z in (0.0, 1e-4, 0.1):
        want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), z))
        got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), z))
        assert abs(got - want) < 1e-6
    all_masked = torch.full((2, 3), -1)
    assert float(cross_entropy(torch.zeros(2, 3, 5), all_masked)) == 0.0


def test_loss_refuses_prepared_params():
    cfg = get_arch("qwen1.5-0.5b").reduced(dtype="bfloat16")
    model = Model(cfg, device="cpu")
    params = model.init(0)
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(ValueError, match="prepared"):
        model.loss(model.prepare(params), batch)
    with pytest.raises(ValueError, match="prepared"):
        model.with_plan("int8").loss(model.with_plan("int8").prepare(params), batch)
    loss, m = model.loss(params, batch)
    assert torch.isfinite(loss) and float(m["aux"]) == 0.0
