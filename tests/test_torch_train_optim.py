"""AdamW, the cosine schedule and the data pipeline against the reference.

AdamW runs five steps on both sides from the same params, moments and
gradients (float32 leaves and one bfloat16 leaf), with clipping on and
off and decoupled decay; params and moments agree within float32
rounding (rtol 1e-6, atol 1e-9: the two frameworks fuse the update's
few operations differently) and the bfloat16 leaf within one bf16 ulp.
``batch_at`` is bit-identical to the reference's (the numpy draws are
the same), codebook grids and vision embeddings included.
"""
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import DataConfig as JaxDataConfig  # noqa: E402
from repro.data import Prefetcher as JaxPrefetcher  # noqa: E402
from repro.data import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import cosine_schedule as jax_cosine_schedule  # noqa: E402
from repro.optim.adamw import global_norm as jax_global_norm  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.data import (  # noqa: E402
    DataConfig, Prefetcher, SyntheticLMDataset, batch_to, make_batch_iterator,
)
from repro_torch.optim import (  # noqa: E402
    AdamWConfig, adamw_init, adamw_update, cosine_schedule, global_norm,
)

SHAPES = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 2)}, "e": [(4,), (1, 6)]}


def _trees(seed, bf16_e0=False):
    """One random tree as numpy (the reference's side) and as tensors;
    keys sorted, so both libraries visit the leaves in one order."""
    rng = np.random.default_rng(seed)
    np_tree = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), SHAPES,
                           is_leaf=lambda s: isinstance(s, tuple))
    if bf16_e0:  # values that bf16 holds exactly
        np_tree["e"][0] = np.asarray(jnp.asarray(np_tree["e"][0], jnp.bfloat16)
                                     .astype(jnp.float32))
    return np_tree


def _jax(np_tree, bf16_e0):
    t = jax.tree.map(jnp.asarray, np_tree)
    if bf16_e0:
        t["e"][0] = t["e"][0].astype(jnp.bfloat16)
    return t


def _torch(np_tree, bf16_e0):
    t = tree_util.map_leaves(lambda a: torch.from_numpy(np.array(a)),
                             jax.tree.map(np.asarray, np_tree))
    if bf16_e0:
        t["e"][0] = t["e"][0].to(torch.bfloat16)
    return t


def _close(got, want, bf16=False):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if bf16:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("clip_norm,bf16_e0", [(0.5, False), (1e6, False), (0.5, True)],
                         ids=["clipped", "unclipped", "clipped-bf16-leaf"])
def test_adamw_update_matches_reference_over_five_steps(clip_norm, bf16_e0):
    jcfg = JaxAdamWConfig(lr=1e-2, clip_norm=clip_norm, weight_decay=0.1)
    tcfg = AdamWConfig(lr=1e-2, clip_norm=clip_norm, weight_decay=0.1)
    p0 = _trees(0, bf16_e0)
    jp, tp = _jax(p0, bf16_e0), _torch(p0, bf16_e0)
    jopt, topt = jax_adamw_init(jp), adamw_init(tp)
    assert topt["m"]["e"][0].dtype == torch.float32 and topt["step"].dtype == torch.int32
    for step in range(5):
        g = _trees(10 + step)
        lr_j = jax_cosine_schedule(jopt["step"], 2, 5)
        lr_t = cosine_schedule(topt["step"], 2, 5)
        jp, jopt, jst = jax_adamw_update(jp, jax.tree.map(jnp.asarray, g), jopt, jcfg, lr_j)
        tp, topt, tst = adamw_update(tp, _torch(g, False), topt, tcfg, lr_t)
        assert int(topt["step"]) == int(jopt["step"]) == step + 1
        _close(tst["grad_norm"], jst["grad_norm"])
        for (name, got), want in zip(tree_util.paths(tp), jax.tree.leaves(jp)):
            assert got.dtype == (torch.bfloat16 if bf16_e0 and name == "e.0" else torch.float32)
            _close(got, want, bf16=(bf16_e0 and name == "e.0"))
        for key in ("m", "v"):
            for got, want in zip(tree_util.leaves(topt[key]), jax.tree.leaves(jopt[key])):
                _close(got, want)


def test_adamw_update_leaves_its_inputs_alone():
    tp = _torch(_trees(0), False)
    before = [t.clone() for t in tree_util.leaves(tp)]
    opt = adamw_init(tp)
    adamw_update(tp, _torch(_trees(1), False), opt, AdamWConfig())
    assert all(torch.equal(a, b) for a, b in zip(before, tree_util.leaves(tp)))
    assert all(float(m.abs().max()) == 0 for m in tree_util.leaves(opt["m"]))
    assert int(opt["step"]) == 0


def test_cosine_schedule_matches_reference():
    for warmup, total in ((0, 10), (5, 100), (20, 16), (3, 3)):
        for step in (0, 1, 2, 4, 5, 9, 10, 50, 99, 100, 150):
            want = float(jax_cosine_schedule(step, warmup, total))
            got = float(cosine_schedule(torch.tensor(step, dtype=torch.int32), warmup, total))
            assert abs(got - want) <= 1e-6, (warmup, total, step)


def test_global_norm_matches_reference():
    t = _trees(3)
    _close(global_norm(_torch(t, False)), jax_global_norm(jax.tree.map(jnp.asarray, t)))
    assert float(global_norm({"x": torch.zeros(3)})) == 0.0


DATA = [dict(vocab=1000, seq_len=40, global_batch=3, seed=7),
        dict(vocab=300, seq_len=160, global_batch=2, seed=1),  # copy spans at 64, 128
        dict(vocab=50, seq_len=16, global_batch=2, n_codebooks=4),
        dict(vocab=5000, seq_len=12, global_batch=2, vision_tokens=6, d_model=8, seed=3)]


@pytest.mark.parametrize("kw", DATA, ids=["tokens", "copy-spans", "codebooks", "vision"])
def test_batch_at_is_bit_identical_to_reference(kw):
    ref, port = JaxDataset(JaxDataConfig(**kw)), SyntheticLMDataset(DataConfig(**kw))
    for step in (0, 1, 5, 1000):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_batch_iterator_and_batch_to_give_the_same_batches():
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=2, vision_tokens=3, d_model=4)
    ds = SyntheticLMDataset(cfg)
    it = make_batch_iterator(cfg, device="cpu", first_step=3)
    for step in (3, 4):
        got = next(it)
        assert got["tokens"].dtype == torch.int32 and got["vision_embeds"].dtype == torch.float32
        for k, v in ds.batch_at(step).items():
            assert np.array_equal(got[k].numpy(), v)
    assert isinstance(next(make_batch_iterator(cfg))["tokens"], np.ndarray)
    assert batch_to(ds.batch_at(0), "cpu")["tokens"].shape == (2, 8)


def test_prefetcher_substitutes_a_straggler_like_reference():
    """A producer that misses the deadline at step 2: the consumer takes
    the deterministic backup batch and counts the step, as the
    reference's prefetcher does."""
    kw = dict(vocab=200, seq_len=8, global_batch=2)
    release = threading.Event()

    def delay(step):  # step 2's shard straggles until the test releases it
        if step == 2:
            release.wait(5.0)
        return 0

    out = {}
    for tag, ds_cls, cfg_cls, pf_cls in (("ref", JaxDataset, JaxDataConfig, JaxPrefetcher),
                                         ("port", SyntheticLMDataset, DataConfig, Prefetcher)):
        release.clear()
        ds = ds_cls(cfg_cls(**kw))
        pf = pf_cls(ds, timeout_s=0.2, delay_injector=delay).start()
        try:
            batches = [pf.get(s)["tokens"] for s in range(3)]
        finally:
            release.set()
            pf.stop()
        assert not pf._thread.is_alive()
        out[tag] = (batches, list(pf.substituted_steps))
        assert all(np.array_equal(b, ds.batch_at(s)["tokens"]) for s, b in enumerate(batches))
    assert out["port"][1] == out["ref"][1] == [2]
    assert all(np.array_equal(a, b) for a, b in zip(out["port"][0], out["ref"][0]))
