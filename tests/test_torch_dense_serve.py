"""The port's decoder stack and serve engine on dense per-slot caches
against the reference's.

The reference engine's default layout (``kv_block_size=0``).  Same
reduced config (stablelm-1.6b here, qwen1.5-0.5b in
``test_torch_dense_serve_qwen.py``), same weights (bridged), same numpy
tokens.

Model: ``Model.prefill`` (full-sequence pass emitting per-layer caches
padded to the serving length) and then ``decode_step`` over those caches
with no block tables, both sides fed the same tokens.  Tolerances:
float32 logits and caches to 1e-4 under ``exact``; 2e-3 under ``int8``,
``sc`` and ``mixed``, whose codes are bit-identical given identical
activations but whose activations differ in the last float32 bits, so a
value at a rounding tie can move one code.  One moved code shifts the
logits of its one position by one code step of the site it feeds (9.9e-3
at one position under ``int8`` on stablelm, the same on the paged path),
so under the quantized plans at most one position per step may differ by
more than 2e-3, and none by more than 2e-2.

Engine: each admission runs one packed full-sequence prefill and
scatters the caches into the admitted slots; decode writes each slot's
own row.  The port must emit exactly the reference's greedy tokens under
the ``exact``, ``int8``, ``sc`` and ``mixed`` plans.  Prompts of mixed
lengths pad the packed prefill, and fewer slots than requests make later
admissions reuse slots: under ``mixed`` the per-column scales of ``v`` in
the pv product span every cache position, the prefill's padding rows and
the positions a free slot's ride-along decode writes included, so the
port's caches must hold the reference's values there too.  Also: the
dense layout has no pool statistics, int8 KV is refused on it with the
reference's reason, and ``generate`` gives the reference's ``generate``
tokens.

On the port side both ``naive`` and ``flash`` (the flash and
dense-decode kernels' plain versions on the CPU) run; the reference runs
``naive`` once per plan (its Pallas kernels in interpret mode are held
against the plain versions in ``test_torch_flash.py``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.engine import kv_quant_reject_reason as jax_reject_reason  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine, kv_quant_reject_reason  # noqa: E402

MAX_LEN, GEN, SLOTS, CHUNK = 32, 5, 2, 4
MODEL_LEN = 16  # cache length of the model-level check


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in (12, 5, 12, 7, 7)]


def make_arch(name):
    jcfg = dataclasses.replace(jax_get_arch(name).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(4))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return name, jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def arch():
    return make_arch("stablelm-1.6b")


def _run_port_model(tcfg, tparams, plan, attn_impl, tokens, feed):
    model = Model(tcfg, ModelOptions(plan=plan, attn_impl=attn_impl), device="cpu")
    params = model.prepare(tparams)
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                   max_len=MODEL_LEN)
    outs = [logits.numpy()]
    kv = [np.stack([c.k.numpy() for c in caches]), np.stack([c.v.numpy() for c in caches])]
    states = {"layers": caches}
    pos = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int64)
    for t in range(feed.shape[1]):
        lg, states = model.decode(params, torch.from_numpy(feed[:, t:t + 1]), states, pos)
        outs.append(lg.numpy())
        pos = pos + 1
    assert all(isinstance(c, KVCache) for c in states["layers"])
    return outs, kv


def _run_reference_model(jcfg, jparams, plan, tokens, feed):
    model = JaxModel(jcfg, JaxOptions(plan=plan))
    logits, states = model.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                   max_len=MODEL_LEN)
    outs = [np.asarray(logits)]
    slot = states["units"]["slot0"]  # caches stacked over the layers
    kv = [np.asarray(slot.k), np.asarray(slot.v)]
    pos = jnp.full((tokens.shape[0],), tokens.shape[1], jnp.int32)
    for t in range(feed.shape[1]):
        lg, states = model.decode(jparams, jnp.asarray(feed[:, t:t + 1]), states, pos)
        outs.append(np.asarray(lg))
        pos = pos + 1
    return outs, kv


def _assert_logits_close(got, want, atol, quantized, what):
    if not quantized:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)
        return
    moved = int((np.abs(got - want) > atol).any(-1).sum())  # positions past atol
    assert moved <= 1, (what, moved)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0, err_msg=what)


_ref_model_cache = {}


@pytest.mark.parametrize("plan,atol", [("exact", 1e-4), ("int8", 2e-3), ("sc", 2e-3),
                                       ("mixed", 2e-3)])
@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_prefill_and_dense_decode_match_reference(arch, plan, atol, attn_impl):
    name, jcfg, tcfg, jparams, tparams = arch
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    tokens, feed = tokens[:, :9], tokens[:, 9:]
    if (name, plan) not in _ref_model_cache:
        _ref_model_cache[name, plan] = _run_reference_model(jcfg, jparams, plan, tokens, feed)
    want, want_kv = _ref_model_cache[name, plan]
    got, got_kv = _run_port_model(tcfg, tparams, plan, attn_impl, tokens, feed)
    assert got_kv[0].shape == want_kv[0].shape  # [layers, B, n_kv, MODEL_LEN, hd]
    for g, w in zip(got_kv, want_kv):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_logits_close(g, w, atol, plan != "exact", f"step {i}")


def test_dense_state_refuses_int8_kv_and_overrun(arch):
    """Dense caches stay in the model dtype (int8 KV refused with the
    engine's reason), and a decode position past the cache is an error,
    not a clamped write."""
    _, _, tcfg, _, tparams = arch
    model = Model(tcfg, ModelOptions(kv_quant="int8"), device="cpu")
    with pytest.raises(ValueError, match="paged KV layout"):
        model.init_decode_state(2, MODEL_LEN)
    model = Model(tcfg, device="cpu")
    states = model.init_decode_state(2, 4)
    assert [tuple(c.k.shape) for c in states["layers"]] == \
        [(2, tcfg.n_kv_heads, 4, tcfg.head_dim)] * tcfg.n_layers
    tok = torch.zeros((2, 1), dtype=torch.int32)
    model.decode(tparams, tok, states, torch.tensor([3, 0]))
    with pytest.raises(RuntimeError, match="pos >= S_cache"):
        model.decode(tparams, tok, states, torch.tensor([4, 0]))


_jax_cache = {}


def _jax_tokens(arch, plan):
    name, jcfg, _, jparams, _ = arch
    key = (name, plan)
    if key not in _jax_cache:
        eng = JaxServeEngine(JaxModel(jcfg, JaxOptions(plan=plan)),
                             jparams, JaxServeConfig(max_slots=SLOTS, max_len=MAX_LEN,
                                                     chunk_steps=CHUNK, kv_block_size=0,
                                                     astra_accounting=False))
        outs = eng.generate_batch(_prompts(jcfg.vocab), GEN)
        _jax_cache[key] = [o.tokens for o in outs]
    return _jax_cache[key]


def _torch_engine(arch, plan, attn_impl):
    _, _, tcfg, _, tparams = arch
    model = Model(tcfg, ModelOptions(plan=plan, attn_impl=attn_impl), device="cpu")
    return ServeEngine(model, tparams, ServeConfig(max_slots=SLOTS, max_len=MAX_LEN,
                                                   chunk_steps=CHUNK, kv_block_size=0),
                       device="cpu")


@pytest.mark.parametrize("plan", ["exact", "int8", "sc", "mixed"])
@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_dense_greedy_tokens_match_reference(arch, plan, attn_impl):
    want = _jax_tokens(arch, plan)
    eng = _torch_engine(arch, plan, attn_impl)
    outs = eng.generate_batch(_prompts(arch[2].vocab), GEN)
    for i, (o, w) in enumerate(zip(outs, want)):
        np.testing.assert_array_equal(o.tokens, w, err_msg=f"request {i}")
    assert eng.kv_stats == {} and eng.prefix_stats == {}
    assert all(isinstance(c, KVCache) for c in eng._states["layers"])


def test_dense_layout_refuses_int8_kv_with_the_reference_reason(arch):
    name, jcfg, tcfg, jparams, tparams = arch
    model = Model(tcfg, ModelOptions(kv_quant="int8"), device="cpu")
    reason = kv_quant_reject_reason(model, 0)
    want = jax_reject_reason(JaxModel(jcfg, JaxOptions(kv_quant="int8")), 0)
    assert reason.split(":")[0] == want.split(":")[0]  # the same reason, port wording after
    with pytest.raises(ValueError, match="paged KV layout"):
        ServeEngine(model, tparams, ServeConfig(max_slots=1, max_len=16), device="cpu")
    with pytest.raises(ValueError, match="paged KV layout"):
        JaxServeEngine(JaxModel(jcfg, JaxOptions(kv_quant="int8")), jparams,
                       JaxServeConfig(max_slots=1, max_len=16, astra_accounting=False))


def test_generate_matches_reference(arch):
    """Packed prefill plus one fused decode over dense states, greedy."""
    _, jcfg, tcfg, jparams, tparams = arch
    prompts = np.random.default_rng(3).integers(0, tcfg.vocab, (3, 7)).astype(np.int32)
    want, _ = jax_generate(JaxModel(jcfg, JaxOptions(plan="int8")), jparams,
                           jnp.asarray(prompts), 5, 16)
    model = Model(tcfg, ModelOptions(plan="int8", attn_impl="flash"), device="cpu")
    got, tps = generate(model, tparams, prompts, 5, 16)
    assert got.shape == (3, 12) and tps > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    same, _ = generate(model, tparams, prompts, 0, 16)
    np.testing.assert_array_equal(same.numpy(), prompts)
