"""The port's serve engine gives the reference engine's greedy tokens.

Same reduced config (stablelm-1.6b here; qwen1.5-0.5b, with QKV bias,
RMSNorm and tied embeddings, in ``test_torch_serve_qwen.py``), same
weights (bridged from the reference's pytree), same prompts: the port's ``ServeEngine`` must emit exactly the
tokens of ``repro.serve.ServeEngine`` on the paged pool, with and
without prefix reuse, under the ``exact`` and ``int8`` plans.  Fewer
slots than requests forces admission after retirements (prefix hits at
block-aligned starts) and free slots riding along in decode.  On the
port side both ``naive`` and ``flash`` (the kernel's plain version on the
CPU) run; the reference runs ``naive`` across the matrix plus one
``flash`` case (its Pallas kernels in interpret mode are slow).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

BS, MAX_LEN, GEN, SLOTS, CHUNK = 4, 32, 6, 2, 4


def _prompts(vocab, seed=0):
    """Mixed lengths; three share an 8-token (two-block) prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 8, dtype=np.int32)
    tails = [3, 0, 6, 1, 0]
    fresh = [None, 5, None, None, 11]
    out = []
    for t, f in zip(tails, fresh):
        if f is None:
            out.append(np.concatenate([prefix, rng.integers(0, vocab, t, dtype=np.int32)]))
        else:
            out.append(rng.integers(0, vocab, f, dtype=np.int32))
    return out


def make_arch(name):
    jcfg = dataclasses.replace(jax_get_arch(name).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return name, jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def arch():
    return make_arch("stablelm-1.6b")


_jax_cache = {}


def _jax_tokens(arch, plan, prefix, attn_impl="naive"):
    name, jcfg, _, jparams, _ = arch
    key = (name, plan, prefix, attn_impl)
    if key not in _jax_cache:
        model = JaxModel(jcfg, JaxOptions(plan=plan, attn_impl=attn_impl))
        eng = JaxServeEngine(model, jparams, JaxServeConfig(
            max_slots=SLOTS, max_len=MAX_LEN, chunk_steps=CHUNK, kv_block_size=BS,
            prefix_cache=prefix, astra_accounting=False))
        outs = eng.generate_batch(_prompts(jcfg.vocab), GEN)
        _jax_cache[key] = ([o.tokens for o in outs], eng.prefix_stats)
    return _jax_cache[key]


def _torch_engine(arch, plan, prefix, attn_impl):
    _, _, tcfg, _, tparams = arch
    model = Model(tcfg, ModelOptions(plan=plan, attn_impl=attn_impl), device="cpu")
    return ServeEngine(model, tparams, ServeConfig(
        max_slots=SLOTS, max_len=MAX_LEN, chunk_steps=CHUNK, kv_block_size=BS,
        prefix_cache=prefix), device="cpu")


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "noprefix"])
@pytest.mark.parametrize("plan", ["exact", "int8"])
@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_greedy_tokens_match_reference(arch, plan, prefix, attn_impl):
    want, jstats = _jax_tokens(arch, plan, prefix)
    eng = _torch_engine(arch, plan, prefix, attn_impl)
    outs = eng.generate_batch(_prompts(arch[2].vocab), GEN)
    for i, (o, w) in enumerate(zip(outs, want)):
        np.testing.assert_array_equal(o.tokens, w, err_msg=f"request {i}")
    assert eng.prefix_stats == jstats
    if plan == "exact" and prefix:
        assert eng.prefix_stats["hits"] > 0  # the shared prefix was reused


def test_greedy_tokens_match_reference_flash(arch):
    """The reference's own kernel path (Pallas, interpret mode) against the
    port's kernel path (its plain version on the CPU)."""
    want, _ = _jax_tokens(arch, "exact", True, attn_impl="flash")
    eng = _torch_engine(arch, "exact", True, "flash")
    outs = eng.generate_batch(_prompts(arch[2].vocab), GEN)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o.tokens, w)

