"""Greedy serving on the int8 KV pool: the port's engine against the
reference's, on identical calibrated scales.

The reference calibrates each plan on the packed prompts (its scales are
computed once per module and carried into the port's plan with
``plan_from_reference``, so both engines quantize with the same floats),
then both engines serve the same requests with ``kv_quant="int8"`` under
a calibrated ``int8`` plan, the ``exact`` plan with its KV scales, and a
calibrated ``mixed`` plan (int8 qk/pv through the dequantized gathered
view, sc projections), with prefix reuse on and off.  Fewer slots than
requests forces admission after retirements, so prefix blocks are
reused at block-aligned starts and free slots ride along in decode.  On
the port side ``naive`` and ``flash`` (the int8 branch's plain version
on the CPU) both run; the reference runs ``naive`` across the matrix and
its Pallas kernel (interpret mode) once.  Greedy tokens and prefix
counters must be identical.  qwen1.5-0.5b runs the same cases in
``test_torch_kv_quant_serve_qwen.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.prefill import pack_prompts as jax_pack_prompts  # noqa: E402
from repro_torch.bridge import plan_from_reference  # noqa: E402
from repro_torch.models.attention import QuantPagedKVCache  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from test_torch_serve import BS, CHUNK, GEN, MAX_LEN, SLOTS, _prompts, make_arch  # noqa: E402

# calibrated int8; exact with its KV scales; calibrated mixed
PLANS = ("int8", "exact", "mixed")


@pytest.fixture(scope="module")
def arch():
    return make_arch("stablelm-1.6b")


_plans = {}
_tokens = {}


def _reference_plan(arch, plan):
    """The reference's plan calibrated on the packed prompts."""
    name, jcfg, _, jparams, _ = arch
    if (name, plan) not in _plans:
        toks, _ = jax_pack_prompts(_prompts(jcfg.vocab), jcfg)
        model = JaxModel(jcfg, JaxOptions(plan=plan)).calibrate(jparams, {"tokens": toks})
        _plans[name, plan] = model.plan
    return _plans[name, plan]


def _reference_tokens(arch, plan, prefix, attn_impl="naive"):
    name, jcfg, _, jparams, _ = arch
    key = (name, plan, prefix, attn_impl)
    if key not in _tokens:
        model = JaxModel(jcfg, JaxOptions(plan=_reference_plan(arch, plan),
                                          attn_impl=attn_impl))
        eng = JaxServeEngine(model, jparams, JaxServeConfig(
            max_slots=SLOTS, max_len=MAX_LEN, chunk_steps=CHUNK, kv_block_size=BS,
            prefix_cache=prefix, kv_quant="int8", astra_accounting=False))
        outs = eng.generate_batch(_prompts(jcfg.vocab), GEN)
        _tokens[key] = ([o.tokens for o in outs], eng.prefix_stats)
    return _tokens[key]


def _port_engine(arch, plan, prefix, attn_impl):
    _, _, tcfg, _, tparams = arch
    jplan = _reference_plan(arch, plan)
    tplan = plan_from_reference(jplan.act_scales, jplan.kv_scales, plan)
    model = Model(tcfg, ModelOptions(plan=tplan, attn_impl=attn_impl), device="cpu")
    return ServeEngine(model, tparams, ServeConfig(
        max_slots=SLOTS, max_len=MAX_LEN, chunk_steps=CHUNK, kv_block_size=BS,
        prefix_cache=prefix, kv_quant="int8"), device="cpu")


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix", "noprefix"])
@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_int8_pool_greedy_tokens_match_reference(arch, plan, prefix, attn_impl):
    want, jstats = _reference_tokens(arch, plan, prefix)
    eng = _port_engine(arch, plan, prefix, attn_impl)
    assert isinstance(eng._states["layers"][0], QuantPagedKVCache)
    outs = eng.generate_batch(_prompts(arch[2].vocab), GEN)
    for i, (o, w) in enumerate(zip(outs, want)):
        np.testing.assert_array_equal(o.tokens, w, err_msg=f"request {i}")
    assert eng.prefix_stats == jstats
    assert eng.kv_stats["kv_quant"] == "int8"
    if prefix:
        assert eng.prefix_stats["hits"] > 0  # calibrated scales keep reuse on


def test_int8_pool_greedy_tokens_match_reference_kernel(arch):
    """The reference's int8-pool kernel path (Pallas, interpret mode)
    against the port's (the int8 branch's plain version on the CPU)."""
    want, jstats = _reference_tokens(arch, "int8", True, attn_impl="flash")
    eng = _port_engine(arch, "int8", True, "flash")
    outs = eng.generate_batch(_prompts(arch[2].vocab), GEN)
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o.tokens, w)
    assert eng.prefix_stats == jstats
