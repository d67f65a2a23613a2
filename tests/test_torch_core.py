"""The port's quantization, execution modes and plans against the reference.

``quantize`` codes and scales must be bit-identical (same float32
division, half-to-even rounding, clip), including the example the
reference's round-trip property pins (``amax_milli=1, seed=0``) — only
the codes are compared there, the bound itself is the reference's open
issue.  ``astra_matmul`` under ``int8`` is then bit-identical too, and
plan resolution and the site registries must agree exactly.  The ``sc``
mode and quantized dynamic sites are held in ``test_torch_sc.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.core.astra_layer import ComputeConfig as JaxCC  # noqa: E402
from repro.core.astra_layer import astra_batched_matmul as jax_astra_batched_matmul  # noqa: E402
from repro.core.astra_layer import astra_matmul as jax_astra_matmul  # noqa: E402
from repro.core.plan import ExecutionPlan as JaxPlan  # noqa: E402
from repro.core.plan import kv_sites as jax_kv_sites  # noqa: E402
from repro.core.plan import model_sites as jax_model_sites  # noqa: E402
from repro.core.quant import MAG_MAX as JAX_MAG_MAX  # noqa: E402
from repro.core.quant import quantize as jax_quantize  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.core.astra_layer import (  # noqa: E402
    ComputeConfig, astra_batched_matmul, astra_matmul, quantize_weight_t,
)
from repro_torch.core.plan import ExecutionPlan, kv_sites, model_sites  # noqa: E402
from repro_torch.core.quant import MAG_MAX, quantize  # noqa: E402


def _assert_same_q(tq, jq):
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(np.broadcast_to(tq.scale.numpy(), np.shape(jq.scale)),
                                  np.asarray(jq.scale))


@pytest.mark.parametrize("axis", [None, 0, -1])
@pytest.mark.parametrize("shape", [(7,), (16, 33), (3, 5, 64)])
def test_quantize_bit_exact(rng, axis, shape):
    if axis == 0 and len(shape) == 1:
        axis = None
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30)).astype(np.float32)
    _assert_same_q(quantize(torch.from_numpy(x), axis=axis),
                   jax_quantize(jnp.asarray(x), axis=axis))


def test_quantize_bf16_and_zero_inputs(rng):
    x = rng.standard_normal((9, 12)).astype(np.float32)
    tq = quantize(torch.from_numpy(x).to(torch.bfloat16), axis=0)
    jq = jax_quantize(jnp.asarray(x, jnp.bfloat16), axis=0)
    _assert_same_q(tq, jq)
    z = np.zeros((4, 3), np.float32)  # amax == 0 -> scale 1.0, codes 0
    _assert_same_q(quantize(torch.from_numpy(z), axis=0), jax_quantize(jnp.asarray(z), axis=0))


@pytest.mark.parametrize("amax_milli,seed", [(1, 0), (37, 5), (10_000, 123)])
def test_quantize_static_scale_codes(amax_milli, seed):
    """Static-scale quantize, as the reference's round-trip property draws
    it (its pinned failing example included): codes equal, bit for bit."""
    amax = amax_milli / 1000.0
    rng = np.random.default_rng(seed)
    x = rng.uniform(-amax, amax, size=(64,)).astype(np.float32)
    assert MAG_MAX == JAX_MAG_MAX
    scale = amax / MAG_MAX
    _assert_same_q(quantize(torch.from_numpy(x), axis=None, scale=scale),
                   jax_quantize(jnp.asarray(x), axis=None, scale=scale))


@pytest.mark.parametrize("act_scale", [None, 0.02])
def test_astra_matmul_int8_bit_exact(rng, act_scale):
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) / 7).astype(np.float32)
    want = jax_astra_matmul(jnp.asarray(x), jnp.asarray(w), JaxCC("int8", act_scale=act_scale))
    want_pl = jax_astra_matmul(jnp.asarray(x), jnp.asarray(w),
                               JaxCC("int8", use_pallas=True, act_scale=act_scale))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    cc = ComputeConfig("int8", act_scale=act_scale)
    for got in (astra_matmul(tx, tw, cc), astra_matmul(tx, tw, cc, wq_t=quantize_weight_t(tw))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_pl))


def test_astra_matmul_exact_and_unported_modes(rng):
    """Exact is a plain matmul; the modes the first slice refused (``sc``,
    and quantized qk/pv under ``mixed``) now run and give the reference's
    values."""
    x = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    got = astra_matmul(torch.from_numpy(x), torch.from_numpy(w), ComputeConfig("exact"))
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-5, atol=1e-5)
    got = astra_matmul(torch.from_numpy(x), torch.from_numpy(w), ComputeConfig("sc"))
    want = jax_astra_matmul(jnp.asarray(x), jnp.asarray(w), JaxCC("sc"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plan, jplan = ExecutionPlan.from_spec("mixed"), JaxPlan.from_spec("mixed")
    got = astra_batched_matmul(torch.from_numpy(x)[None], torch.from_numpy(w)[None],
                               plan.site("L0.attn.qk"))
    want = jax_astra_batched_matmul(jnp.asarray(x)[None], jnp.asarray(w)[None],
                                    jplan.site("L0.attn.qk"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("spec", ["exact", "int8", "mixed", "sc",
                                  '{"*.qk|*.pv": "int8", "L1.*": "int8", "default": "exact"}',
                                  {"*_proj": {"mode": "int8", "act_scale": 0.5},
                                   "lm_head": "exact", "default": "int8"}])
def test_plan_resolution_matches_reference(spec):
    tp, jp = ExecutionPlan.from_spec(spec), JaxPlan.from_spec(spec)
    assert tp.name == jp.name
    for cfg in (get_arch("stablelm-1.6b"), get_arch("qwen1.5-0.5b"),
                get_arch("stablelm-1.6b").reduced()):
        for site in model_sites(cfg):
            t, j = tp.resolve(site), jp.resolve(site)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), site


def test_plan_rejects_like_reference():
    for bad in ("bogus-plan", "{not json"):
        with pytest.raises(ValueError):
            ExecutionPlan.from_spec(bad)
        with pytest.raises(ValueError):
            JaxPlan.from_spec(bad)
    tp = ExecutionPlan.from_spec({"L0.*": "int8", "default": "exact"})
    with pytest.raises(ValueError, match="scanned"):
        tp.resolve_group(("L0.attn.q_proj", "L1.attn.q_proj"))


def test_site_registries_match_reference():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name in ARCHS:
        for red in (False, True):
            tcfg = get_arch(name).reduced() if red else get_arch(name)
            jcfg = JAX_ARCHS[name].reduced() if red else JAX_ARCHS[name]
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
            assert model_sites(tcfg) == jax_model_sites(jcfg)
            assert kv_sites(tcfg) == jax_kv_sites(jcfg)
