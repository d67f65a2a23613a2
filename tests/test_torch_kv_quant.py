"""Calibration and the int8 KV pool of the port against the reference.

* ``kv_quantize``/``kv_dequantize``: codes and dequantized values
  bit-equal to the reference's on seeded numpy inputs, exact half-way
  ties (power-of-two scales) and values past +-127 scale included.
* ``Model.calibrate``: on the reference's weights (bridged) and the same
  tokens, the port's activation and KV scales cover the same sites as the
  reference's and agree to rtol 1e-6 (both take the float32 absmax of
  activations that differ only in float32 summation order, then divide
  by 127 in float64).  A three-layer stablelm shows a layer group sharing
  one scale, as the reference's shared scan tap gives it.
* The int8-pool plain versions of paged decode and causal prefill against
  the reference's kernel (Pallas, interpret mode) with per-KV-head
  scales, float32 to 1e-5 (both dequantize to the same float32 values;
  only summation order differs).
* The engine's three refusals of ``kv_quant="int8"``, the prefix gate
  that calibrated scales open, the pool's byte accounting at its real
  dtype, and the CLI's ``--calibrate --kv-quant int8``.

Greedy serving parity on the int8 pool is in ``test_torch_kv_quant_serve.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.kernels.paged_attention.ops import (  # noqa: E402
    paged_attention_decode as jax_paged_decode,
    paged_attention_prefill as jax_paged_prefill,
)
from repro.models.attention import kv_dequantize as jax_kv_dequantize  # noqa: E402
from repro.models.attention import kv_quantize as jax_kv_quantize  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro_torch.bridge import params_from_reference, plan_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.plan import ExecutionPlan, kv_sites  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    QuantPagedKVCache, kv_dequantize, kv_quantize,
)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine, kv_quant_reject_reason  # noqa: E402

CAL_RTOL = 1e-6


def _pair(name, n_layers=None):
    over = {} if n_layers is None else {"n_layers": n_layers}
    jcfg = dataclasses.replace(jax_get_arch(name).reduced(**over), dtype="float32")
    tcfg = dataclasses.replace(get_arch(name).reduced(**over), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(2))
    return jcfg, tcfg, jparams, params_from_reference(jax.tree.map(np.asarray, jparams),
                                                      tcfg, "cpu")


@pytest.fixture(scope="module")
def stablelm():
    return _pair("stablelm-1.6b")


@pytest.fixture(scope="module")
def calibrated(stablelm):
    """The port's int8 plan calibrated on the reference's scales."""
    jcfg, tcfg, jparams, tparams = stablelm
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (3, 12)).astype(np.int32)
    jplan = JaxModel(jcfg, JaxOptions(plan="int8")).calibrate(jparams, {"tokens": toks}).plan
    plan = plan_from_reference(jplan.act_scales, jplan.kv_scales, "int8")
    return Model(tcfg, ModelOptions(plan=plan), device="cpu"), tparams


# ------------------------------------------------------------ quantize
def test_kv_quantize_codes_bit_equal_to_reference(rng):
    kvh, hd = 4, 16
    scale = rng.uniform(0.005, 0.05, kvh).astype(np.float32)
    x = (rng.standard_normal((3, kvh, 9, hd)) * 2.5).astype(np.float32)  # some past 127 s
    pow2 = np.asarray([2.0 ** -6, 2.0 ** -4, 2.0 ** -7, 1.0], np.float32)
    ties = ((np.arange(-140, 140) + 0.5)[None, :, None] * pow2[:, None, None])
    ties = np.broadcast_to(ties, (kvh, 280, hd)).astype(np.float32)[None]
    for xs, s in ((x, scale), (ties, pow2)):
        want = np.asarray(jax_kv_quantize(jnp.asarray(xs), jnp.asarray(s)))
        got = kv_quantize(torch.from_numpy(xs), torch.from_numpy(s))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
        deq = kv_dequantize(got, torch.from_numpy(s)).numpy()
        np.testing.assert_array_equal(deq, np.asarray(jax_kv_dequantize(jnp.asarray(want),
                                                                        jnp.asarray(s))))
    codes = kv_quantize(torch.from_numpy(ties), torch.from_numpy(pow2)).numpy()
    assert {-127, 127} <= set(np.unique(codes))  # saturated
    assert (codes[0, :, 139:141, 0] == 0).all()  # -0.5 and 0.5 round to even 0


# ------------------------------------------------------------ calibrate
@pytest.mark.parametrize("name,n_layers", [("stablelm-1.6b", 3), ("qwen1.5-0.5b", None)])
def test_calibrate_scales_match_reference(name, n_layers):
    jcfg, tcfg, jparams, tparams = _pair(name, n_layers)
    rng = np.random.default_rng(3)
    for plan, toks in (("int8", rng.integers(0, jcfg.vocab, (3, 13))),
                       ("mixed", rng.integers(0, jcfg.vocab, (2, 7)))):
        toks = toks.astype(np.int32)
        want = JaxModel(jcfg, JaxOptions(plan=plan)).calibrate(jparams, {"tokens": toks}).plan
        got = Model(tcfg, ModelOptions(plan=plan), device="cpu").calibrate(
            tparams, {"tokens": torch.from_numpy(toks)}).plan
        assert got.name == want.name
        assert [(p, cc.mode) for p, cc in got.rules] == [(p, cc.mode) for p, cc in want.rules]
        wa, ga = dict(want.act_scales), dict(got.act_scales)
        assert set(ga) == set(wa) and len(wa) == 7 * jcfg.n_layers + 1
        for s in wa:
            np.testing.assert_allclose(ga[s], wa[s], rtol=CAL_RTOL, err_msg=s)
        wk, gk = dict(want.kv_scales), dict(got.kv_scales)
        assert set(gk) == set(wk) == set(kv_sites(tcfg))
        for s in wk:
            assert len(gk[s]) == tcfg.n_kv_heads
            np.testing.assert_allclose(gk[s], wk[s], rtol=CAL_RTOL, err_msg=s)
        # one scanned group: every layer's site carries the group's max
        assert len({ga[f"L{li}.attn.q_proj"] for li in range(tcfg.n_layers)}) == 1
        assert len({gk[f"L{li}.kv.v"] for li in range(tcfg.n_layers)}) == 1


def test_calibrate_observer_is_not_cached(stablelm):
    """Each calibration records into its own observer: a second pass over
    other tokens gives that pass's scales, not a mix with the first."""
    jcfg, tcfg, jparams, tparams = stablelm
    model = Model(tcfg, ModelOptions(plan="int8"), device="cpu")
    rng = np.random.default_rng(9)
    big = rng.integers(0, jcfg.vocab, (4, 16)).astype(np.int32)
    small = big[:1, :3]
    model.calibrate(tparams, torch.from_numpy(big))
    again = model.calibrate(tparams, torch.from_numpy(small)).plan
    want = JaxModel(jcfg, JaxOptions(plan="int8")).calibrate(jparams, {"tokens": small}).plan
    np.testing.assert_allclose([a for _, a in again.act_scales],
                               [a for _, a in want.act_scales], rtol=CAL_RTOL)
    assert model.plan.act_scales == ()  # calibrate returns a new model


# ------------------------------------------------------------ int8 pools
def _int8_pool_inputs(rng, b, kvh, g, hd, bs, w, n_blocks, s=None):
    lead = (b, kvh * g, hd) if s is None else (b, kvh * g, s, hd)
    q = rng.standard_normal(lead).astype(np.float32)
    kp = rng.integers(-127, 128, (n_blocks, kvh, bs, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (n_blocks, kvh, bs, hd)).astype(np.int8)
    table = rng.integers(1, n_blocks, (b, w)).astype(np.int32)
    table[0, -1] = 0  # an entry at scratch block 0
    ks = rng.uniform(0.005, 0.03, kvh).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, kvh).astype(np.float32)
    return q, kp, vp, table, ks, vs


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("g,softcap", [(1, 0.0), (2, 5.0)])
def test_int8_pool_decode_plain_matches_reference_kernel(rng, g, softcap):
    kvh, hd, bs, w = 2, 16, 4, 3
    kv_len = np.asarray([0, 1, bs, bs + 1, w * bs], np.int32)
    q, kp, vp, table, ks, vs = _int8_pool_inputs(rng, 5, kvh, g, hd, bs, w, 16)
    want = jax_paged_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(table), jnp.asarray(kv_len), jnp.asarray(ks),
                            jnp.asarray(vs), softcap=softcap, interpret=True)
    before = (pa_ops.paged_attention_decode.launches,
              pa_ops.paged_attention_decode.int8_launches)
    got = pa_ops.paged_attention_decode(*_t(q, kp, vp, table, kv_len, ks, vs),
                                        softcap=softcap)
    assert (pa_ops.paged_attention_decode.launches,
            pa_ops.paged_attention_decode.int8_launches) == before  # CPU: plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert not got[0].any()  # kv_len == 0 -> zeros


@pytest.mark.parametrize("g", [1, 2])
def test_int8_pool_prefill_plain_matches_reference_kernel(rng, g):
    """Starts at 0, mid-block, one before a block edge, on it, and past it."""
    kvh, hd, bs, w, s = 2, 16, 4, 4, 3
    start = np.asarray([0, 2, bs - 1, bs, 2 * bs + 1], np.int32)
    q, kp, vp, table, ks, vs = _int8_pool_inputs(rng, 5, kvh, g, hd, bs, w, 24, s=s)
    want = jax_paged_prefill(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(table), jnp.asarray(start), jnp.asarray(ks),
                             jnp.asarray(vs), interpret=True)
    got = pa_ops.paged_attention_prefill(*_t(q, kp, vp, table, start, ks, vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_int8_pool_queries_stay_float32(rng):
    """A bf16 model's queries are cast to float32 for an int8 pool (not to
    the pool's int8), and the output comes back in the query dtype."""
    q, kp, vp, table, ks, vs = _int8_pool_inputs(rng, 2, 2, 2, 16, 4, 3, 8)
    kv_len = np.asarray([3, 9], np.int32)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    got = pa_ops.paged_attention_decode(tq, *_t(kp, vp, table, kv_len, ks, vs))
    want = jax_paged_decode(jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp), jnp.asarray(vp),
                            jnp.asarray(table), jnp.asarray(kv_len), jnp.asarray(ks),
                            jnp.asarray(vs), interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-2, rtol=0)


# ------------------------------------------------------------ engine gates
def test_rejects_dynamic_scale_plan(stablelm):
    """Uncalibrated int8 has batch-dependent act scales: refused with the
    reason; without kv_quant the plan serves with prefix reuse off."""
    _, tcfg, _, tparams = stablelm
    model = Model(tcfg, ModelOptions(plan="int8"), device="cpu")
    with pytest.raises(ValueError, match="deterministic"):
        ServeEngine(model, tparams, ServeConfig(max_slots=1, max_len=16, kv_block_size=4,
                                                kv_quant="int8"), device="cpu")
    eng = ServeEngine(model, tparams, ServeConfig(max_slots=1, max_len=16, kv_block_size=4),
                      device="cpu")
    assert not eng.kv_stats["prefix_cache"]
    assert "non-deterministic" in eng.kv_stats["prefix_cache_off_reason"]


def test_rejects_dense_layout(calibrated):
    model, params = calibrated
    assert "paged KV layout" in kv_quant_reject_reason(model, 0)
    assert kv_quant_reject_reason(model, 4) is None
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(model, params, ServeConfig(max_slots=1, max_len=16, kv_block_size=0,
                                               kv_quant="int8"), device="cpu")


def test_rejects_missing_kv_scales(calibrated):
    """Static act scales alone are not enough: every L{li}.kv.{k,v} site
    needs its calibrated scales."""
    model, params = calibrated
    static = model.with_plan(ExecutionPlan.from_spec(
        {"default": {"mode": "int8", "act_scale": 0.05}}))
    assert static.plan.kv_scale(kv_sites(model.cfg)[0]) is None
    with pytest.raises(ValueError, match="calibrate"):
        ServeEngine(static, params, ServeConfig(max_slots=1, max_len=16, kv_block_size=4,
                                                kv_quant="int8"), device="cpu")
    with pytest.raises(ValueError, match="kv_quant"):
        ModelOptions(kv_quant="int4")
    with pytest.raises(ValueError, match="kv_quant"):
        ServeEngine(model, params, ServeConfig(max_slots=1, max_len=16, kv_block_size=4,
                                               kv_quant="fp8"), device="cpu")


def test_calibrated_plans_turn_prefix_reuse_back_on(calibrated):
    """The existing gate needs no change: static scales on every quantized
    site make pooled KV deterministic, with and without kv_quant."""
    model, params = calibrated
    for kv_quant in ("none", "int8"):
        eng = ServeEngine(model, params, ServeConfig(max_slots=2, max_len=16, kv_block_size=4,
                                                     kv_quant=kv_quant), device="cpu")
        assert eng.kv_stats["prefix_cache"] and eng.kv_stats["kv_quant"] == kv_quant
        layer = eng._states["layers"][0]
        assert isinstance(layer, QuantPagedKVCache) == (kv_quant == "int8")


def test_kv_stats_byte_accounting_exact(calibrated):
    """bytes_per_block counts K and V of every layer at the pool's dtype:
    1 byte an element in int8, 4 in float32 (the scales are per pool)."""
    model, params = calibrated
    cfg = model.cfg
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in (6, 10)]
    stats = {}
    for kv_quant in ("int8", "none"):
        eng = ServeEngine(model, params, ServeConfig(max_slots=2, max_len=15, chunk_steps=2,
                                                     kv_block_size=4, kv_quant=kv_quant),
                          device="cpu")
        eng.generate_batch(prompts, 4)
        s = stats[kv_quant] = eng.kv_stats
        assert s["kv_quant"] == kv_quant
        assert s["pool_bytes"] == (s["pool_blocks"] - 1) * s["bytes_per_block"]
        assert s["live_bytes"] == s["live_blocks"] * s["bytes_per_block"]
        assert s["live_blocks"] == eng._pool.n_live
    elems = cfg.n_layers * 2 * cfg.n_kv_heads * 4 * cfg.head_dim
    assert stats["int8"]["bytes_per_block"] == elems
    assert stats["none"]["bytes_per_block"] == 4 * elems


def test_cli_calibrate_kv_quant(capsys):
    from repro_torch.launch.serve import main

    args = ["--reduced", "--device", "cpu", "--gen", "4", "--batch", "4",
            "--prompt-mix", "5,12", "--max-slots", "2", "--kv-block-size", "4",
            "--mode", "int8"]
    outs = main(args + ["--calibrate", "--kv-quant", "int8"])
    text = capsys.readouterr().out
    assert len(outs) == 4 and all(o.gen_len == 4 for o in outs)
    assert "calibrated 8 site activation scales + 2 KV storage-site scales" in text
    assert "int8 storage" in text and "prefix cache:" in text
    with pytest.raises(SystemExit):
        main(args + ["--kv-quant", "int8"])  # dynamic scales: refused at the flag
    assert "--kv-quant: kv_quant='int8' requires deterministic KV" in capsys.readouterr().err
