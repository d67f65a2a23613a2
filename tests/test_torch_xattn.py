"""The port's cross-attention (``xattn``) and vision-embedding entry points
against the reference's.

Reduced llama-3.2-vision-90b (one pattern period: four ``attn`` layers
and one ``xattn``; d_model 64, 4 heads over 2 KV heads of 16, 16 vision
tokens) at float32, the reference's weights bridged, inputs from numpy:

* ``attn_seq`` with ``kv_src`` and ``attn_decode`` of one ``xattn``
  layer under ``exact``, ``int8`` (projections int8, qk/pv exact) and
  ``mixed`` (projections sc, qk/pv on the batched int8 entry), against a
  cross cache filled from embeddings and against the zeroed one the
  engine serves with (an all-zero K quantizes at scale 1.0, not NaN);
* ``init_decode_state``: the cross cache holds ``vision_tokens``
  positions on both layouts, whatever ``max_len`` is;
* ``forward`` and ``Model.prefill`` with ``vision_embeds`` at
  ``reduced()`` and ``reduced(n_layers=10)`` (two periods: each slot's
  sites resolve as one group over its two layers);
* ``packed_prefill`` with embeddings at mixed lengths (the full-sequence
  pass), then 4 decode steps fed the reference's greedy tokens; without
  embeddings the forced masked scan; the ``NotImplementedError`` of a
  vision prefill that would have to scan;
* ``calibrate`` with embeddings: the reference's ``act_scales`` and
  ``kv_scales``; the bridge of the cross-attention weights.

Tolerances: float32 under ``exact`` to 1e-4 (another summation order);
under the quantized plans the codes match given equal activations, but a
last-bit float32 difference can move a rounding tie by one code, so
logits compare to 2e-3 (as ``tests/test_torch_model.py``); calibrated
scales to a relative 1e-5 (``amax / 127`` of float32 absmaxes taken over
ten layers of activations that differ in their last bits: 1.4e-6 seen).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core.plan import ExecutionPlan as JaxPlan  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro.models.transformer import init_decode_state as jax_init_state  # noqa: E402
from repro.serve.prefill import packed_prefill as jax_packed_prefill  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions, forward, init_decode_state  # noqa: E402
from repro_torch.serve import packed_prefill  # noqa: E402

NAME = "llama-3.2-vision-90b"
ATOL = {"exact": 1e-4, "int8": 2e-3, "mixed": 2e-3}


def _cfgs(**red):
    return (dataclasses.replace(jax_get_arch(NAME).reduced(**red), dtype="float32"),
            dataclasses.replace(get_arch(NAME).reduced(**red), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _weights(**red):
    jcfg, tcfg = _cfgs(**red)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(2))
    return jparams, params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


def _side(plan="exact", **red):
    """Reference and port models of the reduced arch under ``plan`` on the
    same weights (drawn once per config)."""
    jcfg, tcfg = _cfgs(**red)
    jparams, tparams = _weights(**red)
    tmodel = Model(tcfg, ModelOptions(plan=plan), device="cpu")
    return (JaxModel(jcfg, JaxOptions(plan=plan)), jparams), (tmodel, tmodel.prepare(tparams))


@pytest.fixture(scope="module")
def sides():
    return {plan: _side(plan) for plan in ("exact", "int8")}


def _embeds(cfg, b, seed=7):
    return np.random.default_rng(seed).normal(0, 1, (b, cfg.vision_tokens, cfg.d_model)) \
        .astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("cache", ["filled", "zeroed"])
@pytest.mark.parametrize("plan", ["exact", "int8", "mixed"])
def test_xattn_layer_matches_reference(plan, cache):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    jp = jattn.attn_init(jax.random.PRNGKey(5), jcfg, cross=True)
    tp = {k: {kk: _t(vv) for kk, vv in d.items()} for k, d in jp.items()}
    x = rng.normal(0, 1, (2, 7, jcfg.d_model)).astype(np.float32)
    src = _embeds(jcfg, 2)
    jsites = JaxPlan.from_spec(plan).binding("xattn", (4,))
    tsites = ExecutionPlan.from_spec(plan).binding("xattn", (4,))
    jout, jc = jattn.attn_seq(jp, jnp.asarray(x), jcfg, kind="xattn", sites=jsites,
                              kv_src=jnp.asarray(src), return_cache=True)
    tout, tc = tattn.attn_seq(tp, _t(x), tcfg, kind="xattn", sites=tsites, kv_src=_t(src),
                              return_cache=True)
    _close(tout, jout, ATOL[plan], "attn_seq")
    assert tc.k.shape == (2, tcfg.n_kv_heads, tcfg.vision_tokens, tcfg.head_dim)
    _close(tc.k, jc.k, ATOL[plan], "cross K")
    _close(tc.v, jc.v, ATOL[plan], "cross V")
    if cache == "zeroed":
        jc = jattn.init_cache(jcfg, "xattn", 2, 5)
        tc = tattn.init_cache(tcfg, 2, 5, kind="xattn")
        assert tc.k.shape == tuple(jc.k.shape)
    tk, tv = tc.k.clone(), tc.v.clone()
    xd = rng.normal(0, 1, (2, 1, jcfg.d_model)).astype(np.float32)
    pos = np.asarray([3, 9], np.int32)
    jo, _ = jattn.attn_decode(jp, jnp.asarray(xd), jc, jnp.asarray(pos), jcfg, kind="xattn",
                              sites=jsites)
    to, tc2 = tattn.attn_decode(tp, _t(xd), tc, _t(pos), tcfg, kind="xattn", sites=tsites)
    assert np.isfinite(to.numpy()).all()
    _close(to, jo, ATOL[plan], "attn_decode")
    assert torch.equal(tc2.k, tk) and torch.equal(tc2.v, tv)  # read, never written


@pytest.mark.parametrize("paged", [None, (9, 4)])
def test_init_decode_state_gives_cross_caches_vision_positions(paged):
    jcfg, tcfg = _cfgs(n_layers=10)
    want = jax_init_state(jcfg, 3, 12, paged=paged)
    got = init_decode_state(tcfg, 3, 12, paged=paged, device="cpu")
    for li, (kind, st) in enumerate(zip(tcfg.layer_kinds, got["layers"])):
        ref = want["units"][f"slot{li % 5}"]
        assert tuple(st.k.shape) == tuple(ref.k.shape[1:]), (li, kind)
        if kind == "xattn":
            assert isinstance(st, tattn.KVCache) and st.k.shape[2] == tcfg.vision_tokens != 12
            assert not st.k.any()
        else:
            assert isinstance(st, tattn.PagedKVCache if paged else tattn.KVCache)


def _teacher_forced(jmodel, jparams, tmodel, tparams, toks, vis):
    """Each port layer run on the reference's own input to that layer, then
    the port's final norm and head on the reference's last hidden state:
    the largest difference of any layer's output, and of the logits."""
    from repro.models import transformer as jt
    from repro.models.layers import embed_tokens as jax_embed, head_apply as jax_head
    from repro.models.layers import norm_apply as jax_norm
    from repro_torch.models import transformer as tt

    cfg, jcfg = tmodel.cfg, jmodel.cfg
    sites = tt._layer_sites(tmodel.opts.plan, cfg)
    jx = jax_embed(jparams["embedding"], jnp.asarray(toks), jcfg)
    block = jax.jit(jt.block_apply_seq, static_argnums=(2, 3, 4, 5))  # a slot's units share it
    worst = 0.0
    for li, kind in enumerate(cfg.layer_kinds):
        p = jax.tree.map(lambda a, u=li // 5: a[u], jparams["units"][f"slot{li % 5}"])
        x_in = _t(jx)
        jx, _, _ = block(p, jx, jcfg, kind, jmodel.opts, jt._slot_layers(jcfg, li % 5),
                         vision_embeds=jnp.asarray(vis))
        blk = tparams["layers"][li]
        h = tt.norm_apply(blk["pre_norm"], x_in, cfg.norm, cfg.norm_eps)
        out, _ = tattn.attn_seq(blk["core"], h, cfg, kind=kind, sites=sites[li], kv_src=_t(vis))
        tx = tt._mlp(blk, x_in + out, cfg, sites[li])
        worst = max(worst, float(np.abs(tx.numpy() - np.asarray(jx)).max()))
    jlog = jax_head(jparams["head"], jparams["embedding"],
                    jax_norm(jparams["final_norm"], jx, jcfg.norm, jcfg.norm_eps), jcfg,
                    jmodel.opts.plan.site("lm_head"))
    tlog = tt._head(tparams, _t(jx), cfg, tmodel.opts)
    return worst, float(np.abs(tlog.numpy() - np.asarray(jlog)).max())


@pytest.mark.parametrize("n_layers", [5, 10])
@pytest.mark.parametrize("plan", ["exact", "int8"])
def test_forward_and_prefill_with_vision_embeds_match_reference(plan, n_layers):
    """Logits end to end, except under ``int8`` at two periods: there each
    layer and the head are held on the reference's own inputs.  End to
    end, the two-period stack's float32 differences (under 2e-6 after
    layer 8) put layer 9's ``q_proj`` input at position 4, channel 21 at
    -28.499996 in code units, 3.8e-6 from the half, so that code rounds
    the other way and the per-tensor scales after it move every
    position's logits by up to 0.04; from the same input layer 9 agrees
    to 1e-6."""
    (jmodel, jparams), (tmodel, tparams) = _side(plan, n_layers=n_layers)
    cfg = tmodel.cfg
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 9), dtype=np.int32)
    vis = _embeds(cfg, 2)
    batch = {"tokens": toks, "vision_embeds": vis}
    jlog, jst = jmodel.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                               max_len=16)
    tlog, tst = tmodel.prefill(tparams, {k: _t(v) for k, v in batch.items()}, max_len=16)
    flog, _ = forward(tparams, _t(toks), cfg, tmodel.opts, vision_embeds=_t(vis))
    assert torch.equal(flog, tlog)
    if plan == "exact" or n_layers == 5:
        _close(tlog, jlog, ATOL[plan], "prefill logits")
    else:
        layer_err, head_err = _teacher_forced(jmodel, jparams, tmodel, tparams, toks, vis)
        assert layer_err < ATOL[plan] and head_err < ATOL[plan], (layer_err, head_err)
    for li, st in enumerate(tst):
        ref = jax.tree.map(lambda a, u=li // 5: a[u], jst["units"][f"slot{li % 5}"])
        assert st.k.shape == ref.k.shape, li
        _close(st.k, ref.k, ATOL[plan], f"layer {li} K")
        _close(st.v, ref.v, ATOL[plan], f"layer {li} V")


def test_forward_without_embeds_is_refused():
    _, (tmodel, tparams) = _side()
    with pytest.raises(ValueError, match="kv_src"):
        forward(tparams, torch.zeros((1, 3), dtype=torch.int32), tmodel.cfg, tmodel.opts)


@pytest.mark.parametrize("plan", ["exact", "int8"])
def test_packed_prefill_with_embeds_then_decode_matches_reference(sides, plan):
    """Mixed lengths with embeddings: the full-sequence pass (``FULL_SEQ_
    KINDS`` holds ``xattn``), then 4 greedy steps on its states."""
    (jmodel, jparams), (tmodel, tparams) = sides[plan]
    cfg = tmodel.cfg
    rng = np.random.default_rng(5)
    lens = [9, 4, 6]
    toks = np.zeros((3, 9), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
    vis = _embeds(cfg, 3, seed=8)
    jlast, jst = jax_packed_prefill(jmodel, jparams, jnp.asarray(toks), jnp.asarray(lens),
                                    24, vision_embeds=jnp.asarray(vis), lengths_static=lens)
    tlast, tst = packed_prefill(tmodel, tparams, _t(toks), _t(np.asarray(lens, np.int32)),
                                24, vision_embeds=_t(vis))
    _close(tlast, jlast, ATOL[plan], "last logits")
    cross = tst["layers"][4]
    assert cross.k.shape[2] == cfg.vision_tokens and cross.k.abs().sum() > 0
    pos = np.asarray(lens, np.int32)
    tok = np.asarray(jnp.argmax(jlast[:, -1], axis=-1))[:, None].astype(np.int32)
    jdecode = jax.jit(jmodel.decode)  # one compile, not each op of 4 steps eagerly
    for step in range(4):
        jlog, jst = jdecode(jparams, jnp.asarray(tok), jst, jnp.asarray(pos))
        tlog, tst = tmodel.decode(tparams, _t(tok), tst, _t(pos))
        _close(tlog, jlog, ATOL[plan], f"decode step {step}")
        tok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1))[:, None].astype(np.int32)
        pos = pos + 1


def test_packed_prefill_without_embeds_takes_the_scan(sides, monkeypatch):
    """No embeddings: the masked scan against zeroed cross caches (what the
    engine serves), on both sides, even where lengths are equal."""
    from repro_torch.serve import prefill as tprefill

    (jmodel, jparams), (tmodel, tparams) = sides["exact"]
    cfg = tmodel.cfg
    scans = []
    monkeypatch.setattr(tprefill, "prefill_full_seq", lambda *a, **k: pytest.fail("full-seq"))
    real_scan = tprefill.prefill_scan
    monkeypatch.setattr(tprefill, "prefill_scan",
                        lambda *a, **k: scans.append(1) or real_scan(*a, **k))
    for lens in ([7, 3], [5, 5]):
        toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, max(lens)), dtype=np.int32)
        jlast, jst = jax_packed_prefill(jmodel, jparams, jnp.asarray(toks), jnp.asarray(lens),
                                        16, lengths_static=lens)
        tlast, tst = tprefill.packed_prefill(tmodel, tparams, _t(toks),
                                             _t(np.asarray(lens, np.int32)), 16)
        _close(tlast, jlast, ATOL["exact"], f"lens {lens}")
        assert not tst["layers"][4].k.any()
        for li in range(4):
            _close(tst["layers"][li].k, jst["units"][f"slot{li}"].k[0], 1e-4, f"layer {li}")
    assert len(scans) == 2


@pytest.mark.parametrize("case", ["force_scan", "local_stack"])
def test_vision_prefill_that_must_scan_is_refused(case):
    """Embeddings given where the full-sequence pass is not exact: both
    sides raise the reference's NotImplementedError."""
    red = {} if case == "force_scan" else dict(block_pattern=("local", "xattn"), n_layers=2,
                                                window=4)
    (jmodel, jparams), (tmodel, tparams) = _side(**red)
    cfg = tmodel.cfg
    lens = [6, 3]
    toks = np.zeros((2, 6), np.int32)
    vis = _embeds(cfg, 2)
    kw = dict(force_scan=True) if case == "force_scan" else {}
    msg = "mixed-length prefill with vision frontends needs a full-seq-safe stack"
    with pytest.raises(NotImplementedError, match=msg):
        jax_packed_prefill(jmodel, jparams, jnp.asarray(toks), jnp.asarray(lens), 8,
                           vision_embeds=jnp.asarray(vis), lengths_static=lens, **kw)
    with pytest.raises(NotImplementedError, match=msg):
        packed_prefill(tmodel, tparams, _t(toks), _t(np.asarray(lens, np.int32)), 8,
                       vision_embeds=_t(vis), **kw)


def test_calibrate_with_embeds_matches_reference_scales():
    (jmodel, jparams), (tmodel, _) = _side("int8", n_layers=10)
    cfg = tmodel.cfg
    tparams = _weights(n_layers=10)[1]
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 8), dtype=np.int32)
    vis = _embeds(cfg, 2, seed=10)
    jplan = jmodel.calibrate(jparams, {"tokens": jnp.asarray(toks),
                                       "vision_embeds": jnp.asarray(vis)}).plan
    tplan = tmodel.calibrate(tparams, {"tokens": _t(toks), "vision_embeds": _t(vis)}).plan
    assert [s for s, _ in tplan.act_scales] == [s for s, _ in jplan.act_scales]
    assert any(s.startswith("L4.xattn.kv_proj") for s, _ in tplan.act_scales)
    np.testing.assert_allclose([a for _, a in tplan.act_scales],
                               [float(a) for _, a in jplan.act_scales], rtol=1e-5)
    assert [s for s, _ in tplan.kv_scales] == [s for s, _ in jplan.kv_scales]
    assert not any(".xattn" in s or s.startswith(("L4.", "L9.")) for s, _ in tplan.kv_scales)
    np.testing.assert_allclose([v for _, v in tplan.kv_scales],
                               [np.asarray(v, np.float64) for _, v in jplan.kv_scales],
                               rtol=1e-5)
    # the embeddings move the cross sites' scales: a text-only batch cannot
    # calibrate them (the reference needs them too)
    with pytest.raises(ValueError, match="kv_src"):
        tmodel.calibrate(tparams, {"tokens": _t(toks)})


def test_bridge_carries_cross_attention_weights():
    jcfg, tcfg = _cfgs(n_layers=10)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(11))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    assert [k for k in tcfg.layer_kinds].count("xattn") == 2
    for li in (4, 9):
        want = jparams["units"]["slot4"]
        got = tparams["layers"][li]
        assert sorted(got["core"]) == ["wk", "wo", "wq", "wv"]
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(got["core"][name]["w"].numpy(),
                                          np.asarray(want["core"][name]["w"][li // 5]))
        np.testing.assert_array_equal(got["mlp"]["gate"]["w"].numpy(),
                                      np.asarray(want["mlp"]["gate"]["w"][li // 5]))
