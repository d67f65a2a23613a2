"""The port's chunked-prefill engine against the reference's, on the CPU.

Same reduced configs at float32, same weights (bridged from the
reference's ``init_params``), same numpy prompts, ``prefill_chunk_tokens
> 0`` on both engines: the port must emit exactly the reference's greedy
tokens, and the same scheduler counters and per-request ASTRA reports:

* stablelm on dense caches (the windowed masked scan over the engine's
  state) at two budgets, one with ``max_len`` 30, not a power of two,
  where a row whose chunk is narrower than its window runs gated steps
  past the dense cache (the clamp of ``attention.attn_decode``);
* stablelm on the paged pool with the prefix cache: a hit seeds a
  request's resident prefix and its chunks resume from it, at in-block
  offsets;
* recurrentgemma (window 8) on dense caches with prompts past the window;
* a calibrated ``int8`` plan on an int8 pool (both engines on the same
  scales, ``bridge.plan_from_reference``);
* a few seeded budgets and length mixes on both layouts.

Also: one window step at positions past the dense cache against the
reference's ``prefill_window`` (logits and caches, ``exact`` and a
dynamic ``int8`` plan), decode priority while a long prompt prefills,
the decode loop's ``active`` gate, and the CLI's chunked run and flags.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.prefill import pack_prompts as jax_pack_prompts  # noqa: E402
from repro.serve.prefill import prefill_window as jax_prefill_window  # noqa: E402
from repro_torch.bridge import params_from_reference, plan_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    GREEDY, ServeConfig, ServeEngine, SlotState, prefill_window,
)
from repro_torch.serve.decode_loop import make_fused_decode, unfused_decode  # noqa: E402


def _arch(name, **red):
    jcfg = dataclasses.replace(jax_get_arch(name).reduced(**red), dtype="float32")
    tcfg = dataclasses.replace(get_arch(name).reduced(**red), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def archs():
    return {"stablelm-1.6b": _arch("stablelm-1.6b"),
            "recurrentgemma-2b": _arch("recurrentgemma-2b", window=8)}


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in lens]


def _prefix_prompts(vocab):
    """A 16-token prompt served first (interned), then it again and an
    extension of it: both hit the prefix cache."""
    [shared] = _prompts(vocab, (16,))
    ext = np.concatenate([shared, _prompts(vocab, (5,), seed=7)[0]])
    return [[shared], [shared, ext]]


# name -> (arch, plan, prompt lengths or "prefix", gen, ServeConfig kwargs)
CASES = {
    "dense-budget3": ("stablelm-1.6b", "exact", (6, 11, 16), 8,
                      dict(max_slots=3, max_len=32, chunk_steps=4, prefill_chunk_tokens=3)),
    # max_len 30: round 2 plans 4 tokens of the first prompt beside 12 of
    # the second in a 16-wide window, so the first row's gated steps reach
    # positions 20..31, past its 30-position cache
    "dense-budget16-len30": ("stablelm-1.6b", "exact", (20, 26), 4,
                             dict(max_slots=2, max_len=30, chunk_steps=3,
                                  prefill_chunk_tokens=16)),
    "paged-prefix": ("stablelm-1.6b", "exact", "prefix", 6,
                     dict(max_slots=2, max_len=32, chunk_steps=3, kv_block_size=4,
                          prefill_chunk_tokens=3)),
    "rg-past-window": ("recurrentgemma-2b", "exact", (6, 11, 16), 8,
                       dict(max_slots=3, max_len=32, chunk_steps=4, prefill_chunk_tokens=5)),
    "int8-pool": ("stablelm-1.6b", "int8-calibrated", (7, 12), 6,
                  dict(max_slots=2, max_len=32, chunk_steps=3, kv_block_size=8,
                       kv_quant="int8", prefill_chunk_tokens=4)),
}
# seeded budgets x length mixes x layouts (the reference's property test)
RANDOM = [(budget, lens, bs) for budget, lens, bs in
          ((1, (3,), 0), (7, (14, 2, 9), 4), (13, (11, 5), 0), (20, (1, 13, 8), 4))]
for _budget, _lens, _bs in RANDOM:
    CASES[f"random-b{_budget}-{'-'.join(map(str, _lens))}-bs{_bs}"] = (
        "stablelm-1.6b", "exact", _lens, 5,
        dict(max_slots=2, max_len=24, chunk_steps=3, kv_block_size=_bs,
             prefill_chunk_tokens=_budget))


def _plans(arch, plan, prompts):
    """(reference plan, port plan): the int8 plan calibrated by the
    reference on the packed prompts, its scales carried across."""
    jcfg, _, jparams, _ = arch
    if plan != "int8-calibrated":
        return plan, plan
    toks, _ = jax_pack_prompts(prompts, jcfg)
    jplan = JaxModel(jcfg, JaxOptions(plan="int8")).calibrate(jparams, {"tokens": toks}).plan
    return jplan, plan_from_reference(jplan.act_scales, jplan.kv_scales, "int8")


def _serve(engine, batches, gen):
    return [o for batch in batches for o in engine.generate_batch(batch, gen)]


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_greedy_tokens_match_reference(archs, case):
    name, plan, lens, gen, kw = CASES[case]
    arch = archs[name]
    jcfg, tcfg, jparams, tparams = arch
    batches = (_prefix_prompts(jcfg.vocab) if lens == "prefix"
               else [_prompts(jcfg.vocab, lens, seed=sum(lens))])
    jplan, tplan = _plans(arch, plan, batches[0])
    jeng = JaxServeEngine(JaxModel(jcfg, JaxOptions(plan=jplan)), jparams, JaxServeConfig(**kw))
    teng = ServeEngine(Model(tcfg, ModelOptions(plan=tplan), device="cpu"), tparams,
                       ServeConfig(**kw), device="cpu")
    want, got = _serve(jeng, batches, gen), _serve(teng, batches, gen)
    assert teng.scheduler_stats["active"]
    assert teng.scheduler_stats == jeng.scheduler_stats
    assert teng.prefix_stats == jeng.prefix_stats
    for i, (o, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(o.tokens, w.tokens, err_msg=f"{case} request {i}")
        assert o.hardware.as_dict() == w.hardware.as_dict(), (case, i)
    if lens == "prefix":
        assert teng.prefix_stats["hit_tokens"] > 0
        assert [o.hardware.cached_prompt_tokens for o in got] == [0, 12, 16]


def _window_states(jcfg, tcfg, jparams, tparams, plan):
    """Both packages' dense states after one window that fills rows 0..2 of
    a 12-position cache to 8, 10 and 12 positions."""
    starts, lengths = np.zeros(3, np.int32), np.array([8, 10, 12], np.int32)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (3, 12), dtype=np.int32)
    jmodel = JaxModel(jcfg, JaxOptions(plan=plan))
    tmodel = Model(tcfg, ModelOptions(plan=plan), device="cpu")
    tparams = tmodel.prepare(tparams)
    _, jst = jax_prefill_window(jmodel, jparams, jnp.asarray(toks), jnp.asarray(starts),
                                jnp.asarray(lengths), jmodel.init_decode_state(3, 12))
    _, tst = prefill_window(tmodel, tparams, torch.from_numpy(toks), torch.from_numpy(starts),
                            torch.from_numpy(lengths), tmodel.init_decode_state(3, 12))
    return jmodel, tmodel, tparams, jst, tst


@pytest.mark.parametrize("plan", ["exact", "int8"])
def test_window_step_past_dense_cache_matches_reference(archs, plan):
    """A window whose gated steps sit past the 12-position dense cache
    (row 1 from position 11 on, row 2, full, at 12..15; row 0 in range):
    the port clamps those writes to the last position and puts them back,
    as the reference's ``dynamic_update_slice`` and state select do.  The
    window's logits and every cache equal the reference's (1e-4 under
    ``exact``; the dynamic ``int8`` scales span all three rows)."""
    jcfg, tcfg, jparams, tparams = archs["stablelm-1.6b"]
    jmodel, tmodel, tparams, jst, tst = _window_states(jcfg, tcfg, jparams, tparams, plan)
    starts, lengths = np.array([8, 10, 12], np.int32), np.array([3, 1, 0], np.int32)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (3, 4), dtype=np.int32)
    jlast, jst = jax_prefill_window(jmodel, jparams, jnp.asarray(toks), jnp.asarray(starts),
                                    jnp.asarray(lengths), jst)
    tlast, tst = prefill_window(tmodel, tparams, torch.from_numpy(toks),
                                torch.from_numpy(starts), torch.from_numpy(lengths), tst)
    atol = 1e-4 if plan == "exact" else 2e-3
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=atol, rtol=0)
    slot = jst["units"]["slot0"]
    for li, c in enumerate(tst["layers"]):
        np.testing.assert_allclose(c.k.numpy(), np.asarray(slot.k[li]), atol=atol, rtol=0)
        np.testing.assert_allclose(c.v.numpy(), np.asarray(slot.v[li]), atol=atol, rtol=0)


def test_decode_gate_keeps_inactive_states(archs):
    """``active`` in the fused and the unfused decode: the gated rows'
    dense caches and recurrent states are exactly what they were, the
    active rows' equal an ungated run's."""
    _, tcfg, _, tparams = archs["recurrentgemma-2b"]
    model = Model(tcfg, device="cpu")
    params = model.prepare(tparams)
    tok = torch.tensor([[3], [5], [7]], dtype=torch.int32)
    pos = torch.tensor([4, 9, 0])
    active = torch.tensor([True, False, True])

    def fresh():
        st = model.init_decode_state(3, 16)
        for leaf in (t for layer in st["layers"] for t in layer):
            leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator().manual_seed(1)))
        return st

    ref_toks, _, (_, free, _, _) = make_fused_decode(model)(
        params, tok, fresh(), pos, None, steps=2, sampler=GREEDY)
    for loop in (make_fused_decode(model), lambda *a, **k: unfused_decode(model, *a, **k)):
        before = fresh()
        kept = [[t.clone() for t in layer] for layer in before["layers"]]
        toks, _, (_, after, _, _) = loop(params, tok, before, pos, None, steps=2,
                                         sampler=GREEDY, active=active)
        np.testing.assert_array_equal(toks[active].numpy(), ref_toks[active].numpy())
        for layer, old, new in zip(after["layers"], kept, free["layers"]):
            for t, o, n in zip(layer, old, new):
                assert torch.equal(t[1], o[1])
                assert torch.equal(t[active], n[active])


def test_decode_is_not_starved_while_a_long_prompt_prefills(archs):
    """A long prompt admitted mid-decode is fed in chunks; every round of
    its prefill still delivers the decoding slot's tokens, and the tokens
    equal the blocking engine's on the same schedule."""
    _, tcfg, _, tparams = archs["stablelm-1.6b"]
    model = Model(tcfg, device="cpu")
    short, long_p = _prompts(tcfg.vocab, (4, 48), seed=3)
    outs = {}

    def decoded(eng, long_id):
        return sum(t.shape[-1] for s in eng._slots if s is not None and s.req.id != long_id
                   for t in s.generated)

    for budget in (8, 0):
        eng = ServeEngine(model, tparams, ServeConfig(
            max_slots=2, max_len=64, chunk_steps=2, kv_block_size=8,
            prefill_chunk_tokens=budget), device="cpu")
        eng.submit(short, 30)
        done = eng.step()  # short admits, prefills in one chunk, decodes
        long_id = eng.submit(long_p, 2)
        rounds = 0
        while budget:
            before = decoded(eng, long_id)
            done += eng.step()
            if not any(s is not None and s.req.id == long_id
                       and s.state is SlotState.PREFILLING for s in eng._slots):
                break
            assert decoded(eng, long_id) > before, "the decoding slot starved"
            rounds += 1
        done += eng.run()
        outs[budget] = {o.request_id: o.tokens for o in done}
        if budget:
            assert rounds >= 3
    for rid, toks in outs[0].items():
        np.testing.assert_array_equal(outs[8][rid], toks)


def test_cli_serves_chunked(capsys):
    """``--prefill-chunk-tokens`` on the CPU: a scheduler line, one modeled
    ASTRA line per request and the site energies; the flags' refusals."""
    outs = serve_cli.main(["--reduced", "--device", "cpu", "--gen", "3", "--batch", "3",
                           "--prompt-mix", "5,12", "--max-slots", "2", "--kv-block-size", "0",
                           "--prefill-chunk-tokens", "8", "--mode", "exact"])
    text = capsys.readouterr().out
    assert len(outs) == 3 and all(o.hardware is not None for o in outs)
    assert "scheduler: budget 8 tok/round" in text
    assert text.count("modeled ASTRA chip: latency") == 3
    assert "modeled ASTRA energy by site (top 5):" in text
    for argv, msg in ((["--prefill-chunk-tokens", "-1"], "negative"),
                      (["--kv-block-size", "0", "--no-degraded-mode"], "paged")):
        with pytest.raises(SystemExit):
            serve_cli.main(["--reduced", "--device", "cpu", *argv])
        assert msg in capsys.readouterr().err


def test_negative_budget_refused(archs):
    _, tcfg, _, tparams = archs["stablelm-1.6b"]
    with pytest.raises(ValueError, match="negative"):
        ServeEngine(Model(tcfg, device="cpu"), tparams, ServeConfig(prefill_chunk_tokens=-1),
                    device="cpu")
