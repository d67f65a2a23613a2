"""recurrentgemma on the paged KV pool: the port's engine against the
reference's paged engine.

Reduced ``recurrentgemma-2b`` at float32 (RG-LRU layers beside one
sliding-window ``local`` layer), the reference's weights bridged into the
port, the same numpy prompts, block size 4.  The local layer's ring lives
in the pool (``ring_len = min(max_len, window)`` positions through the
table); the RG-LRU states stay by slot.  Admission prefills dense and
block-scatters the caches and rings into the pools
(``slots.paged_scatter_states``).  Greedy tokens must equal the
reference's in every case:

* ring: window 8, ``max_len 24``, prompts past the window, so rings wrap
  in admission and in decode;
* window > max_len (window 32, ``max_len 20``): the masked scan is forced
  and the ring is clamped to ``max_len``;
* mixed lengths (6, 11, 16) with three slots and block 8;
* chunked admission requested: the paged stateful stack falls back to
  blocking admission (``scheduler_stats["active"]`` False), same tokens;
* the int8 plan, and the int8 pool after ``calibrate`` (the reference's
  scales carried across);

on both attention paths (``naive``; ``flash``: the paged decode kernel's
plain version on the CPU).  ``kv_stats`` (bytes per block over the pool
leaves only, the prefix-off reason) and ``scheduler_stats`` equal the
reference's, and ``paged_scatter_states`` equals the reference's leaf for
leaf, scratch block 0 included, where several admitted rows point at it.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.attention import QuantPagedKVCache as JaxQuantPagedKVCache  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.prefill import pack_prompts as jax_pack_prompts  # noqa: E402
from repro.serve.prefill import packed_prefill as jax_packed_prefill  # noqa: E402
from repro.serve.slots import paged_scatter_states as jax_paged_scatter  # noqa: E402
from repro_torch.bridge import params_from_reference, plan_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    KVCache, PagedKVCache, QuantPagedKVCache,
)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.rglru import RGLRUState  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve.prefill import pack_prompts, packed_prefill  # noqa: E402
from repro_torch.serve.slots import paged_scatter_states  # noqa: E402

NAME = "recurrentgemma-2b"
GEN = 6
# case -> (prompt lengths, window, serve config)
CASES = {
    "ring": ((16, 3, 11, 5), 8, dict(max_slots=2, max_len=24, chunk_steps=3,
                                      kv_block_size=4)),
    "window_gt_max_len": ((5, 8, 8), 32, dict(max_slots=2, max_len=20, chunk_steps=3,
                                               kv_block_size=4)),
    "mixed_lengths": ((6, 11, 16), 8, dict(max_slots=3, max_len=26, chunk_steps=4,
                                           kv_block_size=8)),
    "chunked_fallback": ((16, 3, 11, 5), 8, dict(max_slots=2, max_len=24, chunk_steps=3,
                                                  kv_block_size=4, prefill_chunk_tokens=5)),
}


def _arch(window):
    jcfg = dataclasses.replace(jax_get_arch(NAME).reduced(window=window), dtype="float32")
    tcfg = dataclasses.replace(get_arch(NAME).reduced(window=window), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(6))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def archs():
    return {w: _arch(w) for w in (8, 32)}


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in lens]


_calibrated = {}


def _plans(archs, window, plan, lens):
    """(reference plan, port plan); ``int8-kvq`` is the int8 plan calibrated
    by the reference on the packed prompts, its scales carried across."""
    if plan != "int8-kvq":
        return plan, plan
    jcfg, _, jparams, _ = archs[window]
    key = (window, lens)
    if key not in _calibrated:
        toks, _ = jax_pack_prompts(_prompts(jcfg.vocab, lens), jcfg)
        _calibrated[key] = JaxModel(jcfg, JaxOptions(plan="int8")).calibrate(
            jparams, {"tokens": toks}).plan
    jplan = _calibrated[key]
    return jplan, plan_from_reference(jplan.act_scales, jplan.kv_scales, "int8")


_ref = {}


def _reference(archs, case, plan):
    key = (case, plan)
    if key not in _ref:
        lens, window, kw = CASES[case]
        jcfg, _, jparams, _ = archs[window]
        jplan, _ = _plans(archs, window, plan, lens)
        kvq = "int8" if plan == "int8-kvq" else "none"
        eng = JaxServeEngine(JaxModel(jcfg, JaxOptions(plan=jplan)), jparams,
                             JaxServeConfig(astra_accounting=False, kv_quant=kvq, **kw))
        outs = eng.generate_batch(_prompts(jcfg.vocab, lens), GEN)
        _ref[key] = ([o.tokens for o in outs], eng.kv_stats, eng.scheduler_stats)
    return _ref[key]


def _port(archs, case, plan, attn_impl):
    lens, window, kw = CASES[case]
    _, tcfg, _, tparams = archs[window]
    _, tplan = _plans(archs, window, plan, lens)
    kvq = "int8" if plan == "int8-kvq" else "none"
    model = Model(tcfg, ModelOptions(plan=tplan, attn_impl=attn_impl), device="cpu")
    eng = ServeEngine(model, tparams, ServeConfig(astra_accounting=False, kv_quant=kvq, **kw),
                      device="cpu")
    outs = eng.generate_batch(_prompts(tcfg.vocab, lens), GEN)
    return eng, [o.tokens for o in outs]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_paged_stateful_tokens_match_reference(archs, case, attn_impl):
    want, kv, sched = _reference(archs, case, "exact")
    eng, got = _port(archs, case, "exact", attn_impl)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{case} request {i}")
    assert eng.kv_stats == kv
    assert eng.scheduler_stats == sched
    lens, window, kw = CASES[case]
    assert eng._ring_len == min(kw["max_len"], window)
    assert eng._force_scan == (case == "window_gt_max_len")
    for st, kind in zip(eng._states["layers"], eng.model.cfg.layer_kinds):
        want_type = RGLRUState if kind == "rglru" else PagedKVCache
        assert isinstance(st, want_type), (kind, type(st))
        if kind == "rglru":
            assert st.h.shape[0] == kw["max_slots"]


@pytest.mark.parametrize("plan", ["int8", "int8-kvq"])
def test_paged_stateful_int8_matches_reference(archs, plan):
    """The int8 plan (dynamic scales: prefix cache off either way), and the
    calibrated int8 plan on an int8 pool, whose scatter quantizes the dense
    rings against the pool's scales."""
    want, kv, sched = _reference(archs, "ring", plan)
    eng, got = _port(archs, "ring", plan, "flash")
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{plan} request {i}")
    assert eng.kv_stats == kv and eng.scheduler_stats == sched
    if plan == "int8-kvq":
        local = [st for st, k in zip(eng._states["layers"], eng.model.cfg.layer_kinds)
                 if k == "local"]
        assert local and all(isinstance(st, QuantPagedKVCache) for st in local)
        assert kv["kv_quant"] == "int8"


def test_kv_stats_bytes_and_reason(archs):
    """bytes_per_block sums the pool leaves only (one local layer x K and V
    x bs x n_kv x hd x 4 B); the RG-LRU states are not per block."""
    eng, _ = _port(archs, "ring", "exact", "naive")
    cfg = eng.model.cfg
    n_local = sum(k == "local" for k in cfg.layer_kinds)
    assert eng.kv_stats["bytes_per_block"] == n_local * 2 * 4 * cfg.n_kv_heads * cfg.head_dim * 4
    assert eng.kv_stats["prefix_cache_off_reason"] == (
        "stateful stack: recurrent/windowed layers cannot resume from pooled blocks")
    assert not eng.kv_stats["prefix_cache"]
    assert eng.scheduler_stats == {"active": False}


def _per_layer(jcfg, states):
    """The reference's state layout (scanned units ``[U, ...]`` plus the
    remainder list) as one numpy NamedTuple per layer."""
    p = len(jcfg.block_pattern)
    n_units = jcfg.n_pattern_units
    out = []
    for li in range(jcfg.n_layers):
        if li < n_units * p:
            out.append(jax.tree.map(lambda a, u=li // p: np.asarray(a[u]),
                                    states["units"][f"slot{li % p}"]))
        else:
            out.append(jax.tree.map(np.asarray, states["rem"][li - n_units * p]))
    return out


def _bump(node):
    """+1 on every state leaf but an int8 pool's scales."""
    if isinstance(node, JaxQuantPagedKVCache):
        return node._replace(k=node.k + 1, v=node.v + 1)
    return node + 1


@pytest.mark.parametrize("pool", ["float32", "int8"])
def test_paged_scatter_states_matches_reference_leaf_for_leaf(archs, pool):
    """Three admitted prompts (two of them a single block long) scattered
    through table rows whose unallocated entries point at scratch block 0:
    every pool (scratch included) and every recurrent leaf equals the
    reference's scatter, as float32 and as an int8 pool."""
    jcfg, tcfg, jparams, tparams = archs[8]
    lens, max_len, bs, n_blocks, slots = (11, 3, 2), 24, 4, 20, 4
    prompts = _prompts(jcfg.vocab, lens, seed=3)
    slot_ids = np.asarray([2, 0, 3], np.int32)
    w = max_len // bs
    rows = np.zeros((len(lens), w), np.int32)
    nxt = 1
    for j, n in enumerate(lens):  # each row: its own blocks, scratch after
        need = -(-(n + 1) // bs)
        rows[j, :need] = np.arange(nxt, nxt + need)
        nxt += need
    plan_j = plan_t = "exact"
    if pool == "int8":
        toks, _ = jax_pack_prompts(prompts, jcfg)
        plan_j = JaxModel(jcfg, JaxOptions(plan="exact")).calibrate(
            jparams, {"tokens": toks}).plan
        plan_t = plan_from_reference(plan_j.act_scales, plan_j.kv_scales, "exact")
    kvq = "int8" if pool == "int8" else "none"
    jmodel = JaxModel(jcfg, JaxOptions(plan=plan_j, kv_quant=kvq))
    tmodel = Model(tcfg, ModelOptions(plan=plan_t, kv_quant=kvq), device="cpu")

    jtok, jlen = jax_pack_prompts(prompts, jcfg)
    _, jsmall = jax_packed_prefill(jmodel, jparams, jtok, jlen, max_len,
                                   lengths_static=list(lens))
    jbig = jmodel.init_decode_state(slots, max_len, paged=(n_blocks, bs))
    # non-zero starting contents, so untouched entries are checked too
    jbig = jax.tree.map(_bump, jbig, is_leaf=lambda x: isinstance(x, JaxQuantPagedKVCache))
    jout = jax_paged_scatter(jbig, jsmall, jnp.asarray(slot_ids), jnp.asarray(rows))

    # the port's own prefill agrees with the reference's to rounding; the
    # scatter itself is held bit for bit on the reference's prefill states
    ttok, tlen = pack_prompts(prompts, tcfg)
    _, own = packed_prefill(tmodel, tmodel.prepare(tparams), ttok, tlen, max_len)
    tsmall = {"layers": [type(st)(*(torch.from_numpy(np.array(a)) for a in ref))
                         for st, ref in zip(own["layers"], _per_layer(jcfg, jsmall))]}
    for st, ref in zip(own["layers"], tsmall["layers"]):
        for a, b in zip(st, ref):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    tbig = tmodel.init_decode_state(slots, max_len, paged=(n_blocks, bs))
    for st in tbig["layers"]:
        for leaf in st[:2]:  # K and V, or h and conv; an int8 pool's scales stay
            leaf += 1
    tout = paged_scatter_states(tbig, tsmall, torch.as_tensor(slot_ids), torch.as_tensor(rows))

    for li, (kind, st, ref) in enumerate(zip(tcfg.layer_kinds, tout["layers"],
                                             _per_layer(jcfg, jout))):
        if kind == "local":
            assert isinstance(st, QuantPagedKVCache if pool == "int8" else PagedKVCache)
            assert isinstance(tsmall["layers"][li], KVCache)
        for name, got, want in zip(type(st)._fields, st, ref):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"layer {li} {name}")
    # the single-block prompts' rings both spill into scratch: last row wins
    assert int((rows[:, : -(-8 // bs)] == 0).sum()) == 2
