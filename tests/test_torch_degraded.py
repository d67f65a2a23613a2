"""The scheduler's policy objects and the paged engine's admission faults
against the reference, on the CPU.

``TokenBudgetScheduler.plan_chunks`` (with its counters),
``DegradedLadder`` and ``pow2_bucket`` are pure host policy: the port's
must give the reference's answers on the same inputs.  Then the port's
forms of the reference's admission-safety tests on a reduced float32
stablelm (weights bridged from the reference) at the pool floor (9
blocks: 2 slots x ceil(16 / 4) + scratch), the prefix tree holding 6
blocks and eviction stubbed out so the next admission cannot reserve its
blocks:

* the failure rolls back every incref, re-queues the request FCFS, keeps
  the free rows at scratch, and once eviction works again the request is
  served with the reference's tokens (blocking and chunked admission);
* ``degraded_mode=False`` raises "wedged" with every slot free instead of
  spinning (the reference raises in the same place);
* the default ladder walks flush_prefix -> no_prefix_admission ->
  shed_load and ends the request as a ``pool_pressure`` output, with the
  reference's outputs, transitions and counters.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import scheduler as jax_sched  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine, scheduler  # noqa: E402

# (token budget, [(needs, n_active_decode), ...]): rounds planned in turn
PLANS = [
    (10, [([(0, 20), (1, 5)], 2), ([(0, 3), (1, 5)], 2), ([(0, 4)], 10), ([], 0)]),
    (1, [([(3, 1)], 0), ([(3, 1), (4, 2)], 1), ([(4, 2)], 0)]),
    (64, [([(2, 100), (0, 7), (1, 0), (5, 30)], 3), ([(0, 40), (1, 40)], 63)]),
    (7, [([(0, 2), (1, 2), (2, 2), (3, 2)], 0), ([(1, 9)], 6), ([(1, 9)], 7)]),
]


@pytest.mark.parametrize("budget,rounds", PLANS, ids=[f"budget{b}" for b, _ in PLANS])
def test_plan_chunks_equals_reference(budget, rounds):
    ours = scheduler.TokenBudgetScheduler(scheduler.SchedulerConfig(budget))
    ref = jax_sched.TokenBudgetScheduler(jax_sched.SchedulerConfig(budget))
    for needs, n_active in rounds:
        assert ours.prefill_budget(n_active) == ref.prefill_budget(n_active)
        assert ours.plan_chunks(needs, n_active) == ref.plan_chunks(needs, n_active)
    assert ours.stats == ref.stats


def test_ladder_and_buckets_equal_reference():
    ours, ref = scheduler.DegradedLadder(), jax_sched.DegradedLadder()
    for step, move in enumerate("eeeeerreerrrrr"):
        got = ours.escalate(step) if move == "e" else ours.relax(step)
        want = ref.escalate(step) if move == "e" else ref.relax(step)
        assert (got, ours.level_name) == (want, ref.level_name)
    assert ours.transitions == ref.transitions
    assert scheduler.DegradedLadder.LEVEL_NAMES == jax_sched.DegradedLadder.LEVEL_NAMES
    for n in range(-1, 70):
        for cap in (1, 5, 16, 64):
            assert scheduler.pow2_bucket(n, cap) == jax_sched.pow2_bucket(n, cap)
    for bad in (0, -3):
        with pytest.raises(ValueError):
            scheduler.SchedulerConfig(bad)


@pytest.fixture(scope="module")
def arch():
    jcfg = dataclasses.replace(jax_get_arch("stablelm-1.6b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_arch("stablelm-1.6b").reduced(), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, n, dtype=np.int32)


def _shortfall_engine(arch, reference=False, chunked=False, **over):
    """An engine at the pool floor whose tree holds 6 of the 8 usable
    blocks (three 8-token prompts, 2 blocks each)."""
    jcfg, tcfg, jparams, tparams = arch
    kw = dict(max_slots=2, max_len=16, chunk_steps=2, kv_block_size=4, kv_pool_blocks=9,
              prefill_chunk_tokens=4 if chunked else 0, **over)
    if reference:
        eng = JaxServeEngine(JaxModel(jcfg), jparams, JaxServeConfig(astra_accounting=False, **kw))
    else:
        eng = ServeEngine(Model(tcfg, device="cpu"), tparams, ServeConfig(**kw), device="cpu")
    for s in range(3):
        eng.generate_batch([_prompt(jcfg.vocab, 8, 10 + s)], 4)
    assert eng.prefix_stats["interned_blocks"] == 6
    return eng


_want = {}


def _reference_tokens(arch, prompt):
    """The reference engine's greedy tokens of one request, alone."""
    key = prompt.tobytes()
    if key not in _want:
        jcfg, _, jparams, _ = arch
        eng = JaxServeEngine(JaxModel(jcfg), jparams, JaxServeConfig(
            max_slots=1, max_len=16, astra_accounting=False))
        _want[key] = eng.generate_batch([prompt], 4)[0].tokens
    return _want[key]


@pytest.mark.parametrize("chunked", [False, True], ids=["blocking", "chunked"])
def test_forced_evict_shortfall_rolls_back_and_recovers(arch, chunked):
    vocab = arch[0].vocab
    eng = _shortfall_engine(arch, chunked=chunked)
    # one slot keeps decoding, so blocks stay held and the engine is not idle
    busy_id = eng.submit(_prompt(vocab, 4, 20), 10)
    outs = eng.step()
    n_live0 = eng._pool.n_live
    real_evict = eng._prefix.evict
    eng._prefix.evict = lambda n, pool: 0  # forced shortfall
    blocked = _prompt(vocab, 8, 21)
    blocked_id = eng.submit(blocked, 4)
    outs += eng.step()  # admission fails cleanly; decode goes on
    assert eng._pool.n_live == n_live0  # no leaked increfs
    assert [r.id for r in eng._queue] == [blocked_id]  # re-queued, FCFS
    free_rows = [i for i, s in enumerate(eng._slots) if s is None]
    assert all(not eng._tables_np[i].any() for i in free_rows)  # rows at scratch
    assert eng.stats()["degraded_level"] == "flush_prefix"  # the stalled round escalated
    eng._prefix.evict = real_evict
    outs += eng.run()  # retries succeed once eviction works again
    by_id = {o.request_id: o for o in outs}
    assert busy_id in by_id and blocked_id in by_id
    assert by_id[blocked_id].fault_reason is None
    np.testing.assert_array_equal(by_id[blocked_id].tokens, _reference_tokens(arch, blocked))


def test_wedged_admission_raises_instead_of_spinning(arch):
    """Every slot free and admission failing forever can release nothing:
    without the ladder both engines raise instead of spinning."""
    prompt = _prompt(arch[0].vocab, 8, 22)
    for reference in (True, False):
        eng = _shortfall_engine(arch, reference=reference, degraded_mode=False)
        eng._prefix.evict = lambda n, pool: 0
        eng.submit(prompt, 4)
        with pytest.raises(RuntimeError, match="wedged"):
            eng.run()


@pytest.mark.parametrize("chunked", [False, True], ids=["blocking", "chunked"])
def test_degraded_ladder_sheds_instead_of_wedging(arch, chunked):
    """With the ladder on, the stalled request ends as a ``pool_pressure``
    output after flush_prefix -> no_prefix_admission -> shed_load; the
    outputs, transitions and counters equal the reference engine's."""
    prompt = _prompt(arch[0].vocab, 8, 22)
    got = {}
    for reference in (True, False):
        eng = _shortfall_engine(arch, reference=reference, chunked=chunked)
        eng._prefix.evict = lambda n, pool: 0
        rid = eng.submit(prompt, 4)
        [out] = [o for o in eng.run() if o.request_id == rid]
        st = eng.stats()
        got[reference] = (out.fault_reason, out.gen_len, st["n_shed"],
                          st["degraded_transitions"], st["step"],
                          {k: eng.kv_stats[k] for k in
                           ("degraded_level", "degraded_transitions", "prefix_admission")},
                          st["scheduler"], st["queued"], st["slots_live"])
    assert got[False] == got[True]
    reason, gen_len, n_shed, transitions = got[False][:4]
    assert (reason, gen_len, n_shed) == ("pool_pressure", 0, 1)
    assert [name for _, name in transitions] == [
        "flush_prefix", "no_prefix_admission", "shed_load"]
    assert got[False][5] == {"degraded_level": "shed_load", "degraded_transitions": 3,
                             "prefix_admission": False}


def test_dense_layout_has_no_ladder(arch):
    """Pool pressure is a paged-only condition: dense caches carry no ladder
    and report the normal level; ``stats()`` has the reference's keys
    that exist in the port."""
    _, tcfg, _, tparams = arch
    eng = ServeEngine(Model(tcfg, device="cpu"), tparams, ServeConfig(max_slots=2, max_len=16),
                      device="cpu")
    eng.generate_batch([_prompt(tcfg.vocab, 5, 1)], 2)
    st = eng.stats()
    assert set(st) == {"step", "queued", "slots_live", "n_quarantined", "n_cancelled", "n_shed",
                       "degraded_level", "degraded_transitions", "kv", "prefix", "scheduler"}
    assert (st["degraded_level"], st["degraded_transitions"], st["kv"], st["scheduler"]) == (
        "normal", [], {}, {"active": False})
    assert st["step"] >= 1 and st["n_shed"] == st["n_quarantined"] == st["n_cancelled"] == 0
