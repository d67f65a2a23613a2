"""The port's fault layer (``serve/faults.py``, ``serve/supervisor.py``
and the engine's fault surface) against the reference's, through the
front-end on a virtual clock.

Reduced stablelm-1.6b at float32 (and reduced recurrentgemma on the paged
pool), the reference's weights bridged into the port, the same traces and
fault schedules.  Each case runs the reference stack (``VirtualClock`` ->
``ServeEngine`` -> ``EngineSupervisor`` -> ``ServeFrontend``) and the
port's side by side; every output must match: tokens, ``fault_reason``,
``reject_reason`` and every ``RequestTiming`` field, and so must the
front-end, supervisor and engine counters.  On the port side the
reference's claims are held as well:

* **isolation** over dense, paged + prefix, paged without prefix, paged
  int8 and paged recurrentgemma: a request no fault touched has the
  tokens of a fault-free replay, and its streamed chunks equal its
  output;
* **conservation**: ``submitted == completed + rejected + faulted +
  cancelled`` (+ what is still queued or in flight);
* **no leaks**: ``audit()`` passes after every step and at the end, and
  catches a planted refcount leak;
* ``cancel`` frees a decoding request's blocks; deadlines expire waiting
  and in-flight requests; retry completes a faulted request with the
  fault-free tokens and ends as a terminal fault once retries run out;
  pool pressure walks the degraded ladder to shedding and recovers;
* the injector's seeded schedule equals the reference's.

The port's engine ends a faulted slot's request before it raises, so the
supervisor's ``quarantine_slot`` of it is a no-op that counts nothing;
the counters must still equal the reference's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro import traffic as jtraffic  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch import traffic as ttraffic  # noqa: E402
from repro_torch.serve.faults import (  # noqa: E402
    CANCELLED, DEADLINE_EXCEEDED, FAULT_KINDS, FAULT_NONFINITE, FAULT_POOL_PRESSURE,
    FAULT_SLOW_STEP, FAULT_STEP_ERROR, RETRYABLE_FAULTS, FaultSpec, ServeFaultInjector,
)
from torch_serve_stacks import (  # noqa: E402
    conserved, make_side, prompts, run_both, stack, trace,
)


# ----------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def stablelm():
    return make_side("stablelm-1.6b")


@pytest.fixture(scope="module")
def calibrated():
    return make_side("stablelm-1.6b", plan="int8", calibrate_lens=(6, 10))


@pytest.fixture(scope="module")
def rgemma():
    return make_side("recurrentgemma-2b", window=8)


VARIANTS = {
    "paged-prefix": ("stablelm", {}),
    "paged-noprefix": ("stablelm", {"prefix_cache": False}),
    "dense": ("stablelm", {"kv_block_size": 0}),
    "paged-int8": ("calibrated", {"kv_quant": "int8"}),
    "paged-recurrentgemma": ("rgemma", {}),
}
CHAOS_KINDS = (FAULT_STEP_ERROR, FAULT_NONFINITE, FAULT_POOL_PRESSURE)


def _replay(side, fe, eng, sup, clk, n=8, seed=2):
    cfg = (eng.model.cfg)
    r = (jtraffic if side == "ref" else ttraffic).replay_trace(
        fe, trace(side, cfg, n=n, seed=seed), virtual_step_s=0.05)
    _replay.last[side] = r
    return r.outputs


_replay.last = {}


# ----------------------------------------------------------- chaos matrix
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_chaos_replay_matches_reference_and_isolates(request, variant):
    """A seeded step_error / nonfinite_logits / pool_pressure schedule over
    a chat trace, on every layout: the port equals the reference; requests
    no fault touched equal a fault-free replay; accounting conserves; the
    final audit is clean."""
    fixture, over = VARIANTS[variant]
    models = request.getfixturevalue(fixture)
    fe0, eng0, sup0, _ = stack("port", models, **over)
    clean = _replay("port", fe0, eng0, sup0, None)
    r0 = _replay.last["port"]
    assert fe0.stats["completed"] == len(clean)
    ref_tokens = {rid: r0.outputs_by_id[rid].tokens for rid in r0.request_ids}

    schedule = ServeFaultInjector.periodic(n_steps=40, every=4, kinds=CHAOS_KINDS,
                                           seed=7).schedule
    outs, (fe, eng, sup, _) = run_both(models, _replay, schedule=schedule, **over)
    r1 = _replay.last["port"]
    st = fe.stats
    assert conserved(st)
    assert sup.stats["faults_injected"] > 0 and st["faulted"] > 0
    n_unaffected = 0
    for i, rid0 in enumerate(r0.request_ids):
        o1 = r1.outputs_by_id[r1.request_ids[i]]
        if o1.fault_reason is None and o1.reject_reason is None:
            n_unaffected += 1
            np.testing.assert_array_equal(o1.tokens, ref_tokens[rid0])
        np.testing.assert_array_equal(r1.token_streams[r1.request_ids[i]], o1.tokens)
        assert o1.fault_reason is None or o1.fault_reason in RETRYABLE_FAULTS
    assert n_unaffected == st["completed"]
    rep = eng.audit(external_refs=sup.held_blocks)
    assert rep["leaked_blocks"] == 0 and rep["leaked_bytes"] == 0
    assert sup.stats["audits_run"] == sup.stats["steps"]


# ----------------------------------------------- per-class fault targeting
def _batch(lens=(6, 9, 12), gen=10, seed=5):
    def drive(side, fe, eng, sup, clk):
        for p in prompts(eng.model.cfg, lens, seed=seed):
            fe.submit(p, gen)
        return fe.run()
    return drive


@pytest.mark.parametrize("spec", [
    FaultSpec(step=2, kind=FAULT_NONFINITE, slot=1),
    FaultSpec(step=3, kind=FAULT_STEP_ERROR, slot=0),
    FaultSpec(step=2, kind=FAULT_SLOW_STEP, delay_s=1.5),
], ids=["nonfinite", "step_error", "slow_step"])
def test_targeted_fault_matches_reference(stablelm, spec):
    """One fault of each class into a batch: the victim keeps its pre-fault
    stream, every other request the fault-free tokens; a slow step moves
    latencies and no token."""
    clean, _ = run_both(stablelm, _batch())
    outs, (fe, eng, sup, _) = run_both(stablelm, _batch(), schedule=[spec])
    clean = {o.request_id: o for o in clean}
    faulted = [o for o in outs if o.fault_reason is not None]
    if spec.kind == FAULT_SLOW_STEP:
        assert not faulted
        assert max(o.timing.wall_time_s for o in outs) > \
            max(o.timing.wall_time_s for o in clean.values())
    else:
        assert [o.fault_reason for o in faulted] == [spec.kind]
        want = clean[faulted[0].request_id].tokens
        assert faulted[0].gen_len < want.shape[-1]
        np.testing.assert_array_equal(faulted[0].tokens, want[: faulted[0].gen_len])
        assert eng.stats()["n_quarantined"] == 1 and sup.stats["quarantined"] == 1
    for o in outs:
        if o.fault_reason is None:
            np.testing.assert_array_equal(o.tokens, clean[o.request_id].tokens)
    assert eng.audit(sup.held_blocks)["leaked_blocks"] == 0


def test_engine_ends_faulted_slot_before_raising(stablelm):
    """Without a supervisor the fault propagates, naming a slot the engine
    has already ended (pre-fault tokens, blocks scrubbed and freed); a later
    quarantine of it is a no-op that counts nothing, while a quarantine of
    any other empty slot is refused as in the reference."""
    model, params = stablelm["port"]
    eng = tserve.ServeEngine(model, params, tserve.ServeConfig(
        max_slots=2, max_len=64, chunk_steps=2, kv_block_size=8, astra_accounting=False),
        device="cpu")
    for p in prompts(model.cfg, (6, 9), seed=5):
        eng.submit(p, 10)
    eng.step()
    with pytest.raises(tserve.NonFiniteLogitsError) as err:
        eng.step(faults=[FaultSpec(step=0, kind=FAULT_NONFINITE, slot=1)])
    assert err.value.slots == (1,) and eng._slots[1] is None
    assert eng.stats()["n_quarantined"] == 1
    eng.quarantine_slot(1, FAULT_NONFINITE)
    assert eng.stats()["n_quarantined"] == 1
    outs = eng._drain()
    assert [o.fault_reason for o in outs] == [FAULT_NONFINITE]
    with pytest.raises(tserve.InjectedStepError) as err:
        eng.step(faults=[FaultSpec(step=0, kind=FAULT_STEP_ERROR)])
    assert err.value.slots == (0,) and eng.stats()["n_quarantined"] == 2
    eng.step()  # a new round forgets the last fault's slots
    with pytest.raises(ValueError, match="empty slot 1"):
        eng.quarantine_slot(1, FAULT_NONFINITE)
    assert eng.audit()["leaked_blocks"] == 0


def test_scrubbed_blocks_never_poison_later_tenants(stablelm):
    """A NaN-quarantined slot's blocks are zeroed before release: the next
    request on them decodes as on a fresh engine."""
    sched = [FaultSpec(step=1, kind=FAULT_NONFINITE, slot=0)]

    def drive(side, fe, eng, sup, clk):
        for p, g in zip(prompts(eng.model.cfg, (10, 7), seed=6), (12, 8)):
            fe.submit(p, g)
        return fe.run()

    outs, (fe, eng, sup, _) = run_both(stablelm, drive, schedule=sched, max_slots=1,
                                       kv_pool_blocks=17, prefix_cache=False)
    assert [o.fault_reason for o in outs if o.fault_reason] == [FAULT_NONFINITE]
    model, params = stablelm["port"]
    fresh = tserve.ServeEngine(model, params, tserve.ServeConfig(
        max_slots=1, max_len=64, kv_block_size=8, astra_accounting=False), device="cpu")
    [want] = fresh.generate_batch(prompts(model.cfg, (10, 7), seed=6)[1:], 8)
    np.testing.assert_array_equal([o for o in outs if o.fault_reason is None][-1].tokens,
                                  want.tokens)


# ------------------------------------------------- cancel, deadline, retry
def test_cancel_frees_blocks_mid_decode(stablelm):
    seen = {}

    def drive(side, fe, eng, sup, clk):
        rids = [fe.submit(p, 16) for p in prompts(eng.model.cfg, (8, 8), seed=7)]
        fe.pump()
        live = eng._pool.n_live
        assert fe.cancel(rids[0]) is True
        outs = fe.run()
        seen[side] = (live, eng._pool.n_live, fe.cancel(12345), fe.cancel(rids[0]))
        return outs

    outs, (fe, eng, sup, _) = run_both(stablelm, drive)
    live_before, live_after, unknown, again = seen["port"]
    assert live_after < live_before and unknown is False and again is False
    assert sorted(o.fault_reason or "" for o in outs) == ["", CANCELLED]
    assert fe.stats["cancelled"] == 1 and fe.stats["completed"] == 1
    assert eng.stats()["n_cancelled"] == 1 and conserved(fe.stats)
    assert eng.audit(sup.held_blocks)["leaked_blocks"] == 0


def test_cancel_waiting_request_never_reaches_engine(stablelm):
    def drive(side, fe, eng, sup, clk):
        p = prompts(eng.model.cfg, (6, 6), seed=8)
        fe.submit(p[0], 12)
        assert fe.cancel(fe.submit(p[1], 12)) is True
        return fe.run()

    outs, _ = run_both(stablelm, drive, max_slots=1)
    assert [(o.fault_reason, o.gen_len) for o in outs][1] == (CANCELLED, 0)


def test_deadline_expires_waiting_and_inflight(stablelm):
    def drive(side, fe, eng, sup, clk):
        p = prompts(eng.model.cfg, (6, 6), seed=9)
        fe.submit(p[0], 40)
        fe.submit(p[1], 4)
        while fe.busy():
            clk.advance(0.05)
            fe.pump()
        return sorted(fe.drain(), key=lambda o: o.request_id)

    outs, (fe, eng, sup, _) = run_both(stablelm, drive, max_slots=1, deadline=0.4)
    assert [o.fault_reason for o in outs] == [DEADLINE_EXCEEDED] * 2
    assert outs[0].gen_len > 0 and outs[1].gen_len == 0
    assert fe.stats["cancelled"] == 2
    assert eng.audit(sup.held_blocks)["leaked_blocks"] == 0


def test_retry_completes_token_identically(stablelm):
    drive = lambda *a: _replay(*a, n=6, seed=11)  # noqa: E731
    clean, _ = run_both(stablelm, drive)
    sched = [FaultSpec(step=2, kind=FAULT_NONFINITE, slot=0),
             FaultSpec(step=5, kind=FAULT_STEP_ERROR, slot=1)]
    outs, (fe, eng, sup, _) = run_both(stablelm, drive, schedule=sched, retries=2)
    r = _replay.last["port"]
    assert fe.stats["retries"] >= 1
    assert fe.stats["completed"] == 6 and fe.stats["faulted"] == 0
    clean = {o.request_id: o.tokens for o in clean}
    for rid in r.request_ids:
        np.testing.assert_array_equal(r.outputs_by_id[rid].tokens, clean[rid])
        np.testing.assert_array_equal(r.token_streams[rid], r.outputs_by_id[rid].tokens)


def test_retry_exhaustion_goes_terminal(stablelm):
    sched = [FaultSpec(step=s, kind=FAULT_STEP_ERROR) for s in range(1, 200)]
    outs, (fe, eng, sup, _) = run_both(stablelm, _batch(lens=(6,), gen=8, seed=12),
                                       schedule=sched, retries=2, max_slots=1)
    assert [o.fault_reason for o in outs] == [FAULT_STEP_ERROR]
    assert fe.stats["retries"] == 2 and fe.stats["faulted"] == 1 and conserved(fe.stats)


def test_pool_pressure_sheds_then_recovers(stablelm):
    """A full-pool hold walks the ladder flush -> no admission -> shed: the
    big queued request ends as ``pool_pressure``, the small ones finish;
    after the hold a new request completes and the ladder relaxes."""
    sched = [FaultSpec(step=1, kind=FAULT_POOL_PRESSURE, duration=8)]

    def drive(side, fe, eng, sup, clk):
        small = [fe.submit(p, 6) for p in prompts(eng.model.cfg, (6, 6), seed=13)]
        fe.pump()
        clk.advance(0.05)
        fe.submit(prompts(eng.model.cfg, (30,), seed=14)[0], 26)
        outs = fe.run()
        assert all(o.fault_reason is None for o in outs if o.request_id in small)
        fe.submit(prompts(eng.model.cfg, (6,), seed=15)[0], 6)
        return outs + fe.run()

    outs, (fe, eng, sup, _) = run_both(stablelm, drive, schedule=sched, kv_pool_blocks=25)
    assert [o.fault_reason for o in outs] == [None, None, FAULT_POOL_PRESSURE, None]
    names = [name for _, name in eng.stats()["degraded_transitions"]]
    assert names[:3] == ["flush_prefix", "no_prefix_admission", "shed_load"]
    assert eng.stats()["degraded_level"] != "shed_load" and eng.stats()["n_shed"] == 1
    assert eng.audit(sup.held_blocks)["leaked_blocks"] == 0 and conserved(fe.stats)


# --------------------------------------------------------- audit teeth
@pytest.mark.parametrize("fixture", ["stablelm", "rgemma"])
def test_audit_catches_planted_refcount_leak(request, fixture):
    fe, eng, sup, _ = stack("port", request.getfixturevalue(fixture))
    fe.submit(prompts(eng.model.cfg, (8,), seed=14)[0], 6)
    fe.pump()
    held = [b for b in eng._slot_blocks if b][0][0]
    eng._pool.incref(held)  # a ref no holder explains
    with pytest.raises(RuntimeError, match="refcount drift"):
        eng.audit(sup.held_blocks)
    eng._pool.decref(held)
    eng._tables_np[2, 0] = held  # an empty slot's row off scratch
    with pytest.raises(RuntimeError, match="non-scratch device table row"):
        eng.audit(sup.held_blocks)
    eng._tables_np[2, 0] = 0
    fe.run()
    assert eng.audit(sup.held_blocks)["leaked_blocks"] == 0


# ------------------------------------------------- injector and validation
@pytest.mark.parametrize("seed,every,kinds", [
    (0, 4, CHAOS_KINDS), (7, 4, CHAOS_KINDS), (3, 5, (FAULT_STEP_ERROR, FAULT_NONFINITE)),
    (11, 1, FAULT_KINDS),
])
def test_injector_schedule_matches_reference(seed, every, kinds):
    got = ServeFaultInjector.periodic(n_steps=100 * 32 + every, every=every, kinds=kinds,
                                      seed=seed)
    want = jserve.ServeFaultInjector.periodic(n_steps=100 * 32 + every, every=every,
                                              kinds=kinds, seed=seed)
    assert [dataclasses.asdict(s) for s in got.schedule] == \
        [dataclasses.asdict(s) for s in want.schedule]
    assert got.pop(every - 1) and not got.pop(every - 1)
    assert got.n_pending == len(want.schedule) - 1


def test_fault_spec_and_frontend_validation(stablelm):
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec(step=0, kind="power_surge")
    with pytest.raises(ValueError, match="timing"):
        FaultSpec(step=-1, kind=FAULT_STEP_ERROR)
    with pytest.raises(ValueError, match="timing"):
        FaultSpec(step=0, kind=FAULT_SLOW_STEP, delay_s=-0.1)
    with pytest.raises(ValueError, match="every"):
        ServeFaultInjector.periodic(n_steps=4, every=0)
    with pytest.raises(ValueError, match="audit_every"):
        tserve.EngineSupervisor(None, audit_every=-1)
    for kw, field in ((dict(default_deadline_s=0.0), "default_deadline_s"),
                      (dict(max_retries=-1), "max_retries"),
                      (dict(retry_backoff_s=-0.5), "retry_backoff_s")):
        with pytest.raises(ValueError, match=field):
            tserve.FrontendConfig(**kw)
    fe_a, eng_a, _, _ = stack("port", stablelm, supervised=False, max_slots=1)
    _, eng_b, _, _ = stack("port", stablelm, supervised=False, max_slots=1)
    with pytest.raises(ValueError, match="different engine"):
        tserve.ServeFrontend(eng_a, supervisor=tserve.EngineSupervisor(eng_b))
    with pytest.raises(ValueError, match="deadline_s"):
        fe_a.submit(np.ones(4, np.int32), 2, deadline_s=-1.0)
