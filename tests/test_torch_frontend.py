"""The port's open-loop front-end (``serve/frontend.py``) against the
reference's, on a ``VirtualClock``.

Reduced stablelm-1.6b at float32, the reference's weights bridged into the
port, the same prompts.  Each case drives the reference's front-end and the
port's the same way; every output must match (tokens, ``reject_reason``,
``fault_reason`` and every ``RequestTiming`` field) and so must the
front-end and engine counters.  On the port side the reference's claims
are held as well:

* per-token streams (``TokenStream``, ``on_tokens``) equal ``run()``'s
  tokens, exactly once, on the dense layout, the paged pool with prefix
  reuse, under chunked prefill, and on paged recurrentgemma;
* a finished request drains mid-stream without disturbing the others;
* ``queue_full`` and ``queue_timeout`` rejections are terminal outputs
  with queue-wait-only timing; the waiting line respects
  ``max_queue_depth``, and ``max_concurrency`` caps the requests in
  flight (and may not exceed ``max_slots``);
* queue time is anchored at the front-end's arrival;
* the config surface refuses nonsense values with the reference's
  messages.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import serve as tserve  # noqa: E402
from torch_serve_stacks import (  # noqa: E402
    make_side, prompts, run_both, stack,
)


@pytest.fixture(scope="module")
def stablelm():
    return make_side("stablelm-1.6b")


@pytest.fixture(scope="module")
def rgemma():
    return make_side("recurrentgemma-2b", window=8)


def fe_stack(models, fe_kw=None, **serve_kw):
    serve_kw.setdefault("max_slots", 4)
    serve_kw.setdefault("max_len", 96)
    serve_kw.setdefault("kv_block_size", 0)
    return dict(fe_kw=fe_kw, supervised=False, **serve_kw)


def _streams(lens, gen):
    def drive(side, fe, eng, sup, clk):
        streams = [fe.stream(p, gen) for p in prompts(eng.model.cfg, lens)]
        for s in streams:
            toks = list(s)  # pumps on demand
            assert s.finished and s.output is not None
            got = np.stack(toks, axis=-1) if toks else np.zeros((0,), np.int32)
            np.testing.assert_array_equal(got, s.output.tokens)
        outs = fe.drain()
        assert sorted(o.request_id for o in outs) == [s.request_id for s in streams]
        assert fe.drain() == [] and fe.run() == []
        return outs
    return drive


@pytest.mark.parametrize("fixture,serve_kw", [
    ("stablelm", {}),
    ("stablelm", {"kv_block_size": 16}),
    ("stablelm", {"kv_block_size": 16, "prefill_chunk_tokens": 32}),
    ("rgemma", {"kv_block_size": 8}),
], ids=["dense", "paged_prefix", "chunked_prefill", "paged_recurrentgemma"])
def test_stream_token_identical_to_run_and_reference(request, fixture, serve_kw):
    models = request.getfixturevalue(fixture)
    lens, gen = [7, 16, 16, 31], 12
    outs, (fe, eng, _, _) = run_both(models, _streams(lens, gen), **fe_stack(models, **serve_kw))
    model, params = models["port"]
    batch = tserve.ServeEngine(model, params, tserve.ServeConfig(
        max_slots=4, max_len=96, chunk_steps=2, astra_accounting=False,
        **{"kv_block_size": 0, **serve_kw}), device="cpu")
    want = batch.generate_batch(prompts(model.cfg, lens), gen)
    for o, w in zip(sorted(outs, key=lambda o: o.request_id), want):
        np.testing.assert_array_equal(o.tokens, w.tokens)


def test_callback_and_mid_stream_drain(stablelm):
    def drive(side, fe, eng, sup, clk):
        short, long_, third = prompts(eng.model.cfg, [8, 8, 9])
        chunks = []
        rid = fe.submit(third, 10, on_tokens=chunks.append)
        s_short = fe.stream(short, 2)
        s_long = fe.stream(long_, 24)
        long_toks = []
        while not s_short.finished:
            long_toks.append(next(s_long))
        drained = fe.drain()  # the short request finished mid-stream
        assert s_short.request_id in [o.request_id for o in drained]
        long_toks.extend(s_long)
        np.testing.assert_array_equal(np.stack(long_toks, axis=-1), s_long.output.tokens)
        outs = drained + fe.run()
        got = {o.request_id: o for o in outs}
        np.testing.assert_array_equal(np.concatenate(chunks, axis=-1), got[rid].tokens)
        assert sum(c.shape[-1] for c in chunks) == 10 and len(chunks) > 1
        return outs

    run_both(stablelm, drive, **fe_stack(stablelm))


def test_gen_len_zero_and_eos_trimmed_stream(stablelm):
    model, params = stablelm["port"]
    [p] = prompts(model.cfg, [11])
    eng = tserve.ServeEngine(model, params, tserve.ServeConfig(
        max_slots=1, max_len=96, chunk_steps=4, astra_accounting=False), device="cpu")
    [ref] = eng.generate_batch([p], 16)
    eos = int(ref.tokens[3])  # a token it will emit

    def drive(side, fe, eng, sup, clk):
        s0 = fe.stream(p, 0)
        assert s0.finished and s0.output.gen_len == 0 and list(s0) == []
        s = fe.stream(p, 16, eos_id=eos)
        toks = list(s)
        np.testing.assert_array_equal(np.stack(toks, axis=-1), s.output.tokens)
        assert s.output.gen_len < 16 and int(toks[-1]) == eos
        return fe.drain()

    run_both(stablelm, drive, **fe_stack(stablelm))


def test_queue_full_rejection_is_visible(stablelm):
    def drive(side, fe, eng, sup, clk):
        rids = [fe.submit(p, 4) for p in prompts(eng.model.cfg, [6, 6, 6])]
        rejected = fe.drain()  # one in flight, one waiting, one over the bound
        assert [o.request_id for o in rejected] == [rids[2]]
        assert rejected[0].gen_len == 0 and rejected[0].timing is not None
        return rejected + fe.run()

    outs, (fe, _, _, _) = run_both(stablelm, drive, **fe_stack(
        stablelm, dict(max_queue_depth=1, max_concurrency=1), max_slots=1))
    assert [o.reject_reason for o in outs] == [tserve.REJECT_QUEUE_FULL, None, None]
    st = fe.stats
    assert st["rejected_queue_full"] == 1 and st["completed"] == 2
    assert st["max_queue_depth"] <= 1


def test_queue_timeout_rejection_counts_wait(stablelm):
    def drive(side, fe, eng, sup, clk):
        for p in prompts(eng.model.cfg, [6, 6]):
            fe.submit(p, 8)
        clk.advance(0.75)  # past the timeout while still queued
        fe.pump()
        return fe.drain() + fe.run()

    outs, (fe, _, _, _) = run_both(stablelm, drive, **fe_stack(
        stablelm, dict(max_concurrency=1, queue_timeout_s=0.5), max_slots=1))
    by_id = {o.request_id: o for o in outs}
    assert by_id[1].reject_reason == tserve.REJECT_QUEUE_TIMEOUT
    assert by_id[1].timing.queue_time_s == pytest.approx(0.75)
    assert by_id[0].reject_reason is None and fe.stats["rejected_queue_timeout"] == 1


def test_concurrency_cap_and_queue_wait_anchor(stablelm):
    """``max_concurrency=2`` over 4 slots: never more than two requests in
    the engine, and the waiting ones' queue time covers the front-end
    wait."""
    def drive(side, fe, eng, sup, clk):
        for p in prompts(eng.model.cfg, [6, 7, 8, 9]):
            fe.submit(p, 6)
        peak = 0
        while fe.busy():
            clk.advance(0.05)
            fe.pump()
            peak = max(peak, eng.stats()["slots_live"], fe.stats["in_flight"])
        assert peak == 2
        return fe.drain()

    outs, _ = run_both(stablelm, drive, **fe_stack(
        stablelm, dict(max_concurrency=2)))
    waits = sorted(o.timing.queue_time_s for o in outs)
    assert waits[2] > waits[1]  # the two held at the front-end waited longer


def test_rejected_stream_is_terminal(stablelm):
    def drive(side, fe, eng, sup, clk):
        a, b = prompts(eng.model.cfg, [6, 6])
        s_ok = fe.stream(a, 4)
        s_no = fe.stream(b, 4)
        assert s_no.finished and s_no.output.reject_reason == tserve.REJECT_QUEUE_FULL
        assert list(s_no) == []
        np.testing.assert_array_equal(np.stack(list(s_ok), axis=-1), s_ok.output.tokens)
        return fe.drain()

    run_both(stablelm, drive, **fe_stack(
        stablelm, dict(max_queue_depth=0, max_concurrency=1), max_slots=1))


@pytest.mark.parametrize("kw,match", [
    (dict(max_queue_depth=-1), "max_queue_depth=-1"),
    (dict(queue_timeout_s=0), "queue_timeout_s=0"),
    (dict(queue_timeout_s=-2.5), "queue_timeout_s=-2.5"),
    (dict(max_concurrency=0), "max_concurrency=0"),
])
def test_frontend_config_validation(kw, match):
    from repro.serve import FrontendConfig as JaxFrontendConfig

    for cls in (tserve.FrontendConfig, JaxFrontendConfig):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def test_max_concurrency_capped_by_slots_and_submit_validation(stablelm):
    fe, eng, _, _ = stack("port", stablelm, supervised=False, max_slots=2, max_len=16)
    with pytest.raises(ValueError, match="max_concurrency=5"):
        tserve.ServeFrontend(eng, tserve.FrontendConfig(max_concurrency=5))
    with pytest.raises(ValueError, match="empty prompt"):
        fe.submit(np.zeros((0,), np.int32), 4)
    [p] = prompts(eng.model.cfg, [8])
    with pytest.raises(ValueError, match="max_new_tokens=-1"):
        fe.submit(p, -1)
    with pytest.raises(ValueError, match="exceeds max_len 16"):
        fe.submit(p, 100)
    assert fe.stats["submitted"] == 0  # refused at intake: no id, no queue place
