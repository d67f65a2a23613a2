"""The port's traffic package (``repro_torch.traffic``) against the
reference's; the replays and the open-loop CLI are in
``test_torch_replay.py``.

* Traces: a trace is a pure function of its seed, so the port's must equal
  the reference's bit for bit, for every suite and both arrival processes
  (and the reference's arrival and scenario helpers on the same
  generator); JSON written by either package loads in the other.
* Spec parsing and SLO scoring: ``parse_trace_spec`` gives the
  reference's dicts and refusals; ``evaluate`` gives the reference's
  scorecard on the same outputs.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import traffic as jtraffic  # noqa: E402
from repro.serve.accounting import RequestTiming as JaxRequestTiming  # noqa: E402
from repro.serve.engine import RequestOutput as JaxRequestOutput  # noqa: E402
from repro.traffic import arrivals as jarrivals  # noqa: E402
from repro.traffic import scenarios as jscenarios  # noqa: E402
from repro_torch import traffic as ttraffic  # noqa: E402
from repro_torch.serve import RequestOutput, RequestTiming  # noqa: E402
from repro_torch.traffic import arrivals, scenarios  # noqa: E402


@pytest.mark.parametrize("suite", sorted(ttraffic.SUITES))
@pytest.mark.parametrize("arrival", ttraffic.ARRIVAL_PROCESSES)
def test_trace_equals_reference(suite, arrival):
    for seed, rate, n in ((0, 4.0, 32), (5, 0.5, 7)):
        got = ttraffic.generate_trace(suite, rate, n, seed, vocab=50304, arrival=arrival)
        want = jtraffic.generate_trace(suite, rate, n, seed, vocab=50304, arrival=arrival)
        assert got.to_dict() == want.to_dict()
        for a, b in zip(got.requests, want.requests):
            assert a.prompt.dtype == b.prompt.dtype and a.arrival_s == b.arrival_s
        assert got.duration_s == want.duration_s
        assert ttraffic.trace_max_len(got) == jtraffic.trace_max_len(want)
    assert ttraffic.suite_engine_max_len(suite) == jtraffic.suite_engine_max_len(suite)
    assert ttraffic.suite_max_total_len(ttraffic.SUITES[suite]) == \
        jtraffic.suite_max_total_len(jtraffic.SUITES[suite])


def test_arrivals_and_scenarios_equal_reference():
    for fn, kw in ((arrivals.poisson_arrivals, {}),
                   (arrivals.bursty_arrivals, dict(burst_size=4, burst_spread_s=0.3))):
        got = fn(3.0, 13, np.random.default_rng(2), **kw)
        want = getattr(jarrivals, fn.__name__)(3.0, 13, np.random.default_rng(2), **kw)
        np.testing.assert_array_equal(got, want)
    got = scenarios.sample_requests(scenarios.SUITES["agent"], 9, 100, np.random.default_rng(4))
    want = jscenarios.sample_requests(jscenarios.SUITES["agent"], 9, 100,
                                      np.random.default_rng(4))
    for (gn, gp, gg), (wn, wp, wg) in zip(got, want):
        assert (gn, gg) == (wn, wg)
        np.testing.assert_array_equal(gp, wp)
    for fn, args, match in ((arrivals.poisson_arrivals, (0.0, 3), "rate_rps=0"),
                            (arrivals.bursty_arrivals, (1.0, 3), "burst_size=0")):
        kw = {"burst_size": 0} if fn is arrivals.bursty_arrivals else {}
        with pytest.raises(ValueError, match=match):
            fn(*args, np.random.default_rng(0), **kw)
    with pytest.raises(ValueError, match="shared_prefix_len"):
        scenarios.Scenario("x", prompt_lens=(4,), gen_lens=(1,), shared_prefix_len=4)


def test_trace_json_round_trip_across_packages(tmp_path):
    t = ttraffic.generate_trace("agent", 2.0, 8, seed=3, vocab=64, arrival="bursty")
    path = str(tmp_path / "port.json")
    t.save(path)
    back = jtraffic.TrafficTrace.load(path)
    assert back.to_dict() == t.to_dict()
    with open(path) as f:
        assert json.load(f)["suite"] == "agent"
    jpath = str(tmp_path / "ref.json")
    back.save(jpath)
    assert ttraffic.TrafficTrace.load(jpath).to_dict() == t.to_dict()


@pytest.mark.parametrize("spec", [
    "longdoc:rate=2.5,n=64,seed=9,arrival=bursty", "chat", "mixed:rate=4,n=32,seed=0",
    "nope:rate=1", "chat:bogus=1", "chat:arrival=warp", "chat:rate=0", "chat:n=0",
    "chat:rate",
])
def test_parse_trace_spec_equals_reference(spec):
    try:
        want = jtraffic.parse_trace_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ttraffic.parse_trace_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert ttraffic.parse_trace_spec(spec) == want


def _outs(rt_cls, ro_cls):
    rows = [(0, 0.1, 0.01, None, None), (1, 0.2, 0.05, None, None),
            (2, 0.9, 0.01, None, None), (3, 0.1, 0.50, None, None),
            (4, 0.0, 0.0, "queue_full", None), (5, 0.0, 0.0, "queue_timeout", None),
            (6, 0.3, 0.02, None, "nonfinite_logits"), (7, 0.0, 0.0, None, "cancelled")]
    out = []
    for rid, ttft, itl, reject, fault in rows:
        timing = rt_cls(queue_time_s=0.1 * rid, ttft_s=ttft, wall_time_s=ttft + 0.5,
                        mean_itl_s=itl / 2, max_itl_s=itl, n_token_events=3)
        toks = np.zeros((0 if reject else 4,), np.int32)
        out.append(ro_cls(rid, np.zeros((4,), np.int32), toks, wall_time_s=ttft + 0.5,
                          timing=timing, reject_reason=reject, fault_reason=fault))
    return out


def test_evaluate_equals_reference():
    port = _outs(RequestTiming, RequestOutput)
    ref = _outs(JaxRequestTiming, JaxRequestOutput)
    for slo in (None, (0.5, 0.1)):
        got = ttraffic.evaluate(port, 10.0, slo and ttraffic.SLOConfig(*slo), offered_rps=0.8)
        want = jtraffic.evaluate(ref, 10.0, slo and jtraffic.SLOConfig(*slo), offered_rps=0.8)
        assert got == want
    assert ttraffic.evaluate([], 1.0) == jtraffic.evaluate([], 1.0)
    for kw, match in ((dict(ttft_s=0, itl_s=1), "ttft_s=0"), (dict(ttft_s=1, itl_s=-1),
                                                                "itl_s=-1")):
        with pytest.raises(ValueError, match=match):
            ttraffic.SLOConfig(**kw)
    clk = ttraffic.VirtualClock(2.0)
    clk.advance(0.5)
    assert clk() == clk.now() == 2.5
    with pytest.raises(ValueError, match="dt_s=-1"):
        clk.advance(-1)
