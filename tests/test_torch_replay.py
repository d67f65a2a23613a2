"""Open-loop replay through the port's front-end, and the serving CLI's
traffic flags, against the reference's.

* One replay: a mixed trace replayed through the port's front-end on a
  ``VirtualClock`` equals the reference's replay (request ids, tokens,
  streams, every timing field, duration, counters and scorecard), and an
  overloaded bursty replay rejects visibly, as the reference's does.
* The CLI: ``--traffic-trace`` prints the ``[traffic]`` lines on the CPU,
  every replay-only flag without a trace and every bad replay value exits
  with the reference's message, and recurrentgemma now serves on
  ``--kv-block-size 4``.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import traffic as jtraffic  # noqa: E402
from repro_torch import traffic as ttraffic  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from torch_serve_stacks import make_side, run_both  # noqa: E402


@pytest.fixture(scope="module")
def stablelm():
    return make_side("stablelm-1.6b")


def _replay(suite, rate, n, seed, arrival="poisson", **trace_kw):
    def drive(side, fe, eng, sup, clk):
        traffic = jtraffic if side == "ref" else ttraffic
        tr = traffic.generate_trace(suite, rate, n, seed, vocab=eng.model.cfg.vocab,
                                    arrival=arrival, **trace_kw)
        r = traffic.replay_trace(fe, tr, virtual_step_s=0.05)
        m = traffic.evaluate(r.outputs, r.duration_s, traffic.SLOConfig(0.5, 0.2),
                             offered_rps=rate)
        _replay.last[side] = (r, m)
        return r.outputs
    return drive


_replay.last = {}


@pytest.mark.parametrize("case", ["mixed", "overload"])
def test_virtual_replay_equals_reference(stablelm, case):
    """The mixed suite on the paged pool with the prefix cache (agent
    prefixes hit it), and a bursty overload against a bounded queue with a
    timeout: request ids, tokens, streams, every timing field, duration,
    front-end counters and scorecard equal the reference's."""
    if case == "mixed":
        drive = _replay("mixed", 8.0, 10, 4)
        kw = dict(max_slots=2, max_len=200, kv_block_size=16,
                  fe_kw=dict(max_queue_depth=4, queue_timeout_s=1.0))
    else:
        drive = _replay("chat", 50.0, 16, 3, arrival="bursty", burst_size=8)
        kw = dict(max_slots=2, max_len=64, kv_block_size=0,
                  fe_kw=dict(max_queue_depth=3, queue_timeout_s=0.4))
    run_both(stablelm, drive, supervised=False, **kw)
    (r, m), (jr, jm) = _replay.last["port"], _replay.last["ref"]
    assert r.request_ids == jr.request_ids and r.duration_s == jr.duration_s
    assert r.stats == jr.stats and m == jm
    for rid in r.request_ids:
        np.testing.assert_array_equal(r.token_streams[rid], jr.token_streams[rid])
        o = r.outputs_by_id[rid]
        want = o.tokens if o.reject_reason is None else np.zeros((0,), np.int32)
        np.testing.assert_array_equal(r.token_streams[rid], want)
    if case == "overload":
        n_rej = r.stats["rejected_queue_full"] + r.stats["rejected_queue_timeout"]
        assert n_rej > 0 and r.stats["completed"] + n_rej == 16
        assert r.stats["max_queue_depth"] <= 3
    else:
        assert m["n_completed"] + m["n_rejected"] == 10


def test_virtual_replay_requires_virtual_clock(stablelm):
    from repro_torch import serve as tserve

    model, params = stablelm["port"]
    eng = tserve.ServeEngine(model, params, tserve.ServeConfig(
        max_slots=2, max_len=64, astra_accounting=False), device="cpu")
    fe = tserve.ServeFrontend(eng, tserve.FrontendConfig())
    tr = ttraffic.generate_trace("chat", 4.0, 2, seed=0, vocab=model.cfg.vocab)
    with pytest.raises(ValueError, match="VirtualClock"):
        ttraffic.replay_trace(fe, tr, virtual_step_s=0.05)
    with pytest.raises(ValueError, match="virtual_step_s=-0.1"):
        ttraffic.replay_trace(fe, tr, virtual_step_s=-0.1)


CPU = ["--reduced", "--device", "cpu", "--mode", "exact"]


def test_cli_replays_a_trace(capsys, tmp_path):
    outs = serve_cli.main(CPU + ["--traffic-trace", "mixed:rate=8,n=8",
                                 "--virtual-step", "0.05", "--slo-ttft", "0.5",
                                 "--slo-itl", "0.2"])
    text = capsys.readouterr().out
    assert len(outs) == 8
    for line in ("[traffic] mixed trace: 8 requests at 8 rps (poisson), replayed in",
                 "(virtual step=0.05s)", "completed ", "queue: p50 wait",
                 "TTFT p50/p95/p99:", "ITL  p50/p95/p99:", "SLO (ttft<=0.5s, itl<=0.2s):"):
        assert line in text, line
    # a trace file, under injected faults with retries: the fault line
    path = str(tmp_path / "t.json")
    ttraffic.generate_trace("chat", 20.0, 6, seed=1, vocab=256).save(path)
    serve_cli.main(CPU + ["--traffic-trace", path, "--virtual-step", "0.05",
                          "--fault-every", "3", "--max-retries", "2",
                          "--fault-kinds", "step_error,nonfinite_logits,pool_pressure"])
    text = capsys.readouterr().out
    assert "[traffic] chat trace: 6 requests" in text and "faults: " in text
    assert "audits clean" in text


@pytest.mark.parametrize("argv,msg", [
    (["--virtual-step", "0.5"], "--virtual-step only applies to open-loop replay"),
    (["--deadline", "1"], "--deadline only applies to open-loop replay"),
    (["--fault-every", "2"], "--fault-every only applies to open-loop replay"),
    (["--traffic-trace", "chat", "--virtual-step", "-1"], "--virtual-step: -1.0 is negative"),
    (["--traffic-trace", "chat", "--deadline", "-1"], "--deadline: -1.0 is negative"),
    (["--traffic-trace", "chat", "--max-queue", "-2"], "--max-queue: -2 is invalid"),
    (["--traffic-trace", "chat", "--fault-kinds", "bogus"],
     "--fault-kinds: unknown name(s): bogus"),
    (["--traffic-trace", "nope"], "is neither a file nor a valid spec"),
    (["--traffic-trace", "chat", "--max-concurrency", "10", "--max-slots", "4"],
     "max_concurrency=10 exceeds the engine's max_slots=4"),
])
def test_cli_refusals(capsys, argv, msg):
    with pytest.raises(SystemExit):
        serve_cli.main(CPU + argv)
    assert msg in capsys.readouterr().err


def test_cli_serves_recurrentgemma_on_the_pool(capsys):
    outs = serve_cli.main(["--arch", "recurrentgemma-2b", "--reduced", "--device", "cpu",
                           "--kv-block-size", "4", "--gen", "4", "--batch", "3",
                           "--prompt-mix", "5,12", "--max-slots", "2", "--mode", "exact"])
    text = capsys.readouterr().out
    assert len(outs) == 3 and all(o.gen_len == 4 for o in outs)
    assert "kv pool:" in text and ("prefix cache off: stateful stack: recurrent/windowed "
                                   "layers cannot resume from pooled blocks") in text
