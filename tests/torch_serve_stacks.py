"""Side-by-side serving stacks for the port's tests: the reference's and
the port's engine, supervisor and front-end on a ``VirtualClock``, built
on the same reduced arch and weights (``test_torch_supervisor.py``,
``test_torch_frontend.py``, ``test_torch_replay.py``,
``test_torch_xlstm_serve.py``, ``test_torch_musicgen_serve.py``).  The reference's jitted functions are
keyed on its ``Model``, so within one process every stack of the same
arch and plan shares their compiles.
"""
import dataclasses

import jax
import numpy as np

from repro import serve as jserve
from repro import traffic as jtraffic
from repro.configs import get_arch as jax_get_arch
from repro.models.model import Model as JaxModel
from repro.models.transformer import ModelOptions as JaxOptions
from repro.serve.prefill import pack_prompts as jax_pack_prompts
from repro_torch import serve as tserve
from repro_torch import traffic as ttraffic
from repro_torch.bridge import params_from_reference, plan_from_reference
from repro_torch.configs import get_arch
from repro_torch.models.model import Model
from repro_torch.models.transformer import ModelOptions


def make_side(name, plan="exact", calibrate_lens=None, **red):
    """Reference and port models of one reduced arch at float32 on the same
    weights: {"ref": (model, params), "port": (model, params)}.  With
    ``calibrate_lens`` the plan is calibrated by the reference on those
    prompts and its scales carried across."""
    jcfg = dataclasses.replace(jax_get_arch(name).reduced(**red), dtype="float32")
    tcfg = dataclasses.replace(get_arch(name).reduced(**red), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    jplan, tplan = plan, plan
    if calibrate_lens is not None:
        toks, _ = jax_pack_prompts(prompts(jcfg, calibrate_lens, seed=3), jcfg)
        jplan = JaxModel(jcfg, JaxOptions(plan=plan)).calibrate(jparams, {"tokens": toks}).plan
        tplan = plan_from_reference(jplan.act_scales, jplan.kv_scales, plan)
    tmodel = Model(tcfg, ModelOptions(plan=tplan), device="cpu")
    return {"ref": (JaxModel(jcfg, JaxOptions(plan=jplan)), jparams),
            "port": (tmodel, tmodel.prepare(tparams))}


def prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lens]


def stack(side, models, schedule=(), retries=0, deadline=None, fe_kw=None, supervised=True,
          **cfg_over):
    """VirtualClock + engine (+ supervisor over ``schedule``) + front-end
    of one side ("ref" | "port")."""
    serve, traffic = (jserve, jtraffic) if side == "ref" else (tserve, ttraffic)
    model, params = models[side]
    clk = traffic.VirtualClock()
    cfg_over.setdefault("max_slots", 3)
    cfg_over.setdefault("max_len", 64)
    cfg_over.setdefault("kv_block_size", 8)
    cfg = serve.ServeConfig(chunk_steps=2, astra_accounting=False, **cfg_over)
    kw = {} if side == "ref" else {"device": "cpu"}
    eng = serve.ServeEngine(model, params, cfg, clock=clk, **kw)
    sup = None
    if supervised:
        sup = serve.EngineSupervisor(eng, serve.ServeFaultInjector(
            [serve.FaultSpec(**dataclasses.asdict(s)) for s in schedule]))
    fe = serve.ServeFrontend(eng, serve.FrontendConfig(
        max_retries=retries, default_deadline_s=deadline, **(fe_kw or {})),
        clock=clk, supervisor=sup)
    return fe, eng, sup, clk


def trace(side, cfg, n=8, seed=1, rate=50.0, suite="chat"):
    """A generated trace of the side's traffic package (``[C, S]`` prompt
    grids for a multi-codebook config)."""
    traffic = jtraffic if side == "ref" else ttraffic
    return traffic.generate_trace(suite=suite, rate_rps=rate, n=n, seed=seed, vocab=cfg.vocab,
                                  n_codebooks=cfg.n_codebooks)


def timing_tuple(o):
    return None if o.timing is None else dataclasses.astuple(o.timing)


def assert_outputs_equal(got, want):
    """Port outputs against the reference's, by request id: tokens, reasons
    and every timing field."""
    got = {o.request_id: o for o in got}
    want = {o.request_id: o for o in want}
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=f"request {rid}")
        assert g.fault_reason == w.fault_reason, rid
        assert g.reject_reason == w.reject_reason, rid
        assert timing_tuple(g) == timing_tuple(w), rid
        assert g.wall_time_s == w.wall_time_s, rid


ENGINE_COUNTERS = ("step", "queued", "slots_live", "n_quarantined", "n_cancelled", "n_shed",
                   "degraded_level", "degraded_transitions", "kv", "prefix", "scheduler")


def assert_stacks_equal(port, ref):
    """Front-end, supervisor and engine counters of two (fe, eng, sup, clk)."""
    assert port[0].stats == ref[0].stats
    if ref[2] is not None:
        assert port[2].stats == ref[2].stats
    pst, rst = port[1].stats(), ref[1].stats()
    for k in ENGINE_COUNTERS:
        assert pst[k] == rst[k], k
    assert port[3]() == ref[3]()


def conserved(st):
    return st["submitted"] == (
        st["completed"] + st["rejected_queue_full"] + st["rejected_queue_timeout"]
        + st["faulted"] + st["cancelled"] + st["queue_depth"] + st["in_flight"]
        + st["retry_pending"])


def run_both(models, drive, **stack_kw):
    """``drive(side, fe, eng, sup, clk) -> outputs`` on both sides; the
    outputs and counters must match.  Returns the port's (outs, stack)."""
    res = {}
    for side in ("ref", "port"):
        st = stack(side, models, **stack_kw)
        res[side] = (drive(side, *st), st)
    assert_outputs_equal(res["port"][0], res["ref"][0])
    assert_stacks_equal(res["port"][1], res["ref"][1])
    return res["port"]
