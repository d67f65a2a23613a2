"""The port's serve engine on xlstm-125m against the reference engine.

Reduced xlstm (one unit of mlstm, mlstm, mlstm, slstm; d_model 64, 4
heads) at float32, the reference's weights bridged, the same numpy
prompts, two slots, so slots are reused.  xLSTM has no attention layer,
so both engines serve it on dense per-slot recurrent states whatever
``kv_block_size`` says (no pool: ``kv_stats`` empty on both).  Greedy
tokens must equal the reference's:

* mixed prompt lengths: the masked token-by-token scan, whose padded
  steps must leave every slot's ``MLSTMState``/``SLSTMState`` as it was
  (``m`` at -1e30 in a fresh slot);
* equal lengths: the full-sequence pass, its states folded from the
  quadratic form;
* ``kv_block_size=4`` requested: the dense layout all the same;

under ``exact`` and ``int8``.  One ``nonfinite_logits`` fault through the
supervisor on a virtual clock: the victim keeps its pre-fault stream,
and every output, timing and counter equals the reference stack's.  The
head-dim refusal of the attention kernels (xlstm's 192 is not built)
applies only to stacks with attention layers: an xLSTM engine is built
with ``attn_impl="flash"`` as it would be on the card.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402
from repro_torch.models.xlstm import M_INIT, MLSTMState, SLSTMState  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ServeConfig, ServeEngine, attn_kernel_reject_reason,
)
from repro_torch.serve.faults import FAULT_NONFINITE, FaultSpec  # noqa: E402
from torch_serve_stacks import make_side, prompts, run_both  # noqa: E402

NAME = "xlstm-125m"
GEN = 5
# case -> (prompt lengths, serve config)
CASES = {
    "mixed": ((12, 5, 9, 3), dict(max_slots=2, max_len=24, kv_block_size=0)),
    "equal": ((9, 9, 9), dict(max_slots=2, max_len=24, kv_block_size=0)),
    # the mixed prompts again: the reference compiles nothing new for them
    "paged_requested": ((12, 5, 9, 3), dict(max_slots=2, max_len=24, kv_block_size=4)),
}


@pytest.fixture(scope="module")
def sides():
    return {plan: make_side(NAME, plan=plan) for plan in ("exact", "int8")}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("plan", ["exact", "int8"])
def test_xlstm_greedy_tokens_match_reference(sides, case, plan):
    lens, kw = CASES[case]
    (jmodel, jparams), (tmodel, tparams) = sides[plan]["ref"], sides[plan]["port"]
    ref = JaxServeEngine(jmodel, jparams, JaxServeConfig(chunk_steps=4, astra_accounting=False,
                                                         **kw))
    want = ref.generate_batch(prompts(jmodel.cfg, lens), GEN)
    model = dataclasses.replace(tmodel, opts=dataclasses.replace(tmodel.opts, attn_impl="flash"))
    eng = ServeEngine(model, tparams, ServeConfig(chunk_steps=4, **kw), device="cpu")
    fresh = eng._states["layers"]
    assert all(torch.equal(st.m, torch.full_like(st.m, M_INIT)) for st in fresh)
    got = eng.generate_batch(prompts(tmodel.cfg, lens), GEN)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=f"{case} request {i}")
    assert eng.kv_stats == ref.kv_stats == {}
    assert eng.scheduler_stats == ref.scheduler_stats
    for st, kind in zip(eng._states["layers"], model.cfg.layer_kinds):
        assert isinstance(st, MLSTMState if kind == "mlstm" else SLSTMState), kind
        assert st.c.shape[0] == kw["max_slots"] and st.c.dtype == torch.float32


def test_nonfinite_fault_through_supervisor_matches_reference(sides):
    """One NaN-poisoned slot mid-decode: its request ends at its pre-fault
    stream, the other completes, on both stacks alike."""
    sched = [FaultSpec(step=2, kind=FAULT_NONFINITE, slot=1)]

    def drive(side, fe, eng, sup, clk):
        for p in prompts(eng.model.cfg, (6, 9, 4), seed=5):
            fe.submit(p, 10)
        return fe.run()

    outs, (fe, eng, sup, _) = run_both(sides["exact"], drive, schedule=sched, max_slots=2,
                                       max_len=24, kv_block_size=0)
    assert [o.fault_reason for o in outs].count(FAULT_NONFINITE) == 1
    assert eng.stats()["n_quarantined"] == 1 and sup.stats["quarantined"] == 1


def test_attention_free_stack_takes_no_head_dim_refusal(monkeypatch):
    """On the card the attention kernels are built for head dims 16/64/
    128/256; xlstm-125m's 192 matters only to a stack with attention
    layers, which is still refused at 192."""
    from repro_torch.serve import engine as engine_mod

    assert get_arch(NAME).head_dim == 192
    assert attn_kernel_reject_reason(192, "flash", "cuda") is not None
    monkeypatch.setattr(engine_mod, "attn_kernel_reject_reason",
                        lambda hd, impl, _dev: attn_kernel_reject_reason(hd, impl, "cuda"))
    small = get_arch(NAME).reduced(head_dim=192)
    model = Model(small, ModelOptions(attn_impl="flash"), device="cpu")
    ServeEngine(model, model.init(0), ServeConfig(max_slots=1, max_len=16), device="cpu")
    attn = get_arch("granite-moe-1b-a400m").reduced(head_dim=192)
    model = Model(attn, ModelOptions(attn_impl="flash"), device="cpu")
    with pytest.raises(NotImplementedError, match="head_dim 192"):
        ServeEngine(model, model.init(0), ServeConfig(max_slots=1, max_len=16), device="cpu")


def test_cli_serves_xlstm_on_dense_states(capsys):
    """``--kv-block-size 4`` asked of a stack with no attention layer: the
    CLI serves on the dense states and says why there is no pool."""
    from repro_torch.launch import serve as cli

    outs = cli.main(["--arch", NAME, "--reduced", "--device", "cpu", "--mode", "int8",
                     "--gen", "4", "--batch", "3", "--prompt-mix", "5,12", "--max-slots", "2",
                     "--kv-block-size", "4"])
    text = capsys.readouterr().out
    assert [o.gen_len for o in outs] == [4, 4, 4]
    assert ("kv cache: dense per-slot layout (no attn/local layer: no KV to pool), 3 layers x "
            "mLSTM states c (2, 4, 32, 32)") in text
    assert "1 layers x sLSTM states c, n, m, h (2, 4, 16) float32" in text
    assert text.count("modeled ASTRA chip") == 3
