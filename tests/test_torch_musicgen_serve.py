"""The port's serve engine on musicgen-large against the reference engine.

Reduced musicgen (two ``attn`` layers, d_model 64, 4 heads over 2 KV
heads of 16, 4 codebooks of 256) at float32, the reference's weights
bridged, the same numpy ``[4, S]`` prompt grids (three share an 8-token
prefix; two slots, so later requests find it interned).  A pure ``attn``
stack, so the paged pool runs the suffix prefill with prefix reuse and
paged chunked prefill, as in the reference.  The engine's tokens are
``[4, G]`` grids; greedy grids, each request's ``hardware``,
``kv_stats``, ``prefix_stats`` and ``scheduler_stats`` must equal the
reference's:

* paged with prefix hits under ``exact``, ``int8`` (dynamic scales: the
  prefix cache off) and ``mixed`` (sc projections, the codebook heads
  among them); dense under ``exact`` and ``int8``; chunked (budget 8) on
  both layouts.  ``sc`` alone is held on the heads, ``forward`` and
  ``decode_step`` in ``tests/test_torch_codebooks.py``;
* an ``eos_id`` is never looked for over codebook grids: every request
  runs its whole budget, on both engines;
* ``token_sink`` gets ``[4, n]`` chunks that concatenate to the output;
* a codebook trace replayed through the front-end (a bounded queue:
  ``[4, 0]`` rejections) and the supervisor (one NaN fault) on a virtual
  clock: outputs, timings and counters equal the reference stack's;
* prompt shapes the engine refuses; the CLI.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import traffic as jtraffic  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import traffic as ttraffic  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve.faults import FAULT_NONFINITE, FaultSpec  # noqa: E402
from torch_serve_stacks import make_side, run_both, trace  # noqa: E402

NAME = "musicgen-large"
C = 4
GEN = 5
LAYOUTS = {
    "paged": dict(kv_block_size=4),
    "dense": dict(kv_block_size=0),
    "chunked_paged": dict(kv_block_size=4, prefill_chunk_tokens=8),
    "chunked_dense": dict(kv_block_size=0, prefill_chunk_tokens=8),
}
CASES = [("paged", p) for p in ("exact", "int8", "mixed")] \
    + [("dense", p) for p in ("exact", "int8")] \
    + [("chunked_paged", "exact"), ("chunked_dense", "exact")]


@pytest.fixture(scope="module")
def arch():
    jcfg = dataclasses.replace(jax_get_arch(NAME).reduced(n_layers=2), dtype="float32")
    tcfg = dataclasses.replace(get_arch(NAME).reduced(n_layers=2), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(13))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(vocab):
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, vocab, (C, 8), dtype=np.int32)
    shared = [np.concatenate([prefix, rng.integers(0, vocab, (C, n), dtype=np.int32)], axis=1)
              for n in (3, 3, 5)]
    return shared + [rng.integers(0, vocab, (C, n), dtype=np.int32) for n in (11, 6)]


def _kw(layout):
    return dict(max_slots=2, max_len=32, chunk_steps=3, **LAYOUTS[layout])


def _engines(arch, layout, plan, **over):
    jcfg, tcfg, jparams, tparams = arch
    ref = JaxServeEngine(JaxModel(jcfg, JaxOptions(plan=plan)), jparams,
                         JaxServeConfig(**{**_kw(layout), **over}))
    eng = ServeEngine(Model(tcfg, ModelOptions(plan=plan), device="cpu"), tparams,
                      ServeConfig(**{**_kw(layout), **over}), device="cpu")
    return ref, eng


def _outputs(outs):
    return [(o.tokens.tolist(), o.hardware.as_dict()) for o in outs]


@pytest.mark.parametrize("layout,plan", CASES)
def test_musicgen_token_grids_match_reference(arch, layout, plan):
    ref, eng = _engines(arch, layout, plan)
    want = ref.generate_batch(_prompts(ref.model.cfg.vocab), GEN)
    got = eng.generate_batch(_prompts(eng.model.cfg.vocab), GEN)
    assert [o.tokens.shape for o in got] == [(C, GEN)] * 5
    assert _outputs(got) == _outputs(want)
    assert eng.kv_stats == ref.kv_stats
    assert eng.prefix_stats == ref.prefix_stats
    assert eng.scheduler_stats == ref.scheduler_stats
    if layout.endswith("paged") and plan == "exact":
        assert eng.prefix_stats["hits"] > 0
    if layout.startswith("chunked"):
        assert eng.scheduler_stats["prefill_chunks"] > 5


def test_eos_is_not_looked_for_over_codebook_grids(arch):
    """An ``eos_id`` that the grids contain ends nothing, as in the
    reference: every request gets its whole budget."""
    ref, eng = _engines(arch, "paged", "exact")
    want = ref.generate_batch(_prompts(ref.model.cfg.vocab), GEN)
    eos = int(want[0].tokens[0, 1])
    got = eng.generate_batch(_prompts(eng.model.cfg.vocab), GEN, eos_id=eos)
    assert any((o.tokens == eos).any() for o in got)
    assert [o.gen_len for o in got] == [GEN] * 5
    assert _outputs(got) == _outputs(want)


def test_token_sink_gets_codebook_chunks(arch):
    chunks = {"ref": [], "port": []}
    engines = _engines(arch, "dense", "exact")
    for side, eng in zip(("ref", "port"), engines):
        eng.token_sink = lambda rid, toks, s=side: chunks[s].append((rid, np.array(toks)))
        outs = eng.generate_batch(_prompts(eng.model.cfg.vocab), GEN)
        for o in outs:
            mine = [t for rid, t in chunks[side] if rid == o.request_id]
            assert all(t.shape[0] == C for t in mine)
            np.testing.assert_array_equal(np.concatenate(mine, axis=1), o.tokens)
    assert [(r, t.tolist()) for r, t in chunks["port"]] == \
        [(r, t.tolist()) for r, t in chunks["ref"]]


def test_codebook_trace_through_frontend_and_supervisor_matches_reference():
    """A chat trace of ``[4, S]`` grids at 50 rps against a queue of 2: some
    requests are rejected with ``[4, 0]`` tokens, one slot's logits go NaN
    mid-decode; every output, stream, timing and counter equals the
    reference stack's."""
    side = make_side(NAME, n_layers=2)
    sched = [FaultSpec(step=3, kind=FAULT_NONFINITE, slot=0)]
    last = {}

    def drive(which, fe, eng, sup, clk):
        traffic = jtraffic if which == "ref" else ttraffic
        tr = trace(which, eng.model.cfg, n=8, seed=2)
        assert all(r.prompt.shape[0] == C for r in tr.requests)
        r = traffic.replay_trace(fe, tr, virtual_step_s=0.05)
        last[which] = r
        return r.outputs

    outs, _ = run_both(side, drive, schedule=sched, max_slots=2, max_len=96,
                       kv_block_size=8, fe_kw=dict(max_queue_depth=2))
    r, jr = last["port"], last["ref"]
    assert r.stats == jr.stats and r.duration_s == jr.duration_s
    for rid in r.request_ids:
        np.testing.assert_array_equal(r.token_streams[rid], jr.token_streams[rid])
    rejected = [o for o in outs if o.reject_reason is not None]
    assert rejected and all(o.tokens.shape == (C, 0) for o in rejected)
    assert [o.fault_reason for o in outs].count(FAULT_NONFINITE) == 1
    assert all(o.tokens.shape[0] == C for o in outs)


def test_prompt_shapes_refused(arch):
    _, eng = _engines(arch, "dense", "exact")
    with pytest.raises(ValueError, match=r"\[4, S\] codebook grids"):
        eng.submit(np.zeros(5, np.int32), 2)
    with pytest.raises(ValueError, match=r"\[4, S\] codebook grids"):
        eng.submit(np.zeros((3, 5), np.int32), 2)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.zeros((C, 0), np.int32), 2)
    with pytest.raises(ValueError, match="exceeds max_len 32"):
        eng.submit(np.zeros((C, 30), np.int32), 3)


def test_cli_serves_codebook_grids(capsys):
    from repro_torch.launch import serve as cli

    outs = cli.main(["--arch", NAME, "--reduced", "--device", "cpu", "--mode", "exact",
                     "--gen", "4", "--batch", "4", "--prompt-mix", "9,5", "--max-slots", "2",
                     "--kv-block-size", "4"])
    text = capsys.readouterr().out
    assert [o.tokens.shape for o in outs] == [(C, 4)] * 4
    assert [o.prompt.shape for o in outs] == [(C, 9), (C, 5)] * 2
    assert "kv pool: " in text and "prefix cache: " in text
    assert text.count("modeled ASTRA chip") == 4
