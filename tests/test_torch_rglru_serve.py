"""The port's serve engine on recurrentgemma (RG-LRU + sliding-window
``local`` attention) against the reference engine, on dense per-slot
caches (``kv_block_size=0``).

Same reduced config (``recurrentgemma-2b`` reduced: 5 layers rglru,
rglru, local, rglru, rglru; d_model 64, head dim 16, d_rnn 64) at float32,
same weights (bridged from the reference's ``init_params``), same numpy
prompts.  The port must emit exactly the reference's greedy tokens:

* mixed prompt lengths: the masked token-by-token scan, whose padded
  steps must leave every slot's ring and recurrent state untouched;
* equal lengths: the full-sequence pass (RG-LRU scan, windowed flash);
* ``max_len < window``: the scan is forced (the full-sequence pass would
  emit rings larger than the slots' clamped rings);
* mixed lengths past the window (window 8, prompts up to 16 tokens): a
  padded scan step of a short prompt would overwrite live ring entries
  at ``t % window`` if its in-place write were not gated;
* slot reuse (fewer slots than requests);

under ``exact`` and ``int8`` with both attention paths (``naive``;
``flash``: the flash and dense-decode kernels' plain versions on the
CPU), and under ``sc`` and ``mixed`` one short case of mixed lengths past
the window.  Also: the
prefill strategy selection against the reference's, what the paged
layout refuses a stateful stack (prefix reuse, chunked admission), and
the refusal at construction of a head dim the CUDA kernels are not built
for.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.prefill import full_seq_packable as jax_full_seq_packable  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.rglru import RGLRUState  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ServeConfig, ServeEngine, attn_kernel_reject_reason, full_seq_packable,
)

NAME = "recurrentgemma-2b"
GEN, CHUNK = 5, 4
# (prompt lengths, slots, max_len, window): the cases of the module docstring
CASES = {
    "mixed": ((12, 5, 9, 7, 3), 2, 32, 32),
    "equal": ((9, 9, 9), 3, 32, 32),
    "max_len_below_window": ((5, 8, 8), 2, 20, 32),
    "mixed_past_window": ((16, 3, 11, 5), 2, 32, 8),
    "short_past_window": ((11, 4), 2, 24, 8),  # one admission: the sc/mixed case
}
PLAIN_CASES = [c for c in CASES if c != "short_past_window"]


def _arch(window):
    jcfg = dataclasses.replace(jax_get_arch(NAME).reduced(window=window), dtype="float32")
    tcfg = dataclasses.replace(get_arch(NAME).reduced(window=window), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(6))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def archs():
    return {w: _arch(w) for w in (32, 8)}


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in lens]


_ref_tokens = {}


def _reference(archs, case, plan):
    key = (case, plan)
    if key not in _ref_tokens:
        lens, slots, max_len, window = CASES[case]
        jcfg, _, jparams, _ = archs[window]
        eng = JaxServeEngine(JaxModel(jcfg, JaxOptions(plan=plan)), jparams,
                             JaxServeConfig(max_slots=slots, max_len=max_len, chunk_steps=CHUNK,
                                            kv_block_size=0, astra_accounting=False))
        if case == "max_len_below_window":
            assert eng._force_scan_prefill
        _ref_tokens[key] = [o.tokens for o in eng.generate_batch(
            _prompts(jcfg.vocab, lens), GEN)]
    return _ref_tokens[key]


def _port(archs, case, plan, attn_impl):
    lens, slots, max_len, window = CASES[case]
    _, tcfg, _, tparams = archs[window]
    model = Model(tcfg, ModelOptions(plan=plan, attn_impl=attn_impl), device="cpu")
    eng = ServeEngine(model, tparams, ServeConfig(max_slots=slots, max_len=max_len,
                                                  chunk_steps=CHUNK, kv_block_size=0),
                      device="cpu")
    assert eng._force_scan == (case == "max_len_below_window")
    outs = eng.generate_batch(_prompts(tcfg.vocab, lens), GEN)
    return eng, [o.tokens for o in outs]


@pytest.mark.parametrize("case", PLAIN_CASES)
@pytest.mark.parametrize("plan", ["exact", "int8"])
@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_rglru_greedy_tokens_match_reference(archs, case, plan, attn_impl):
    want = _reference(archs, case, plan)
    eng, got = _port(archs, case, plan, attn_impl)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{case} request {i}")
    window = CASES[case][3]
    ring = min(CASES[case][2], window)
    kinds = eng.model.cfg.layer_kinds
    for st, kind in zip(eng._states["layers"], kinds):
        if kind == "rglru":
            assert isinstance(st, RGLRUState) and st.h.dtype == torch.float32
        else:
            assert st.k.shape[2] == ring, (kind, tuple(st.k.shape))


@pytest.mark.parametrize("plan", ["sc", "mixed"])
def test_rglru_stochastic_plans_match_reference(archs, plan):
    want = _reference(archs, "short_past_window", plan)
    _, got = _port(archs, "short_past_window", plan, "flash")
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


@pytest.mark.parametrize("lens", [(3, 5, 7), (5, 5, 5), (1,), (4, 4, 9)])
@pytest.mark.parametrize("name", ["recurrentgemma-2b", "stablelm-1.6b"])
def test_full_seq_packable_matches_reference(name, lens):
    assert full_seq_packable(get_arch(name).reduced(), lens) == \
        jax_full_seq_packable(jax_get_arch(name).reduced(), lens)


def test_paged_layout_refused_for_stateful_stack(archs):
    """The paged layout serves a stateful stack (its rings in the pool) but
    refuses it what needs pooled blocks to resume state: the prefix cache
    (off, with the reference's reason) and chunked admission (blocking, as
    the reference falls back to)."""
    jcfg, tcfg, jparams, tparams = archs[32]
    cfg = dict(max_slots=2, max_len=32, kv_block_size=4, prefill_chunk_tokens=8)
    eng = ServeEngine(Model(tcfg, device="cpu"), tparams, ServeConfig(**cfg), device="cpu")
    ref = JaxServeEngine(JaxModel(jcfg), jparams, JaxServeConfig(**cfg))
    assert eng.kv_stats["prefix_cache_off_reason"] == ref.kv_stats["prefix_cache_off_reason"]
    assert "recurrent/windowed" in eng.kv_stats["prefix_cache_off_reason"]
    assert eng.scheduler_stats == ref.scheduler_stats == {"active": False}


def test_head_dim_outside_the_kernels_refused_at_construction(monkeypatch):
    """The kernels take head dims 16/64/128/256 on the card: another head
    dim is refused when the engine is built, not mid-admission; the CPU and
    the naive path take any."""
    for hd in (16, 64, 128, 256):
        assert attn_kernel_reject_reason(hd, "flash", "cuda") is None
    reason = attn_kernel_reject_reason(96, "flash", "cuda")
    assert reason is not None and "96" in reason and "256" in reason
    assert attn_kernel_reject_reason(96, "naive", "cuda") is None
    assert attn_kernel_reject_reason(96, "flash", "cpu") is None
    cfg = get_arch(NAME).reduced(head_dim=24)
    model = Model(cfg, ModelOptions(attn_impl="flash"), device="cpu")
    params = model.init(0)
    ServeEngine(model, params, ServeConfig(max_slots=1, max_len=16), device="cpu")
    # the engine asks the same function, as it would on the card
    from repro_torch.serve import engine as engine_mod

    monkeypatch.setattr(engine_mod, "attn_kernel_reject_reason",
                        lambda hd, impl, _dev: attn_kernel_reject_reason(hd, impl, "cuda"))
    with pytest.raises(NotImplementedError, match="head_dim 24"):
        ServeEngine(model, params, ServeConfig(max_slots=1, max_len=16), device="cpu")
