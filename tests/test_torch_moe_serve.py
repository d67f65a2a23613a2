"""The port's serve engine on granite-moe-1b-a400m against the reference
engine.

Reduced granite (2 ``attn`` layers, d_model 64, head dim 16, GQA 4 over 2
KV heads; a MoE MLP of 4 experts, top-2, expert width 32) at float32, the
reference's weights bridged, the same numpy prompts (three share an
8-token prefix; two slots, so later requests find it interned).  Greedy
tokens must equal the reference's:

* on the paged pool (block 4) with prefix reuse, on dense per-slot caches
  and under chunked prefill (budget 8 a round), each under ``exact`` and
  ``int8`` (the uniform plan: attention projections int8, router and
  experts exact);
* under a plan that quantizes the expert sites (``*.expert_*``: the
  batched int8 kernel's plain version on the CPU), whose dynamic scales
  turn the prefix cache off, as the reference's ``_kv_deterministic``
  does;

with ``kv_stats``, ``prefix_stats`` and ``scheduler_stats`` equal to the
reference's.  Every prefill runs drop-free (``_drop_free``), as the
reference's does.
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
from repro.serve.prefill import _drop_free as jax_drop_free  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve.prefill import _drop_free  # noqa: E402

NAME = "granite-moe-1b-a400m"
GEN = 5
EXPERTS_INT8 = {"*.expert_*": "int8", "default": "exact"}
LAYOUTS = {
    "paged_prefix": dict(kv_block_size=4),
    "dense": dict(kv_block_size=0),
    "chunked": dict(kv_block_size=4, prefill_chunk_tokens=8),
}


@pytest.fixture(scope="module")
def arch():
    jcfg = dataclasses.replace(jax_get_arch(NAME).reduced(n_layers=2), dtype="float32")
    tcfg = dataclasses.replace(get_arch(NAME).reduced(n_layers=2), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(6))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(vocab):
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, 8, dtype=np.int32)
    shared = [np.concatenate([prefix, rng.integers(0, vocab, n, dtype=np.int32)])
              for n in (4, 9, 2)]
    return shared + [rng.integers(0, vocab, n, dtype=np.int32) for n in (5, 13)]


def _kw(layout):
    return dict(max_slots=2, max_len=32, chunk_steps=4, **LAYOUTS[layout])


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("plan", ["exact", "int8"])
def test_moe_greedy_tokens_match_reference(arch, layout, plan):
    jcfg, tcfg, jparams, tparams = arch
    ref = JaxServeEngine(JaxModel(jcfg, JaxOptions(plan=plan)), jparams,
                         JaxServeConfig(astra_accounting=False, **_kw(layout)))
    want = ref.generate_batch(_prompts(jcfg.vocab), GEN)
    eng = ServeEngine(Model(tcfg, ModelOptions(plan=plan, attn_impl="flash"), device="cpu"),
                      tparams, ServeConfig(**_kw(layout)), device="cpu")
    got = eng.generate_batch(_prompts(tcfg.vocab), GEN)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=f"request {i}")
    assert eng.kv_stats == ref.kv_stats
    assert eng.prefix_stats == ref.prefix_stats
    assert eng.scheduler_stats == ref.scheduler_stats
    if layout != "dense" and plan == "exact":  # deterministic KV: prefix reuse
        assert eng.prefix_stats["hits"] > 0
    if layout == "chunked":
        assert eng.scheduler_stats["prefill_chunks"] > 5


def test_quantized_experts_match_reference_and_turn_prefix_off(arch):
    jcfg, tcfg, jparams, tparams = arch
    ref = JaxServeEngine(JaxModel(jcfg, JaxOptions(plan=EXPERTS_INT8)), jparams,
                         JaxServeConfig(astra_accounting=False, **_kw("paged_prefix")))
    want = ref.generate_batch(_prompts(jcfg.vocab), GEN)
    model = Model(tcfg, ModelOptions(plan=EXPERTS_INT8, attn_impl="flash"), device="cpu")
    eng = ServeEngine(model, tparams, ServeConfig(**_kw("paged_prefix")), device="cpu")
    got = eng.generate_batch(_prompts(tcfg.vocab), GEN)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=f"request {i}")
    assert eng.kv_stats == ref.kv_stats
    assert "non-deterministic KV" in eng.kv_stats["prefix_cache_off_reason"]
    # the expert weights carry int8 codes per expert; the router stays float32
    mlp = eng.params["layers"][0]["mlp"]
    assert mlp["caches"]["w_up"]["wq_t"].q.shape == (4, 32, 64)
    assert mlp["caches"]["w_down"]["wq_t"].scale.shape == (4, 1, 64)
    assert "wc" not in mlp["router"] and mlp["router"]["w"].dtype == torch.float32


@pytest.mark.parametrize("cf", [1.25, 64.0])
def test_drop_free_prefill_matches_reference(arch, cf):
    jcfg, tcfg, _, _ = arch
    got = _drop_free(Model(tcfg, ModelOptions(capacity_factor=cf), device="cpu"))
    want = jax_drop_free(JaxModel(jcfg, JaxOptions(capacity_factor=cf)))
    assert got.opts.capacity_factor == want.opts.capacity_factor == max(cf, 4.0)


def test_cli_serves_granite_with_prefix_reuse(capsys):
    from repro_torch.launch import serve as cli

    cli.main(["--arch", NAME, "--reduced", "--device", "cpu", "--mode", "exact", "--gen", "4",
              "--batch", "5", "--prompt-mix", "5,12,20", "--max-slots", "3",
              "--kv-block-size", "4"])
    text = capsys.readouterr().out
    assert "kv pool: " in text and "prefix cache: 1 hits / 5 misses" in text
    assert "attn.expert_up" in text and "attn.expert_down" in text
