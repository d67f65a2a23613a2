"""The port's serve engine on llama-3.2-vision-90b against the reference
engine.

Reduced llama-3.2-vision (four ``attn`` layers and one ``xattn``; d_model
64, 4 heads over 2 KV heads of 16, 16 vision tokens) at float32, the
reference's weights bridged, the same numpy prompts, two slots for four
requests, so slots are reused.  Neither engine takes vision embeddings:
both serve the model text-only, admitting through the masked scan
against zeroed cross caches (``packed_prefill`` forces it for a stack
with ``xattn`` layers and no embeddings), the cross caches dense by slot
beside the pools on the paged layout.  Greedy tokens, each request's
modeled ASTRA report (``hardware``), ``kv_stats`` (the prefix cache off
with the reference's reason: the stack is stateful), ``prefix_stats``
and ``scheduler_stats`` must equal the reference's:

* on the paged pool (block 4) under ``exact`` and ``int8``, and on dense
  per-slot caches under those and ``mixed`` (sc projections, qk/pv on
  the batched int8 entry over the zeroed cross cache).  The cross layer
  takes the same path on both layouts (a dense cache by slot), and
  ``tests/test_torch_xattn.py`` holds it under ``mixed`` on its own, so
  ``mixed`` on the pool and ``sc`` add only reference compiles;
* chunked (budget 8 a round) on dense caches, the windowed masked scan,
  under ``int8``; chunked asked of the paged pool, where the stateful
  stack admits blocking, as the reference's does.

And the CLI on both layouts.
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
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.attention import KVCache, PagedKVCache  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

NAME = "llama-3.2-vision-90b"
GEN = 5
LAYOUTS = {
    "paged": dict(kv_block_size=4),
    "dense": dict(kv_block_size=0),
    "chunked_dense": dict(kv_block_size=0, prefill_chunk_tokens=8),
    "chunked_paged": dict(kv_block_size=4, prefill_chunk_tokens=8),
}
CASES = [("paged", p) for p in ("exact", "int8")] \
    + [("dense", p) for p in ("exact", "int8", "mixed")] \
    + [("chunked_dense", "int8"), ("chunked_paged", "exact")]
STATEFUL_REASON = "stateful stack: recurrent/windowed layers cannot resume from pooled blocks"


@pytest.fixture(scope="module")
def arch():
    jcfg = dataclasses.replace(jax_get_arch(NAME).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_arch(NAME).reduced(), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(12))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(vocab):
    """Two rounds of two mixed-length admissions; the second round reuses
    the first's slots (and, by its shapes, the reference's compiles)."""
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in (11, 6, 11, 6)]


def _kw(layout):
    return dict(max_slots=2, max_len=32, chunk_steps=3, **LAYOUTS[layout])


def _outputs(outs):
    return [(o.tokens.tolist(), o.hardware.as_dict()) for o in outs]


@pytest.mark.parametrize("layout,plan", CASES)
def test_vlm_greedy_tokens_match_reference(arch, layout, plan):
    jcfg, tcfg, jparams, tparams = arch
    ref = JaxServeEngine(JaxModel(jcfg, JaxOptions(plan=plan)), jparams,
                         JaxServeConfig(**_kw(layout)))
    want = ref.generate_batch(_prompts(jcfg.vocab), GEN)
    model = Model(tcfg, ModelOptions(plan=plan), device="cpu")
    eng = ServeEngine(model, tparams, ServeConfig(**_kw(layout)), device="cpu")
    got = eng.generate_batch(_prompts(tcfg.vocab), GEN)
    assert [o.tokens.shape for o in got] == [(GEN,)] * 4
    assert _outputs(got) == _outputs(want)
    assert eng.kv_stats == ref.kv_stats
    assert eng.prefix_stats == ref.prefix_stats == {}
    assert eng.scheduler_stats == ref.scheduler_stats
    cross = eng._states["layers"][4]
    assert isinstance(cross, KVCache) and cross.k.shape == (2, 2, tcfg.vision_tokens, 16)
    assert not cross.k.any() and not cross.v.any()  # text-only: the zeroed cross cache
    pooled = LAYOUTS[layout]["kv_block_size"] > 0
    assert all(isinstance(st, PagedKVCache if pooled else KVCache)
               for st in eng._states["layers"][:4])
    if pooled:
        assert eng.kv_stats["prefix_cache_off_reason"] == STATEFUL_REASON


def test_vlm_engine_takes_no_vision_input(arch):
    """``submit`` has no vision argument (the reference's neither) and a
    request is one token sequence: a ``[C, S]`` grid is refused."""
    import inspect

    _, tcfg, _, tparams = arch
    eng = ServeEngine(Model(tcfg, device="cpu"), tparams, ServeConfig(**_kw("dense")),
                      device="cpu")
    assert not any("vision" in name for name in inspect.signature(eng.submit).parameters)
    with pytest.raises(ValueError, match="1-D tokens"):
        eng.submit(np.zeros((4, 5), np.int32), 2)


@pytest.mark.parametrize("block", ["4", "0"])
def test_cli_serves_vlm(capsys, block):
    from repro_torch.launch import serve as cli

    outs = cli.main(["--arch", NAME, "--reduced", "--device", "cpu", "--mode", "exact",
                     "--gen", "4", "--batch", "3", "--prompt-mix", "5,12", "--max-slots", "2",
                     "--kv-block-size", block])
    text = capsys.readouterr().out
    assert [o.gen_len for o in outs] == [4, 4, 4]
    cross = "1 layers x cross K and V (2, 2, 16, 16) bfloat16 (16 vision positions)"
    if block == "0":
        assert f"kv cache: dense per-slot layout, 4 layers x K and V (2, 2, 17, 16) bfloat16; " \
               f"{cross}" in text
    else:
        assert f"prefix cache off: {STATEFUL_REASON}; dense beside it: {cross}" in text
    assert text.count("modeled ASTRA chip") == 3
