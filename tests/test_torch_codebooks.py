"""The port's multi-codebook embeddings and heads (musicgen-large) against
the reference's.

Reduced musicgen (two ``attn`` layers, d_model 64, 4 heads over 2 KV
heads of 16, LayerNorm, GELU MLP, 4 codebooks of 256) at float32, the
reference's weights bridged, token grids ``[B, 4, S]`` from numpy:

* ``embed_tokens``: the 4 codebook rows summed in float32 in codebook
  order, then cast, bit for bit (float32 and bfloat16);
* ``head_apply``: 4 heads under the one ``lm_head`` site stacked into
  ``[B, S, 4, V]`` float32, under ``exact``, ``int8`` and ``sc``, with
  ``prepare``'s per-head caches (int8 codes ``quantize(w[c], axis=0)``,
  sc codes, bf16 copies) equal to what each call would compute;
* ``sample_next_token`` -> ``[B, 4, 1]``, ``pack_prompts`` of ``[4,
  S_i]`` grids, the prefix tree keyed on grid blocks;
* ``forward`` and ``decode_step`` logits ``[B, S, 4, V]`` under ``exact``,
  ``int8`` and ``sc``; the bridge and ``init_params``'s shapes.

Tolerances: float32 logits to 1e-4 under ``exact``; under the quantized
plans equal codes give equal integer sums, and the float32 activations
that pick the codes differ in their last bits, so logits compare to 2e-3
(``tests/test_torch_model.py``'s bound).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core.astra_layer import ComputeConfig as JaxCC  # noqa: E402
from repro.core.quant import quantize as jax_quantize  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro.models.transformer import forward as jax_forward  # noqa: E402
from repro.serve.kv_pool import KVBlockPool as JaxPool  # noqa: E402
from repro.serve.prefill import pack_prompts as jax_pack  # noqa: E402
from repro.serve.prefix_tree import RadixPrefixTree as JaxTree  # noqa: E402
from repro.serve.sampling import GREEDY as JAX_GREEDY  # noqa: E402
from repro.serve.sampling import sample_next_token as jax_sample  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.astra_layer import ComputeConfig, quantize_weight_t  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions, forward, init_params  # noqa: E402
from repro_torch.serve import GREEDY, SamplerConfig, pack_prompts  # noqa: E402
from repro_torch.serve.kv_pool import KVBlockPool  # noqa: E402
from repro_torch.serve.prefix_tree import RadixPrefixTree  # noqa: E402
from repro_torch.serve.sampling import sample_next_token  # noqa: E402

NAME = "musicgen-large"
C = 4
ATOL = {"exact": 1e-4, "int8": 2e-3, "sc": 2e-3}


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jax_get_arch(NAME).reduced(n_layers=2), dtype=dtype),
            dataclasses.replace(get_arch(NAME).reduced(n_layers=2), dtype=dtype))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(3))
    return jcfg, tcfg, jparams, params_from_reference(jax.tree.map(np.asarray, jparams),
                                                      tcfg, "cpu")


def _grid(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, C, s), dtype=np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_tokens_sums_codebooks_bit_for_bit(pair, dtype):
    jcfg, tcfg, jparams, tparams = pair
    jcfg, tcfg = dataclasses.replace(jcfg, dtype=dtype), dataclasses.replace(tcfg, dtype=dtype)
    toks = _grid(tcfg, 3, 7)
    want = jl.embed_tokens(jparams["embedding"], jnp.asarray(toks), jcfg)
    got = tl.embed_tokens(tparams["embedding"], _t(toks), tcfg)
    assert got.shape == (3, 7, tcfg.d_model)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("mode", ["exact", "int8", "sc"])
def test_head_apply_and_its_per_head_caches_match_reference(pair, mode):
    jcfg, tcfg, jparams, tparams = pair
    x = np.random.default_rng(1).normal(0, 1, (2, 5, tcfg.d_model)).astype(np.float32)
    want = jl.head_apply(jparams["head"], jparams["embedding"], jnp.asarray(x), jcfg,
                         JaxCC(mode))
    prepared = Model(tcfg, ModelOptions(plan=mode), device="cpu").prepare(tparams)
    got = tl.head_apply(prepared["head"], prepared["embedding"], _t(x), tcfg, ComputeConfig(mode))
    bare = tl.head_apply(tparams["head"], tparams["embedding"], _t(x), tcfg, ComputeConfig(mode))
    assert got.shape == (2, 5, C, tcfg.vocab) and got.dtype == torch.float32
    assert torch.equal(got, bare)  # the caches are what each call computes
    _close(got, want, ATOL[mode])
    head = prepared["head"]
    if mode == "exact":
        assert sorted(head) == ["w"]  # float32 model: no cast copies
        return
    key = "wq_t" if mode == "int8" else "wsc_t"
    assert len(head[key]) == C
    for c in range(C):
        ref = jax_quantize(jparams["head"]["w"][c], axis=0)
        np.testing.assert_array_equal(head[key][c].q.numpy(), np.asarray(ref.q).T)
        np.testing.assert_array_equal(head[key][c].scale.numpy(), np.asarray(ref.scale))
        assert torch.equal(head[key][c].q, quantize_weight_t(tparams["head"]["w"][c]).q)


def test_bf16_model_caches_a_cast_copy_per_head(pair):
    _, tcfg, _, tparams = pair
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    head = Model(cfg, device="cpu").prepare(tparams)["head"]
    assert [w.dtype for w in head["wc"]] == [torch.bfloat16] * C
    for c in range(C):
        assert torch.equal(head["wc"][c], tparams["head"]["w"][c].to(torch.bfloat16))


def test_sample_next_token_gives_codebook_columns(pair):
    jcfg, tcfg, _, _ = pair
    logits = np.random.default_rng(2).normal(0, 1, (3, 4, C, tcfg.vocab)).astype(np.float32)
    want = jax_sample(jnp.asarray(logits), JAX_GREEDY, jax.random.PRNGKey(0), jcfg)
    got = sample_next_token(_t(logits), GREEDY, None, tcfg)
    assert got.shape == (3, C, 1) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = sample_next_token(_t(logits), SamplerConfig(0.8, 5),
                              torch.Generator().manual_seed(0), tcfg)
    assert drawn.shape == (3, C, 1) and ((drawn >= 0) & (drawn < tcfg.vocab)).all()


def test_pack_prompts_pads_codebook_grids(pair):
    jcfg, tcfg, _, _ = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tcfg.vocab, (C, n), dtype=np.int32) for n in (5, 9, 2)]
    jt, jlens = jax_pack(prompts, jcfg)
    tt, tlens = pack_prompts(prompts, tcfg)
    assert tt.shape == (3, C, 9)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    with pytest.raises(ValueError, match="empty prompt at index 1"):
        pack_prompts([prompts[0], np.zeros((C, 0), np.int32)], tcfg)


def test_prefix_tree_keys_grid_blocks_like_reference():
    """Blocks of a ``[C, S]`` grid key on all C rows: grids sharing one
    codebook row but not another share no block."""
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (C, 12), dtype=np.int32)
    other = base.copy()
    other[2, 5] += 1  # differs in codebook 2 inside block 1
    trees = [(JaxTree(4), JaxPool(16, 4)), (RadixPrefixTree(4), KVBlockPool(16, 4))]
    seen = []
    for tree, pool in trees:
        blocks = pool.alloc(3)
        tree.insert(base, blocks, pool)
        seen.append((tree.match(base, 3), tree.match(other, 3), tree.match(base[:, :9], 2),
                     tree.hits, tree.misses, tree.hit_tokens, len(tree)))
    assert seen[1] == seen[0]
    full, part, short, *_ = seen[1]
    assert len(full) == 3 and len(part) == 1 and len(short) == 2


@pytest.mark.parametrize("plan", ["exact", "int8", "sc"])
def test_forward_and_decode_step_logits_match_reference(pair, plan):
    jcfg, tcfg, jparams, tparams = pair
    jmodel = JaxModel(jcfg, JaxOptions(plan=plan))
    tmodel = Model(tcfg, ModelOptions(plan=plan), device="cpu")
    prepared = tmodel.prepare(tparams)
    toks = _grid(tcfg, 2, 6, seed=5)
    jlog, _, _ = jax.jit(jax_forward, static_argnums=(2, 3))(jparams, jnp.asarray(toks), jcfg,
                                                              jmodel.opts)
    tlog, _ = forward(prepared, _t(toks), tcfg, tmodel.opts)
    assert tlog.shape == (2, 6, C, tcfg.vocab)
    _close(tlog, jlog, ATOL[plan], "forward")
    jl2, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=12)
    tl2, tst = tmodel.prefill(prepared, {"tokens": _t(toks)}, max_len=12)
    _close(tl2, jl2, ATOL[plan], "prefill")
    states, pos = {"layers": tst}, np.asarray([6, 6], np.int32)
    jdecode = jax.jit(jmodel.decode)  # one compile, not each op of 3 steps eagerly
    for step in range(3):
        tok = _grid(tcfg, 2, 1, seed=10 + step)
        jlog, jst = jdecode(jparams, jnp.asarray(tok), jst, jnp.asarray(pos))
        tlog, states = tmodel.decode(prepared, _t(tok), states, _t(pos))
        assert tlog.shape == (2, 1, C, tcfg.vocab)
        _close(tlog, jlog, ATOL[plan], f"decode step {step}")
        pos = pos + 1


def test_bridge_and_init_params_carry_codebook_tables(pair):
    jcfg, tcfg, jparams, tparams = pair
    assert tparams["embedding"]["table"].shape == (C, tcfg.vocab, tcfg.d_model)
    assert tparams["head"]["w"].shape == (C, tcfg.d_model, tcfg.vocab)
    np.testing.assert_array_equal(tparams["embedding"]["table"].numpy(),
                                  np.asarray(jparams["embedding"]["table"]))
    np.testing.assert_array_equal(tparams["head"]["w"].numpy(), np.asarray(jparams["head"]["w"]))
    own = init_params(tcfg, 0, "cpu")
    assert own["embedding"]["table"].shape == (C, tcfg.vocab, tcfg.d_model)
    assert own["head"]["w"].shape == (C, tcfg.d_model, tcfg.vocab)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == jax.tree.map(
        lambda t: tuple(t.shape), tparams)
