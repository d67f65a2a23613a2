"""The port's layers and decoder stack against the reference's.

Weights are the reference's own, bridged (``repro_torch.bridge``); inputs
come from numpy.  Tolerances: float32 logits to 1e-4 absolute under
``exact`` (same math, another summation order); under ``int8`` the codes
and scales are bit-identical given identical activations, but the
activations themselves differ in the last float32 bits, which can move a
rounding tie by one code, so logits compare to 2e-3; bf16 compares to
6e-2 (one bf16 ulp at the logits' magnitude, plus rounding at other
places in the two frameworks).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.attention import BlockTables as JaxTables  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro.models.transformer import decode_step as jax_decode_step  # noqa: E402
from repro.models.transformer import forward as jax_forward  # noqa: E402
from repro.models.transformer import init_decode_state as jax_init_state  # noqa: E402
from repro.models.transformer import suffix_forward as jax_suffix_forward  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.attention import BlockTables  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions, init_params  # noqa: E402

BS, W, N_BLOCKS = 4, 4, 10
TABLE = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)


def _cfgs(name, dtype="float32"):
    return (dataclasses.replace(jax_get_arch(name).reduced(), dtype=dtype),
            dataclasses.replace(get_arch(name).reduced(), dtype=dtype))


@pytest.fixture(scope="module", params=["stablelm-1.6b", "qwen1.5-0.5b"])
def pair(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(1))
    return jcfg, tcfg, jparams, params_from_reference(jax.tree.map(np.asarray, jparams),
                                                      tcfg, "cpu")


def test_bridge_unstacks_every_layer(pair):
    jcfg, tcfg, jparams, tparams = pair
    assert len(tparams["layers"]) == tcfg.n_layers
    for li, blk in enumerate(tparams["layers"]):
        want = jax.tree.map(lambda a: np.asarray(a[li]), jparams["units"]["slot0"])
        got = jax.tree.map(lambda t: t.numpy(), blk)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tparams["embedding"]["table"].numpy(),
                                  np.asarray(jparams["embedding"]["table"]))
    assert ("w" in tparams["head"]) == (not tcfg.tie_embeddings)


def test_layers_match_reference(rng):
    """Norms in float32, interleaved partial RoPE (16 of 64 channels on
    stablelm's 25%), SwiGLU MLP."""
    jcfg, tcfg = _cfgs("stablelm-1.6b")
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    for kind in ("layernorm", "rmsnorm"):
        p = {"scale": rng.standard_normal(64).astype(np.float32),
             "bias": rng.standard_normal(64).astype(np.float32)}
        if kind == "rmsnorm":
            del p["bias"]
        got = tl.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind, 1e-5)
        want = jl.norm_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind, 1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    xh = rng.standard_normal((2, 3, 5, 64)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 9, 11, 40, 41]], np.int32)
    for pct in (0.25, 1.0):
        got = tl.apply_rope(torch.from_numpy(xh), torch.from_numpy(pos), pct, 10_000.0)
        want = jl.apply_rope(jnp.asarray(xh), jnp.asarray(pos), pct, 10_000.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        if pct < 1:  # channels past rot_dim pass through untouched
            assert torch.equal(got[..., 16:], torch.from_numpy(xh)[..., 16:])
    mp = jl.mlp_init(jax.random.PRNGKey(3), jcfg)
    got = tl.mlp_apply(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), mp),
                       torch.from_numpy(x), tcfg)
    want = jl.mlp_apply(mp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _run_port(tcfg, tparams, plan, attn_impl, tokens, feed):
    model = Model(tcfg, ModelOptions(plan=plan, attn_impl=attn_impl), device="cpu")
    params = model.prepare(tparams)
    states = model.init_decode_state(2, W * BS, paged=(N_BLOCKS, BS))
    table = torch.from_numpy(TABLE)
    logits, states = model.prefill_suffix(params, torch.from_numpy(tokens), states, table,
                                          torch.zeros(2, dtype=torch.int32), ctx_blocks=2)
    outs = [logits.numpy()]
    pos = torch.full((2,), tokens.shape[1], dtype=torch.int64)
    for t in range(feed.shape[1]):
        lg, states = model.decode(params, torch.from_numpy(feed[:, t:t + 1]), states, pos,
                                  BlockTables(table))
        outs.append(lg.numpy())
        pos = pos + 1
    return outs


def _run_reference(jcfg, jparams, plan, tokens, feed):
    opts = JaxOptions(plan=plan)
    states = jax_init_state(jcfg, 2, W * BS, paged=(N_BLOCKS, BS))
    table = jnp.asarray(TABLE)
    logits, states = jax_suffix_forward(jparams, jnp.asarray(tokens), jcfg, opts, states,
                                        table, jnp.zeros(2, jnp.int32), 2)
    outs = [np.asarray(logits)]
    pos = jnp.full((2,), tokens.shape[1], jnp.int32)
    for t in range(feed.shape[1]):
        lg, states = jax_decode_step(jparams, jnp.asarray(feed[:, t:t + 1]), states, pos,
                                     jcfg, opts, JaxTables(table, jnp.int32(0)))
        outs.append(np.asarray(lg))
        pos = pos + 1
    return outs


@pytest.mark.parametrize("plan,atol", [("exact", 1e-4), ("int8", 2e-3), ("sc", 2e-3),
                                       ("mixed", 2e-3)])
@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_suffix_and_decode_logits_match_reference(pair, rng, plan, atol, attn_impl):
    jcfg, tcfg, jparams, tparams = pair
    tokens = rng.integers(0, tcfg.vocab, (2, 10)).astype(np.int32)
    tokens, feed = tokens[:, :7], tokens[:, 7:]  # decode feeds both the same tokens
    got = _run_port(tcfg, tparams, plan, attn_impl, tokens, feed)
    want = _run_reference(jcfg, jparams, plan, tokens, feed)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=f"step {i}")


def test_forward_decode_parity(pair, rng):
    """Full-sequence forward, paged suffix prefill and step-by-step decode
    all give the same logits (the port's own consistency, as the
    reference's test_decode_parity checks its)."""
    jcfg, tcfg, jparams, tparams = pair
    tokens = rng.integers(0, tcfg.vocab, (2, 9)).astype(np.int32)
    model = Model(tcfg, ModelOptions(plan="exact"), device="cpu")
    full, states = model.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, max_len=16)
    assert len(states) == tcfg.n_layers and states[0].k.shape[2] == 16
    want, _, _ = jax_forward(jparams, jnp.asarray(tokens), jcfg, JaxOptions())
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    paged = model.init_decode_state(2, W * BS, paged=(N_BLOCKS, BS))
    table = torch.from_numpy(TABLE)
    lg, paged = model.prefill_suffix(tparams, torch.from_numpy(tokens[:, :4]), paged, table,
                                     torch.zeros(2, dtype=torch.int32), ctx_blocks=1)
    np.testing.assert_allclose(lg.numpy(), full[:, :4].numpy(), atol=1e-4, rtol=0)
    # the rest mid-block from position 4 (a prefix hit), then one token at a time
    lg, paged = model.prefill_suffix(tparams, torch.from_numpy(tokens[:, 4:6]), paged, table,
                                     torch.full((2,), 4, dtype=torch.int32), ctx_blocks=2)
    np.testing.assert_allclose(lg.numpy(), full[:, 4:6].numpy(), atol=1e-4, rtol=0)
    for t in range(6, 9):
        lg, paged = model.decode(tparams, torch.from_numpy(tokens[:, t:t + 1]), paged,
                                 torch.full((2,), t), BlockTables(table))
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(), atol=1e-4, rtol=0)


def test_bf16_logits_match_reference(rng):
    jcfg, tcfg = _cfgs("stablelm-1.6b", dtype="bfloat16")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(2))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tokens = rng.integers(0, tcfg.vocab, (2, 9)).astype(np.int32)
    tokens, feed = tokens[:, :7], tokens[:, 7:]
    got = _run_port(tcfg, tparams, "exact", "flash", tokens, feed)
    want = _run_reference(jcfg, jparams, "exact", tokens, feed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=6e-2, rtol=0)


def test_init_params_shapes_match_reference():
    """The port's own random init has the reference's shapes (its draws
    differ: torch.Generator, not threefry)."""
    for name in ("stablelm-1.6b", "qwen1.5-0.5b"):
        jcfg, tcfg = _cfgs(name)
        shapes = jax.eval_shape(lambda: JaxModel(jcfg).init(jax.random.PRNGKey(0)))
        bridged = params_from_reference(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), tcfg, "cpu")
        own = init_params(tcfg, 0, "cpu")
        assert (jax.tree.map(lambda t: tuple(t.shape), own)
                == jax.tree.map(lambda t: tuple(t.shape), bridged))
