"""Engine behaviour beyond token parity: EOS retirement against the
reference engine, the chunked decode loop against its step-by-step
oracle, sampling and the per-slot helpers.  One reduced float32 config
(stablelm-1.6b) with the reference's weights bridged in."""
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
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.transformer import ModelOptions  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

BS, MAX_LEN, GEN, SLOTS, CHUNK = 4, 32, 6, 2, 4


@pytest.fixture(scope="module")
def arch():
    name = "stablelm-1.6b"
    jcfg = dataclasses.replace(jax_get_arch(name).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_arch(name).reduced(), dtype="float32")
    jparams = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return name, jcfg, tcfg, jparams, tparams


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 8, dtype=np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, 3, dtype=np.int32)]),
            rng.integers(0, vocab, 5, dtype=np.int32),
            np.concatenate([prefix, rng.integers(0, vocab, 6, dtype=np.int32)])]


def test_eos_trims_like_reference(arch):
    """A request stops at its first EOS (kept), exactly as in the reference."""
    _, jcfg, tcfg, jparams, tparams = arch
    model = JaxModel(jcfg, JaxOptions(plan="exact"))
    jcfg_serve = JaxServeConfig(max_slots=SLOTS, max_len=MAX_LEN, chunk_steps=CHUNK,
                                kv_block_size=BS, astra_accounting=False)
    full = JaxServeEngine(model, jparams, jcfg_serve).generate_batch(
        _prompts(jcfg.vocab), GEN)
    eos = int(full[0].tokens[2])
    jeng = JaxServeEngine(model, jparams, jcfg_serve)
    want = [o.tokens for o in jeng.generate_batch(_prompts(jcfg.vocab), GEN, eos_id=eos)]
    tmodel = Model(tcfg, ModelOptions(plan="exact", attn_impl="flash"), device="cpu")
    got = ServeEngine(tmodel, tparams, ServeConfig(
        max_slots=SLOTS, max_len=MAX_LEN, chunk_steps=CHUNK, kv_block_size=BS),
        device="cpu").generate_batch(_prompts(tcfg.vocab), GEN, eos_id=eos)
    assert len(want[0]) == 3
    for o, w in zip(got, want):
        np.testing.assert_array_equal(o.tokens, w)


def test_fused_decode_matches_unfused_oracle(arch):
    from repro_torch.models.attention import BlockTables
    from repro_torch.serve import GREEDY, make_fused_decode, unfused_decode

    _, _, tcfg, _, tparams = arch
    model = Model(tcfg, ModelOptions(plan="int8", attn_impl="flash"), device="cpu")
    params = model.prepare(tparams)
    table = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    toks, runs = torch.tensor([[3], [7]], dtype=torch.int32), []
    for loop in (make_fused_decode(model), None):
        states = model.init_decode_state(2, 16, paged=(9, BS))
        args = (params, toks, states, torch.tensor([0, 0]), None)
        if loop is None:
            out = unfused_decode(model, *args, steps=5, sampler=GREEDY,
                                 tables=BlockTables(table))
        else:
            out = loop(*args, steps=5, sampler=GREEDY, tables=BlockTables(table))
        runs.append(out)
    (t1, f1, c1), (t2, f2, c2) = runs
    assert torch.equal(t1, t2) and t1.shape == (2, 5) and bool(f1.all()) and bool(f2.all())
    assert torch.equal(c1[2], c2[2]) and torch.equal(c1[2], torch.tensor([5, 5]))
    for a, b in zip(c1[1]["layers"], c2[1]["layers"]):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


def test_sampling_and_slot_helpers():
    from repro_torch.serve.sampling import SamplerConfig, sample_logits
    from repro_torch.serve.slots import finite_mask, select_states

    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 0.0, 3.0, 1.0]])
    # greedy takes the first maximum, as jnp.argmax does
    assert sample_logits(logits, SamplerConfig(), None).tolist() == [1, 0]
    assert (np.asarray(jax.numpy.argmax(logits.numpy(), -1)) == [1, 0]).all()
    gen = torch.Generator().manual_seed(0)
    ids = torch.stack([sample_logits(logits, SamplerConfig(1.0, 2), gen) for _ in range(200)])
    assert set(ids[:, 0].tolist()) <= {1, 2} and set(ids[:, 1].tolist()) <= {0, 2}
    with pytest.raises(ValueError):
        SamplerConfig(temperature=-1.0)
    bad = logits.clone()
    bad[1, 3] = float("nan")
    assert finite_mask(bad[:, None]).tolist() == [True, False]
    new = {"a": [torch.ones(2, 3)], "b": torch.ones(2)}
    old = {"a": [torch.zeros(2, 3)], "b": torch.zeros(2)}
    out = select_states(new, old, torch.tensor([True, False]))
    assert out["a"][0].tolist() == [[1, 1, 1], [0, 0, 0]] and out["b"].tolist() == [1, 0]
