"""A decode chunk whose logits go non-finite on one slot must not break
its healthy neighbours.

Reduced stablelm-1.6b at float32 under ``exact``, 2 slots, chunks of 4
steps, on the dense and the paged layout.  The fused decode's finite
flag of slot 1 is forced false in the second chunk: the engine commits
slot 0's tokens, position and budget first, drops slot 1's tokens of
that chunk, and only then raises ``NonFiniteLogitsError`` naming exactly
slot 1 (as the reference engine does).  Slot 1's request ends at its
pre-fault stream (its prefill token and first chunk, ``fault_reason``
``"nonfinite_logits"``) and its slot is freed, on the paged layout with
the blocks only it holds zeroed.  The caller goes on with ``run()``: slot 0's 16
tokens equal a clean run's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import NonFiniteLogitsError, ServeConfig, ServeEngine  # noqa: E402
from repro_torch.serve.faults import FAULT_NONFINITE  # noqa: E402

GEN = 16


def _engine(kv_block_size):
    model = Model(get_arch("stablelm-1.6b").reduced(dtype="float32"), device="cpu")
    params = model.init(2)
    return ServeEngine(model, params, ServeConfig(max_slots=2, max_len=40, chunk_steps=4,
                                                  kv_block_size=kv_block_size),
                       device="cpu")


@pytest.mark.parametrize("kv_block_size", [0, 4])
def test_nonfinite_slot_leaves_healthy_slot_intact(kv_block_size):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n, dtype=np.int32) for n in (9, 6)]
    clean = _engine(kv_block_size).generate_batch(prompts, GEN)

    eng = _engine(kv_block_size)
    fused, calls = eng._fused, []

    def poisoned(*args, **kwargs):
        toks, finite, rest = fused(*args, **kwargs)
        calls.append(1)
        if len(calls) == 2:  # the second chunk: slot 1's logits went non-finite
            finite = finite.clone()
            finite[1] = False
        return toks, finite, rest

    eng._fused = poisoned
    ids = [eng.submit(p, GEN) for p in prompts]
    outs = list(eng.step())
    # the blocks only slot 1 holds (its full prompt block is interned)
    own = [b for b in eng._slot_blocks[1] if eng._pool.ref(b) == 1] if kv_block_size else []
    assert own or not kv_block_size
    with pytest.raises(NonFiniteLogitsError) as err:
        outs += eng.step()
    assert err.value.slots == (1,) and isinstance(err.value, RuntimeError)
    assert eng._slots[0].pos == len(prompts[0]) + 8  # slot 0 committed both chunks
    assert eng._slots[1] is None  # slot 1 was retired at its fault
    for st in eng._states["layers"] if kv_block_size else ():
        for blk in own:
            assert not st.k[blk].any() and not st.v[blk].any()
    outs += eng.run()
    by_id = {o.request_id: o for o in outs}
    np.testing.assert_array_equal(by_id[ids[0]].tokens, clean[0].tokens)
    assert by_id[ids[0]].fault_reason is None
    # prefill token + the first chunk; the poisoned chunk is not delivered
    np.testing.assert_array_equal(by_id[ids[1]].tokens, clean[1].tokens[:1 + 4])
    assert by_id[ids[1]].fault_reason == FAULT_NONFINITE
