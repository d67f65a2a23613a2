"""The port's xLSTM blocks against the reference's ``models.xlstm``.

Reduced xlstm-125m (d_model 64, 4 heads: mLSTM heads of 32 over the 2x
expansion, sLSTM heads of 16) at float32, the reference's parameters
bridged, the same numpy inputs on both sides:

* ``mlstm_seq`` (the quadratic decay-masked form) with the folded state,
  ``mlstm_decode`` from that state, ``slstm_seq`` (the cell stepped over
  time) with its last state and ``slstm_decode``, under ``exact`` and
  ``int8``: outputs and every state field within 2e-5 (float32; the
  reference sums the cumulative gates and the einsums in other orders) or
  5e-4 under int8 (a last-bit difference may move one activation code);
  the running max ``m`` within 2e-5.
* The sequence path's state against the decode recurrence unrolled over
  the same tokens from the zero state (``m`` at -1e30), port against
  port: outputs and states within 2e-5.  This is the identity the
  serving engine leans on (a full-sequence admission, then decode).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core.plan import ExecutionPlan as JaxPlan  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

NAME = "xlstm-125m"
TOL = {"exact": 2e-5, "int8": 5e-4}
# the reference's functions, each compiled whole (its eager ops would
# compile one by one)
J = {name: jax.jit(getattr(jx, name), static_argnames=("cfg", "sites")
                   + (("return_state",) if name.endswith("seq") else ()))
     for name in ("mlstm_seq", "slstm_seq", "mlstm_decode", "slstm_decode")}


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def blocks():
    jcfg = dataclasses.replace(jax_get_arch(NAME).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_arch(NAME).reduced(), dtype="float32")
    out = {"cfg": (jcfg, tcfg)}
    for kind, init in (("mlstm", jx.mlstm_init), ("slstm", jx.slstm_init)):
        jp = jax.jit(init, static_argnums=1)(jax.random.PRNGKey(11 if kind == "mlstm" else 12),
                                             jcfg)
        if kind == "slstm":  # a nonzero gate bias, so the bias path is exercised
            b = np.random.default_rng(1).standard_normal(4 * jcfg.d_model) * 0.1
            jp = {**jp, "w_gates": {**jp["w_gates"], "b": jnp.asarray(b, jnp.float32)}}
        out[kind] = (jp, jax.tree.map(lambda a: _t(np.asarray(a)), jp))
    return out


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _sites(plan, kind):
    return (JaxPlan.from_spec(plan).binding(kind, (0,)),
            ExecutionPlan.from_spec(plan).binding(kind, (0,)))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("plan,b,s", [("exact", 2, 7), ("exact", 1, 1), ("int8", 3, 16)])
def test_seq_and_state_match_reference(blocks, kind, plan, b, s):
    jcfg, tcfg = blocks["cfg"]
    jp, tp = blocks[kind]
    jsites, tsites = _sites(plan, kind)
    x = _x(b, s, tcfg.d_model, seed=b * 10 + s)
    jseq, tseq = J[f"{kind}_seq"], getattr(tx, f"{kind}_seq")
    want, wst = jseq(jp, jnp.asarray(x), cfg=jcfg, sites=jsites, return_state=True)
    got, gst = tseq(tp, _t(x), tcfg, tsites, return_state=True)
    tol = TOL[plan]
    _close(got, want, tol, f"{kind} out")
    for name, g, w in zip(wst._fields, gst, wst):
        _close(g, w, tol if name != "m" else 2e-5, f"{kind} state {name}")


@pytest.mark.parametrize("plan", ["exact", "int8"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_matches_reference(blocks, kind, plan):
    """One decode step from the state a 5-token prefill left."""
    jcfg, tcfg = blocks["cfg"]
    jp, tp = blocks[kind]
    jsites, tsites = _sites(plan, kind)
    x = _x(3, 6, tcfg.d_model, seed=21)
    jseq, jdec = J[f"{kind}_seq"], J[f"{kind}_decode"]
    tseq, tdec = getattr(tx, f"{kind}_seq"), getattr(tx, f"{kind}_decode")
    _, wst = jseq(jp, jnp.asarray(x[:, :5]), cfg=jcfg, sites=jsites, return_state=True)
    _, gst = tseq(tp, _t(x[:, :5]), tcfg, tsites, return_state=True)
    want, wst2 = jdec(jp, jnp.asarray(x[:, 5:]), wst, cfg=jcfg, sites=jsites)
    got, gst2 = tdec(tp, _t(x[:, 5:]), gst, tcfg, tsites)
    tol = TOL[plan]
    _close(got, want, tol, f"{kind} decode out")
    for name, g, w in zip(wst2._fields, gst2, wst2):
        _close(g, w, tol if name != "m" else 2e-5, f"{kind} decode state {name}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_seq_state_equals_unrolled_decode(blocks, kind):
    """Port against port: the sequence path's outputs and folded state
    against the decode recurrence stepped over the same tokens."""
    _, tcfg = blocks["cfg"]
    _, tp = blocks[kind]
    x = _t(_x(2, 9, tcfg.d_model, seed=31))
    if kind == "mlstm":
        seq, dec, st = tx.mlstm_seq, tx.mlstm_decode, tx.mlstm_state_init(tcfg, 2)
    else:
        seq, dec, st = tx.slstm_seq, tx.slstm_decode, tx.slstm_state_init(tcfg, 2)
    want, want_st = seq(tp, x, tcfg, return_state=True)
    assert torch.equal(st.m, torch.full_like(st.m, tx.M_INIT))
    outs = []
    for t in range(x.shape[1]):
        o, st = dec(tp, x[:, t:t + 1], st, tcfg)
        outs.append(o)
    _close(torch.cat(outs, dim=1), want, 2e-5, f"{kind} unrolled out")
    for name, g, w in zip(st._fields, st, want_st):
        _close(g, w, 2e-5, f"{kind} unrolled state {name}")
