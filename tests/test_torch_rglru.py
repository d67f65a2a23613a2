"""The port's RG-LRU pieces against the reference's: the linear-recurrence
kernel's plain version, the recurrent block and the sliding-window ring.

* ``rglru_scan`` (plain version, the path a CPU tensor takes) against the
  reference's Pallas kernel in interpret mode and its ``lax.scan``
  oracle, at the reference test's shapes plus ragged ``B`` and ``S``:
  rtol = atol = 2e-5, the reference test's tolerance (the kernel scans in
  another order than the loop).
* ``rglru_seq`` and ``rglru_decode`` at reduced recurrentgemma width
  under ``exact`` and ``int8``, with the ``RGLRUState`` (last ``h`` and
  the conv tail of pre-conv inputs), also for a sequence shorter than the
  conv history: float32 within 1e-5 (same arithmetic, other summation
  orders in the GEMMs and the conv).
* the ``local`` layer's ring: ``_make_cache`` for ``s < w``, ``s == w``
  and ``s > w``, and dense decode past the wrap, against the reference's
  ``attn_seq``/``attn_decode``: 1e-5.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core.plan import ExecutionPlan as JaxPlan  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_scan_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.kernels.rglru_scan import rglru_scan  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402

NAME = "recurrentgemma-2b"
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _port_tree(tree):
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    return _t(tree)


@pytest.mark.parametrize("b,s,d", [(2, 64, 16), (3, 100, 8), (1, 16, 4), (5, 37, 3), (7, 1, 9)])
def test_rglru_scan_plain_matches_reference(b, s, d):
    rng = np.random.default_rng(b * 100 + s)
    a = rng.uniform(0.2, 0.999, (b, s, d)).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    before = rglru_scan.launches
    got = rglru_scan(_t(a), _t(x))
    assert rglru_scan.launches == before and got.dtype == torch.float32  # plain on the CPU
    for want in (jax_rglru_scan(jnp.asarray(a), jnp.asarray(x), chunk=min(32, s)),
                 jax_rglru_scan_ref(jnp.asarray(a), jnp.asarray(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="one"):
        rglru_scan(_t(a), _t(x[..., :1]))


@pytest.fixture(scope="module")
def block():
    """One RG-LRU block's reference params and the same in the port."""
    jcfg = dataclasses.replace(jax_get_arch(NAME).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_arch(NAME).reduced(), dtype="float32")
    jp = jrglru.rglru_init(jax.random.PRNGKey(3), jcfg)
    # nonzero conv and gate biases, so the bias paths are exercised
    rng = np.random.default_rng(0)
    jp = {**jp, "conv_b": jnp.asarray(rng.standard_normal(jcfg.d_rnn) * 0.1, jnp.float32),
          "w_a": {**jp["w_a"], "b": jnp.asarray(rng.standard_normal(jcfg.d_rnn) * 0.1,
                                                 jnp.float32)}}
    return jcfg, tcfg, jp, _port_tree(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("s", [2, 3, 11])  # 2 < conv_width - 1: a zero-padded tail
@pytest.mark.parametrize("plan", ["exact", "int8"])
def test_rglru_seq_and_decode_match_reference(block, plan, s):
    jcfg, tcfg, jp, tp = block
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s + 3, jcfg.d_model)).astype(np.float32)
    jsites = JaxPlan.from_spec(plan).binding("rglru", (0,))
    tsites = ExecutionPlan.from_spec(plan).binding("rglru", (0,))
    jout, jst = jrglru.rglru_seq(jp, jnp.asarray(x[:, :s]), jcfg, jsites, return_state=True)
    tout, tst = trglru.rglru_seq(tp, _t(x[:, :s]), tcfg, tsites, return_state=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL, rtol=0)
    assert tst.conv.shape == (2, tcfg.conv_width - 1, tcfg.d_rnn)
    for g, w in zip(tst, jst):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    for t in range(s, s + 3):  # decode from the prefilled state
        jout, jst = jrglru.rglru_decode(jp, jnp.asarray(x[:, t:t + 1]), jst, jcfg, jsites)
        tout, tst = trglru.rglru_decode(tp, _t(x[:, t:t + 1]), tst, tcfg, tsites)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL, rtol=0)
        for g, w in zip(tst, jst):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("s", [5, 8, 13])  # s < w, s == w, s > w (window 8)
@pytest.mark.parametrize("use_flash", [False, True])
def test_local_ring_matches_reference(s, use_flash):
    """The ring ``_make_cache`` builds and decode past the wrap."""
    jcfg = dataclasses.replace(jax_get_arch(NAME).reduced(window=8), dtype="float32")
    tcfg = dataclasses.replace(get_arch(NAME).reduced(window=8), dtype="float32")
    jp = jattn.attn_init(jax.random.PRNGKey(5), jcfg)
    tp = _port_tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s + 6, jcfg.d_model)).astype(np.float32)
    jout, jc = jattn.attn_seq(jp, jnp.asarray(x[:, :s]), jcfg, kind="local",
                              use_flash=False, return_cache=True, max_len=32)
    tout, tc = tattn.attn_seq(tp, _t(x[:, :s]), tcfg, kind="local", use_flash=use_flash,
                              return_cache=True, max_len=32)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL, rtol=0)
    assert tc.k.shape[2] == 8
    for g, w in zip(tc, jc):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    for t in range(s, s + 6):  # writes at t % 8: past the wrap for every s
        jout, jc = jattn.attn_decode(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                     jnp.full((2,), t, jnp.int32), jcfg, kind="local")
        tout, tc = tattn.attn_decode(tp, _t(x[:, t:t + 1]), tc, torch.full((2,), t), tcfg,
                                     kind="local", use_kernel=use_flash)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL, rtol=0)
        for g, w in zip(tc, jc):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    ring = tattn.init_cache(tcfg, 2, 5, kind="local")  # clamped to max_len < window
    assert ring.k.shape == (2, tcfg.n_kv_heads, 5, tcfg.head_dim)
