"""The port's mixture-of-experts FFN against the reference's ``moe_apply``.

Reduced granite-moe-1b-a400m (d_model 64, 4 experts, top-2, expert width
32, SwiGLU) at float32, the reference's parameters bridged, the same
numpy inputs on both sides:

* ``moe_apply`` under ``exact`` at the reference's default capacity
  (1.25), drop-free (``full_capacity``), at a size where some pairs drop,
  and over ``[3, 200]`` tokens (600: groups of 300, not a power of two);
  under plans that quantize the expert sites (``int8``, ``sc``; the
  batched kernels' plain versions on the CPU) and the router too: output
  within 1e-5 (exact; the same products in other summation orders) or
  2e-4 (quantized: a last-bit difference in an activation may move one
  code of the down projection's input by one step), the load-balance
  loss within 1e-6.  Router probabilities are held to 1e-6 first, so
  both sides route alike.
* The port's ``min(C, g)``-row expert-major buffers against the
  reference's one-hot dispatch formula, written out here in torch: the
  buffers hold the same rows (the formula's extra rows all zero), and the
  combine gives the same output, float32 within 1e-6.
* ``astra_batched_matmul`` with ``fold_groups`` (each expert's groups as
  one product) against it over every (group, expert) pair under exact, int8 and sc: equal (bit for bit when
  quantized: the same int32 sums and scales).
* The dispatch on the path: no host sync (``.item()``, ``nonzero``) and
  no tensor the size of the one-hot dispatch tensor, seen by every op
  the call runs.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.core.astra_layer import astra_matmul as jax_astra_matmul  # noqa: E402
from repro.core.plan import ExecutionPlan as JaxPlan  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.astra_layer import astra_batched_matmul  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

NAME = "granite-moe-1b-a400m"
# the reference's moe_apply compiled whole (its eager ops would compile one by one)
JAX_MOE = jax.jit(jmoe.moe_apply, static_argnums=(2, 3, 4, 5))
EXPERTS_INT8 = {"*.expert_*": "int8", "default": "exact"}
EXPERTS_SC = {"*.expert_*": "sc", "default": "exact"}
ALL_INT8 = {"*.router|*.expert_*": "int8", "default": "exact"}
# (batch, seq, capacity_factor, full_capacity, plan)
CASES = {
    "default_capacity": (2, 9, 1.25, False, "exact"),
    "full_capacity": (2, 9, 1.25, True, "exact"),
    "drops": (1, 40, 1.0, False, "exact"),
    "groups_of_300": (3, 200, 1.25, False, "exact"),
    "experts_int8": (2, 24, 32.0, False, EXPERTS_INT8),
    "experts_sc": (1, 12, 1.25, True, EXPERTS_SC),
    "router_and_experts_int8": (3, 200, 1.25, False, ALL_INT8),
}


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@pytest.fixture(scope="module")
def moe():
    jcfg = dataclasses.replace(jax_get_arch(NAME).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_arch(NAME).reduced(), dtype="float32")
    jp = jax.jit(jmoe.moe_init, static_argnums=1)(jax.random.PRNGKey(5), jcfg)
    tp = jax.tree.map(lambda a: _t(np.asarray(a)), jp)
    return jcfg, tcfg, jp, tp


def _x(b, s, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(moe, case):
    jcfg, tcfg, jp, tp = moe
    b, s, cf, full, plan = CASES[case]
    x = _x(b, s, tcfg.d_model, seed=len(case))
    jsites = JaxPlan.from_spec(plan).binding("attn", (0,))
    tsites = ExecutionPlan.from_spec(plan).binding("attn", (0,))
    want, want_aux = JAX_MOE(jp, jnp.asarray(x), jcfg, jsites, cf, full)
    got, got_aux = tmoe.moe_apply(tp, _t(x), tcfg, tsites, cf, full)
    # the router first: both sides must route alike
    t = b * s
    g = tmoe.group_len(t)
    probs, _, experts = tmoe.route(tp, _t(x).reshape(t // g, g, -1), tcfg, tsites)
    jlogits = jax_astra_matmul(jnp.asarray(x).reshape(t // g, g, -1), jp["router"]["w"],
                               jsites("router"))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jax.nn.softmax(jlogits, -1)),
                               rtol=0, atol=1e-6)
    if case == "drops":  # the case must drop pairs at its capacity
        pos, _ = tmoe.positions(experts, tcfg.moe.n_experts)
        assert (pos >= tmoe.capacity(tcfg, g, cf, full)).any()
    if case == "groups_of_300":
        assert g == 300
    tol = 1e-5 if plan == "exact" else 2e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), rtol=1e-6, atol=1e-6)


def _one_hot_formula(xt, gates, experts, cap, n_experts):
    """The reference's dispatch and combine, written out: ``disp [G, g, k,
    E, C]``, the expert inputs ``[G, E, C, D]`` and the combine weights
    ``[G, g, E, C]``."""
    e_oh = torch.nn.functional.one_hot(experts, n_experts).to(xt.dtype)
    flat = e_oh.reshape(experts.shape[0], -1, n_experts).to(torch.int64)
    pos = ((flat.cumsum(1) - 1) * flat).amax(-1).reshape(experts.shape)
    c_oh = torch.nn.functional.one_hot(pos.clamp(max=cap), cap + 1)[..., :cap].to(xt.dtype)
    disp = e_oh[..., :, None] * c_oh[..., None, :]
    disp = disp * (pos < cap)[..., None, None].to(xt.dtype)
    expert_in = torch.einsum("gtec,gtd->gecd", disp.sum(2), xt)
    combine = (gates[..., None, None].to(xt.dtype) * disp).sum(2)
    return expert_in, combine


@pytest.mark.parametrize("b,s,cf,full", [(2, 9, 1.25, True), (1, 40, 1.0, False),
                                         (3, 200, 1.25, False)])
def test_expert_buffers_match_one_hot_formula(moe, b, s, cf, full):
    _, tcfg, _, tp = moe
    e, d = tcfg.moe.n_experts, tcfg.d_model
    t = b * s
    g = tmoe.group_len(t)
    n_groups = t // g
    xt = _t(_x(b, s, d, seed=3)).reshape(n_groups, g, d)
    sites = ExecutionPlan.from_spec("exact").binding("attn", (0,))
    _, gates, experts = tmoe.route(tp, xt, tcfg, sites)
    cap = tmoe.capacity(tcfg, g, cf, full)
    rows = min(cap, g)
    pos, _ = tmoe.positions(experts, e)
    buf, slot = tmoe.dispatch(xt, experts, pos, cap, e)
    assert buf.shape == (e, n_groups, rows, d)
    want_in, weights = _one_hot_formula(xt, gates, experts, cap, e)
    assert torch.equal(buf.transpose(0, 1), want_in[:, :, :rows])
    assert not want_in[:, :, rows:].any()  # the rows the port leaves out
    # any expert outputs (an all-zero row's output is zero: no bias): the
    # port's gather and gated sum against the formula's combine einsum
    out_e = torch.randn(n_groups, e, cap, d, generator=torch.Generator().manual_seed(0))
    out_e[:, :, rows:] = 0
    got = tmoe.combine(out_e[:, :, :rows].transpose(0, 1), slot, gates, torch.float32)
    want = torch.einsum("gtec,gecd->gtd", weights, out_e).reshape(t, d)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["exact", "int8", "sc"])
def test_expert_matmul_equals_batched_per_group_and_expert(mode):
    gen = torch.Generator().manual_seed(1)
    e, n_groups, m, k, n = 3, 2, 5, 32, 16
    x = torch.randn(e, n_groups, m, k, generator=gen)
    x[:, :, 3:] = 0  # zero rows, as a buffer's unfilled rows are
    w = torch.randn(e, k, n, generator=gen)
    cc = ExecutionPlan.from_spec({"*.expert_up": mode}).binding("attn", (0,))("expert_up")
    got = astra_batched_matmul(x, w, cc, fold_groups=True)
    want = astra_batched_matmul(x.transpose(0, 1), w, cc).transpose(0, 1)
    if mode == "exact":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(got, want)


class _Watch(TorchDispatchMode):
    """Every op's name and the largest tensor any op produced."""

    def __init__(self):
        super().__init__()
        self.ops, self.largest = set(), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.add(str(func.overloadpacket))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.largest = max(self.largest, o.numel())
        return out


def test_dispatch_has_no_host_sync_and_no_one_hot_tensor(moe):
    _, tcfg, _, tp = moe
    b, s = 2, 300  # t = 600: G = 2 groups of 300, drop-free as serving runs
    x = _t(_x(b, s, tcfg.d_model, seed=4))
    sites = ExecutionPlan.from_spec("exact").binding("attn", (0,))
    with _Watch() as watch:
        tmoe.moe_apply(tp, x, tcfg, sites, capacity_factor=float(tcfg.moe.n_experts))
    m = tcfg.moe
    g = tmoe.group_len(b * s)
    one_hot = (b * s) * m.top_k * m.n_experts * g * m.top_k  # [G, g, k, E, C], C = g * k
    assert watch.largest < one_hot // 8, (watch.largest, one_hot)
    synced = {op for op in watch.ops if "_local_scalar_dense" in op or "nonzero" in op}
    assert not synced, synced


@pytest.mark.parametrize("t,want", [(1, 1), (8, 8), (512, 512), (600, 300), (1031, 1),
                                    (3072, 512), (1536, 512), (1000, 500)])
def test_group_len_is_the_reference_grouping(t, want):
    assert tmoe.group_len(t) == want
