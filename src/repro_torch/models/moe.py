"""Mixture-of-experts FFN: top-k router, per-group expert buffers, combine.

Port of ``repro.models.moe``.  Tokens are split into groups of ``g`` (the
largest divisor of the token count that is at most ``group_size``, 512); the
router (float32, site ``router``) picks each token's top-k experts, and
each (token, k) pair takes the next row of its expert's buffer in its
group, counted in token-major order over the pairs.  Pairs at or past
the capacity are dropped (they keep the residual).  The experts run as
batched products (sites ``expert_up``, shared by the gate, and
``expert_down``), and each token sums its experts' outputs weighted by
its renormalised gates, rounded to the model dtype first.  The Switch
load-balance loss comes back beside the output.

The reference builds a one-hot dispatch tensor ``[G, g, k, E, C]`` with
``C`` the capacity (``g * k`` when drop-free, as serving always is) and
contracts it with the tokens.  The port never builds it: an expert's
buffer in a group can hold at most ``g`` pairs, since a token's top-k
experts are distinct, so each buffer has ``min(C, g)`` rows, filled by
index and read back by index.  The rows it leaves out are always zero in
the reference; a zero row changes no per-(group, expert) absmax, so a
quantized expert site gets the reference's dynamic scales.  Buffers are
laid out expert-major, ``[E, G, min(C, g), D]``, so each expert's groups
run as one product (:func:`~repro_torch.core.astra_layer.astra_batched_matmul`
with ``fold_groups``).
Every size comes from the shapes and the config: nothing syncs with the
host.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.astra_layer import ComputeConfig, EXACT, astra_batched_matmul
from repro_torch.core.plan import SiteBinding, as_binding
from repro_torch.models.layers import dense, dense_init

MOE_GROUP = 512  # tokens per dispatch group, the reference's
# the expert weights and the site each runs under (the gate shares the up site)
EXPERT_WEIGHTS = (("w_up", "expert_up"), ("w_gate", "expert_up"), ("w_down", "expert_down"))


def moe_init(gen: torch.Generator, cfg: ArchConfig, device=None) -> Dict[str, Any]:
    """Random float32 parameters with the reference's shapes and scales:
    the router ``[D, E]`` at 0.02, ``w_up``/``w_gate`` ``[E, D, F]`` at
    ``D**-0.5`` (a gate only for swiglu/geglu), ``w_down`` ``[E, F, D]``
    at ``F**-0.5``."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_expert
    p = {
        "router": dense_init(gen, d, e, device=device, scale=0.02),
        "w_up": torch.randn(e, d, f, generator=gen, device=device) * d ** -0.5,
        "w_down": torch.randn(e, f, d, generator=gen, device=device) * f ** -0.5,
    }
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = torch.randn(e, d, f, generator=gen, device=device) * d ** -0.5
    return p


def group_len(t: int, group: int = MOE_GROUP) -> int:
    """The largest divisor of ``t`` that is at most ``group``: groups tile
    the token stream exactly."""
    g = min(group, t)
    while t % g:
        g -= 1
    return g


def capacity(cfg: ArchConfig, g: int, capacity_factor: float, full_capacity: bool) -> int:
    """Rows per (group, expert) buffer in the reference: ``g * k`` when
    drop-free, else ``max(k, int(cf * g * k / E))``."""
    m = cfg.moe
    if full_capacity:
        return g * m.top_k
    return max(m.top_k, int(capacity_factor * g * m.top_k / m.n_experts))


def route(p, xt: torch.Tensor, cfg: ArchConfig, sites: SiteBinding):
    """Router over ``xt [G, g, D]`` in float32.  Returns (probs ``[G, g,
    E]``, renormalised top-k gates ``[G, g, k]`` float32, experts ``[G, g,
    k]`` int64)."""
    logits = dense(p["router"], xt.to(torch.float32), sites("router"))
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, experts


def positions(experts: torch.Tensor, n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, k) pair's row in its expert's buffer of its group: the
    count of earlier pairs of the group, token-major over ``(t, k)``, sent
    to the same expert.  Returns (rows ``[G, g, k]``, the one-hot experts
    ``[G, g, k, E]``)."""
    n_groups, g, k = experts.shape
    # a comparison, not F.one_hot: that checks the indices' range on the host
    onehot = (experts[..., None] == torch.arange(n_experts, device=experts.device)).long()
    ahead = onehot.reshape(n_groups, g * k, n_experts).cumsum(1) - 1
    rows = ahead.gather(2, experts.reshape(n_groups, g * k, 1)).reshape(n_groups, g, k)
    return rows, onehot


def dispatch(xt: torch.Tensor, experts: torch.Tensor, pos: torch.Tensor, cap: int,
             n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill the expert buffers from ``xt [G, g, D]``: each kept (token, k)
    pair's token goes to row ``pos`` of its expert's buffer in its group.
    Returns (buffers ``[E, G, min(cap, g), D]``, rows never filled zero;
    each pair's flat buffer row ``[G * g * k]``, or ``E * G * min(cap, g)``,
    a spare row, for a pair dropped at ``cap``)."""
    n_groups, g, d = xt.shape
    rows = min(cap, g)  # an expert takes at most one pair of each token
    n_rows = n_experts * n_groups * rows
    grp = torch.arange(n_groups, device=xt.device).reshape(n_groups, 1, 1)
    slot = torch.where(pos < cap, (experts * n_groups + grp) * rows + pos,
                       torch.full_like(pos, n_rows)).reshape(-1)
    # the token each buffer row holds: the zero row past the tokens if none
    token = torch.arange(n_groups * g, device=xt.device).reshape(n_groups, g, 1)
    src = torch.full((n_rows + 1,), n_groups * g, dtype=torch.long, device=xt.device)
    src[slot] = token.expand_as(experts).reshape(-1)  # duplicates only at the spare row
    x_pad = torch.cat([xt.reshape(n_groups * g, d), xt.new_zeros(1, d)])
    return x_pad[src[:n_rows]].reshape(n_experts, n_groups, rows, d), slot


def combine(expert_out: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """Each token's gated sum of its pairs' expert rows (a dropped pair's
    spare row is zero), the gates ``[G, g, k]`` rounded to ``dtype`` first
    as the reference's combine weights are.  Returns ``[G * g, D]``."""
    d = expert_out.shape[-1]
    t, k = gates.shape[0] * gates.shape[1], gates.shape[2]
    out_pad = torch.cat([expert_out.reshape(-1, d), expert_out.new_zeros(1, d)])
    picked = out_pad[slot].reshape(t, k, d)
    return torch.bmm(gates.to(dtype).reshape(t, 1, k), picked).reshape(t, d)


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig,
              sites: Union[ComputeConfig, SiteBinding] = EXACT,
              capacity_factor: float = 1.25, full_capacity: bool = False,
              group_size: int = MOE_GROUP, dp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, D]`` -> (output ``[B, S, D]`` in ``x``'s dtype, the
    load-balance loss, a float32 scalar).  ``full_capacity`` (decode)
    sizes the buffers so no pair can drop.  With ``dp``
    (``parallel.dp.DataParallel``; ``x`` is this rank's rows) the loss is
    the global batch's: both token means are summed over the
    data-parallel ranks before their product, its gradient this rank's
    part."""
    m = cfg.moe
    b, s, d = x.shape
    sites = as_binding(sites)
    t, e = b * s, m.n_experts
    g = group_len(t, group_size)
    n_groups = t // g
    xt = x.reshape(n_groups, g, d)
    probs, gates, experts = route(p, xt, cfg, sites)
    cap = capacity(cfg, g, capacity_factor, full_capacity)
    pos, onehot = positions(experts, e)
    expert_in, slot = dispatch(xt, experts, pos, cap, e)

    def product(h, name, site):
        return astra_batched_matmul(h, p[name], sites(site), fold_groups=True,
                                    **p.get("caches", {}).get(name, {}))

    up = product(expert_in, "w_up", "expert_up")
    if "w_gate" in p:
        gg = product(expert_in, "w_gate", "expert_up")
        act = F.silu(gg) if cfg.act == "swiglu" else F.gelu(gg, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(up, approximate="tanh")
    expert_out = product(h, "w_down", "expert_down")  # [E, G, min(cap, g), D]
    out = combine(expert_out, slot, gates, x.dtype).reshape(b, s, d)
    # Switch load-balance loss: E * sum(mean router prob x dispatch fraction)
    if dp is None:
        me = probs.mean((0, 1))
        ce = (onehot.sum(2) > 0).to(torch.float32).mean((0, 1))
        aux = e * torch.sum(me * ce) * m.load_balance_coef
        return out.to(x.dtype), aux
    n_tok = t * dp.size
    me_part = probs.sum((0, 1)) / n_tok
    ce = dp.sum((onehot.sum(2) > 0).to(torch.float32).sum((0, 1))) / n_tok
    me = dp.sum(me_part)
    aux = dp.global_value(e * torch.sum(me_part * ce) * m.load_balance_coef,
                       e * torch.sum(me * ce) * m.load_balance_coef)
    return out.to(x.dtype), aux
