"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``repro.models.xlstm`` (arXiv:2405.04517).  mLSTM is a
pre-up-projection block (2x expansion, gated by ``silu``): its sequence
path is the quadratic decay-masked form, in float32,

    D[t, s] = b_t - b_s + li_s  (s <= t, else -inf),  b = cumsum(logsigmoid(f))
    m_t = max_s D[t, s]
    h_t = sum_s exp(D[t, s] - m_t) (q_t . k_s) v_s
          / max(|sum_s exp(D[t, s] - m_t) (q_t . k_s)|, exp(-m_t)),

and its decode path the stabilised recurrence over ``MLSTMState`` (the
matrix memory ``c``, the normaliser ``n`` and the running log max ``m``),
which the sequence path folds its whole sequence into when a prefill asks
for the state.  sLSTM is post-up-projection (a 4/3 GLU FFN after the
cell) with per-head recurrent weights ``r_gates``: inherently sequential,
a loop over time here where the reference runs ``lax.scan``.  ``m``
starts at -1e30 in both states.  ``r_gates`` and the intra-sequence
products are not GEMM sites of the plan; the projections are
(``up_proj``, ``qkv``, ``gates``, ``down_proj``; ``gates_in``, ``up``,
``down``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.astra_layer import ComputeConfig, EXACT
from repro_torch.core.plan import SiteBinding, as_binding
from repro_torch.models.layers import dense, dense_init, norm_apply, norm_init

M_INIT = -1e30  # the running log max before any token


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


# ===================================================================== mLSTM
class MLSTMState(NamedTuple):
    c: torch.Tensor  # [B, H, dh, dh] float32, stabilised matrix memory
    n: torch.Tensor  # [B, H, dh] float32
    m: torch.Tensor  # [B, H] float32, running log max


def mlstm_init(gen: torch.Generator, cfg: ArchConfig, device=None):
    d = cfg.d_model
    e, h = 2 * d, cfg.n_heads
    return {
        "w_up": dense_init(gen, d, 2 * e, device=device),  # [x | gate]
        "w_q": dense_init(gen, e, e, device=device),
        "w_k": dense_init(gen, e, e, device=device),
        "w_v": dense_init(gen, e, e, device=device),
        "w_if": dense_init(gen, e, 2 * h, device=device),  # input + forget gate per head
        "out_norm": norm_init(e, "rmsnorm", device),
        "w_down": dense_init(gen, e, d, device=device),
    }


def mlstm_state_init(cfg: ArchConfig, batch: int, device=None) -> MLSTMState:
    h = cfg.n_heads
    dh = 2 * cfg.d_model // h
    return MLSTMState(
        torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        torch.full((batch, h), M_INIT, dtype=torch.float32, device=device))


def _mlstm_qkvif(p, xe: torch.Tensor, cfg: ArchConfig, sites: SiteBinding):
    """q (scaled by dh**-0.5), k, v ``[B, H, S, dh]`` in the model dtype;
    the log input gate (pre-exp) and log forget gate ``[B, H, S]`` in
    float32."""
    b, s, e = xe.shape
    h = cfg.n_heads
    dh = e // h

    def heads(w):
        return dense(p[w], xe, sites("qkv")).reshape(b, s, h, dh).transpose(1, 2)

    q, k, v = heads("w_q") * (dh ** -0.5), heads("w_k"), heads("w_v")
    gif = dense(p["w_if"], xe, sites("gates")).to(torch.float32).reshape(b, s, 2, h)
    li = gif[:, :, 0].transpose(1, 2)
    lf = F.logsigmoid(gif[:, :, 1]).transpose(1, 2)
    return q, k, v, li, lf


def _mlstm_out(p, hvec: torch.Tensor, gate: torch.Tensor, cfg: ArchConfig,
               sites: SiteBinding) -> torch.Tensor:
    hvec = norm_apply(p["out_norm"], hvec, "rmsnorm", cfg.norm_eps)
    return dense(p["w_down"], hvec * F.silu(gate), sites("down_proj"))


def mlstm_seq(p, x: torch.Tensor, cfg: ArchConfig,
              sites: Union[ComputeConfig, SiteBinding] = EXACT,
              return_state: bool = False) -> Tuple[torch.Tensor, Optional[MLSTMState]]:
    """Full-sequence block over ``x [B, S, D]``.  Returns (out ``[B, S,
    D]``, the state after the last position | None)."""
    b, s, d = x.shape
    e = 2 * d
    sites = as_binding(sites)
    up = dense(p["w_up"], x, sites("up_proj"))
    xe, gate = up[..., :e], up[..., e:]
    q, k, v, li, lf = _mlstm_qkvif(p, xe, cfg, sites)
    qf, kf, vf = q.to(torch.float32), k.to(torch.float32), v.to(torch.float32)
    bcum = torch.cumsum(lf, dim=-1)  # [B, H, S]
    dmat = bcum[..., :, None] - bcum[..., None, :] + li[..., None, :]  # [B, H, S, S]
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    dmat = dmat.masked_fill(~causal, float("-inf"))
    m = dmat.amax(dim=-1)  # [B, H, S]
    ws = torch.exp(dmat - m[..., None]) * (qf @ kf.transpose(-1, -2))
    num = ws @ vf
    den = torch.maximum(ws.sum(-1).abs(), torch.exp(-m))
    hseq = (num / den[..., None]).to(x.dtype)  # [B, H, S, dh]
    out = _mlstm_out(p, hseq.transpose(1, 2).reshape(b, s, e), gate, cfg, sites)
    state = _mlstm_fold_state(kf, vf, li, bcum) if return_state else None
    return out, state


def _mlstm_fold_state(kf: torch.Tensor, vf: torch.Tensor, li: torch.Tensor,
                      bcum: torch.Tensor) -> MLSTMState:
    """The whole sequence folded into the recurrent state (float32 k, v)."""
    dvec = bcum[..., -1:] - bcum + li  # each position's weight in the final state
    m_s = dvec.amax(dim=-1)  # [B, H]
    wv = torch.exp(dvec - m_s[..., None])
    c = torch.einsum("bhs,bhsd,bhse->bhde", wv, kf, vf)
    n = torch.einsum("bhs,bhsd->bhd", wv, kf)
    return MLSTMState(c, n, m_s)


def mlstm_decode(p, x: torch.Tensor, state: MLSTMState, cfg: ArchConfig,
                 sites: Union[ComputeConfig, SiteBinding] = EXACT
                 ) -> Tuple[torch.Tensor, MLSTMState]:
    """One step per slot (``x [B, 1, D]``).  Returns (out ``[B, 1, D]``,
    the next state)."""
    b, _, d = x.shape
    e = 2 * d
    sites = as_binding(sites)
    up = dense(p["w_up"], x, sites("up_proj"))
    xe, gate = up[..., :e], up[..., e:]
    q, k, v, li, lf = _mlstm_qkvif(p, xe, cfg, sites)
    qf, kf, vf = (t[:, :, 0].to(torch.float32) for t in (q, k, v))  # [B, H, dh]
    li, lf = li[..., 0], lf[..., 0]  # [B, H]
    m_new = torch.maximum(lf + state.m, li)
    alpha = torch.exp(lf + state.m - m_new)[..., None]
    beta = torch.exp(li - m_new)[..., None]
    c = alpha[..., None] * state.c + beta[..., None] * (kf[..., :, None] * vf[..., None, :])
    n = alpha * state.n + beta * kf
    num = torch.einsum("bhde,bhd->bhe", c, qf)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qf).abs(), torch.exp(-m_new))
    hvec = (num / den[..., None]).reshape(b, 1, e).to(x.dtype)
    return _mlstm_out(p, hvec, gate, cfg, sites), MLSTMState(c, n, m_new)


# ===================================================================== sLSTM
class SLSTMState(NamedTuple):
    c: torch.Tensor  # [B, H, dh] float32
    n: torch.Tensor  # [B, H, dh]
    m: torch.Tensor  # [B, H, dh]
    h: torch.Tensor  # [B, H, dh]


def slstm_init(gen: torch.Generator, cfg: ArchConfig, device=None):
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    f_up = int(d * 4 / 3)
    return {
        "w_gates": dense_init(gen, d, 4 * d, bias=True, device=device),  # i f z o
        "r_gates": torch.randn(4, h, dh, dh, generator=gen, device=device) / math.sqrt(dh),
        "out_norm": norm_init(d, "rmsnorm", device),
        "w_up": dense_init(gen, d, 2 * f_up, device=device),
        "w_down": dense_init(gen, f_up, d, device=device),
    }


def slstm_state_init(cfg: ArchConfig, batch: int, device=None) -> SLSTMState:
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    z = torch.zeros((batch, h, dh), dtype=torch.float32, device=device)
    return SLSTMState(z, z.clone(), torch.full_like(z, M_INIT), z.clone())


def _slstm_cell(p, wx_t: torch.Tensor, state: SLSTMState) -> SLSTMState:
    """One step from ``wx_t [B, 4, H, dh]``, the input's share of the
    gates (float32)."""
    rh = torch.einsum("ghde,bhd->gbhe", p["r_gates"], state.h)  # [4, B, H, dh]
    i_raw, f_raw, z_raw, o_raw = wx_t.transpose(0, 1) + rh
    lf = F.logsigmoid(f_raw)
    m_new = torch.maximum(lf + state.m, i_raw)
    alpha = torch.exp(lf + state.m - m_new)
    beta = torch.exp(i_raw - m_new)
    c = alpha * state.c + beta * torch.tanh(z_raw)
    n = alpha * state.n + beta
    h = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1e-9)
    return SLSTMState(c, n, m_new, h)


def _slstm_ffn(p, hseq: torch.Tensor, cfg: ArchConfig, sites: SiteBinding) -> torch.Tensor:
    hseq = norm_apply(p["out_norm"], hseq, "rmsnorm", cfg.norm_eps)
    up = dense(p["w_up"], hseq, sites("up"))
    f = up.shape[-1] // 2
    return dense(p["w_down"], gelu(up[..., :f]) * up[..., f:], sites("down"))


def slstm_seq(p, x: torch.Tensor, cfg: ArchConfig,
              sites: Union[ComputeConfig, SiteBinding] = EXACT,
              return_state: bool = False) -> Tuple[torch.Tensor, Optional[SLSTMState]]:
    """Full-sequence block over ``x [B, S, D]``, the cell stepped over
    time.  Returns (out ``[B, S, D]``, the state after the last position
    | None)."""
    b, s, d = x.shape
    hh, dh = cfg.n_heads, d // cfg.n_heads
    sites = as_binding(sites)
    wx = dense(p["w_gates"], x, sites("gates_in")).to(torch.float32).reshape(b, s, 4, hh, dh)
    state = slstm_state_init(cfg, b, x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(p, wx[:, t], state)
        hs.append(state.h)
    hseq = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return _slstm_ffn(p, hseq, cfg, sites), (state if return_state else None)


def slstm_decode(p, x: torch.Tensor, state: SLSTMState, cfg: ArchConfig,
                 sites: Union[ComputeConfig, SiteBinding] = EXACT
                 ) -> Tuple[torch.Tensor, SLSTMState]:
    """One step per slot (``x [B, 1, D]``)."""
    b, _, d = x.shape
    hh, dh = cfg.n_heads, d // cfg.n_heads
    sites = as_binding(sites)
    wx = dense(p["w_gates"], x, sites("gates_in")).to(torch.float32).reshape(b, 4, hh, dh)
    state = _slstm_cell(p, wx, state)
    hseq = state.h.reshape(b, 1, d).to(x.dtype)
    return _slstm_ffn(p, hseq, cfg, sites), state
