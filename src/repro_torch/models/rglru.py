"""Griffin / RecurrentGemma recurrent block (RG-LRU + temporal conv).

Port of ``repro.models.rglru``.  Block structure (arXiv:2402.19427):

    x -> linear (d -> 2r): [branch, gate]
    branch -> causal conv1d (width ``conv_width``) -> RG-LRU -> * gelu(gate)
           -> linear (r -> d)

RG-LRU recurrence, per channel, gates in float32:

    r_t = sigmoid(W_a y_t + b_a)              (recurrence gate)
    i_t = sigmoid(W_x y_t + b_x)              (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)    c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

The full-sequence path runs the recurrence through ``kernels.rglru_scan``
(the hand-written CUDA kernel on the card, its plain loop on the CPU);
decode carries ``RGLRUState`` (the last ``h`` and the last
``conv_width - 1`` pre-conv inputs) and takes one step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.astra_layer import ComputeConfig, EXACT
from repro_torch.core.plan import SiteBinding, as_binding
from repro_torch.models.layers import dense, dense_init

C_LRU = 8.0


class RGLRUState(NamedTuple):
    h: torch.Tensor  # [B, r] float32
    conv: torch.Tensor  # [B, conv_width - 1, r] float32: trailing pre-conv inputs


def rglru_init(gen: torch.Generator, cfg: ArchConfig, device=None):
    """Random float32 parameters (the reference's shapes and scales, and
    its Griffin init of ``lam``: a^c in [0.9, 0.999] at r_t = 1)."""
    r = cfg.d_rnn
    grid = torch.linspace(0.9, 0.999, r, dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(gen, cfg.d_model, 2 * r, device=device),
        "conv_w": torch.randn(cfg.conv_width, r, generator=gen, device=device) * 0.1,
        "conv_b": torch.zeros(r, device=device),
        "w_a": dense_init(gen, r, r, bias=True, device=device),
        "w_x": dense_init(gen, r, r, bias=True, device=device),
        "lam": torch.log(torch.expm1(-torch.log(grid) / C_LRU)),
        "w_out": dense_init(gen, r, cfg.d_model, device=device),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def _gates(p, y: torch.Tensor, sites: SiteBinding) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, scaled input) in float32: a = decay in (0, 1), the input is
    ``sqrt(max(1 - a^2, 1e-12)) * i_t * y``."""
    rt = torch.sigmoid(dense(p["w_a"], y, sites("gates")).to(torch.float32))
    it = torch.sigmoid(dense(p["w_x"], y, sites("gates")).to(torch.float32))
    softplus = torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))  # jax.nn.softplus
    log_a = -C_LRU * softplus * rt  # [B, S, r], < 0
    a = torch.exp(log_a)
    scale = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, scale * it * y.to(torch.float32)


def _conv_seq(p, y: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Causal depthwise conv1d over ``y [B, S, r]`` (left zero padding),
    plus ``conv_b``; float32 (the float32 weights promote it)."""
    w = p["conv_w"]  # [cw, r]
    cw = cfg.conv_width
    s = y.shape[1]
    pads = F.pad(y, (0, 0, cw - 1, 0)).to(torch.float32)
    out = 0
    for i in range(cw):  # the reference's summation order
        out = out + pads[:, i:i + s, :] * w[i]
    return out + p["conv_b"]


def rglru_seq(p, x: torch.Tensor, cfg: ArchConfig,
              sites: Union[ComputeConfig, SiteBinding] = EXACT,
              return_state: bool = False) -> Tuple[torch.Tensor, Optional[RGLRUState]]:
    """Full-sequence block over ``x [B, S, D]``.  Returns (out [B, S, D],
    ``RGLRUState`` after the last position | None)."""
    from repro_torch.kernels.rglru_scan import rglru_scan

    r = cfg.d_rnn
    sites = as_binding(sites)
    xz = dense(p["w_in"], x, sites("in_proj"))
    y, gate = xz[..., :r], xz[..., r:]
    a, bx = _gates(p, _conv_seq(p, y, cfg), sites)
    h = rglru_scan(a, bx)
    out = dense(p["w_out"], h.to(x.dtype) * gelu(gate), sites("out_proj"))
    state = None
    if return_state:
        cw, s = cfg.conv_width, x.shape[1]
        # the conv history holds the last cw - 1 *pre-conv* inputs,
        # left-padded with zeros when the prompt is shorter
        tail = F.pad(y, (0, 0, max(cw - 1 - s, 0), 0))[:, -(cw - 1):]
        state = RGLRUState(h[:, -1].to(torch.float32), tail.to(torch.float32))
    return out, state


def rglru_decode(p, x: torch.Tensor, state: RGLRUState, cfg: ArchConfig,
                 sites: Union[ComputeConfig, SiteBinding] = EXACT
                 ) -> Tuple[torch.Tensor, RGLRUState]:
    """One step per slot (``x [B, 1, D]``) from ``state``.  Returns (out
    [B, 1, D], the next state)."""
    r = cfg.d_rnn
    sites = as_binding(sites)
    xz = dense(p["w_in"], x, sites("in_proj"))
    y_new, gate = xz[..., :r], xz[..., r:]
    hist = torch.cat([state.conv, y_new.to(torch.float32)], dim=1)  # [B, cw, r]
    y = torch.einsum("bcr,cr->br", hist, p["conv_w"])[:, None, :] + p["conv_b"]
    a, bx = _gates(p, y.to(x.dtype), sites)
    h = a[:, 0] * state.h + bx[:, 0]
    out = dense(p["w_out"], h[:, None, :].to(x.dtype) * gelu(gate), sites("out_proj"))
    return out, RGLRUState(h, hist[:, 1:])
