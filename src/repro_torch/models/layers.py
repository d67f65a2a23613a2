"""Shared neural building blocks (port of ``repro.models.layers``).

Plain functions on tensors with parameters in nested dicts.  Every GEMM
goes through :func:`dense` -> ``core.astra_matmul`` so the execution plan
decides its mode per site.  A dense parameter dict holds the float32
master ``w`` (``[d_in, d_out]``) and optional ``b``; ``prepare`` in
``models.transformer`` may add ``wq_t`` (cached int8 codes), ``wsc_t``
(the same codes tagged with the generator of their streams) and ``wc`` (a cast copy in the model dtype), which
:func:`dense` passes along.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.astra_layer import BoundSite, ComputeConfig, EXACT, astra_matmul
from repro_torch.core.plan import SiteBinding, as_binding
from repro_torch.device import torch_dtype

SiteOrCC = Union[ComputeConfig, BoundSite]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, bias: bool = False,
               device=None, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": torch.randn(d_in, d_out, generator=gen, device=device) * scale}
    if bias:
        p["b"] = torch.zeros(d_out, device=device)
    return p


def dense(p, x: torch.Tensor, cc: SiteOrCC = EXACT) -> torch.Tensor:
    y = astra_matmul(x, p["w"], cc, wq_t=p.get("wq_t"), wsc_t=p.get("wsc_t"), wc=p.get("wc"))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def norm_init(d: int, kind: str, device=None):
    p = {"scale": torch.ones(d, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, device=device)
    return p


def norm_apply(p, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    """RMSNorm or LayerNorm computed in float32, cast back to ``x.dtype``."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y.to(x.dtype)


# ----------------------------------------------------------------- RoPE
@functools.lru_cache(maxsize=64)
def rope_freqs(head_dim: int, pct: float, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies of the rotary channel pairs (cached per device:
    decode asks for them in every layer of every step)."""
    rot_dim = int(head_dim * pct) // 2 * 2
    return 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                         device=device) / rot_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, pct: float,
               theta: float) -> torch.Tensor:
    """x [B, H, S, D], positions [B, S] (absolute).  Rotates *interleaved*
    pairs (``0::2`` with ``1::2``) over the first ``rot_dim`` channels."""
    d = x.shape[-1]
    freqs = rope_freqs(d, pct, theta, x.device)
    rot = freqs.shape[0] * 2
    angles = positions[:, None, :, None].to(torch.float32) * freqs  # [B,1,S,rot/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([y, x_pass], dim=-1) if rot < d else y


# ----------------------------------------------------------------- MLP
def mlp_init(gen: torch.Generator, cfg: ArchConfig, device=None):
    p = {"up": dense_init(gen, cfg.d_model, cfg.d_ff, device=device),
         "down": dense_init(gen, cfg.d_ff, cfg.d_model, device=device)}
    if cfg.act in ("swiglu", "geglu"):
        p["gate"] = dense_init(gen, cfg.d_model, cfg.d_ff, device=device)
    return p


def mlp_apply(p, x: torch.Tensor, cfg: ArchConfig,
              sites: Union[ComputeConfig, SiteBinding] = EXACT) -> torch.Tensor:
    sites = as_binding(sites)
    # the gate GEMM shares the "up" site (the simulator's fused up op)
    up = dense(p["up"], x, sites("up"))
    if "gate" in p:
        g = dense(p["gate"], x, sites("up"))
        act = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(up, approximate="tanh")
    return dense(p["down"], h, sites("down"))


# ----------------------------------------------------------------- embeddings
def embedding_init(gen: torch.Generator, cfg: ArchConfig, device=None):
    if cfg.n_codebooks:
        raise NotImplementedError("multi-codebook embeddings are not ported yet "
                                  "(ROADMAP queue 1: other block kinds)")
    return {"table": torch.randn(cfg.vocab, cfg.d_model, generator=gen, device=device) * 0.02}


def embed_tokens(p, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """tokens [B, S] -> [B, S, D] in the model dtype."""
    return p["table"][tokens.long()].to(torch_dtype(cfg.dtype))


def head_init(gen: torch.Generator, cfg: ArchConfig, device=None):
    if cfg.tie_embeddings:
        return {}
    w = torch.randn(cfg.d_model, cfg.vocab, generator=gen, device=device) / math.sqrt(cfg.d_model)
    return {"w": w}


def head_apply(p, emb_p, x: torch.Tensor, cfg: ArchConfig, cc: SiteOrCC = EXACT) -> torch.Tensor:
    """x [B, S, D] -> float32 logits [B, S, V]; tied heads use the
    embedding table transposed (its cached codes live beside it)."""
    if cfg.tie_embeddings:
        return astra_matmul(x, emb_p["table"].t(), cc, wq_t=emb_p.get("head_wq_t"),
                            wsc_t=emb_p.get("head_wsc_t"),
                            wc=emb_p.get("head_wc")).to(torch.float32)
    return astra_matmul(x, p["w"], cc, wq_t=p.get("wq_t"), wsc_t=p.get("wsc_t"),
                        wc=p.get("wc")).to(torch.float32)
