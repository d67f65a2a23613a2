"""The decoder stack for pure global-attention configs, unrolled.

Port of ``repro.models.transformer``.  The reference stacks each pattern
slot's parameters under a unit axis and runs ``lax.scan`` over units; the
port keeps one parameter dict per layer (``params["layers"]``) and loops
over them in Python.  Site groups stay the reference's — a pattern slot's
GEMM sites resolve together across its units — so a plan means the same
thing in both packages.

Parameters: ``{"embedding": {"table"}, "head": {"w"} | {}, "final_norm",
"layers": [{"pre_norm", "core": {"wq","wk","wv","wo"}, "post_norm",
"mlp": {"up","gate","down"}}, ...]}``, float32 masters.  Serving state:
``{"layers": [PagedKVCache, ...]}`` — one block pool per layer.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.astra_layer import ComputeConfig, quantize_weight_t
from repro_torch.core.plan import ExecutionPlan, SiteBinding
from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    embed_tokens, embedding_init, head_apply, head_init, mlp_apply, mlp_init,
    norm_apply, norm_init,
)


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Execution options.  ``plan`` is an :class:`ExecutionPlan` or any
    ``from_spec`` form (preset name, mode string, JSON rules, dict).
    ``attn_impl``: ``naive`` = plain attention over the gathered view;
    ``flash`` = the paged-attention kernel on decode and suffix prefill.
    ``kv_quant``: only ``none`` in this slice."""

    plan: Optional[Union[ExecutionPlan, str, dict, ComputeConfig]] = None
    attn_impl: str = "naive"
    kv_quant: str = "none"

    ATTN_IMPLS = ("naive", "flash")
    KV_QUANTS = ("none", "int8")

    def __post_init__(self):
        if self.attn_impl not in self.ATTN_IMPLS:
            raise ValueError(f"attn_impl={self.attn_impl!r} unknown; valid: "
                             f"{', '.join(self.ATTN_IMPLS)}")
        if self.kv_quant not in self.KV_QUANTS:
            raise ValueError(f"kv_quant={self.kv_quant!r} unknown; valid: "
                             f"{', '.join(self.KV_QUANTS)}")
        if self.kv_quant != "none":
            raise NotImplementedError("kv_quant='int8' is not ported yet (ROADMAP "
                                      "queue 1: calibration with kv_quant)")
        plan = self.plan
        if plan is None:
            plan = ExecutionPlan.from_spec("exact")
        elif not isinstance(plan, ExecutionPlan):
            plan = ExecutionPlan.from_spec(plan)
        object.__setattr__(self, "plan", plan)


def _has_mlp(cfg: ArchConfig, kind: str) -> bool:
    return kind in ("attn", "local", "xattn", "rglru") and (cfg.d_ff > 0 or cfg.moe is not None)


def _check_supported(cfg: ArchConfig) -> None:
    if any(k != "attn" for k in cfg.layer_kinds) or cfg.moe is not None or cfg.n_codebooks:
        raise NotImplementedError(
            f"{cfg.name}: only dense global-attention stacks are ported yet "
            "(ROADMAP queue 1: other block kinds)")


def layer_group(cfg: ArchConfig, li: int) -> Tuple[int, ...]:
    """The layers whose sites resolve with layer ``li``'s: every unit of
    its pattern slot (the reference's scanned group), or ``li`` alone for
    a remainder layer."""
    p = len(cfg.block_pattern)
    n_units = cfg.n_pattern_units
    if li < n_units * p:
        si = li % p
        return tuple(u * p + si for u in range(n_units))
    return (li,)


@functools.lru_cache(maxsize=64)
def _layer_sites(plan: ExecutionPlan, cfg: ArchConfig) -> Tuple[SiteBinding, ...]:
    return tuple(plan.binding(kind, layer_group(cfg, li))
                 for li, kind in enumerate(cfg.layer_kinds))


# ------------------------------------------------------------------ params
def block_init(gen: torch.Generator, cfg: ArchConfig, kind: str, device=None):
    p: Dict[str, Any] = {"pre_norm": norm_init(cfg.d_model, cfg.norm, device),
                         "core": attn.attn_init(gen, cfg, device)}
    if _has_mlp(cfg, kind):
        p["post_norm"] = norm_init(cfg.d_model, cfg.norm, device)
        p["mlp"] = mlp_init(gen, cfg, device)
    return p


def init_params(cfg: ArchConfig, seed: int, device) -> Dict[str, Any]:
    """Random float32 parameters drawn from a seeded ``torch.Generator`` on
    ``device`` (the reference's shapes and scales; not its draws)."""
    _check_supported(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {
        "embedding": embedding_init(gen, cfg, dev),
        "head": head_init(gen, cfg, dev),
        "final_norm": norm_init(cfg.d_model, cfg.norm, dev),
        "layers": [block_init(gen, cfg, kind, dev) for kind in cfg.layer_kinds],
    }


def prepare_params(params: Dict[str, Any], cfg: ArchConfig,
                   plan: ExecutionPlan) -> Dict[str, Any]:
    """Params with per-weight caches for ``plan``: int8 codes (``wq_t``) for
    sites that resolve to int8 — exactly the codes ``quantize(w, axis=0)``
    gives each call — and a model-dtype copy (``wc``) for exact sites of a
    bf16 model.  Leaves are shared with ``params``; nothing is mutated."""
    dt = torch_dtype(cfg.dtype)

    def cached(p: Dict[str, torch.Tensor], site_group: Tuple[str, ...], w_key="w"):
        mode = plan.resolve_group(site_group).mode
        w = p[w_key] if w_key == "w" else p[w_key].t()
        extra = {}
        if mode == "int8":
            extra["wq_t"] = quantize_weight_t(w)
        elif mode == "exact" and dt != torch.float32:
            extra["wc"] = w.to(dt)
        return extra

    layers = []
    for li, blk in enumerate(params["layers"]):
        grp = layer_group(cfg, li)

        def sites(op):
            return tuple(f"L{l}.attn.{op}" for l in grp)

        core = {name: {**blk["core"][name], **cached(blk["core"][name], sites(op))}
                for name, op in (("wq", "q_proj"), ("wk", "kv_proj"), ("wv", "kv_proj"),
                                 ("wo", "o_proj"))}
        new = {**blk, "core": core}
        if "mlp" in blk:
            new["mlp"] = {name: {**d, **cached(d, sites("down" if name == "down" else "up"))}
                          for name, d in blk["mlp"].items()}
        layers.append(new)
    out = {**params, "layers": layers}
    if cfg.tie_embeddings:
        extra = cached(params["embedding"], ("lm_head",), w_key="table")
        out["embedding"] = {**params["embedding"],
                            **{f"head_{k}": v for k, v in extra.items()}}
    else:
        out["head"] = {**params["head"], **cached(params["head"], ("lm_head",))}
    return out


# ------------------------------------------------------------------ blocks
def _mlp(p, x, cfg, sites):
    if "mlp" not in p:
        return x
    h2 = norm_apply(p["post_norm"], x, cfg.norm, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], h2, cfg, sites)


def _head(params, x, cfg, opts):
    x = norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return head_apply(params["head"], params["embedding"], x, cfg, opts.plan.site("lm_head"))


def forward(params, tokens: torch.Tensor, cfg: ArchConfig, opts: ModelOptions,
            return_states: bool = False, max_len: Optional[int] = None):
    """Full-sequence pass.  Returns (logits [B, S, V], dense per-layer
    KVCache list | None)."""
    _check_supported(cfg)
    x = embed_tokens(params["embedding"], tokens, cfg)
    states: List[attn.KVCache] = []
    for p, sites in zip(params["layers"], _layer_sites(opts.plan, cfg)):
        h = norm_apply(p["pre_norm"], x, cfg.norm, cfg.norm_eps)
        out, cache = attn.attn_seq(p["core"], h, cfg, sites=sites,
                                   use_flash=(opts.attn_impl == "flash"),
                                   return_cache=return_states, max_len=max_len)
        x = _mlp(p, x + out, cfg, sites)
        states.append(cache)
    return _head(params, x, cfg, opts), (states if return_states else None)


def decode_step(params, token: torch.Tensor, states, pos: torch.Tensor, cfg: ArchConfig,
                opts: ModelOptions, block_tables: Optional[attn.BlockTables] = None):
    """One serving step: token [B, 1] at per-slot positions ``pos [B]``
    against the paged pools.  Returns (logits [B, 1, V], states)."""
    x = embed_tokens(params["embedding"], token, cfg)
    use_kernel = opts.attn_impl == "flash"
    new_layers = []
    for p, st, sites in zip(params["layers"], states["layers"], _layer_sites(opts.plan, cfg)):
        h = norm_apply(p["pre_norm"], x, cfg.norm, cfg.norm_eps)
        out, st = attn.attn_decode(p["core"], h, st, pos, cfg, sites=sites,
                                   tables=block_tables, use_kernel=use_kernel)
        x = _mlp(p, x + out, cfg, sites)
        new_layers.append(st)
    return _head(params, x, cfg, opts), {**states, "layers": new_layers}


def suffix_forward(params, tokens: torch.Tensor, cfg: ArchConfig, opts: ModelOptions,
                   states, table: torch.Tensor, start: torch.Tensor, ctx_blocks: int):
    """Prefix-aware packed prefill: the unmatched suffixes (``tokens
    [B, S_suf]``, right-padded) in one pass against prefix KV resident in
    the pool, writing the suffix KV into each slot's blocks; a cold
    request is ``start == 0``.  Returns (logits [B, S_suf, V], states)."""
    if any(k != "attn" for k in cfg.layer_kinds):
        raise ValueError(
            f"suffix_forward needs a pure global-attention stack, got "
            f"{set(cfg.layer_kinds)}; recurrent/windowed/cross states cannot "
            "be reconstructed from paged prefix blocks")
    x = embed_tokens(params["embedding"], tokens, cfg)
    use_kernel = opts.attn_impl == "flash"
    new_layers = []
    for p, st, sites in zip(params["layers"], states["layers"], _layer_sites(opts.plan, cfg)):
        h = norm_apply(p["pre_norm"], x, cfg.norm, cfg.norm_eps)
        out, st = attn.attn_prefill_paged(p["core"], h, st, table, start, cfg, sites=sites,
                                          ctx_blocks=ctx_blocks, use_kernel=use_kernel)
        x = _mlp(p, x + out, cfg, sites)
        new_layers.append(st)
    return _head(params, x, cfg, opts), {**states, "layers": new_layers}


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      paged: Optional[Tuple[int, int]] = None, device=None):
    """Zeroed serving state: ``paged = (n_blocks, block_size)`` gives one
    block pool per layer (no batch axis: block tables carry slot
    identity).  The dense per-slot layout arrives with its own slice."""
    _check_supported(cfg)
    if paged is None:
        raise NotImplementedError("the dense per-slot KV layout is not ported yet "
                                  "(ROADMAP queue 1: dense layout); pass paged=")
    n_blocks, block_size = paged
    return {"layers": [attn.init_paged_cache(cfg, n_blocks, block_size, device)
                       for _ in cfg.layer_kinds]}
