"""The decoder stack, unrolled: global (``attn``) and sliding-window
(``local``) attention blocks and RG-LRU (``rglru``) recurrent blocks.

Port of ``repro.models.transformer``.  The reference stacks each pattern
slot's parameters under a unit axis and runs ``lax.scan`` over units; the
port keeps one parameter dict per layer (``params["layers"]``) and loops
over them in Python.  Site groups stay the reference's — a pattern slot's
GEMM sites resolve together across its units — so a plan means the same
thing in both packages.

Parameters: ``{"embedding": {"table"}, "head": {"w"} | {}, "final_norm",
"layers": [{"pre_norm", "core", "post_norm", "mlp": {"up","gate","down"}},
...]}``, float32 masters; an attention core is ``{"wq","wk","wv","wo"}``,
an RG-LRU core ``{"w_in","conv_w","conv_b","w_a","w_x","lam","w_out"}``.
Serving state: ``{"layers": [...]}`` with one entry per layer — a dense
per-slot ``KVCache`` in the model dtype (a ``window``-sized ring for a
local layer) or an ``RGLRUState`` — or, for pure global-attention stacks
only, one ``PagedKVCache | QuantPagedKVCache`` block pool per layer, int8
under ``kv_quant="int8"``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.astra_layer import ComputeConfig, quantize_weight_t, sc_weight_t
from repro_torch.core.plan import ExecutionPlan, SiteBinding
from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import rglru as rglru_mod
from repro_torch.models.layers import (
    embed_tokens, embedding_init, head_apply, head_init, mlp_apply, mlp_init,
    norm_apply, norm_init,
)


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Execution options.  ``plan`` is an :class:`ExecutionPlan` or any
    ``from_spec`` form (preset name, mode string, JSON rules, dict).
    ``attn_impl``: ``naive`` = plain attention (over the gathered view
    on the paged layout); ``flash`` = the kernels: flash attention on the
    full-sequence pass, the paged or dense decode kernel on decode, the
    paged kernel on suffix prefill.  ``kv_quant``: ``int8`` stores the
    paged pools as int8 against the plan's calibrated per-KV-head scales."""

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
        plan = self.plan
        if plan is None:
            plan = ExecutionPlan.from_spec("exact")
        elif not isinstance(plan, ExecutionPlan):
            plan = ExecutionPlan.from_spec(plan)
        object.__setattr__(self, "plan", plan)


def _has_mlp(cfg: ArchConfig, kind: str) -> bool:
    return kind in ("attn", "local", "xattn", "rglru") and (cfg.d_ff > 0 or cfg.moe is not None)


PORTED_KINDS = ("attn", "local", "rglru")


def _check_supported(cfg: ArchConfig) -> None:
    if (any(k not in PORTED_KINDS for k in cfg.layer_kinds) or cfg.moe is not None
            or cfg.n_codebooks):
        raise NotImplementedError(
            f"{cfg.name}: only dense stacks of {'/'.join(PORTED_KINDS)} blocks are ported "
            "yet (ROADMAP queue 1: other block kinds)")


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


def _layer_sites(plan: ExecutionPlan, cfg: ArchConfig) -> Tuple[SiteBinding, ...]:
    if plan._observer is not None:  # an observing plan never enters a cache
        return _layer_sites_uncached(plan, cfg)
    return _layer_sites_cached(plan, cfg)


def _layer_sites_uncached(plan: ExecutionPlan, cfg: ArchConfig) -> Tuple[SiteBinding, ...]:
    return tuple(plan.binding(kind, layer_group(cfg, li))
                 for li, kind in enumerate(cfg.layer_kinds))


_layer_sites_cached = functools.lru_cache(maxsize=64)(_layer_sites_uncached)


# ------------------------------------------------------------------ params
def block_init(gen: torch.Generator, cfg: ArchConfig, kind: str, device=None):
    core = (rglru_mod.rglru_init(gen, cfg, device) if kind == "rglru"
            else attn.attn_init(gen, cfg, device))
    p: Dict[str, Any] = {"pre_norm": norm_init(cfg.d_model, cfg.norm, device), "core": core}
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
    gives each call — the same codes tagged with the site's ``w_gen``
    (``wsc_t``; the stochastic kernel expands them to streams as it stages
    them, so no stream is stored) for sites that resolve to sc, and a
    model-dtype copy (``wc``) for exact sites of a bf16 model.  Leaves are
    shared with ``params``; nothing is mutated."""
    dt = torch_dtype(cfg.dtype)

    def cached(p: Dict[str, torch.Tensor], site_group: Tuple[str, ...], w_key="w"):
        cc = plan.resolve_group(site_group)
        w = p[w_key] if w_key == "w" else p[w_key].t()
        extra = {}
        if cc.mode == "int8":
            extra["wq_t"] = quantize_weight_t(w)
        elif cc.mode == "sc":
            extra["wsc_t"] = sc_weight_t(w, cc.w_gen)
        elif dt != torch.float32:
            extra["wc"] = w.to(dt)
        return extra

    layers = []
    for li, (blk, kind) in enumerate(zip(params["layers"], cfg.layer_kinds)):
        grp = layer_group(cfg, li)

        def sites(op):
            return tuple(f"L{l}.{kind}.{op}" for l in grp)

        core = dict(blk["core"])  # conv_w, conv_b, lam pass through
        core.update({name: {**blk["core"][name], **cached(blk["core"][name], sites(op))}
                     for name, op in _CORE_GEMMS[kind]})
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


# the GEMM weights of a block's core, with the site each resolves under
_ATTN_GEMMS = (("wq", "q_proj"), ("wk", "kv_proj"), ("wv", "kv_proj"), ("wo", "o_proj"))
_CORE_GEMMS = {"attn": _ATTN_GEMMS, "local": _ATTN_GEMMS,
               "rglru": (("w_in", "in_proj"), ("w_a", "gates"), ("w_x", "gates"),
                         ("w_out", "out_proj"))}


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
    """Full-sequence pass.  Returns (logits [B, S, V], per-layer serving
    states | None: dense ``KVCache``s and ``RGLRUState``s)."""
    _check_supported(cfg)
    x = embed_tokens(params["embedding"], tokens, cfg)
    states: List[Any] = []
    for p, kind, sites in zip(params["layers"], cfg.layer_kinds, _layer_sites(opts.plan, cfg)):
        h = norm_apply(p["pre_norm"], x, cfg.norm, cfg.norm_eps)
        if kind == "rglru":
            out, st = rglru_mod.rglru_seq(p["core"], h, cfg, sites, return_state=return_states)
        else:
            out, st = attn.attn_seq(p["core"], h, cfg, kind=kind, sites=sites,
                                    use_flash=(opts.attn_impl == "flash"),
                                    return_cache=return_states, max_len=max_len)
        x = _mlp(p, x + out, cfg, sites)
        states.append(st)
    return _head(params, x, cfg, opts), (states if return_states else None)


def decode_step(params, token: torch.Tensor, states, pos: torch.Tensor, cfg: ArchConfig,
                opts: ModelOptions, block_tables: Optional[attn.BlockTables] = None,
                write: Optional[torch.Tensor] = None):
    """One serving step: token [B, 1] at per-slot positions ``pos [B]`` (or
    one position for all) against the dense states or, with
    ``block_tables``, the paged pools.  ``write [B]`` bool: the slots
    whose in-place dense cache writes are kept (None = all); the others
    attend with their new entry, which is then put back as it was.
    Recurrent states are returned new, never written in place.
    Returns (logits [B, 1, V], states)."""
    glob = next((st for st, kind in zip(states["layers"], cfg.layer_kinds)
                 if kind == "attn" and isinstance(st, attn.KVCache)), None)
    if glob is not None:
        # a kept write past the cache would be clamped onto the last
        # position: check the kept rows once for every global layer, on the
        # device (no sync); gated rows are clamped and put back (attention),
        # local rings wrap and recurrent states have no positions
        past = torch.as_tensor(pos, device=glob.k.device) >= glob.k.shape[2]
        if write is not None:
            past = past & write.to(past.device)
        torch._assert_async(~past.any(),
                            "decode position past the dense cache (pos >= S_cache)")
    x = embed_tokens(params["embedding"], token, cfg)
    use_kernel = opts.attn_impl == "flash"
    new_layers = []
    for p, st, kind, sites in zip(params["layers"], states["layers"], cfg.layer_kinds,
                                  _layer_sites(opts.plan, cfg)):
        h = norm_apply(p["pre_norm"], x, cfg.norm, cfg.norm_eps)
        if kind == "rglru":
            out, st = rglru_mod.rglru_decode(p["core"], h, st, cfg, sites)
        else:
            out, st = attn.attn_decode(p["core"], h, st, pos, cfg, kind=kind, sites=sites,
                                       tables=block_tables, use_kernel=use_kernel,
                                       write=write)
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


PAGED_STATEFUL_REASON = (
    "the paged KV layout (kv_block_size > 0) serves pure global-attention stacks only: "
    "local rings and recurrent states in the pool are not ported yet (ROADMAP queue 1: "
    "paged stateful stacks); serve this stack with kv_block_size=0")


def _dense_state(cfg: ArchConfig, kind: str, batch: int, max_len: int, device):
    if kind == "rglru":
        return rglru_mod.RGLRUState(
            torch.zeros((batch, cfg.d_rnn), dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn), dtype=torch.float32,
                        device=device))
    return attn.init_cache(cfg, batch, max_len, device, kind=kind)


DENSE_KV_QUANT_REASON = ("kv_quant='int8' requires the paged KV layout (kv_block_size > 0): "
                         "dense per-slot caches stay in the model dtype")


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      paged: Optional[Tuple[int, int]] = None, device=None,
                      kv_quant: str = "none", plan: Optional[ExecutionPlan] = None):
    """Zeroed serving state.  Without ``paged``: per layer, one dense
    ``[batch, n_kv, max_len, hd]`` cache in the model dtype (a local
    layer's ring clamped to ``min(max_len, window)``) or an ``RGLRUState``
    (``h [batch, d_rnn]``, ``conv [batch, conv_width - 1, d_rnn]``, both
    float32).  ``paged = (n_blocks, block_size)`` gives one block pool per
    layer of a pure global-attention stack instead (no batch axis: block
    tables carry slot identity); ``kv_quant="int8"`` makes each pool int8
    with the per-head scales ``plan.kv_group_scale`` gives over the
    layer's group (the reference's one pool per scanned group).  Dense
    caches stay in the model dtype: with ``kv_quant="int8"`` they are
    refused, with the serving engine's reason."""
    _check_supported(cfg)
    if paged is None:
        if kv_quant != "none":
            raise ValueError(DENSE_KV_QUANT_REASON)
        return {"layers": [_dense_state(cfg, kind, batch, max_len, device)
                           for kind in cfg.layer_kinds]}
    if any(k != "attn" for k in cfg.layer_kinds):
        raise NotImplementedError(PAGED_STATEFUL_REASON)
    n_blocks, block_size = paged
    if kv_quant == "none":
        return {"layers": [attn.init_paged_cache(cfg, n_blocks, block_size, device)
                           for _ in cfg.layer_kinds]}
    if plan is None:
        raise ValueError("kv_quant='int8' needs a calibrated plan")
    layers = []
    for li in range(cfg.n_layers):
        grp = layer_group(cfg, li)
        k_scale = plan.kv_group_scale(tuple(f"L{l}.kv.k" for l in grp))
        v_scale = plan.kv_group_scale(tuple(f"L{l}.kv.v" for l in grp))
        layers.append(attn.init_paged_quant_cache(cfg, n_blocks, block_size, k_scale,
                                                  v_scale, device))
    return {"layers": layers}
