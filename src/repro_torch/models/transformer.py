"""The decoder stack, unrolled: global (``attn``), sliding-window
(``local``) and cross-attention (``xattn``) blocks, RG-LRU (``rglru``)
recurrent blocks and the xLSTM blocks (``mlstm``, ``slstm``), each
attention or RG-LRU block followed by a dense MLP or a mixture of experts
(``cfg.moe``).  A multi-codebook model (``cfg.n_codebooks = C``) takes
``[B, C, S]`` token grids, sums its C embeddings and gives ``[B, S, C,
V]`` logits from C heads.

Port of ``repro.models.transformer``.  The reference stacks each pattern
slot's parameters under a unit axis and runs ``lax.scan`` over units; the
port keeps one parameter dict per layer (``params["layers"]``) and loops
over them in Python.  Site groups stay the reference's — a pattern slot's
GEMM sites resolve together across its units — so a plan means the same
thing in both packages.

Parameters: ``{"embedding": {"table"}, "head": {"w"} | {}, "final_norm",
"layers": [{"pre_norm", "core", "post_norm", "mlp"}, ...]}``, float32
masters (``table [V, D]`` or ``[C, V, D]``, ``w [D, V]`` or ``[C, D,
V]``); an attention core (cross-attention's too) is
``{"wq","wk","wv","wo"}``, an RG-LRU core
``{"w_in","conv_w","conv_b","w_a","w_x","lam","w_out"}``, the xLSTM cores
those of ``models.xlstm``; a dense MLP is ``{"up","gate","down"}``, a
MoE ``{"router","w_up","w_gate","w_down"}`` (``models.moe``); an xLSTM
block has no MLP.  Serving state: ``{"layers": [...]}`` with one entry
per layer — a dense per-slot ``KVCache`` in the model dtype (a
``window``-sized ring for a local layer) or a slot-indexed recurrent
state (``RGLRUState``, ``MLSTMState``, ``SLSTMState``, float32) — or, on
the paged layout, one ``PagedKVCache | QuantPagedKVCache`` block pool
per ``attn``/``local`` layer (int8 under ``kv_quant="int8"``) beside the
recurrent states and the ``xattn`` layers' cross caches (``KVCache [B,
n_kv, vision_tokens, hd]``), still by slot.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_util
from repro_torch.configs.base import ArchConfig
from repro_torch.core.astra_layer import (
    ComputeConfig, batched_sc_weight_t, batched_weight_t, quantize_weight_t, sc_weight_t,
)
from repro_torch.core.plan import ExecutionPlan, SiteBinding
from repro_torch.device import torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
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
    paged pools as int8 against the plan's calibrated per-KV-head scales.
    ``capacity_factor``: a MoE layer's expert capacity on the sequence
    paths (decode is always drop-free; the serving prefills raise it to
    ``n_experts``, drop-free too).  ``remat``: a full-sequence pass that
    autograd records runs each pattern period (the reference's scanned
    unit) under activation checkpointing.  ``z_loss``: the weight of
    ``Model.loss``'s log-partition penalty."""

    plan: Optional[Union[ExecutionPlan, str, dict, ComputeConfig]] = None
    attn_impl: str = "naive"
    kv_quant: str = "none"
    capacity_factor: float = 1.25
    remat: bool = True
    z_loss: float = 1e-4

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


PORTED_KINDS = ("attn", "local", "xattn", "rglru", "mlstm", "slstm")
ATTN_KINDS = ("attn", "local", "xattn")  # the kinds that run attention kernels


def _check_supported(cfg: ArchConfig) -> None:
    if any(k not in PORTED_KINDS for k in cfg.layer_kinds):
        raise NotImplementedError(
            f"{cfg.name}: only stacks of {'/'.join(PORTED_KINDS)} blocks are ported "
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
_CORE_INIT = {"rglru": rglru_mod.rglru_init, "mlstm": xlstm_mod.mlstm_init,
              "slstm": xlstm_mod.slstm_init}


def block_init(gen: torch.Generator, cfg: ArchConfig, kind: str, device=None):
    core = _CORE_INIT.get(kind, attn.attn_init)(gen, cfg, device)
    p: Dict[str, Any] = {"pre_norm": norm_init(cfg.d_model, cfg.norm, device), "core": core}
    if _has_mlp(cfg, kind):
        p["post_norm"] = norm_init(cfg.d_model, cfg.norm, device)
        p["mlp"] = (moe_mod.moe_init(gen, cfg, device) if cfg.moe is not None
                    else mlp_init(gen, cfg, device))
    return p


def init_params(cfg: ArchConfig, seed: int, device) -> Dict[str, Any]:
    """Random float32 parameters drawn from a seeded ``torch.Generator`` on
    ``device`` (the reference's shapes and scales; not its draws).  On the
    meta device, which has no generator, the same tree of shapes and
    dtypes with nothing drawn."""
    _check_supported(cfg)
    dev = torch.device(device)
    gen = None
    if dev.type != "meta":
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

    def cached(p: Dict[str, torch.Tensor], site_group: Tuple[str, ...], w_key="w",
               cast=True):
        cc = plan.resolve_group(site_group)
        w = p[w_key] if w_key == "w" else p[w_key].t()
        extra = {}
        if cc.mode == "int8":
            extra["wq_t"] = quantize_weight_t(w)
        elif cc.mode == "sc":
            extra["wsc_t"] = sc_weight_t(w, cc.w_gen)
        elif dt != torch.float32 and cast:
            extra["wc"] = w.to(dt)
        return extra

    def expert_cached(w: torch.Tensor, site_group: Tuple[str, ...]):
        cc = plan.resolve_group(site_group)
        if cc.mode == "int8":
            return {"wq_t": batched_weight_t(w)}
        if cc.mode == "sc":
            return {"wsc_t": batched_sc_weight_t(w, cc.w_gen)}
        return {"wc": w.to(dt)} if dt != torch.float32 else {}

    def moe_cached(p: Dict[str, Any], sites) -> Dict[str, Any]:
        caches = {name: expert_cached(p[name], sites(op))
                  for name, op in moe_mod.EXPERT_WEIGHTS if name in p}
        return {**p, "router": {**p["router"], **cached(p["router"], sites("router"),
                                                         cast=False)},
                "caches": caches}

    layers = []
    for li, (blk, kind) in enumerate(zip(params["layers"], cfg.layer_kinds)):
        grp = layer_group(cfg, li)

        def sites(op):
            return tuple(f"L{l}.{kind}.{op}" for l in grp)

        core = dict(blk["core"])  # conv_w, conv_b, lam pass through
        core.update({name: {**blk["core"][name], **cached(blk["core"][name], sites(op))}
                     for name, op in _CORE_GEMMS[kind]})
        new = {**blk, "core": core}
        if "mlp" in blk and cfg.moe is not None:
            new["mlp"] = moe_cached(blk["mlp"], sites)
        elif "mlp" in blk:
            new["mlp"] = {name: {**d, **cached(d, sites("down" if name == "down" else "up"))}
                          for name, d in blk["mlp"].items()}
        layers.append(new)
    out = {**params, "layers": layers}
    head = params["head"]
    if cfg.tie_embeddings:
        extra = cached(params["embedding"], ("lm_head",), w_key="table")
        out["embedding"] = {**params["embedding"],
                            **{f"head_{k}": v for k, v in extra.items()}}
    elif cfg.n_codebooks:  # one entry per codebook head, in lists
        per = [cached({"w": w_c}, ("lm_head",)) for w_c in head["w"]]
        out["head"] = {**head, **{k: [e[k] for e in per] for k in per[0]}}
    else:
        out["head"] = {**head, **cached(head, ("lm_head",))}
    return out


# the GEMM weights of a block's core, with the site each resolves under
_ATTN_GEMMS = (("wq", "q_proj"), ("wk", "kv_proj"), ("wv", "kv_proj"), ("wo", "o_proj"))
_CORE_GEMMS = {"attn": _ATTN_GEMMS, "local": _ATTN_GEMMS, "xattn": _ATTN_GEMMS,
               "rglru": (("w_in", "in_proj"), ("w_a", "gates"), ("w_x", "gates"),
                         ("w_out", "out_proj")),
               "mlstm": (("w_up", "up_proj"), ("w_q", "qkv"), ("w_k", "qkv"), ("w_v", "qkv"),
                         ("w_if", "gates"), ("w_down", "down_proj")),
               "slstm": (("w_gates", "gates_in"), ("w_up", "up"), ("w_down", "down"))}


# ------------------------------------------------------------------ blocks
def _mlp_aux(p, x, cfg, sites, capacity_factor: float = 1.25, full_capacity: bool = False,
             dp=None):
    """The block's MLP or MoE with its residual, and the MoE's load-balance
    loss (None without a MoE; over every data-parallel rank's tokens with
    ``dp``)."""
    if "mlp" not in p:
        return x, None
    h2 = norm_apply(p["post_norm"], x, cfg.norm, cfg.norm_eps)
    if cfg.moe is not None:
        out, aux = moe_mod.moe_apply(p["mlp"], h2, cfg, sites, capacity_factor, full_capacity,
                                     dp=dp)
        return x + out, aux
    return x + mlp_apply(p["mlp"], h2, cfg, sites), None


def _mlp(p, x, cfg, sites, capacity_factor: float = 1.25, full_capacity: bool = False):
    """:func:`_mlp_aux` without the load-balance loss (the serving paths)."""
    return _mlp_aux(p, x, cfg, sites, capacity_factor, full_capacity)[0]


_CORE_SEQ = {"rglru": rglru_mod.rglru_seq, "mlstm": xlstm_mod.mlstm_seq,
             "slstm": xlstm_mod.slstm_seq}
_CORE_DECODE = {"rglru": rglru_mod.rglru_decode, "mlstm": xlstm_mod.mlstm_decode,
                "slstm": xlstm_mod.slstm_decode}


def _head(params, x, cfg, opts):
    x = norm_apply(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return head_apply(params["head"], params["embedding"], x, cfg, opts.plan.site("lm_head"))


def _block_seq(p, x, cfg, kind, sites, opts, vision_embeds, return_state, max_len, dp=None):
    """One block over the full sequence: (x, serving state | None, MoE aux
    | None)."""
    h = norm_apply(p["pre_norm"], x, cfg.norm, cfg.norm_eps)
    if kind in _CORE_SEQ:
        out, st = _CORE_SEQ[kind](p["core"], h, cfg, sites, return_state=return_state)
    else:
        out, st = attn.attn_seq(p["core"], h, cfg, kind=kind, sites=sites,
                                use_flash=(opts.attn_impl == "flash"),
                                kv_src=vision_embeds, return_cache=return_state,
                                max_len=max_len)
    x, aux = _mlp_aux(p, x + out, cfg, sites, opts.capacity_factor, dp=dp)
    return x, st, aux


def _records_grad(x: torch.Tensor, blocks) -> bool:
    """Whether autograd records a pass of ``blocks`` over ``x``."""
    return x.requires_grad or any(isinstance(t, torch.Tensor) and t.requires_grad
                                  for t in tree_util.leaves(blocks))


def forward_aux(params, tokens: torch.Tensor, cfg: ArchConfig, opts: ModelOptions,
                return_states: bool = False, max_len: Optional[int] = None,
                vision_embeds: Optional[torch.Tensor] = None, dp=None):
    """Full-sequence pass over ``tokens [B, S]`` (``[B, C, S]``
    multi-codebook).  Returns (logits [B, S, V] (``[B, S, C, V]``), the
    MoE layers' load-balance losses summed (a float32 scalar, 0 without a
    MoE), per-layer serving states | None: dense ``KVCache``s, the
    ``xattn`` layers' cross caches of ``vision_embeds [B, T, D]``'s K/V,
    and recurrent states).  A stack with ``xattn`` layers needs
    ``vision_embeds``.  A MoE layer runs at ``opts.capacity_factor``;
    with ``dp`` (``parallel.dp.DataParallel``) its load-balance loss is
    that of every data-parallel rank's tokens.

    With ``opts.remat``, while grad is enabled and the pass returns no
    states, each pattern period whose input or parameters require grad
    runs under ``torch.utils.checkpoint`` (non-reentrant): its activations
    are recomputed in the backward pass, as the reference's
    ``jax.checkpoint`` over its scanned unit does.  Remainder layers are
    not checkpointed, as in the reference."""
    _check_supported(cfg)
    x = embed_tokens(params["embedding"], tokens, cfg)
    layer_sites = _layer_sites(opts.plan, cfg)
    kinds = cfg.layer_kinds
    remat = opts.remat and not return_states and torch.is_grad_enabled()

    def run(lo: int, hi: int, x):
        aux, sts = None, []
        for li in range(lo, hi):
            x, st, a = _block_seq(params["layers"][li], x, cfg, kinds[li], layer_sites[li], opts,
                                  vision_embeds, return_states, max_len, dp)
            if a is not None:
                aux = a if aux is None else aux + a
            sts.append(st)
        return x, aux, sts

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    states: List[Any] = []
    period = len(cfg.block_pattern)
    n_unit = cfg.n_pattern_units * period
    bounds = [(lo, lo + period) for lo in range(0, n_unit, period)]
    bounds += [(li, li + 1) for li in range(n_unit, cfg.n_layers)]
    for lo, hi in bounds:
        if remat and lo < n_unit and _records_grad(x, params["layers"][lo:hi]):
            x, aux, sts = checkpoint(run, lo, hi, x, use_reentrant=False,
                                     preserve_rng_state=False)  # the blocks draw nothing
        else:
            x, aux, sts = run(lo, hi, x)
        if aux is not None:
            total = total + aux
        states += sts
    return _head(params, x, cfg, opts), total, (states if return_states else None)


def forward(params, tokens: torch.Tensor, cfg: ArchConfig, opts: ModelOptions,
            return_states: bool = False, max_len: Optional[int] = None,
            vision_embeds: Optional[torch.Tensor] = None):
    """:func:`forward_aux` without the load-balance loss: (logits,
    per-layer serving states | None)."""
    logits, _, states = forward_aux(params, tokens, cfg, opts, return_states, max_len,
                                    vision_embeds)
    return logits, states


def decode_step(params, token: torch.Tensor, states, pos: torch.Tensor, cfg: ArchConfig,
                opts: ModelOptions, block_tables: Optional[attn.BlockTables] = None,
                write: Optional[torch.Tensor] = None):
    """One serving step: token [B, 1] (``[B, C, 1]`` multi-codebook) at
    per-slot positions ``pos [B]`` (or one position for all) against the
    dense states or, with
    ``block_tables``, the paged pools.  ``write [B]`` bool: the slots
    whose in-place dense cache writes are kept (None = all); the others
    attend with their new entry, which is then put back as it was.
    Recurrent states are returned new, never written in place.  A MoE
    layer runs drop-free.  An ``xattn`` layer reads its cross cache and
    never writes it.  Returns (logits [B, 1, V] (``[B, 1, C, V]``),
    states)."""
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
        if kind in _CORE_DECODE:
            out, st = _CORE_DECODE[kind](p["core"], h, st, cfg, sites)
        else:
            out, st = attn.attn_decode(p["core"], h, st, pos, cfg, kind=kind, sites=sites,
                                       tables=block_tables, use_kernel=use_kernel,
                                       write=write)
        x = _mlp(p, x + out, cfg, sites, full_capacity=True)
        new_layers.append(st)
    return _head(params, x, cfg, opts), {**states, "layers": new_layers}


def suffix_forward(params, tokens: torch.Tensor, cfg: ArchConfig, opts: ModelOptions,
                   states, table: torch.Tensor, start: torch.Tensor, ctx_blocks: int):
    """Prefix-aware packed prefill: the unmatched suffixes (``tokens
    [B, S_suf]`` or ``[B, C, S_suf]``, right-padded) in one pass against
    prefix KV resident in
    the pool, writing the suffix KV into each slot's blocks; a cold
    request is ``start == 0``.  A MoE layer runs at
    ``opts.capacity_factor``.  Returns (logits [B, S_suf, V] or [B, S_suf,
    C, V], states)."""
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
        x = _mlp(p, x + out, cfg, sites, opts.capacity_factor)
        new_layers.append(st)
    return _head(params, x, cfg, opts), {**states, "layers": new_layers}


def _dense_state(cfg: ArchConfig, kind: str, batch: int, max_len: int, device):
    if kind == "rglru":
        return rglru_mod.RGLRUState(
            torch.zeros((batch, cfg.d_rnn), dtype=torch.float32, device=device),
            torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn), dtype=torch.float32,
                        device=device))
    if kind == "mlstm":
        return xlstm_mod.mlstm_state_init(cfg, batch, device)
    if kind == "slstm":
        return xlstm_mod.slstm_state_init(cfg, batch, device)
    return attn.init_cache(cfg, batch, max_len, device, kind=kind)


DENSE_KV_QUANT_REASON = ("kv_quant='int8' requires the paged KV layout (kv_block_size > 0): "
                         "dense per-slot caches stay in the model dtype")


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      paged: Optional[Tuple[int, int]] = None, device=None,
                      kv_quant: str = "none", plan: Optional[ExecutionPlan] = None):
    """Zeroed serving state.  Without ``paged``: per layer, one dense
    ``[batch, n_kv, max_len, hd]`` cache in the model dtype (a local
    layer's ring clamped to ``min(max_len, window)``, an ``xattn`` layer's
    cross cache ``[batch, n_kv, vision_tokens, hd]``, zeros) or a float32
    recurrent state: ``RGLRUState`` (``h [batch, d_rnn]``, ``conv [batch,
    conv_width - 1, d_rnn]``), ``MLSTMState`` (``c [batch, H, dh, dh]``,
    ``n [batch, H, dh]``, ``m [batch, H]`` at -1e30) or ``SLSTMState``
    (``c, n, m, h [batch, H, dh]``, ``m`` at -1e30).  ``paged =
    (n_blocks, block_size)`` gives each ``attn`` and ``local`` layer one
    block pool instead (no batch axis: block tables carry slot identity; a
    local layer's ring lives in it) while a recurrent layer keeps its
    slot-indexed state and an ``xattn`` layer its dense cross cache;
    ``kv_quant="int8"`` makes each pool int8 with the per-head scales
    ``plan.kv_group_scale`` gives over the layer's group (the reference's
    one pool per scanned group).  Dense caches stay in the model dtype:
    with ``kv_quant="int8"`` they are refused, with the serving engine's
    reason."""
    _check_supported(cfg)
    if paged is None:
        if kv_quant != "none":
            raise ValueError(DENSE_KV_QUANT_REASON)
        return {"layers": [_dense_state(cfg, kind, batch, max_len, device)
                           for kind in cfg.layer_kinds]}
    if kv_quant != "none" and plan is None:
        raise ValueError("kv_quant='int8' needs a calibrated plan")
    n_blocks, block_size = paged
    layers = []
    for li, kind in enumerate(cfg.layer_kinds):
        if kind not in ("attn", "local"):
            layers.append(_dense_state(cfg, kind, batch, max_len, device))
        elif kv_quant == "none":
            layers.append(attn.init_paged_cache(cfg, n_blocks, block_size, device))
        else:
            grp = layer_group(cfg, li)
            k_scale = plan.kv_group_scale(tuple(f"L{l}.kv.k" for l in grp))
            v_scale = plan.kv_group_scale(tuple(f"L{l}.kv.v" for l in grp))
            layers.append(attn.init_paged_quant_cache(cfg, n_blocks, block_size, k_scale,
                                                      v_scale, device))
    return {"layers": layers}
