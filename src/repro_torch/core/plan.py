"""Per-site ExecutionPlan: ordered glob rules mapping GEMM sites to modes.

Port of ``repro.core.plan`` (resolution, presets, site registry).  Every
GEMM the model executes has a stable site id (``L{layer}.{kind}.{op}``,
plus ``lm_head``); the plan maps sites to
:class:`~repro_torch.core.astra_layer.ComputeConfig` by ordered glob
rules (first match wins, ``|`` separates alternatives) with a default:

    plan = ExecutionPlan.from_spec({"*.qk|*.pv": "int8", "default": "exact"})

``uniform(cc)`` applies ``cc`` to every weight GEMM and pins the dynamic
qk/pv and MoE sites to exact — the reference's legacy global-mode
semantics.

``plan.calibrate(model, params, batch)`` runs one exact forward with an
absmax observer on every GEMM site and every KV storage site
(``L{li}.kv.{k,v}``) and bakes static per-site activation scales and
per-KV-head storage scales into the plan.  The reference taps each site
with ``jax.debug.callback``; here each tap folds its absmax into a
float32 device tensor with ``torch.fmax``/``torch.maximum``, and all of
them reach the host in one transfer after the pass.  The simulator
cross-check (``validate_site_registry``) comes with a later slice.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
import json
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.astra_layer import EXACT, INT8, MODES, SC, BoundSite, ComputeConfig
from repro_torch.core.quant import MAG_MAX

DYNAMIC_SITES = "*.qk|*.pv"
MOE_SITES = "*.router|*.expert_up|*.expert_down"


def _match(pattern: str, site: str) -> bool:
    return any(fnmatch.fnmatchcase(site, alt) for alt in pattern.split("|"))


class _AbsMaxObserver:
    """Calibration accumulator, keyed by the site group a tap stands for.

    ``record`` keeps a float32 device scalar per group (``torch.fmax``
    skips NaN, as the reference's ``>`` comparison does); ``record_vec``
    a per-KV-head vector (``torch.maximum``, as ``np.maximum``).  Nothing
    syncs until :meth:`host`, which moves every value in one transfer."""

    def __init__(self):
        self.amax: Dict[Tuple[str, ...], torch.Tensor] = {}
        self.vec: Dict[Tuple[str, ...], torch.Tensor] = {}

    def record(self, sites: Tuple[str, ...], x: torch.Tensor) -> None:
        a = x.detach().to(torch.float32).abs().amax()
        prev = self.amax.get(sites)
        self.amax[sites] = a if prev is None else torch.fmax(prev, a)

    def record_vec(self, sites: Tuple[str, ...], amax: torch.Tensor) -> None:
        """Elementwise (per-KV-head) absmax for KV storage sites."""
        prev = self.vec.get(sites)
        self.vec[sites] = amax if prev is None else torch.maximum(prev, amax)

    def host(self) -> Tuple[Dict[str, float], Dict[str, Tuple[float, ...]]]:
        """Every site's absmax as Python floats, in one transfer: each site
        of a group gets the group's value, and an act site whose absmax is
        not positive gets none (the reference records only values above 0)."""
        scal, vecs = list(self.amax.items()), list(self.vec.items())
        if not scal and not vecs:
            return {}, {}
        flat = torch.cat([v.reshape(-1) for _, v in scal + vecs]).cpu().tolist()
        amax = {s: a for (sites, _), a in zip(scal, flat) if a > 0 for s in sites}
        vec: Dict[str, Tuple[float, ...]] = {}
        i = len(scal)
        for sites, v in vecs:
            vec.update(dict.fromkeys(sites, tuple(flat[i:i + v.numel()])))
            i += v.numel()
        return amax, vec


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Ordered glob rules -> per-site ComputeConfig, plus calibrated scales.

    Frozen and hashable.  ``_observer`` is set only on the throwaway plan
    ``calibrate`` runs its forward under; ``compare=False`` keeps that plan
    hashable and equal to its non-observing twin, so the memoizing helpers
    below build its bindings afresh instead of caching them."""

    rules: Tuple[Tuple[str, ComputeConfig], ...] = ()
    default: ComputeConfig = EXACT
    act_scales: Tuple[Tuple[str, float], ...] = ()  # site -> static act scale
    # KV storage sites (``L{li}.kv.{k,v}``) -> per-KV-head static scales:
    # they quantize what the paged pool stores, not a GEMM
    kv_scales: Tuple[Tuple[str, Tuple[float, ...]], ...] = ()
    name: str = ""
    _observer: Optional[_AbsMaxObserver] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __hash__(self) -> int:
        # computed once: a calibrated plan carries ~2000 floats, and the
        # memoized lookups below hash the plan at every GEMM of every step
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.rules, self.default, self.act_scales, self.kv_scales, self.name))
            object.__setattr__(self, "_hash", h)
        return h

    # ---------------------------------------------------------- resolution
    def resolve(self, site: str) -> ComputeConfig:
        """ComputeConfig for one concrete site (first matching rule wins)."""
        cc = next((cc for pat, cc in self.rules if _match(pat, site)), self.default)
        if cc.mode != "exact" and cc.act_scale is None:
            for s, scale in self.act_scales:
                if s == site:
                    cc = dataclasses.replace(cc, act_scale=scale)
                    break
        return cc

    def resolve_group(self, sites: Sequence[str]) -> ComputeConfig:
        """Resolve sites that must share one config (the reference scans
        layers under one trace; the port keeps the same rule so a plan
        means the same thing in both).  Memoized: the model resolves the
        same groups on every step."""
        return _resolve_group(self, tuple(sites))

    def _resolve_group_uncached(self, sites: Tuple[str, ...]) -> ComputeConfig:
        ccs = [self.resolve(s) for s in sites]
        first = ccs[0]
        for s, cc in zip(sites[1:], ccs[1:]):
            if cc != first:
                raise ValueError(
                    f"plan {self.name or self.rules!r} resolves {sites[0]!r} -> "
                    f"{first.mode} but {s!r} -> {cc.mode}; layers sharing a "
                    "scanned trace must resolve identically (layer-granular "
                    "rules only apply to unrolled/remainder layers)"
                )
        return first

    def site(self, name: str) -> BoundSite:
        return BoundSite(self, (name,))

    def binding(self, kind: str, layers: Sequence[int]) -> "SiteBinding":
        return SiteBinding(self, tuple(f"L{li}.{kind}" for li in layers))

    # ----------------------------------------------------------- KV storage
    def kv_scale(self, site: str) -> Optional[Tuple[float, ...]]:
        """Calibrated per-KV-head scales for one ``L{li}.kv.{k,v}`` site."""
        for s, scales in self.kv_scales:
            if s == site:
                return scales
        return None

    def kv_group_scale(self, sites: Sequence[str]) -> Tuple[float, ...]:
        """Per-head scales for a group of KV storage sites: the elementwise
        max (calibration gives a group's sites the same vector).  Raises if
        any site has none: quantized KV without a static scale is never
        legal."""
        vecs = []
        for s in sites:
            v = self.kv_scale(s)
            if v is None:
                raise ValueError(
                    f"plan {self.name or self.rules!r} has no calibrated KV "
                    f"scale for {s!r}; run Model.calibrate before enabling "
                    "kv_quant (static scales keep cached KV a pure function "
                    "of the token path)")
            vecs.append(v)
        return tuple(float(max(col)) for col in zip(*vecs))

    # --------------------------------------------------------- construction
    @staticmethod
    def uniform(cc: ComputeConfig) -> "ExecutionPlan":
        return ExecutionPlan(rules=((DYNAMIC_SITES, EXACT), (MOE_SITES, EXACT)),
                             default=cc, name=f"uniform-{cc.mode}")

    @staticmethod
    def from_spec(spec: Union[str, Mapping, ComputeConfig, "ExecutionPlan"],
                  name: str = "") -> "ExecutionPlan":
        """Build a plan from a preset name, mode string, JSON string, or dict."""
        if isinstance(spec, ExecutionPlan):
            return spec
        if isinstance(spec, ComputeConfig):
            return ExecutionPlan.uniform(spec)
        if isinstance(spec, str):
            s = spec.strip()
            if s in PRESET_PLANS:
                return PRESET_PLANS[s]
            if s in MODES:
                return ExecutionPlan.uniform(ComputeConfig(s))
            if s.startswith("{"):
                try:
                    return ExecutionPlan.from_spec(json.loads(s), name=name or "<json>")
                except json.JSONDecodeError as e:
                    raise ValueError(f"invalid plan JSON: {e}") from e
            raise ValueError(
                f"unknown plan {spec!r}; valid presets: "
                f"{', '.join(sorted(PRESET_PLANS))}; valid uniform modes: "
                f"{', '.join(MODES)}; or pass JSON glob rules"
            )
        if isinstance(spec, Mapping):
            default = EXACT
            rules: List[Tuple[str, ComputeConfig]] = []
            for pat, val in spec.items():
                cc = _as_cc(val)
                if pat == "default":
                    default = cc
                else:
                    rules.append((pat, cc))
            return ExecutionPlan(tuple(rules), default, name=name)
        raise TypeError(f"cannot build ExecutionPlan from {type(spec).__name__}")

    # ---------------------------------------------------------- calibration
    def calibrate(self, model, params, batch) -> "ExecutionPlan":
        """One exact forward over ``batch`` (``{"tokens": [B, S]}`` or the
        tokens) with an observer on every site; returns this plan with
        per-site static ``act_scales`` and per-KV-head ``kv_scales``.  A
        tap records into every site of its layer group, so each scale is
        the group's max, as the reference's shared scan tap gives.  Each
        scale is ``amax / MAG_MAX`` in float64 from the float32 absmax."""
        from repro_torch.models.transformer import forward

        obs = _AbsMaxObserver()
        observe_plan = ExecutionPlan(name="calibrate", _observer=obs)
        opts = dataclasses.replace(model.opts, plan=observe_plan)
        tokens = batch["tokens"] if isinstance(batch, Mapping) else batch
        with torch.no_grad():
            forward(params, torch.as_tensor(tokens, device=model.device), model.cfg, opts)
        amax, vec = obs.host()
        scales = tuple(sorted((site, (a / MAG_MAX) if a > 0 else 1.0)
                              for site, a in amax.items()))
        kv = tuple(sorted((site, tuple((a / MAG_MAX) if a > 0 else 1.0 for a in v))
                          for site, v in vec.items()))
        return dataclasses.replace(self, act_scales=scales, kv_scales=kv)


@functools.lru_cache(maxsize=4096)
def _resolve_group(plan: ExecutionPlan, sites: Tuple[str, ...]) -> ComputeConfig:
    return plan._resolve_group_uncached(sites)


def _as_cc(val: Union[str, Mapping, ComputeConfig]) -> ComputeConfig:
    if isinstance(val, ComputeConfig):
        return val
    if isinstance(val, str):
        return ComputeConfig(val)
    if isinstance(val, Mapping):
        return ComputeConfig(**val)
    raise TypeError(f"cannot build ComputeConfig from {type(val).__name__}")


PRESET_PLANS: Dict[str, ExecutionPlan] = {
    "exact": ExecutionPlan.uniform(EXACT),
    "int8": ExecutionPlan.uniform(INT8),
    "sc": ExecutionPlan.uniform(SC),
    "mixed": ExecutionPlan(
        rules=((DYNAMIC_SITES, INT8), ("*_proj", SC)), default=EXACT, name="mixed"
    ),
}


# ===================================================================== sites
@dataclasses.dataclass(frozen=True)
class SiteBinding:
    """Site-scoped view of a plan for one block: ``binding("qk")`` is the
    :class:`BoundSite` for ``L{li}.{kind}.qk`` of every layer it covers."""

    plan: ExecutionPlan
    prefixes: Tuple[str, ...]  # "L{li}.{kind}" per concrete layer

    def __call__(self, op: str) -> BoundSite:
        if self.plan._observer is not None:  # never cache an observing plan
            return BoundSite(self.plan, tuple(f"{p}.{op}" for p in self.prefixes))
        return _bound_site(self, op)


@functools.lru_cache(maxsize=4096)
def _bound_site(binding: SiteBinding, op: str) -> BoundSite:
    return BoundSite(binding.plan, tuple(f"{p}.{op}" for p in binding.prefixes))


def as_binding(cc: Union[ComputeConfig, SiteBinding]) -> SiteBinding:
    if isinstance(cc, SiteBinding):
        return cc
    return SiteBinding(ExecutionPlan.uniform(cc), ("block",))


_KV_KINDS = ("attn", "local")


def kv_site_names(prefixes: Sequence[str], which: str) -> Tuple[str, ...]:
    """``("L0.attn", "L2.attn"), "k"`` -> ``("L0.kv.k", "L2.kv.k")``."""
    return tuple(f"{p.split('.', 1)[0]}.kv.{which}" for p in prefixes)


def observe_kv(sites: SiteBinding, k: torch.Tensor, v: torch.Tensor) -> None:
    """Calibration tap for KV storage sites: the per-KV-head absmax of what
    the pool would store (post-rope k, raw v; ``[B, KVH, S, hd]``).  No-op
    unless the binding's plan carries an observer."""
    obs = sites.plan._observer
    if obs is None:
        return
    for which, x in (("k", k), ("v", v)):
        amax = x.detach().to(torch.float32).abs().amax(dim=(0, 2, 3))
        obs.record_vec(kv_site_names(sites.prefixes, which), amax)


def kv_sites(cfg: ArchConfig) -> Tuple[str, ...]:
    """Every KV storage site of a config, in layer order."""
    return tuple(
        f"L{li}.kv.{which}"
        for li, kind in enumerate(cfg.layer_kinds)
        if kind in _KV_KINDS
        for which in ("k", "v")
    )


_ATTN_OPS = ("q_proj", "kv_proj", "qk", "pv", "o_proj")
_BLOCK_GEMMS: Dict[str, Tuple[str, ...]] = {
    "attn": _ATTN_OPS,
    "local": _ATTN_OPS,
    "xattn": _ATTN_OPS,
    "rglru": ("in_proj", "gates", "out_proj"),
    "mlstm": ("up_proj", "qkv", "gates", "down_proj"),
    "slstm": ("gates_in", "up", "down"),
}


def block_site_ops(cfg: ArchConfig, kind: str) -> Tuple[str, ...]:
    ops = list(_BLOCK_GEMMS[kind])
    has_mlp = kind in ("attn", "local", "xattn", "rglru") and (
        cfg.d_ff > 0 or cfg.moe is not None
    )
    if has_mlp:
        ops += ["router", "expert_up", "expert_down"] if cfg.moe is not None else ["up", "down"]
    return tuple(ops)


def model_sites(cfg: ArchConfig) -> Tuple[str, ...]:
    """Every GEMM site the model executes, in layer order, plus lm_head."""
    sites = [
        f"L{li}.{kind}.{op}"
        for li, kind in enumerate(cfg.layer_kinds)
        for op in block_site_ops(cfg, kind)
    ]
    sites.append("lm_head")
    return tuple(sites)


def site_class(op_name: str) -> str:
    """Aggregation key for per-site accounting: the layer index stripped
    (``L3.attn.qk`` -> ``attn.qk``); non-layer ops pass through."""
    if op_name.startswith("L") and "." in op_name:
        head, rest = op_name.split(".", 1)
        if head[1:].isdigit():
            return rest
    return op_name


def validate_site_registry(cfg: ArchConfig, seq: int = 8) -> None:
    """Every executed GEMM site resolves to exactly one op of the
    simulator's graph (``core.simulator.model_ops``); raises with the
    offending sites otherwise.  The converse need not hold: the simulator
    also models ops kept on the electronic side."""
    from collections import Counter

    from repro_torch.core.simulator import model_ops

    mm, _ = model_ops(cfg, seq=seq, batch=1)
    counts = Counter(op.name for op in mm)
    bad = {s: counts.get(s, 0) for s in model_sites(cfg) if counts.get(s, 0) != 1}
    if bad:
        raise AssertionError(f"{cfg.name}: executed GEMM sites without a 1:1 simulator op: {bad}")
