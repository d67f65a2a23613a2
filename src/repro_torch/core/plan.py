"""Per-site ExecutionPlan: ordered glob rules mapping GEMM sites to modes.

Port of ``repro.core.plan`` (resolution, presets, site registry).  Every
GEMM the model executes has a stable site id (``L{layer}.{kind}.{op}``,
plus ``lm_head``); the plan maps sites to
:class:`~repro_torch.core.astra_layer.ComputeConfig` by ordered glob
rules (first match wins, ``|`` separates alternatives) with a default:

    plan = ExecutionPlan.from_spec({"*.qk|*.pv": "int8", "default": "exact"})

``uniform(cc)`` applies ``cc`` to every weight GEMM and pins the dynamic
qk/pv and MoE sites to exact — the reference's legacy global-mode
semantics.  Calibration (``calibrate``) and the simulator cross-check
(``validate_site_registry``) come with later slices.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
import json
from typing import Dict, List, Mapping, Sequence, Tuple, Union

from repro_torch.configs.base import ArchConfig
from repro_torch.core.astra_layer import EXACT, INT8, MODES, SC, BoundSite, ComputeConfig

DYNAMIC_SITES = "*.qk|*.pv"
MOE_SITES = "*.router|*.expert_up|*.expert_down"


def _match(pattern: str, site: str) -> bool:
    return any(fnmatch.fnmatchcase(site, alt) for alt in pattern.split("|"))


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Ordered glob rules -> per-site ComputeConfig, plus calibrated scales."""

    rules: Tuple[Tuple[str, ComputeConfig], ...] = ()
    default: ComputeConfig = EXACT
    act_scales: Tuple[Tuple[str, float], ...] = ()  # site -> static act scale
    name: str = ""

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

    def calibrate(self, model, params, batch) -> "ExecutionPlan":
        raise NotImplementedError(
            "PTQ calibration is not ported yet (ROADMAP queue 1: calibration "
            "with kv_quant)")


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
        return _bound_site(self, op)


@functools.lru_cache(maxsize=4096)
def _bound_site(binding: SiteBinding, op: str) -> BoundSite:
    return BoundSite(binding.plan, tuple(f"{p}.{op}" for p in binding.prefixes))


def as_binding(cc: Union[ComputeConfig, SiteBinding]) -> SiteBinding:
    if isinstance(cc, SiteBinding):
        return cc
    return SiteBinding(ExecutionPlan.uniform(cc), ("block",))


_KV_KINDS = ("attn", "local")


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
