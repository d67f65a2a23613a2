"""ASTRA as a first-class execution mode for model matmuls.

Port of ``repro.core.astra_layer``.  ``astra_matmul(x, w, cc)`` is the
single entry point every model GEMM goes through:

* ``exact`` — ``torch.matmul(x, w.to(x.dtype))``;
* ``int8``  — ASTRA's expectation: per-tensor int8 activations,
  per-output-channel int8 weights, an exact int32 product and dequant.
  On a CUDA tensor the product always runs the hand-written int8 kernel
  (``kernels.int8_matmul``) whatever ``use_pallas`` says — the reference's
  kernel and its XLA path are bit-identical; on a CPU tensor it runs the
  kernel's plain version;
* ``sc``    — the bit-true stochastic-stream mode, not ported yet.

``cc`` is a plain :class:`ComputeConfig` or a :class:`BoundSite` (a named
GEMM site bound to an :class:`~repro_torch.core.plan.ExecutionPlan`).
Weights may come with their int8 codes cached (``wq_t``: codes ``[N, K]``
and scales ``[1, N]``, exactly ``quantize(w, axis=0)`` transposed) and a
cast copy (``wc``), computed once at load instead of every call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.quant import QTensor, quantize

MODES = ("exact", "int8", "sc")
SC_TODO = ("the 'sc' stochastic-stream mode is not ported yet (ROADMAP queue 1: "
           "sc mode with bts_encode and stoch_matmul)")


@dataclasses.dataclass(frozen=True)
class ComputeConfig:
    mode: str = "exact"
    x_gen: str = "thermometer"
    w_gen: str = "bresenham"
    use_pallas: bool = False  # kept for parity; the port always uses its kernel on CUDA
    act_scale: Optional[float] = None  # static activation scale (PTQ-calibrated)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"unknown compute mode {self.mode!r}; valid modes: {', '.join(MODES)}"
            )


EXACT = ComputeConfig("exact")
INT8 = ComputeConfig("int8")
SC = ComputeConfig("sc")


@dataclasses.dataclass(frozen=True)
class BoundSite:
    """A named GEMM site (or a group of layers' sites) bound to a plan."""

    plan: object  # repro_torch.core.plan.ExecutionPlan (duck-typed)
    sites: Tuple[str, ...]

    def resolved(self) -> ComputeConfig:
        return self.plan.resolve_group(self.sites)


def resolve_cc(cc: Union[ComputeConfig, BoundSite]) -> ComputeConfig:
    return cc.resolved() if isinstance(cc, BoundSite) else cc


def runs_exact(cc: Union[ComputeConfig, BoundSite]) -> bool:
    """Whether this GEMM takes the plain exact path."""
    return resolve_cc(cc).mode == "exact"


def quantize_weight_t(w: torch.Tensor) -> QTensor:
    """``quantize(w [K, N], axis=0)`` stored transposed: codes ``[N, K]``
    (K-contiguous, the int8 kernel's layout), scales ``[1, N]``."""
    wq = quantize(w, axis=0)
    return QTensor(wq.q.t().contiguous(), wq.scale)


def astra_matmul(x: torch.Tensor, w: torch.Tensor,
                 cc: Union[ComputeConfig, BoundSite] = EXACT, *,
                 wq_t: Optional[QTensor] = None,
                 wc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[..., K] @ [K, N]`` under the site's execution mode."""
    cc = resolve_cc(cc)
    if cc.mode == "exact":
        w_x = wc if wc is not None and wc.dtype == x.dtype else w.to(x.dtype)
        return torch.matmul(x, w_x)
    if cc.mode == "sc":
        raise NotImplementedError(SC_TODO)
    from repro_torch.kernels.int8_matmul.ops import int8_matmul_t

    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq = quantize(x2, axis=None, scale=cc.act_scale)
    if wq_t is None:
        wq_t = quantize_weight_t(w)
    out = int8_matmul_t(xq, wq_t)
    return out.reshape(*lead, w.shape[-1]).to(x.dtype)


def astra_batched_matmul(x: torch.Tensor, w: torch.Tensor,
                         cc: Union[ComputeConfig, BoundSite]) -> torch.Tensor:
    """Batched GEMM with a per-batch second operand (attention qk/pv).

    Exact only in this slice; a quantized dynamic site raises until its
    slice lands (the uniform ``int8`` plan pins qk/pv to exact)."""
    if runs_exact(cc):
        return torch.matmul(x, w.to(x.dtype))
    raise NotImplementedError(
        f"quantized dynamic GEMM sites ({resolve_cc(cc).mode} qk/pv, e.g. the "
        "'mixed' preset) are not ported yet (ROADMAP queue 1)")
