"""ASTRA as a first-class execution mode for model matmuls.

Port of ``repro.core.astra_layer``.  ``astra_matmul(x, w, cc)`` is the
single entry point every model GEMM goes through:

* ``exact`` — ``torch.matmul(x, w.to(x.dtype))``;
* ``int8``  — ASTRA's expectation: per-tensor int8 activations,
  per-output-channel int8 weights, an exact int32 product and dequant;
* ``sc``    — the bit-true stochastic-stream mode: the same codes become
  128-bit streams (``x_gen`` for activations, ``w_gen`` for weights) and
  the OSSM array ANDs, popcounts and sums them with their signs.

On a CUDA tensor the products always run the hand-written kernels
(``kernels.int8_matmul``; ``kernels.stoch_matmul``, which reads both
operands as int8 codes and expands each to its stream's sign planes while
it stages them, so no stream is ever stored) whatever ``use_pallas`` says
— the reference's kernels and its jnp paths are bit-identical; on a CPU
tensor they run the kernels' plain versions.

``cc`` is a plain :class:`ComputeConfig` or a :class:`BoundSite` (a named
GEMM site bound to an :class:`~repro_torch.core.plan.ExecutionPlan`).
While a plan calibrates (it carries an observer), every bound GEMM feeds
its activation's absmax to the observer before it runs, and the dynamic
qk/pv products leave the caller's exact fast path for
:func:`astra_batched_matmul`'s exact matmul, as in the reference.
Weights may come with caches computed once at load instead of every call:
int8 codes (``wq_t``: codes ``[N, K]`` and scales ``[1, N]``, exactly
``quantize(w, axis=0)`` transposed), the same codes tagged with the
generator of their streams (``wsc_t``, a
:class:`~repro_torch.core.ossm.WeightCodes`) and a cast copy (``wc``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.bitstream import STREAM_LEN
from repro_torch.core.ossm import WeightCodes
from repro_torch.core.quant import QTensor, quantize

MODES = ("exact", "int8", "sc")


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

    @property
    def observing(self) -> bool:
        return getattr(self.plan, "_observer", None) is not None


def resolve_cc(cc: Union[ComputeConfig, BoundSite]) -> ComputeConfig:
    return cc.resolved() if isinstance(cc, BoundSite) else cc


def runs_exact(cc: Union[ComputeConfig, BoundSite]) -> bool:
    """Whether this GEMM takes the plain exact path: neither quantized nor
    tapped by a calibration observer."""
    return resolve_cc(cc).mode == "exact" and not (
        isinstance(cc, BoundSite) and cc.observing)


def _maybe_observe(cc: Union[ComputeConfig, BoundSite], x: torch.Tensor) -> None:
    """Feed ``x``'s absmax to the plan's calibration observer, if any."""
    if isinstance(cc, BoundSite) and cc.observing:
        cc.plan._observer.record(cc.sites, x)


def quantize_weight_t(w: torch.Tensor) -> QTensor:
    """``quantize(w [K, N], axis=0)`` stored transposed: codes ``[N, K]``
    (K-contiguous, the int8 kernel's layout), scales ``[1, N]``."""
    wq = quantize(w, axis=0)
    return QTensor(wq.q.t().contiguous(), wq.scale)


def sc_weight_t(w: torch.Tensor, w_gen: str) -> WeightCodes:
    """``quantize_weight_t(w)``'s codes ``[N, K]`` and scales ``[1, N]``,
    tagged with ``w_gen``: what the ``sc`` mode reads of ``w``."""
    wq_t = quantize_weight_t(w)
    return WeightCodes(wq_t.q, wq_t.scale, w_gen)


def batched_weight_t(w: torch.Tensor) -> QTensor:
    """Per-batch weights ``w [B, K, N]`` (a MoE layer's experts) quantized
    as the batched product quantizes its second operand, ``quantize(w,
    axis=1)``, with the codes stored transposed: codes ``[B, N, K]``,
    scales ``[B, 1, N]``."""
    wq = quantize(w, axis=1)
    return QTensor(wq.q.transpose(1, 2).contiguous(), wq.scale)


def batched_sc_weight_t(w: torch.Tensor, w_gen: str) -> WeightCodes:
    """``batched_weight_t(w)`` tagged with the weight streams' generator."""
    wq = batched_weight_t(w)
    return WeightCodes(wq.q, wq.scale, w_gen)


def astra_matmul(x: torch.Tensor, w: torch.Tensor,
                 cc: Union[ComputeConfig, BoundSite] = EXACT, *,
                 wq_t: Optional[QTensor] = None,
                 wsc_t: Optional[WeightCodes] = None,
                 wc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[..., K] @ [K, N]`` under the site's execution mode."""
    _maybe_observe(cc, x)
    cc = resolve_cc(cc)
    if cc.mode == "exact":
        w_x = wc if wc is not None and wc.dtype == x.dtype else w.to(x.dtype)
        return torch.matmul(x, w_x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq = quantize(x2, axis=None, scale=cc.act_scale)
    if cc.mode == "int8":
        from repro_torch.kernels.int8_matmul.ops import int8_matmul_t

        out = int8_matmul_t(xq, wq_t if wq_t is not None else quantize_weight_t(w))
    else:
        from repro_torch.kernels.stoch_matmul.ops import stoch_matmul

        if wsc_t is None or wsc_t.gen != cc.w_gen:
            wsc_t = sc_weight_t(w, cc.w_gen)
        out = stoch_matmul(xq, wsc_t, cc.x_gen)
    return out.reshape(*lead, w.shape[-1]).to(x.dtype)


def astra_batched_matmul(x: torch.Tensor, w: torch.Tensor,
                         cc: Union[ComputeConfig, BoundSite], *,
                         fold_groups: bool = False,
                         wq_t: Optional[QTensor] = None,
                         wsc_t: Optional[WeightCodes] = None,
                         wc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched GEMM with a per-batch second operand: ``[..., M, K] @
    [..., K, N]`` with shared leading dims (the attention qk/pv products).

    Exact mode is a plain matmul.  A quantized mode gives each batch
    element (each slot and KV head) its own per-tensor ``x`` scale and its
    own per-output-column ``w`` scale, as the reference's ``vmap`` of
    ``astra_matmul`` does, and runs every element's product in one launch
    of the batched int8 or stochastic kernel.

    ``fold_groups`` (the expert products of a MoE layer): ``x [E, G, M,
    K]`` (group g's buffer rows for expert e) against ``w [E, K, N]`` ->
    ``[E, G, M, N]``, the same function over every (group, expert) pair,
    but each expert's G groups run as one product of G*M rows, so ``w`` is
    read once and never broadcast over the groups: a row's products do
    not depend on the rows beside it (int32 sums are exact, and the
    scales are applied per pair afterwards).  Caches made once at load:
    ``wc`` (``w`` in the model dtype), ``wq_t`` (:func:`batched_weight_t`)
    and ``wsc_t`` (:func:`batched_sc_weight_t`)."""
    m, k = x.shape[-2:]
    n = w.shape[-1]
    lead = x.shape[:-2]
    w_lead = lead[:1] if fold_groups else lead  # the batch of distinct weights
    reps = lead[1] if fold_groups else 1  # x batches sharing each weight

    def plain(w_x):
        if not fold_groups:
            return torch.matmul(x, w_x)
        return torch.matmul(x.reshape(-1, reps * m, k), w_x).reshape(*lead, m, n)

    if runs_exact(cc):
        return plain(wc if wc is not None and wc.dtype == x.dtype else w.to(x.dtype))
    _maybe_observe(cc, x)
    cc = resolve_cc(cc)
    if cc.mode == "exact":  # observed while calibrating
        return plain(w.to(x.dtype))
    wf = w.broadcast_to(*w_lead, k, n).reshape(-1, k, n)
    b = wf.shape[0]
    xq = quantize(x.reshape(-1, m, k), axis=(1, 2), scale=cc.act_scale)
    xs = xq.scale.reshape(b, reps, 1, 1) if xq.scale.dim() else xq.scale
    codes = xq.q.reshape(b, reps * m, k)
    if cc.mode == "int8":
        from repro_torch.kernels.int8_matmul.ops import int8_gemm_batched

        wq = wq_t if wq_t is not None else batched_weight_t(wf)
        acc = int8_gemm_batched(codes, wq.q).reshape(b, reps, m, n)
        out = (acc.to(torch.float32) * xs) * wq.scale[:, None]
    else:
        from repro_torch.kernels.stoch_matmul.ops import stoch_matmul_codes_batched

        if wsc_t is None or wsc_t.gen != cc.w_gen:
            wsc_t = batched_sc_weight_t(wf, cc.w_gen)
        acc = stoch_matmul_codes_batched(codes, wsc_t.q, cc.x_gen, cc.w_gen)
        out = acc.reshape(b, reps, m, n).to(torch.float32) * STREAM_LEN * xs \
            * wsc_t.scale[:, None]
    return out.reshape(*lead, m, n).to(x.dtype)
