"""Layer -> VDP-core mapping with the output-stationary dataflow (paper §II;
port of ``repro.core.mapping``, pure Python).

ASTRA's dataflow: each output element y[m, n] is pinned to a PCA slot; its
K-dimension is streamed through a VDPE in ceil(K/lanes) passes, the PCA
integrating across passes, one ADC conversion at the end.  Both operands are
*streamed* (dynamically encoded in the optical domain), so matmuls with two
dynamic operands (QK^T, PV) cost the same as weight matmuls — no
weight-stationary reconfiguration penalty.  Within a core the X operand is
optically broadcast to all VDPEs (see ``core.energy``).

``map_matmul`` returns wall latency + per-component energy for one matmul;
``core.simulator`` walks whole models through it.  Which ops are
VDPE-mappable at all (vs routed to the electronic NLUs via
``map_elementwise``) is catalogued in DESIGN.md §Arch-applicability; the
chip organization being modeled is DESIGN.md §1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.energy import AstraChipConfig, ceil_div


@dataclasses.dataclass(frozen=True)
class MatmulOp:
    """One GEMM in the workload graph.

    dynamic_x / dynamic_w: whether the operand is produced at run time
    (activations, attention probs) or static (weights).  Static operands
    may be buffered in SRAM; a weight-stationary *baseline* would pay
    reconfiguration on dynamic operands — ASTRA does not.
    weight_reads: how many times the static operand must be fetched from
    HBM (1 unless it exceeds SRAM; ALBERT's sharing reduces unique bytes,
    not reads).
    """

    name: str
    m: int
    k: int
    n: int
    dynamic_x: bool = True
    dynamic_w: bool = False
    count: int = 1  # identical instances (e.g. per head, per layer)

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.count

    @property
    def out_elems(self) -> int:
        return self.m * self.n * self.count


@dataclasses.dataclass
class OpCost:
    name: str
    latency_s: float
    energy_j: Dict[str, float]
    macs: int
    passes: int
    adc_convs: int

    @property
    def total_energy_j(self) -> float:
        return sum(self.energy_j.values())


def _merge(into: Dict[str, float], frm: Dict[str, float], scale: float = 1.0):
    for k, v in frm.items():
        into[k] = into.get(k, 0.0) + v * scale


def map_matmul(chip: AstraChipConfig, op: MatmulOp) -> OpCost:
    """Cost of one MatmulOp on the ASTRA chip, output-stationary mapping."""
    passes_per_out = ceil_div(op.k, chip.lanes)
    vdpe_passes = op.out_elems * passes_per_out
    # wall latency: all VDPEs run in parallel, fully pipelined
    latency = ceil_div(vdpe_passes, chip.total_vdpes) * chip.pass_time_s

    energy: Dict[str, float] = {}
    per_pass = chip.component_pass_energy_j()
    _merge(energy, per_pass, scale=float(vdpe_passes))
    # one ADC conversion per output element (in-situ accumulation across passes)
    energy["adc"] = op.out_elems * chip.e_adc_conv_j
    # SRAM traffic for outputs (int8 write-back after requantization)
    energy["sram"] = energy.get("sram", 0.0) + op.out_elems * chip.e_sram_byte_j
    # HBM traffic: static operands streamed from DRAM when not SRAM-resident.
    hbm_bytes = 0
    if not op.dynamic_w:
        w_bytes = op.k * op.n * op.count  # int8
        reads = 1 if w_bytes <= chip.sram_bytes else ceil_div(op.m, 1)  # re-stream per row tile if oversized
        hbm_bytes += w_bytes * min(reads, 4)  # cap: tiling bounds re-reads  # assumed
    if not op.dynamic_x:
        hbm_bytes += op.m * op.k * op.count
    energy["hbm"] = hbm_bytes * chip.e_hbm_byte_j
    return OpCost(op.name, latency, energy, op.macs, vdpe_passes, op.out_elems)


@dataclasses.dataclass(frozen=True)
class ElementwiseOp:
    """Non-matmul work routed to the electronic non-linear units."""

    name: str
    ops: int  # elementwise op count


def map_elementwise(chip: AstraChipConfig, op: ElementwiseOp) -> OpCost:
    latency = op.ops / chip.nlu_ops_per_s
    return OpCost(op.name, latency, {"nlu": op.ops * chip.e_nlu_op_j}, 0, 0, 0)
