"""Architecture-level ASTRA simulator (paper §III methodology; port of
``repro.core.simulator``, pure Python).

Walks a model config into its GEMM + elementwise op graph, maps every op
through ``core.mapping`` onto the ASTRA chip, and rolls up latency and
per-component energy.  Reproduces:

* Fig. 5 — energy breakdown by component,
* Fig. 6 / §III — latency + energy vs baseline platforms (``core.baselines``),
* the per-model numbers for the five paper models.

Elementwise/recurrent work that cannot map to VDPEs (softmax, norms, RG-LRU
and sLSTM recurrences, routing) runs on the electronic non-linear units —
see DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core.energy import AstraChipConfig
from repro_torch.core.mapping import ElementwiseOp, MatmulOp, OpCost, map_elementwise, map_matmul

ENCODER_MODELS = {"bert-base", "albert-base", "vit-base", "transformer-base"}


def _attn_ops(cfg: ArchConfig, b: int, s: int, s_kv: int, name: str, cross: bool = False) -> List[MatmulOp]:
    d, hd, nh, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    t = b * s
    ops = [
        MatmulOp(f"{name}.q_proj", t, d, nh * hd),
        MatmulOp(f"{name}.kv_proj", (b * s_kv) if cross else t, d, 2 * nkv * hd),
        MatmulOp(f"{name}.qk", s, hd, s_kv, dynamic_w=True, count=b * nh),
        MatmulOp(f"{name}.pv", s, s_kv, hd, dynamic_w=True, count=b * nh),
        MatmulOp(f"{name}.o_proj", t, nh * hd, d),
    ]
    return ops


def _mlp_ops(cfg: ArchConfig, b: int, s: int, name: str) -> Tuple[List[MatmulOp], List[ElementwiseOp]]:
    t = b * s
    d = cfg.d_model
    mm: List[MatmulOp] = []
    ew: List[ElementwiseOp] = []
    if cfg.moe is not None:
        m = cfg.moe
        mm.append(MatmulOp(f"{name}.router", t, d, m.n_experts))
        # top-k dispatch: every token hits top_k experts
        mm.append(MatmulOp(f"{name}.expert_up", t * m.top_k, d, 2 * m.d_expert))
        mm.append(MatmulOp(f"{name}.expert_down", t * m.top_k, m.d_expert, d))
        ew.append(ElementwiseOp(f"{name}.route", t * m.n_experts * 3))  # softmax+topk
        ew.append(ElementwiseOp(f"{name}.glu", t * m.top_k * m.d_expert * 2))
    elif cfg.d_ff > 0:
        gated = cfg.act in ("swiglu", "geglu")
        mm.append(MatmulOp(f"{name}.up", t, d, (2 if gated else 1) * cfg.d_ff))
        mm.append(MatmulOp(f"{name}.down", t, cfg.d_ff, d))
        ew.append(ElementwiseOp(f"{name}.act", t * cfg.d_ff * (2 if gated else 1)))
    return mm, ew


def _block_ops(cfg: ArchConfig, kind: str, b: int, s: int, li: int, causal: bool) -> Tuple[List[MatmulOp], List[ElementwiseOp]]:
    d = cfg.d_model
    t = b * s
    name = f"L{li}.{kind}"
    mm: List[MatmulOp] = []
    ew: List[ElementwiseOp] = [ElementwiseOp(f"{name}.norms", t * d * 8)]
    if kind in ("attn", "local", "xattn"):
        if kind == "local":
            s_kv = min(s, cfg.window or s)
        elif kind == "xattn":
            s_kv = cfg.vision_tokens or s
        else:
            # causal attention averages s/2 effective context
            s_kv = s // 2 if causal else s
        mm += _attn_ops(cfg, b, s, max(s_kv, 1), name, cross=(kind == "xattn"))
        ew.append(ElementwiseOp(f"{name}.softmax", b * cfg.n_heads * s * max(s_kv, 1) * 5))
        m2, e2 = _mlp_ops(cfg, b, s, name)
        mm += m2
        ew += e2
    elif kind == "rglru":
        r = cfg.d_rnn
        mm.append(MatmulOp(f"{name}.in_proj", t, d, 2 * r))
        # RG-LRU recurrence+input gates (W_a, W_x): r -> r GEMMs the model
        # actually executes (site registry cross-check keeps this in sync)
        mm.append(MatmulOp(f"{name}.gates", t, r, 2 * r))
        mm.append(MatmulOp(f"{name}.out_proj", t, r, d))
        # conv1d + RG-LRU recurrence: elementwise, electronic (DESIGN.md)
        ew.append(ElementwiseOp(f"{name}.conv", t * r * 2 * cfg.conv_width))
        ew.append(ElementwiseOp(f"{name}.lru", t * r * 8))
        m2, e2 = _mlp_ops(cfg, b, s, name)
        mm += m2
        ew += e2
    elif kind == "mlstm":
        e = 2 * d
        hd = e // max(cfg.n_heads, 1)
        mm.append(MatmulOp(f"{name}.up_proj", t, d, 2 * e))
        # three e -> e projections (w_q, w_k, w_v), as the model executes
        mm.append(MatmulOp(f"{name}.qkv", t, e, 3 * e))
        # per-head input/forget gate projections (w_if)
        mm.append(MatmulOp(f"{name}.gates", t, e, 2 * cfg.n_heads))
        # chunkwise matrix-memory: intra-chunk attention-like products
        chunk = min(128, s)
        n_chunks = max(1, s // chunk)
        mm.append(MatmulOp(f"{name}.intra_qk", chunk, hd, chunk, dynamic_w=True, count=b * cfg.n_heads * n_chunks))
        mm.append(MatmulOp(f"{name}.intra_pv", chunk, chunk, hd, dynamic_w=True, count=b * cfg.n_heads * n_chunks))
        ew.append(ElementwiseOp(f"{name}.state", t * e * 6))  # inter-chunk C/n update
        mm.append(MatmulOp(f"{name}.down_proj", t, e, d))
    elif kind == "slstm":
        h = d
        mm.append(MatmulOp(f"{name}.gates_in", t, d, 4 * h))
        # post-cell GLU FFN (4/3 expansion), matching the executed block
        f_up = int(d * 4 / 3)
        mm.append(MatmulOp(f"{name}.up", t, h, 2 * f_up))
        mm.append(MatmulOp(f"{name}.down", t, f_up, d))
        # sequential scalar recurrence + recurrent matvecs: electronic
        ew.append(ElementwiseOp(f"{name}.recurrence", t * h * 10 + t * 4 * h * h // max(cfg.n_heads, 1) // 64))
    return mm, ew


def model_ops(cfg: ArchConfig, seq: int, batch: int = 1) -> Tuple[List[MatmulOp], List[ElementwiseOp]]:
    """The full inference op graph of one forward pass."""
    causal = cfg.name not in ENCODER_MODELS
    mm: List[MatmulOp] = []
    ew: List[ElementwiseOp] = []
    t = batch * seq
    if cfg.name == "vit-base":
        mm.append(MatmulOp("patch_embed", batch * 197, 16 * 16 * 3, cfg.d_model))
    for li, kind in enumerate(cfg.layer_kinds):
        m, e = _block_ops(cfg, kind, batch, seq, li, causal)
        mm += m
        ew += e
    heads = max(1, cfg.n_codebooks or 1)
    mm.append(MatmulOp("lm_head", t, cfg.d_model, cfg.vocab * heads))
    ew.append(ElementwiseOp("final_norm", t * cfg.d_model * 4))
    return mm, ew


@dataclasses.dataclass
class ModelReport:
    name: str
    latency_s: float
    energy_j: Dict[str, float]
    macs: int
    op_costs: List[OpCost]

    @property
    def total_energy_j(self) -> float:
        return sum(self.energy_j.values())

    @property
    def energy_per_mac_j(self) -> float:
        return self.total_energy_j / max(self.macs, 1)

    @property
    def throughput_macs(self) -> float:
        return self.macs / self.latency_s


def simulate(cfg: ArchConfig, chip: AstraChipConfig, seq: int, batch: int = 1) -> ModelReport:
    mm, ew = model_ops(cfg, seq, batch)
    costs = [map_matmul(chip, op) for op in mm] + [map_elementwise(chip, op) for op in ew]
    energy: Dict[str, float] = {}
    for c in costs:
        for k, v in c.energy_j.items():
            energy[k] = energy.get(k, 0.0) + v
    # ALBERT: one shared layer's weights stay SRAM-resident across all 12
    # repeats -> HBM weight traffic paid once.
    if cfg.name == "albert-base" and "hbm" in energy:
        energy["hbm"] /= cfg.n_layers
    # matmul VDPE time and NLU time overlap only partially: ASTRA pipelines
    # the NLU behind the VDPEs (non-linears depend on matmul outputs);
    # model 70% overlap.  # assumed
    t_mm = sum(c.latency_s for c in costs if c.macs > 0)
    t_ew = sum(c.latency_s for c in costs if c.macs == 0)
    latency = t_mm + 0.3 * t_ew
    macs = sum(c.macs for c in costs)
    return ModelReport(cfg.name, latency, energy, macs, costs)
