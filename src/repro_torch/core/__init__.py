"""Quantization, execution modes and per-site plans (port of ``repro.core``)."""
from repro_torch.core.astra_layer import (
    EXACT, INT8, MODES, SC, BoundSite, ComputeConfig, astra_batched_matmul, astra_matmul,
)
from repro_torch.core.plan import PRESET_PLANS, ExecutionPlan, kv_sites, model_sites
from repro_torch.core.quant import MAG_MAX, QTensor, int8_matmul_exact, quantize

__all__ = [
    "EXACT", "INT8", "MODES", "SC", "BoundSite", "ComputeConfig", "astra_batched_matmul",
    "astra_matmul", "PRESET_PLANS", "ExecutionPlan", "kv_sites", "model_sites", "MAG_MAX",
    "QTensor", "int8_matmul_exact", "quantize",
]
