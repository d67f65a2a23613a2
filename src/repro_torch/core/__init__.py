"""Quantization, execution modes, per-site plans and the ASTRA chip model
(port of ``repro.core``)."""
from repro_torch.core.astra_layer import (
    EXACT, INT8, MODES, SC, BoundSite, ComputeConfig, astra_batched_matmul, astra_matmul,
)
from repro_torch.core.energy import AstraChipConfig
from repro_torch.core.plan import (
    PRESET_PLANS, ExecutionPlan, kv_sites, model_sites, site_class, validate_site_registry,
)
from repro_torch.core.quant import MAG_MAX, STREAM_LEN, QTensor, int8_matmul_exact, quantize
from repro_torch.core.vdpe import VDPEConfig, sc_matmul

__all__ = [
    "EXACT", "INT8", "MODES", "SC", "BoundSite", "ComputeConfig", "astra_batched_matmul",
    "astra_matmul", "AstraChipConfig", "PRESET_PLANS", "ExecutionPlan", "kv_sites",
    "model_sites", "site_class", "validate_site_registry", "MAG_MAX", "STREAM_LEN", "QTensor",
    "int8_matmul_exact", "quantize", "VDPEConfig", "sc_matmul",
]
