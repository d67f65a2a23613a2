"""Serving stack (port of ``repro.serve``: blocking and chunked admission
on the dense and paged KV layouts, the degraded-mode ladder and per-request
ASTRA accounting)."""
from repro_torch.serve.decode_loop import make_fused_decode, unfused_decode
from repro_torch.serve.engine import (
    RequestOutput, ServeConfig, ServeEngine, attn_kernel_reject_reason, kv_quant_reject_reason,
)
from repro_torch.serve.accounting import RequestHardwareReport, request_hardware_report
from repro_torch.serve.faults import FAULT_POOL_PRESSURE, NonFiniteLogitsError
from repro_torch.serve.prefill import (
    full_seq_packable, pack_prompts, packed_prefill, prefill_full_seq, prefill_paged_suffix,
    prefill_scan, prefill_window,
)
from repro_torch.serve.sampling import GREEDY, SamplerConfig, sample_next_token
from repro_torch.serve.scheduler import DegradedLadder, SchedulerConfig, TokenBudgetScheduler
from repro_torch.serve.slots import SlotState

__all__ = [
    "make_fused_decode", "unfused_decode", "RequestOutput", "ServeConfig", "ServeEngine",
    "attn_kernel_reject_reason", "kv_quant_reject_reason", "RequestHardwareReport",
    "request_hardware_report", "FAULT_POOL_PRESSURE", "NonFiniteLogitsError",
    "full_seq_packable", "pack_prompts", "packed_prefill", "prefill_full_seq",
    "prefill_paged_suffix", "prefill_scan", "prefill_window", "GREEDY", "SamplerConfig",
    "sample_next_token", "DegradedLadder", "SchedulerConfig", "TokenBudgetScheduler",
    "SlotState",
]
