"""Serving stack (port of ``repro.serve``: blocking and chunked admission
on the dense and paged KV layouts, the degraded-mode ladder, per-request
ASTRA accounting, fault injection and its supervisor, and the open-loop
front-end that ``repro_torch.traffic`` replays traces through)."""
from repro_torch.serve.accounting import (
    RequestHardwareReport, RequestTiming, request_hardware_report,
)
from repro_torch.serve.decode_loop import make_fused_decode, unfused_decode
from repro_torch.serve.engine import (
    Request, RequestOutput, ServeConfig, ServeEngine, attn_kernel_reject_reason,
    kv_quant_reject_reason,
)
from repro_torch.serve.faults import (
    CANCELLED, DEADLINE_EXCEEDED, FAULT_KINDS, FAULT_POOL_PRESSURE, RETRYABLE_FAULTS,
    FaultSpec, InjectedStepError, NonFiniteLogitsError, ServeFault, ServeFaultInjector,
)
from repro_torch.serve.frontend import (
    REJECT_QUEUE_FULL, REJECT_QUEUE_TIMEOUT, FrontendConfig, ServeFrontend, TokenStream,
)
from repro_torch.serve.kv_pool import KVBlockPool
from repro_torch.serve.prefill import (
    full_seq_packable, pack_prompts, packed_prefill, prefill_full_seq, prefill_paged_suffix,
    prefill_scan, prefill_window,
)
from repro_torch.serve.prefix_tree import RadixPrefixTree
from repro_torch.serve.sampling import GREEDY, SamplerConfig, sample_next_token
from repro_torch.serve.scheduler import DegradedLadder, SchedulerConfig, TokenBudgetScheduler
from repro_torch.serve.slots import SlotState
from repro_torch.serve.supervisor import EngineSupervisor

__all__ = [
    "CANCELLED", "DEADLINE_EXCEEDED", "DegradedLadder", "EngineSupervisor", "FAULT_KINDS",
    "FAULT_POOL_PRESSURE", "FaultSpec", "FrontendConfig", "GREEDY", "InjectedStepError",
    "KVBlockPool", "NonFiniteLogitsError", "REJECT_QUEUE_FULL", "REJECT_QUEUE_TIMEOUT",
    "RETRYABLE_FAULTS", "RadixPrefixTree", "Request", "RequestHardwareReport",
    "RequestOutput", "RequestTiming", "SamplerConfig", "SchedulerConfig", "ServeConfig",
    "ServeEngine", "ServeFault", "ServeFaultInjector", "ServeFrontend", "SlotState",
    "TokenBudgetScheduler", "TokenStream", "attn_kernel_reject_reason", "full_seq_packable",
    "kv_quant_reject_reason", "make_fused_decode", "pack_prompts", "packed_prefill",
    "prefill_full_seq", "prefill_paged_suffix", "prefill_scan", "prefill_window",
    "request_hardware_report", "sample_next_token", "unfused_decode",
]
