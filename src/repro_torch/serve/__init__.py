"""Serving stack (port of ``repro.serve``: blocking admission on the dense
and paged KV layouts)."""
from repro_torch.serve.decode_loop import make_fused_decode, unfused_decode
from repro_torch.serve.engine import (
    RequestOutput, ServeConfig, ServeEngine, attn_kernel_reject_reason, kv_quant_reject_reason,
)
from repro_torch.serve.faults import NonFiniteLogitsError
from repro_torch.serve.prefill import (
    full_seq_packable, pack_prompts, packed_prefill, prefill_full_seq, prefill_paged_suffix,
    prefill_scan,
)
from repro_torch.serve.sampling import GREEDY, SamplerConfig, sample_next_token

__all__ = [
    "make_fused_decode", "unfused_decode", "RequestOutput", "ServeConfig", "ServeEngine",
    "attn_kernel_reject_reason", "kv_quant_reject_reason", "NonFiniteLogitsError",
    "full_seq_packable", "pack_prompts", "packed_prefill", "prefill_full_seq",
    "prefill_paged_suffix", "prefill_scan", "GREEDY", "SamplerConfig", "sample_next_token",
]
