"""Serving stack (port of ``repro.serve``: blocking admission on the dense
and paged KV layouts)."""
from repro_torch.serve.decode_loop import make_fused_decode, unfused_decode
from repro_torch.serve.engine import (
    RequestOutput, ServeConfig, ServeEngine, kv_quant_reject_reason,
)
from repro_torch.serve.prefill import pack_prompts, prefill_full_seq, prefill_paged_suffix
from repro_torch.serve.sampling import GREEDY, SamplerConfig, sample_next_token

__all__ = [
    "make_fused_decode", "unfused_decode", "RequestOutput", "ServeConfig", "ServeEngine",
    "kv_quant_reject_reason",
    "pack_prompts", "prefill_full_seq", "prefill_paged_suffix", "GREEDY", "SamplerConfig",
    "sample_next_token",
]
