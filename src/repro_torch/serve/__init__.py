"""Serving stack (port of ``repro.serve``: paged blocking admission)."""
from repro_torch.serve.decode_loop import make_fused_decode, unfused_decode
from repro_torch.serve.engine import RequestOutput, ServeConfig, ServeEngine
from repro_torch.serve.prefill import pack_prompts, prefill_paged_suffix
from repro_torch.serve.sampling import GREEDY, SamplerConfig, sample_next_token

__all__ = [
    "make_fused_decode", "unfused_decode", "RequestOutput", "ServeConfig", "ServeEngine",
    "pack_prompts", "prefill_paged_suffix", "GREEDY", "SamplerConfig", "sample_next_token",
]
