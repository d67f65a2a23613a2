from repro_torch.kernels.paged_attention.ops import (
    paged_attention_decode, paged_attention_prefill,
)

__all__ = ["paged_attention_decode", "paged_attention_prefill"]
