from repro_torch.kernels.paged_attention.ops import (
    dense_attention_decode, paged_attention_decode, paged_attention_prefill,
)

__all__ = ["dense_attention_decode", "paged_attention_decode", "paged_attention_prefill"]
