"""llama-3.2-vision-90b — [vlm] 100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

Cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; unverified].
100 decoder layers with a cross-attention layer every 5th (20 xattn layers),
matching the 90B layout.  The vision tower is a STUB per the assignment —
``input_specs()`` provides precomputed patch embeddings
(B, vision_tokens, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab=128_256,
    block_pattern=("attn", "attn", "attn", "attn", "xattn"),
    vision_tokens=6_404,  # 4 tiles x 1601 patches
    norm="rmsnorm",
    act="swiglu",
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
