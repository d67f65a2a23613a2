"""stablelm-1.6b — [dense] 24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.

[hf:stabilityai/stablelm-2-1_6b; unverified]. StableLM-2 details: partial
rotary (25%), LayerNorm, SiLU-gated MLP, no QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab=100_352,
    qkv_bias=False,
    rope_pct=0.25,
    norm="layernorm",
    act="swiglu",
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
