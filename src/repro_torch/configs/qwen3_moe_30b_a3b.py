"""qwen3-moe-30b-a3b — [moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768, vocab=151936.

MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].  d_ff=768 is the
per-expert (moe_intermediate) width; head_dim=128 per the HF config
(q-proj 2048 -> 4096).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151_936,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768),
    qkv_bias=False,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
