"""granite-moe-1b-a400m — [moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512, vocab=49155.

MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
d_ff=512 is the per-expert width.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49_155,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
