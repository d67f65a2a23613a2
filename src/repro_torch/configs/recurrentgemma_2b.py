"""recurrentgemma-2b — [hybrid] 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.

RG-LRU + local attention, 1 attn : 2 recurrent [arXiv:2402.19427; hf].
Griffin pattern (rec, rec, local-MQA); 26 layers = 8 full units + 2 recurrent
remainder.  head_dim=256 (MQA), GeGLU MLP, sliding window 2048,
attention-logit softcap per Griffin.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    d_rnn=2560,
    conv_width=4,
    norm="rmsnorm",
    act="geglu",
    logit_softcap=0.0,
    tie_embeddings=True,
    source="arXiv:2402.19427; hf",
)
