"""musicgen-large — [audio] 48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048.

Decoder-only over EnCodec tokens [arXiv:2306.05284; hf].  4 RVQ codebooks:
input embedding is the sum of 4 codebook embeddings; output is 4 parallel
LM heads (delay interleaving handled by the data pipeline).  The EnCodec
modality frontend is a STUB per the assignment — ``input_specs()`` provides
the precomputed token grid (B, 4, S).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    n_codebooks=4,
    norm="layernorm",
    act="gelu",
    source="arXiv:2306.05284; hf",
)
