"""The five transformer models ASTRA evaluates (paper §III).

Transformer-base, BERT-base, ALBERT-base, ViT-base, OPT-350M.  These drive
the paper-reproduction benchmarks (accuracy, Figs 4-6); they are *additional*
to the ten assigned architectures.  Encoder models (BERT/ALBERT/ViT) are
run as bidirectional encoders by the simulator (no causal mask, no decode).
"""
from repro_torch.configs.base import ArchConfig

# Vaswani et al. 2017, base: 6 enc + 6 dec; ASTRA maps the matmul workload,
# we model it as 12 layers of d=512.
TRANSFORMER_BASE = ArchConfig(
    name="transformer-base", family="dense", n_layers=12, d_model=512,
    n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048, vocab=37_000,
    norm="layernorm", act="gelu", source="Vaswani et al. 2017",
)

BERT_BASE = ArchConfig(
    name="bert-base", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab=30_522,
    norm="layernorm", act="gelu", source="Devlin et al. 2019",
)

# ALBERT shares one layer's params across 12 steps; compute equals BERT-base,
# parameters ~12x smaller — the simulator distinguishes weight *reads* from
# unique weights via `weight_sharing_factor`.
ALBERT_BASE = ArchConfig(
    name="albert-base", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab=30_000,
    norm="layernorm", act="gelu", source="Lan et al. 2020",
)

# ViT-base/16: 224x224 -> 196 patches + cls.
VIT_BASE = ArchConfig(
    name="vit-base", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab=1_000,
    norm="layernorm", act="gelu", source="Dosovitskiy et al. 2021",
)

OPT_350M = ArchConfig(
    name="opt-350m", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab=50_272,
    norm="layernorm", act="gelu", source="Zhang et al. 2022",
)

PAPER_MODELS = {
    m.name: m for m in (TRANSFORMER_BASE, BERT_BASE, ALBERT_BASE, VIT_BASE, OPT_350M)
}

# Workload sequence lengths used by the paper's inference evaluation
# (typical published settings for each model family).
PAPER_SEQ_LEN = {
    "transformer-base": 128,
    "bert-base": 128,
    "albert-base": 128,
    "vit-base": 197,
    "opt-350m": 512,
}
