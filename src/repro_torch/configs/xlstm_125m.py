"""xlstm-125m — [ssm] 12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304.

sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].  d_ff=0: xLSTM blocks
carry their own up/down projections (mLSTM: 2x expansion; sLSTM: gated FFN
inside the block).  We use a 3:1 mLSTM:sLSTM repeating unit (12 layers = 3
units), following the paper's mLSTM-dominant LM recipes.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab=50_304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    source="arXiv:2405.04517; unverified",
)
