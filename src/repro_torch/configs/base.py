"""Architecture configuration system.

Every selectable architecture (``--arch <id>``) is described by an
:class:`ArchConfig`.  The model builder in ``repro_torch.models.model`` consumes
these declaratively — adding an architecture means adding a config file, not
new model code.

Block kinds (``block_pattern`` is the repeating unit; layers are
``pattern * (n_layers // len(pattern)) + pattern[:remainder]``):

* ``attn``   — global causal self-attention (GQA) + MLP/MoE
* ``local``  — sliding-window causal self-attention + MLP
* ``xattn``  — cross-attention to frontend embeddings + MLP (VLM)
* ``rglru``  — Griffin/RecurrentGemma recurrent block (conv1d + RG-LRU) + MLP
* ``mlstm``  — xLSTM mLSTM block (matrix memory, parallelizable)
* ``slstm``  — xLSTM sLSTM block (scalar memory, sequential scan)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

VALID_BLOCKS = ("attn", "local", "xattn", "rglru", "mlstm", "slstm")
VALID_FAMILIES = ("dense", "hybrid", "ssm", "audio", "vlm", "moe")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN replacing the dense MLP in every block."""

    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | hybrid | ssm | audio | vlm | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    block_pattern: Tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    # attention details
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0  # stablelm-2 uses partial rotary (25%)
    window: int = 0  # sliding-window size for "local" blocks
    logit_softcap: float = 0.0
    # norms / activations
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    act: str = "swiglu"  # swiglu | geglu | gelu
    tie_embeddings: bool = False
    # modality frontends (stubs per assignment: precomputed embeddings)
    n_codebooks: int = 0  # audio: EnCodec token grid (B, n_codebooks, S)
    vision_tokens: int = 0  # vlm: precomputed patch embeds (B, vision_tokens, d_model)
    # recurrent widths
    d_rnn: int = 0  # RG-LRU width (0 -> d_model)
    conv_width: int = 4  # Griffin temporal conv width
    # numerics
    dtype: str = "bfloat16"
    # bookkeeping
    source: str = ""  # provenance tag from the assignment table

    def __post_init__(self):
        assert self.family in VALID_FAMILIES, self.family
        for b in self.block_pattern:
            assert b in VALID_BLOCKS, b
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.d_rnn == 0:
            object.__setattr__(self, "d_rnn", self.d_model)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, "GQA group size"

    # ------------------------------------------------------------------
    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds, pattern repeated/truncated to n_layers."""
        p = self.block_pattern
        reps = (self.n_layers + len(p) - 1) // len(p)
        return tuple((p * reps)[: self.n_layers])

    @property
    def n_pattern_units(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def n_remainder_layers(self) -> int:
        return self.n_layers - self.n_pattern_units * len(self.block_pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def token_lead(self) -> Tuple[int, ...]:
        """The axes before a token sequence's length: ``(n_codebooks,)``
        for a multi-codebook model (``[C, S]`` grids), else ``()``."""
        return (self.n_codebooks,) if self.n_codebooks else ()

    @property
    def is_subquadratic(self) -> bool:
        """True if decode state is bounded (no full-seq KV cache)."""
        return all(k in ("rglru", "mlstm", "slstm", "local") for k in self.layer_kinds)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += d * v * max(1, self.n_codebooks or 1)  # lm head(s)
        if self.n_codebooks:
            n += (self.n_codebooks - 1) * v * d  # extra codebook embeddings
        for kind in self.layer_kinds:
            n += self._block_params(kind)
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        per_expert = 3 * self.d_model * m.d_expert
        dead = (m.n_experts - m.top_k) * per_expert * self.n_layers
        return self.param_count() - dead

    def _block_params(self, kind: str) -> int:
        d = self.d_model
        n = 2 * d  # two norms
        if kind in ("attn", "local", "xattn"):
            n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                n += self.q_dim + 2 * self.kv_dim
        elif kind == "rglru":
            r = self.d_rnn
            n += d * 2 * r + r * self.conv_width + 2 * r + r * d  # proj,conv,lru,out
        elif kind == "mlstm":
            # up-proj (2x expand), q/k/v projs in expanded space, gates, down
            e = 2 * d
            n += d * 2 * e + 3 * e * e // 4 + 2 * e + e * d
        elif kind == "slstm":
            h = d
            n += 4 * d * h + 4 * h * h // max(self.n_heads, 1) + 4 * h + 2 * d * h
        if kind in ("attn", "local", "xattn"):
            if self.moe is not None:
                m = self.moe
                n += d * m.n_experts  # router
                n += m.n_experts * 3 * d * m.d_expert
            elif self.d_ff > 0:
                mult = 3 if self.act in ("swiglu", "geglu") else 2
                n += mult * d * self.d_ff
        elif kind in ("rglru",) and self.d_ff > 0:
            mult = 3 if self.act in ("swiglu", "geglu") else 2
            n += mult * d * self.d_ff
        return n

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=max(len(self.block_pattern), 2 if self.n_remainder_layers else len(self.block_pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            window=min(self.window, 32) if self.window else 0,
            d_rnn=64,
            vision_tokens=16 if self.vision_tokens else 0,
            moe=None
            if self.moe is None
            else dataclasses.replace(self.moe, n_experts=4, top_k=2, d_expert=32),
            name=self.name + "-smoke",
        )
        # keep enough layers to exercise the full pattern incl. remainder
        if self.n_remainder_layers:
            small["n_layers"] = len(self.block_pattern) + self.n_remainder_layers
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell is defined, and why not if skipped."""
    if shape.name == "long_500k" and not arch.is_subquadratic:
        return False, "long_500k needs sub-quadratic attention; %s is full-attention" % arch.name
    return True, ""
