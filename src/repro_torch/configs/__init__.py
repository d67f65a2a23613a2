"""Config registry: ``get_arch(id)`` / ``ARCHS`` / shapes."""
from repro_torch.configs.base import ArchConfig, MoEConfig, ShapeConfig, SHAPES, shape_applicable
from repro_torch.configs.stablelm_1_6b import CONFIG as _stablelm
from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen110b
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen05b
from repro_torch.configs.qwen2_5_32b import CONFIG as _qwen32b
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rg2b
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.llama3_2_vision_90b import CONFIG as _llamav
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite
from repro_torch.configs.paper_models import PAPER_MODELS, PAPER_SEQ_LEN

ARCHS = {
    c.name: c
    for c in (
        _stablelm, _qwen110b, _qwen05b, _qwen32b, _rg2b,
        _xlstm, _musicgen, _llamav, _qwen3moe, _granite,
    )
}

ALL_MODELS = dict(ARCHS)
ALL_MODELS.update(PAPER_MODELS)


def get_arch(name: str) -> ArchConfig:
    if name not in ALL_MODELS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ALL_MODELS)}")
    return ALL_MODELS[name]


__all__ = [
    "ArchConfig", "MoEConfig", "ShapeConfig", "SHAPES", "shape_applicable",
    "ARCHS", "ALL_MODELS", "PAPER_MODELS", "PAPER_SEQ_LEN", "get_arch",
]
