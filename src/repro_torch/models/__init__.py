"""The decoder stack (port of ``repro.models``: attention, RG-LRU and xLSTM
blocks, dense and mixture-of-experts MLPs)."""
from repro_torch.models.model import Model
from repro_torch.models.transformer import ModelOptions

__all__ = ["Model", "ModelOptions"]
