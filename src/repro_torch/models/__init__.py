"""The decoder stack (port of ``repro.models``: ``attn`` blocks only)."""
from repro_torch.models.model import Model
from repro_torch.models.transformer import ModelOptions

__all__ = ["Model", "ModelOptions"]
