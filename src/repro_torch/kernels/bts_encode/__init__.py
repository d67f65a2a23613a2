from repro_torch.kernels.bts_encode.ops import bts_encode

__all__ = ["bts_encode"]
