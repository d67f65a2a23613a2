from repro_torch.kernels.stoch_matmul.ops import stoch_matmul, stoch_matmul_packed

__all__ = ["stoch_matmul", "stoch_matmul_packed"]
