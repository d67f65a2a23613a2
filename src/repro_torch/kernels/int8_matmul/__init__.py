from repro_torch.kernels.int8_matmul.ops import int8_gemm, int8_gemm_batched, int8_matmul_t

__all__ = ["int8_gemm", "int8_gemm_batched", "int8_matmul_t"]
