"""Hand-written Hopper kernels for the port's hot path.

Each subpackage holds ``csrc/*.cu`` (CUDA C++ for ``sm_90a``, built with
``nvcc`` into a plain-C shared library and bound with ctypes — see
``_build``), ``ops.py`` (the public wrapper: checks, launch, a launch
counter) and ``ref.py`` (the plain PyTorch version of the same function).
On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.

* ``int8_matmul``     — int8 x int8 -> int32 GEMM on the tensor cores
  (replaces ``repro.kernels.int8_matmul``)
* ``paged_attention`` — streaming-softmax decode and causal suffix
  prefill straight from the paged KV pool through the block table
  (replaces ``repro.kernels.paged_attention.paged_attention_kernel``)

``kernel_wrappers``, ``reset_launches`` and ``launch_counts`` read and
clear every wrapper's launch counter, so a harness can count what one
run launched.
"""


def kernel_wrappers() -> dict:
    """Every counted kernel wrapper, by name."""
    from repro_torch.kernels.int8_matmul.ops import int8_gemm
    from repro_torch.kernels.paged_attention.ops import (
        paged_attention_decode, paged_attention_prefill,
    )
    return {
        "paged_attention_decode": paged_attention_decode,
        "paged_attention_prefill": paged_attention_prefill,
        "int8_gemm": int8_gemm,
    }


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
