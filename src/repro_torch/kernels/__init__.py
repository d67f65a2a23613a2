"""Hand-written Hopper kernels for the port's hot path.

Each subpackage holds ``csrc/*.cu`` (CUDA C++ for ``sm_90a``, built with
``nvcc`` into a plain-C shared library and bound with ctypes — see
``_build``), ``ops.py`` (the public wrapper: checks, launch, a launch
counter) and ``ref.py`` (the plain PyTorch version of the same function).
On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.

* ``int8_matmul``     — int8 x int8 -> int32 GEMM on the tensor cores,
  one product or a batch of them per launch; one product runs on
  ``wgmma`` with TMA-fed tiles at admission and streams the weight at
  decode, a batch of products of at most 16 rows streams each product's
  second operand in a block of its own and a batch of larger products
  runs a block a tile of 32 rows by up to 256 columns
  (``csrc/int8_gemm_sm90.cu``, its own library); a K that is not a
  multiple of 16 (or, batched, past 4096) runs on ``mma.sync`` tiles
  (replaces ``repro.kernels.int8_matmul``)
* ``paged_attention`` — single-query decode over dense per-slot caches
  and through the paged pool's block table, one kernel for both layouts:
  each (slot, KV head)'s keys split across blocks (``decode_split_plan``)
  and the splits' partial softmax states merged by a second kernel
  (``csrc/decode.cu``; replaces ``dense_attention_kernel`` and the decode
  mode of ``paged_attention_kernel``), and causal suffix prefill through
  the block table (``csrc/paged_prefill.cu``, the causal mode of
  ``repro.kernels.paged_attention.paged_attention_kernel``)
* ``flash_attention`` — streaming-softmax attention over full sequences,
  causal with an optional sliding window, GQA folded over the query axis
  (bf16 on ``wgmma`` with K/V tiles brought by TMA, float32 on FMA tiles):
  the dense layout's prefill (replaces ``repro.kernels.flash_attention``)
* ``bts_encode``      — the B-to-S encoder: int8 codes -> packed 128-bit
  stochastic streams and signs, the packed operands of
  ``stoch_matmul_packed`` / ``stoch_matmul_codes``; the serving path
  launches it nowhere, since the stochastic GEMM reads codes
  (replaces ``repro.kernels.bts_encode``)
* ``stoch_matmul``    — the OSSM array: AND, popcount and signed sum of
  streams.  On the serving path both operands are int8 codes, each
  expanded to sign planes of its stream from a table while it is staged,
  the signed popcounts summed by the binary tensor cores (``mma.sync``
  at decode, ``wgmma`` at admission; ``csrc/stoch_gemm_sm90.cu``, its own
  library); the reference's packed interface and codes against packed
  weight streams run a CUDA-core kernel (``csrc/stoch_matmul.cu``)
  (replaces ``repro.kernels.stoch_matmul``)
* ``rglru_scan``      — the linear recurrence ``h_t = a_t h_{t-1} + b_t``
  of the RG-LRU prefill, parallel over the sequence too: chunks staged by
  ``cp.async``, each warp's run of steps scanned in registers, the runs'
  carries folded through shared memory, one pass over the bytes
  (replaces ``repro.kernels.rglru_scan``)

``kernel_wrappers``, ``reset_launches`` and ``launch_counts`` read and
clear every wrapper's launch counter, so a harness can count what one
run launched.  The paged-attention wrappers' launches on int8 pools (the
kernel's dequantizing branch) are also counted apart, as
``paged_attention_decode_int8`` and ``paged_attention_prefill_int8``, and
``int8_gemm``'s launches by the kernel they took, as ``int8_gemm_wgmma``,
``int8_gemm_stream`` and ``int8_gemm_mma``, ``int8_gemm_batched``'s as
``int8_gemm_batched_stream``, ``int8_gemm_batched_tiles`` and
``int8_gemm_batched_mma``, and those of
the binary stochastic GEMM's entries as ``stoch_gemm_codes_stream`` /
``_wgmma`` and ``stoch_matmul_codes_batched_stream`` / ``_wgmma``, and
``rglru_scan``'s by the sequence length they took, as ``rglru_scan_s<S>``
(a key for each length launched since the last reset), and its backward
launches (the same kernel over the reversed sequence) also apart, as
``rglru_scan_backward``.

``rglru_scan`` is the one kernel with a gradient (a
``torch.autograd.Function``).  Every other wrapper calls
:func:`refuse_grad` before it picks the device, so on the CPU and on the
card alike it raises when autograd would record it with an input that
requires grad, instead of returning a tensor cut from the graph.  Its
integer operands never require grad, so the quantized paths are refused
where the codes are made from float tensors: ``core.quant.quantize`` and
the entries that dequantize (``int8_matmul_t``, ``stoch_matmul``).
"""
import torch

# wrappers that also count their launches by kernel (``paths``)
PATH_COUNTED = ("int8_gemm", "int8_gemm_batched", "stoch_gemm_codes",
                "stoch_matmul_codes_batched")
# counters of a wrapper's int8-pool branch -> the wrapper that keeps them
INT8_BRANCHES = {"paged_attention_decode_int8": "paged_attention_decode",
                 "paged_attention_prefill_int8": "paged_attention_prefill"}


def refuse_grad(what: str, *tensors) -> None:
    """Raise when grad is enabled and one of ``tensors`` (None allowed)
    requires grad: the kernel has no backward, and its output would leave
    the graph without a word."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward, and an input requires grad: training runs the "
            "plain attention (attn_impl='naive') under the exact plan")


def kernel_wrappers() -> dict:
    """Every counted kernel wrapper, by name."""
    from repro_torch.kernels.bts_encode.ops import bts_encode
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.int8_matmul.ops import int8_gemm, int8_gemm_batched
    from repro_torch.kernels.paged_attention.ops import (
        dense_attention_decode, paged_attention_decode, paged_attention_prefill,
    )
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.stoch_matmul.ops import (
        stoch_gemm_codes, stoch_matmul_codes, stoch_matmul_codes_batched, stoch_matmul_packed,
    )
    return {
        "paged_attention_decode": paged_attention_decode,
        "paged_attention_prefill": paged_attention_prefill,
        "dense_attention_decode": dense_attention_decode,
        "flash_attention": flash_attention,
        "int8_gemm": int8_gemm,
        "int8_gemm_batched": int8_gemm_batched,
        "bts_encode": bts_encode,
        "stoch_matmul_packed": stoch_matmul_packed,
        "stoch_matmul_codes": stoch_matmul_codes,
        "stoch_matmul_codes_batched": stoch_matmul_codes_batched,
        "stoch_gemm_codes": stoch_gemm_codes,
        "rglru_scan": rglru_scan,
    }


def reset_launches() -> None:
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for parent in INT8_BRANCHES.values():
        wrappers[parent].int8_launches = 0
    for name in PATH_COUNTED:
        paths = wrappers[name].paths
        for path in paths:
            paths[path] = 0
    wrappers["rglru_scan"].lengths.clear()
    wrappers["rglru_scan"].backward_launches = 0


def launch_counts() -> dict:
    wrappers = kernel_wrappers()
    counts = {name: fn.launches for name, fn in wrappers.items()}
    counts.update({name: wrappers[parent].int8_launches
                   for name, parent in INT8_BRANCHES.items()})
    for name in PATH_COUNTED:
        counts.update({f"{name}_{path}": c for path, c in wrappers[name].paths.items()})
    counts.update({f"rglru_scan_s{s}": c for s, c in wrappers["rglru_scan"].lengths.items()})
    counts["rglru_scan_backward"] = wrappers["rglru_scan"].backward_launches
    return counts
