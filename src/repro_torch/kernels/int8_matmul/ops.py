"""Public wrappers of the int8 GEMM kernels: checks, launch, dequantization.

``int8_gemm`` is the launch point of one product and ``int8_gemm_batched``
of a batch of independent products in one launch (the attention qk/pv
products of every slot and KV head under a quantized plan); each carries
its own launch counter.  One product takes one of three kernels, chosen
by :func:`int8_gemm_plan` from the shapes alone: ``"wgmma"`` (wgmma on
TMA-fed tiles, admissions) and ``"stream"`` (the weight streamed past at
most 16 activation rows, decode) from ``csrc/int8_gemm_sm90.cu``, and
``"mma"`` (``csrc/int8_matmul.cu``) for a K that is not a multiple of 16.
A batch takes one of three, chosen by :func:`int8_batched_plan`:
``"stream"`` (each block streams one whole product past its at most 16
rows, decode) or ``"tiles"`` (a block a tile of 32 rows by up to 256
columns, all of its K in flight at once and its output written as whole
rows, admissions), both ``csrc/int8_gemm_sm90.cu``, or ``"mma"``
(``csrc/int8_matmul.cu``) for a K that is not a multiple of 16 or past
4096.  ``launches`` counts every launch of an entry and ``paths`` each
kernel's.  ``int8_matmul_t`` takes
the weight pre-transposed ``[N, K]`` as the model caches it, so both
operands are K-contiguous.  Dequantization is ``(acc * xs) * ws`` in
float32, the reference's order.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from repro_torch.core.quant import QTensor
from repro_torch.kernels import _build
from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref

_BK = 64  # the mma kernel's K step; its split-K chunks are multiples of it
# (BM, BN) of the mma kernel's two tile configurations, indexed by ``cfg``
_TILES = {0: (16, 64), 1: (64, 128)}
# int8_gemm_sm90.cu: the wgmma kernel's output tile and K step, and the
# stream kernel's weight rows per block
_WG_BM, _WG_BN, _WG_BK = 128, 128, 128
_ST_BN = 16
# The wgmma kernel's K split, priced in its own 128-byte K steps (about
# 0.55 us each for a block when the tiles fill few SMs): a split costs a
# fixed 4.5 steps (the zeroed output's launch) and one step per 82,000
# int32 atomic adds (the output elements times the splits).  Fitted to an
# H100's readings of chip_smoke.py's "short admission" lines, M 64 and 256
# at the serving (K, N); the rule picks the faster of the two at each.
_SPLIT_FIXED_STEPS = 4.5
_SPLIT_ATOMICS_PER_STEP = 82_000
PATHS = ("wgmma", "stream", "mma")
# ctypes signatures: pointers and the stream as c_void_p, sizes as c_int
_P, _I = ctypes.c_void_p, ctypes.c_int
_BATCHED_ARGS = [_P] * 3 + [_I] * 7 + [_P]
_WGMMA_ARGS = [_P] * 3 + [_I] * 5 + [_P]
_STREAM_ARGS = [_P] * 3 + [_I] * 3 + [_P]
_BATCHED_SM90_ARGS = [_P] * 3 + [_I] * 4 + [_P]
BATCHED_PATHS = ("stream", "tiles", "mma")
# the batched stream and tiles kernels' longest K: a product's X rows and
# two chunks of 16 weight rows in flight stay within a block's shared
# memory, and a tile's K stages stay few
_BT_MAX_K = 4096


def _fn(lib_name: str, sym: str, argtypes):
    fn = getattr(_build.load(lib_name), sym)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _lib():
    return _fn("int8_matmul", "int8_gemm_batched_launch", _BATCHED_ARGS)


def split_plan(m: int, n: int, k: int, n_sm: int, batch: int = 1):
    """The mma kernel's (tile config, K elements per split, number of
    splits).  Small M (decode) takes the 16-row tile; K is split when the
    output tiles of all ``batch`` products cannot give every SM two
    blocks."""
    cfg = 0 if m <= 16 else 1
    bm, bn = _TILES[cfg]
    return (cfg, *_build.split_k(batch * -(-m // bm) * -(-n // bn), k, _BK, 2 * n_sm))


@dataclasses.dataclass(frozen=True)
class Int8GemmPlan:
    """How one product ``[M, K] x [N, K]`` runs: the kernel (``path``), its
    grid, and K cut into ``splits`` ranges of ``kps`` elements (the last
    one shorter).  ``cfg`` is the mma kernel's tile configuration."""
    path: str
    grid: Tuple[int, int, int]
    kps: int
    splits: int
    cfg: int = 1


def int8_gemm_plan(m: int, n: int, k: int, n_sm: int) -> Int8GemmPlan:
    """The kernel and grid of one product, from the shapes alone (no host
    sync, no trial launch).  K % 16 == 0 (the 16-byte row pitch TMA and
    16-byte copies need): ``"stream"`` for M <= 16, one block per 16
    weight rows, whose four warps split K among them (K is never split over
    blocks).  ``"wgmma"`` for M > 16 on 128 x 128 tiles, K split over
    about one block per SM only when the tiles are fewer than the SMs and
    the K steps a block no longer walks outweigh the split's cost (a zeroed
    output and an int32 atomic add per output element per split).  Any
    other K: ``"mma"``."""
    if k % 16 == 0 and m <= 16:
        return Int8GemmPlan("stream", (_cdiv(n, _ST_BN), 1, 1), k, 1)
    if k % 16 == 0:
        split = wgmma_plan(m, n, k, n_sm)
        saved = _cdiv(k, _WG_BK) - _cdiv(split.kps, _WG_BK)
        cost = _SPLIT_FIXED_STEPS + m * n * split.splits / _SPLIT_ATOMICS_PER_STEP
        return split if split.splits > 1 and saved > cost else wgmma_plan(m, n, k, 0)
    cfg, kps, splits = split_plan(m, n, k, n_sm)
    bm, bn = _TILES[cfg]
    return Int8GemmPlan("mma", (_cdiv(n, bn), _cdiv(m, bm), splits), kps, splits, cfg)


def wgmma_plan(m: int, n: int, k: int, want: int) -> Int8GemmPlan:
    """The wgmma kernel's plan for ``[M, K] x [N, K]`` with K split until
    the grid reaches ``want`` blocks (0: unsplit); each split is whole
    128-byte steps, at least two of them."""
    tiles_m, tiles_n = _cdiv(m, _WG_BM), _cdiv(n, _WG_BN)
    kps, splits = _build.split_k(tiles_m * tiles_n, k, _WG_BK, want)
    return Int8GemmPlan("wgmma", (tiles_m, tiles_n, splits), kps, splits)


def int8_batched_plan(m: int, n: int, k: int) -> str:
    """The kernel of a batch of products ``[M, K] x [N, K]``, from the
    shapes alone.  K a multiple of 16 up to 4096: ``"stream"`` (a block a
    product, its second operand streamed past the at most 16 rows of the
    first; the decode qk/pv products) for M <= 16, ``"tiles"`` (a block a
    tile of 32 rows by up to 256 columns, ``ref.int8_batched_tiles_ref``;
    the admissions) for M > 16.  Any other K: ``"mma"`` (16 x 64 or 64 x 128
    ``mma.sync`` tiles, K split when the tiles are few)."""
    if k % 16 or k > _BT_MAX_K:
        return "mma"
    return "stream" if m <= 16 else "tiles"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _operands(x: torch.Tensor, w_t: torch.Tensor, what: str):
    """Device and type checks; both operands contiguous with 16-byte
    aligned starts (the kernels read 16-byte vectors)."""
    if x.device.type != "cuda" or w_t.device != x.device:
        raise ValueError(f"{what}: operands on {x.device} and {w_t.device}; "
                         "both must be on the same CUDA device (or both on the CPU)")
    if x.dtype != torch.int8 or w_t.dtype != torch.int8:
        raise TypeError(f"{what} takes int8 operands, got {x.dtype} and {w_t.dtype}")
    return _build.aligned(x), _build.aligned(w_t)


def _launch(x: torch.Tensor, w_t: torch.Tensor, what: str) -> torch.Tensor:
    """Checks and one launch of the mma kernel over ``x [B, M, K]``,
    ``w_t [B, N, K]``."""
    x, w_t = _operands(x, w_t, what)
    b, m, k = x.shape
    n = w_t.shape[1]
    cfg, kps, splits = split_plan(m, n, k, _build.sm_count(x.device.index), b)
    if b * splits > 65535:  # gridDim.z
        raise ValueError(f"{what}: batch {b} x {splits} K splits exceeds the grid")
    out = (torch.zeros if splits > 1 else torch.empty)((b, m, n), dtype=torch.int32,
                                                        device=x.device)
    if out.numel() == 0:
        return out
    rc = _lib()(x.data_ptr(), w_t.data_ptr(), out.data_ptr(), b, m, n, k, kps, splits, cfg,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, what)
    return out


def int8_gemm(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """int8 ``x [M, K]`` x int8 ``w_t [N, K]`` -> int32 ``[M, N]``: one
    launch of the kernel :func:`int8_gemm_plan` picks."""
    if x.dim() != 2 or w_t.dim() != 2 or x.shape[1] != w_t.shape[1]:
        raise ValueError(f"int8_gemm: shapes {tuple(x.shape)} x {tuple(w_t.shape)} "
                         "are not [M, K] x [N, K]")
    if x.device.type == "cpu" and w_t.device.type == "cpu":
        return int8_matmul_acc_ref(x, w_t)
    x, w_t = _operands(x, w_t, "int8_gemm")
    (m, k), n = x.shape, w_t.shape[0]
    return run_plan(x, w_t, int8_gemm_plan(m, n, k, _build.sm_count(x.device.index)))


def run_plan(x: torch.Tensor, w_t: torch.Tensor, plan: Int8GemmPlan) -> torch.Tensor:
    """One launch of ``plan``'s kernel over CUDA operands ``x [M, K]``,
    ``w_t [N, K]`` as :func:`int8_gemm` passes them (contiguous, 16-byte
    aligned): the plan :func:`int8_gemm_plan` picks, or another plan of the
    same product (a timing of one split count against another)."""
    (m, k), n = x.shape, w_t.shape[0]
    if plan.path == "mma":
        out = _launch(x[None], w_t[None], "int8_gemm")[0]
    else:
        zeroed = plan.path == "wgmma" and plan.splits > 1  # wgmma splits meet by atomics
        out = (torch.zeros if zeroed else torch.empty)((m, n), dtype=torch.int32,
                                                        device=x.device)
        if out.numel() == 0:
            return out
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.path == "wgmma":
            rc = _fn("int8_gemm_sm90", "int8_gemm_wgmma_launch", _WGMMA_ARGS)(
                x.data_ptr(), w_t.data_ptr(), out.data_ptr(), m, n, k, plan.kps, plan.splits,
                stream)
        else:
            rc = _fn("int8_gemm_sm90", "int8_gemm_stream_launch", _STREAM_ARGS)(
                x.data_ptr(), w_t.data_ptr(), out.data_ptr(), m, n, k, stream)
        _build.check(rc, "int8_gemm")
    if out.numel():
        int8_gemm.launches += 1
        int8_gemm.paths[plan.path] += 1
    return out


int8_gemm.launches = 0
int8_gemm.paths = dict.fromkeys(PATHS, 0)


def int8_gemm_batched(x: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """int8 ``x [B, M, K]`` x int8 ``w_t [B, N, K]`` -> int32 ``[B, M, N]``:
    B independent products in one launch of the kernel
    :func:`int8_batched_plan` picks."""
    if (x.dim() != 3 or w_t.dim() != 3 or x.shape[0] != w_t.shape[0]
            or x.shape[2] != w_t.shape[2]):
        raise ValueError(f"int8_gemm_batched: shapes {tuple(x.shape)} x {tuple(w_t.shape)} "
                         "are not [B, M, K] x [B, N, K]")
    if x.device.type == "cpu" and w_t.device.type == "cpu":
        return int8_matmul_acc_ref(x, w_t)
    (b, m, k), n = x.shape, w_t.shape[1]
    path = int8_batched_plan(m, n, k)
    if path == "mma":
        out = _launch(x, w_t, "int8_gemm_batched")
    else:
        x, w_t = _operands(x, w_t, "int8_gemm_batched")
        out = torch.empty((b, m, n), dtype=torch.int32, device=x.device)
        if out.numel():
            rc = _fn("int8_gemm_sm90", f"int8_gemm_batched_{path}_launch", _BATCHED_SM90_ARGS)(
                x.data_ptr(), w_t.data_ptr(), out.data_ptr(), b, m, n, k,
                torch.cuda.current_stream(x.device).cuda_stream)
            _build.check(rc, "int8_gemm_batched")
    if out.numel():
        int8_gemm_batched.launches += 1
        int8_gemm_batched.paths[path] += 1
    return out


int8_gemm_batched.launches = 0
int8_gemm_batched.paths = dict.fromkeys(BATCHED_PATHS, 0)


def int8_matmul_t(xq: QTensor, wq_t: QTensor) -> torch.Tensor:
    """``xq [M, K]`` x pre-transposed ``wq_t [N, K]`` (scale ``[1, N]``)
    -> dequantized float32 ``[M, N]``."""
    acc = int8_gemm(xq.q, wq_t.q)
    return (acc.to(torch.float32) * xq.scale) * wq_t.scale
