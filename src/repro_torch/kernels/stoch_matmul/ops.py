"""Public wrappers of the stochastic-matmul kernels: checks, launch, counters.

Port of ``repro.kernels.stoch_matmul.ops``.  Two CUDA libraries compute
``sum_k sx * sw * popcount(X & W)`` into int32, each operand's stream
coming from a table of every magnitude's stream (:func:`stream_table`)
where it is given as int8 codes:

* ``csrc/stoch_gemm_sm90.cu``, codes against codes on the binary tensor
  cores (``mma.sync`` for at most 16 rows, ``wgmma`` above; the kernel per
  shape from :func:`stoch_gemm_plan`), behind two entries:
  ``stoch_gemm_codes`` (one product: ``stoch_matmul``, i.e.
  ``astra_matmul``'s ``sc`` branch against a weight's cached codes) and
  ``stoch_matmul_codes_batched`` (a batch of independent products:
  ``astra_batched_matmul``'s ``sc`` branch).  Each counts its launches,
  and by kernel in ``paths``.
* ``csrc/stoch_matmul.cu``, the CUDA-core kernel template that reads each
  operand as packed streams or as codes it encodes while staging, behind
  ``stoch_matmul_packed`` (packed streams and signs of both operands, the
  reference kernel's interface) and ``stoch_matmul_codes`` (int8
  activation codes against a weight's packed streams).  Neither is on the
  serving path.

All entries take K-contiguous operands and give int32 accumulators; the
reference pads to block multiples, the kernels mask ragged edges
themselves.  ``stoch_matmul`` takes quantized activations and a weight's
cached codes (``core.ossm.WeightCodes``) and dequantizes as ``((acc * 128)
* xs) * ws``, the reference's order.  On CPU tensors the entries run their
plain versions (``ref.py``: sign planes and ``same - opp`` for the codes x
codes entries; ``core.bitstream.encode_signed`` then the packed product
for the codes x streams entry); on CUDA tensors they launch their kernel
or raise.  A code -128, which ``quantize`` never gives, stages as the
reference's ``encode_signed`` gives it, on every entry that reads codes
(:func:`stream_table`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bitstream import N_WORDS, STREAM_LEN, encode, encode_signed
from repro_torch.core.ossm import W_GEN, X_GEN, WeightCodes
from repro_torch.core.quant import QTensor
from repro_torch.kernels import _build
from repro_torch.kernels.stoch_matmul.ref import (
    stoch_gemm_codes_ref, stoch_matmul_codes_ref, stoch_matmul_packed_ref,
)

_BK = 16  # stoch_matmul.cu's K step; split-K chunks are multiples of it
# (BM, BN) of the kernel's two tile configurations, indexed by ``cfg``
_TILES = {0: (8, 128), 1: (64, 64)}
# rows of a stream table: magnitudes 0..127 (quantize's codes reach
# +-127), then row 128, the stream of an int8 -128 (encode_signed's, whose
# wrapped magnitude -128 gives no full stream: see stream_table)
TABLE_LEN = 129
_tables = {}  # (device, generator) -> the generator's stream table on it


# stoch_gemm_sm90.cu: K codes a decode warp takes at a time, codes a
# wgmma stage holds (split-K chunks are multiples of them), the rows a
# decode block owns, the wgmma kernel's output tile
_ST_CHUNK, _WG_CODES, _ST_ROWS, _WG_TILE = 64, 8, 32, 128
GEMM_KERNELS = ("stream", "wgmma")  # stoch_gemm_launch's kernel 0, 1


def _lib():
    fn = _build.load("stoch_matmul").stoch_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _gemm_lib():
    fn = _build.load("stoch_gemm_sm90").stoch_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def stream_table(generator: str, device="cpu") -> torch.Tensor:
    """The packed stream the kernels stage for each code magnitude under
    ``generator``, ``[129, 4]`` int32 (uint32 bit patterns): row ``m <
    128`` is ``core.bitstream.encode(m)``, and row 128 is what
    ``encode_signed`` gives an int8 -128 (its wrapped magnitude through the
    generator's formula: ``[1, 1, 1, 1]`` under bresenham, the empty
    stream under thermometer and lfsr).  The kernels stage a code ``c`` as
    row ``|c|`` with sign ``c < 0 ? -1 : +1``, so every int8 code stages as
    ``encode_signed`` gives it at phase 0.  Built once per device and
    generator."""
    device = torch.device(device)
    key = (device, generator)
    if key not in _tables:
        rows = encode(torch.arange(TABLE_LEN - 1), generator)
        minus_128, _ = encode_signed(torch.tensor([-128], dtype=torch.int8), generator)
        _tables[key] = torch.cat([rows, minus_128]).to(device)
    return _tables[key]


def _wave_splits(tiles: int, k: int, step: int, n_sm: int, most: int = 8):
    """(K codes per split, splits) for ``tiles`` output tiles of a kernel
    that runs one block an SM: the count s of splits (1 to ``most``, each
    at least two steps of K) with the least ``ceil(tiles * s / n_sm) / s``
    (waves of blocks times each block's share of K), each split costing 2%
    more for its atomics; ties go to fewer splits."""
    top = max(1, min(most, k // (2 * step)))
    s = min(range(1, top + 1), key=lambda s: (-(-tiles * s // n_sm) / s * (1 + 0.02 * (s - 1)), s))
    kps = -(-(-(-k // s)) // step) * step
    return kps, -(-k // kps)


def stoch_gemm_plan(m: int, n: int, k: int, n_sm: int, batch: int = 1):
    """(kernel, K codes per split, number of splits) of ``stoch_gemm_sm90``
    for ``batch`` products of ``[m, k] x [n, k]``: the ``stream`` kernel
    (``mma.sync``, row blocks of 32 weight rows, one block an SM) for ``m
    <= 16``, the ``wgmma`` kernel (128 x 128 tiles, one block an SM) above;
    K is split into the count that wastes the fewest SMs in the last wave."""
    if m <= 16:
        blocks = batch * -(-n // _ST_ROWS)
        return ("stream", *_wave_splits(blocks, k, _ST_CHUNK, n_sm))
    tiles = batch * -(-m // _WG_TILE) * -(-n // _WG_TILE)
    return ("wgmma", *_wave_splits(tiles, k, _WG_CODES, n_sm))


def split_plan(m: int, n: int, k: int, n_sm: int, batch: int = 1):
    """``stoch_matmul.cu``'s (tile config, K positions per split, number of
    splits).  M <= 8 (decode) takes the 8-row tile; K is split when the
    output tiles of all ``batch`` products cannot give every SM four
    blocks."""
    cfg = 0 if m <= 8 else 1
    bm, bn = _TILES[cfg]
    return (cfg, *_build.split_k(batch * -(-m // bm) * -(-n // bn), k, _BK, 4 * n_sm))


def _check_device(tensors, what: str) -> bool:
    """True when every tensor is on the CPU (run the plain version); raise
    unless all are on one CUDA device."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if any(t.device != dev for t in tensors) or dev.type != "cuda":
        raise ValueError(f"{what}: operands on {sorted({str(t.device) for t in tensors})}; "
                         "all must be on one CUDA device (or all on the CPU)")
    return False


def _launch(what: str, x, x_aux, w, w_aux, lead, m: int, n: int, k: int,
            x_codes: bool) -> torch.Tensor:
    """One launch of ``stoch_matmul.cu`` over operands checked by the
    caller: ``x [(B,) M, K(, 4)]`` (packed, or codes with their stream
    table) and packed ``w [(B,) N, K, 4]`` with their signs."""
    # the kernel reads 16-byte words: contiguous, 16-byte aligned starts
    x, x_aux, w, w_aux = (_build.aligned(t) for t in (x, x_aux, w, w_aux))
    b = lead[0] if lead else 1
    cfg, kps, splits = split_plan(m, n, k, _build.sm_count(x.device.index), b)
    if b * splits > 65535:  # gridDim.z
        raise ValueError(f"{what}: batch {b} x {splits} K splits exceeds the grid")
    out = (torch.zeros if splits > 1 else torch.empty)((*lead, m, n), dtype=torch.int32,
                                                       device=x.device)
    if out.numel() == 0:
        return out
    rc = _lib()(x.data_ptr(), x_aux.data_ptr(), w.data_ptr(), w_aux.data_ptr(), out.data_ptr(),
                b, m, n, k, kps, splits, cfg, int(x_codes), 0,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, what)
    return out


def stoch_matmul_packed(xs: torch.Tensor, sx: torch.Tensor, ws: torch.Tensor,
                        sw: torch.Tensor) -> torch.Tensor:
    """``xs [(B,) M, K, 4]`` int32 streams, ``sx [(B,) M, K]`` int8 signs,
    ``ws [(B,) N, K, 4]``, ``sw [(B,) N, K]`` -> int32 ``[(B,) M, N]``:
    ``sum_k sx * sw * popcount(xs & ws)``."""
    tensors = (xs, sx, ws, sw)
    if _check_device(tensors, "stoch_matmul_packed"):
        return stoch_matmul_packed_ref(xs, sx, ws, sw)
    if (xs.dtype, sx.dtype, ws.dtype, sw.dtype) != (torch.int32, torch.int8) * 2:
        raise TypeError("stoch_matmul_packed takes int32 streams and int8 signs, got "
                        f"{[t.dtype for t in tensors]}")
    batched = sx.dim() == 3
    if (sx.dim() not in (2, 3) or sw.dim() != sx.dim() or xs.shape != (*sx.shape, N_WORDS)
            or ws.shape != (*sw.shape, N_WORDS) or sx.shape[-1] != sw.shape[-1]
            or (batched and sx.shape[0] != sw.shape[0])):
        raise ValueError(f"stoch_matmul_packed: shapes {[tuple(t.shape) for t in tensors]} "
                         "are not [(B,) M, K, 4], [(B,) M, K], [(B,) N, K, 4], [(B,) N, K]")
    m, k = sx.shape[-2:]
    out = _launch("stoch_matmul_packed", xs, sx, ws, sw, sx.shape[:-2], m, sw.shape[-2], k,
                  False)
    if out.numel():
        stoch_matmul_packed.launches += 1
    return out


stoch_matmul_packed.launches = 0


def stoch_matmul_codes(xq: torch.Tensor, ws: torch.Tensor, sw: torch.Tensor,
                       x_gen: str = X_GEN) -> torch.Tensor:
    """int8 activation codes ``xq [M, K]`` against a weight's streams ``ws
    [N, K, 4]`` (int32) and signs ``sw [N, K]`` (int8) -> int32 ``[M, N]``:
    what ``encode_signed(xq, x_gen)`` then ``stoch_matmul_packed`` give
    (``bts_encode`` differs from it only at -128), with the codes encoded
    while the kernel stages its tiles."""
    tensors = (xq, ws, sw)
    if _check_device(tensors, "stoch_matmul_codes"):
        return stoch_matmul_codes_ref(xq, ws, sw, x_gen)
    if (xq.dtype, ws.dtype, sw.dtype) != (torch.int8, torch.int32, torch.int8):
        raise TypeError("stoch_matmul_codes takes int8 codes, int32 streams and int8 signs, "
                        f"got {[t.dtype for t in tensors]}")
    if (xq.dim() != 2 or sw.dim() != 2 or ws.shape != (*sw.shape, N_WORDS)
            or xq.shape[1] != sw.shape[1]):
        raise ValueError(f"stoch_matmul_codes: shapes {[tuple(t.shape) for t in tensors]} "
                         "are not [M, K], [N, K, 4], [N, K]")
    (m, k), n = xq.shape, sw.shape[0]
    out = _launch("stoch_matmul_codes", xq, stream_table(x_gen, xq.device), ws, sw, (), m, n,
                  k, True)
    if out.numel():
        stoch_matmul_codes.launches += 1
    return out


stoch_matmul_codes.launches = 0


def _gemm_launch(what: str, xq, wq_t, lead, x_gen: str, w_gen: str):
    """One launch of ``stoch_gemm_sm90`` over codes checked by the caller,
    ``xq [(B,) M, K]`` against ``wq_t [(B,) N, K]``; the output and the
    kernel it took."""
    xq, wq_t = _build.aligned(xq), _build.aligned(wq_t)
    (m, k), n = xq.shape[-2:], wq_t.shape[-2]
    b = lead[0] if lead else 1
    n_sm = _build.sm_count(xq.device.index)
    kernel, kps, splits = stoch_gemm_plan(m, n, k, n_sm, b)
    if b * splits > 65535:  # gridDim.z
        raise ValueError(f"{what}: batch {b} x {splits} K splits exceeds the grid")
    out = (torch.zeros if splits > 1 else torch.empty)((*lead, m, n), dtype=torch.int32,
                                                       device=xq.device)
    if out.numel() == 0:
        return out, kernel
    dev = xq.device
    # the stream kernel's blocks (one an SM) walk its row blocks in turn
    width = min(-(-n // _ST_ROWS), max(1, n_sm // (b * splits)))
    rc = _gemm_lib()(xq.data_ptr(), stream_table(x_gen, dev).data_ptr(), wq_t.data_ptr(),
                     stream_table(w_gen, dev).data_ptr(), out.data_ptr(), b, m, n, k, kps,
                     splits, GEMM_KERNELS.index(kernel), width,
                     torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, what)
    return out, kernel


def _count(fn, out: torch.Tensor, kernel: str) -> None:
    if out.numel():
        fn.launches += 1
        fn.paths[kernel] += 1


def stoch_gemm_codes(xq: torch.Tensor, wq_t: torch.Tensor, x_gen: str = X_GEN,
                     w_gen: str = W_GEN) -> torch.Tensor:
    """int8 activation codes ``xq [M, K]`` against int8 weight codes ``wq_t
    [N, K]`` -> int32 ``[M, N]``: each operand's streams from its
    generator's table, summed with their signs on the binary tensor cores."""
    tensors = (xq, wq_t)
    if _check_device(tensors, "stoch_gemm_codes"):
        return stoch_gemm_codes_ref(xq, wq_t, x_gen, w_gen)
    if xq.dtype != torch.int8 or wq_t.dtype != torch.int8:
        raise TypeError(f"stoch_gemm_codes takes int8 codes, got {xq.dtype} and {wq_t.dtype}")
    if xq.dim() != 2 or wq_t.dim() != 2 or xq.shape[1] != wq_t.shape[1]:
        raise ValueError(f"stoch_gemm_codes: shapes {tuple(xq.shape)} x {tuple(wq_t.shape)} "
                         "are not [M, K] x [N, K]")
    out, kernel = _gemm_launch("stoch_gemm_codes", xq, wq_t, (), x_gen, w_gen)
    _count(stoch_gemm_codes, out, kernel)
    return out


stoch_gemm_codes.launches = 0
stoch_gemm_codes.paths = dict.fromkeys(GEMM_KERNELS, 0)


def stoch_matmul_codes_batched(xq: torch.Tensor, wq_t: torch.Tensor, x_gen: str = X_GEN,
                               w_gen: str = W_GEN) -> torch.Tensor:
    """int8 codes ``xq [B, M, K]`` against int8 codes ``wq_t [B, N, K]`` ->
    int32 ``[B, M, N]``: B independent products in one launch of the
    binary tensor-core kernel."""
    tensors = (xq, wq_t)
    if _check_device(tensors, "stoch_matmul_codes_batched"):
        return stoch_gemm_codes_ref(xq, wq_t, x_gen, w_gen)
    if xq.dtype != torch.int8 or wq_t.dtype != torch.int8:
        raise TypeError("stoch_matmul_codes_batched takes int8 codes, got "
                        f"{xq.dtype} and {wq_t.dtype}")
    if (xq.dim() != 3 or wq_t.dim() != 3 or xq.shape[0] != wq_t.shape[0]
            or xq.shape[2] != wq_t.shape[2]):
        raise ValueError(f"stoch_matmul_codes_batched: shapes {tuple(xq.shape)} x "
                         f"{tuple(wq_t.shape)} are not [B, M, K] x [B, N, K]")
    out, kernel = _gemm_launch("stoch_matmul_codes_batched", xq, wq_t, (xq.shape[0],), x_gen,
                               w_gen)
    _count(stoch_matmul_codes_batched, out, kernel)
    return out


stoch_matmul_codes_batched.launches = 0
stoch_matmul_codes_batched.paths = dict.fromkeys(GEMM_KERNELS, 0)


def stoch_matmul(xq: QTensor, w: WeightCodes, x_gen: str = X_GEN) -> torch.Tensor:
    """Quantized ``xq [M, K]`` through the OSSM array against a weight's
    cached codes (``[N, K]``, scale ``[1, N]``, streams under ``w.gen``) ->
    dequantized float32 ``[M, N]``."""
    acc = stoch_gemm_codes(xq.q, w.q, x_gen, w.gen)
    return acc.to(torch.float32) * STREAM_LEN * xq.scale * w.scale
