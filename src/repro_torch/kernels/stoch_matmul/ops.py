"""Public wrappers of the stochastic-matmul kernel: checks, launch, counters.

Port of ``repro.kernels.stoch_matmul.ops``.  One kernel
(``csrc/stoch_matmul.cu``) reads each operand either as packed streams
and int8 signs or as int8 codes that it encodes while staging its tiles,
from a table of every magnitude's stream (:func:`stream_table`).  Three
entries launch it, each with its own launch counter:

* ``stoch_matmul_packed``: packed streams and signs of both operands, the
  reference kernel's interface;
* ``stoch_matmul_codes``: int8 activation codes against a weight's cached
  streams (``astra_matmul``'s ``sc`` branch), so no activation is encoded
  by a launch of its own;
* ``stoch_matmul_codes_batched``: codes against codes, a batch of
  independent products (``astra_batched_matmul``'s ``sc`` branch).

All three take K-contiguous operands and give int32 accumulators; the
reference pads to block multiples, the kernel masks ragged edges itself.
``stoch_matmul`` takes quantized activations and a weight's cached
streams (``core.ossm.WeightStreams``) and dequantizes as ``((acc * 128) *
xs) * ws``, the reference's order.  On CPU tensors the entries run their
plain versions (``ref.py``: the codes entries encode with
``bts_encode_ref`` first); on CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bitstream import N_WORDS, STREAM_LEN, encode
from repro_torch.core.ossm import W_GEN, X_GEN, WeightStreams
from repro_torch.core.quant import QTensor
from repro_torch.kernels import _build
from repro_torch.kernels.stoch_matmul.ref import (
    stoch_matmul_codes_batched_ref, stoch_matmul_codes_ref, stoch_matmul_packed_ref,
)

_BK = 16  # the kernel's K step; split-K chunks are multiples of it
# (BM, BN) of the kernel's two tile configurations, indexed by ``cfg``
_TILES = {0: (8, 128), 1: (64, 64)}
# magnitudes a code can have: quantize's codes reach 127, and an int8
# -128 has magnitude 128 (encode gives it the full stream)
TABLE_LEN = 129
_tables = {}  # (device, generator) -> the generator's stream table on it


def _lib():
    fn = _build.load("stoch_matmul").stoch_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def stream_table(generator: str, device="cpu") -> torch.Tensor:
    """The packed stream of every magnitude 0..128 under ``generator``:
    ``core.bitstream.encode(arange(129), generator)``, ``[129, 4]`` int32
    (uint32 bit patterns).  The kernel stages a code ``c`` as row ``|c|``
    with sign ``c < 0 ? -1 : +1``, which is what ``encode_signed`` gives at
    phase 0.  Built once per device and generator."""
    device = torch.device(device)
    key = (device, generator)
    if key not in _tables:
        _tables[key] = encode(torch.arange(TABLE_LEN), generator).to(device)
    return _tables[key]


def split_plan(m: int, n: int, k: int, n_sm: int, batch: int = 1):
    """(tile config, K positions per split, number of splits).  M <= 8
    (decode) takes the 8-row tile; K is split when the output tiles of all
    ``batch`` products cannot give every SM four blocks."""
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


def _launch(what: str, x, x_aux, w, w_aux, lead, m: int, n: int, k: int, x_codes: bool,
            w_codes: bool) -> torch.Tensor:
    """One launch over operands checked by the caller: ``x [(B,) M, K(, 4)]``
    and ``w [(B,) N, K(, 4)]`` with their signs or stream tables."""
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
                b, m, n, k, kps, splits, cfg, int(x_codes), int(w_codes),
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
                  False, False)
    if out.numel():
        stoch_matmul_packed.launches += 1
    return out


stoch_matmul_packed.launches = 0


def stoch_matmul_codes(xq: torch.Tensor, ws: torch.Tensor, sw: torch.Tensor,
                       x_gen: str = X_GEN) -> torch.Tensor:
    """int8 activation codes ``xq [M, K]`` against a weight's streams ``ws
    [N, K, 4]`` (int32) and signs ``sw [N, K]`` (int8) -> int32 ``[M, N]``:
    what ``bts_encode(xq, x_gen)`` then ``stoch_matmul_packed`` give, with
    the codes encoded while the kernel stages its tiles."""
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
                  k, True, False)
    if out.numel():
        stoch_matmul_codes.launches += 1
    return out


stoch_matmul_codes.launches = 0


def stoch_matmul_codes_batched(xq: torch.Tensor, wq_t: torch.Tensor, x_gen: str = X_GEN,
                               w_gen: str = W_GEN) -> torch.Tensor:
    """int8 codes ``xq [B, M, K]`` against int8 codes ``wq_t [B, N, K]`` ->
    int32 ``[B, M, N]``: B independent products in one launch, each
    operand encoded (``x_gen``, ``w_gen``) while the kernel stages it."""
    tensors = (xq, wq_t)
    if _check_device(tensors, "stoch_matmul_codes_batched"):
        return stoch_matmul_codes_batched_ref(xq, wq_t, x_gen, w_gen)
    if xq.dtype != torch.int8 or wq_t.dtype != torch.int8:
        raise TypeError("stoch_matmul_codes_batched takes int8 codes, got "
                        f"{xq.dtype} and {wq_t.dtype}")
    if (xq.dim() != 3 or wq_t.dim() != 3 or xq.shape[0] != wq_t.shape[0]
            or xq.shape[2] != wq_t.shape[2]):
        raise ValueError(f"stoch_matmul_codes_batched: shapes {tuple(xq.shape)} x "
                         f"{tuple(wq_t.shape)} are not [B, M, K] x [B, N, K]")
    b, m, k = xq.shape
    out = _launch("stoch_matmul_codes_batched", xq, stream_table(x_gen, xq.device), wq_t,
                  stream_table(w_gen, xq.device), (b,), m, wq_t.shape[1], k, True, True)
    if out.numel():
        stoch_matmul_codes_batched.launches += 1
    return out


stoch_matmul_codes_batched.launches = 0


def stoch_matmul(xq: QTensor, w: WeightStreams, x_gen: str = X_GEN) -> torch.Tensor:
    """Quantized ``xq [M, K]`` through the OSSM array against a weight's
    cached streams (``[N, K]``, scale ``[1, N]``) -> dequantized float32
    ``[M, N]``."""
    acc = stoch_matmul_codes(xq.q, w.words, w.sign, x_gen)
    return acc.to(torch.float32) * STREAM_LEN * xq.scale * w.scale
