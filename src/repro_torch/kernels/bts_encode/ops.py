"""Public wrapper of the B-to-S encoder kernel: checks, launch, counter.

Port of ``repro.kernels.bts_encode.ops.bts_encode``.  The words come back
as int32 carrying the reference's uint32 bit patterns (see
``core.bitstream``).  The reference pads to block multiples; the kernel
checks its bounds instead, so any shape goes in as it is.  On a CPU tensor
the wrapper runs the plain version (``ref.py``); on a CUDA tensor it
launches ``csrc/bts_encode.cu`` or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.bitstream import GENERATORS, LFSR_ORDER, N_WORDS
from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.bts_encode.ref import bts_encode_ref

GENERATOR_IDS = {name: i for i, name in enumerate(GENERATORS)}  # the kernel's ``gen``
_lfsr_loaded = set()  # devices whose __constant__ LFSR table is written


def _lib(device: torch.device):
    lib = _build.load("bts_encode")
    if lib.bts_encode_launch.argtypes is None:
        lib.bts_encode_set_lfsr.argtypes = [ctypes.c_void_p]
        lib.bts_encode_set_lfsr.restype = ctypes.c_int
        lib.bts_encode_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int]
                                          + [ctypes.c_void_p])
        lib.bts_encode_launch.restype = ctypes.c_int
    if device.index not in _lfsr_loaded:
        table = (ctypes.c_int32 * len(LFSR_ORDER))(*LFSR_ORDER)
        with torch.cuda.device(device):
            _build.check(lib.bts_encode_set_lfsr(ctypes.addressof(table)), "bts_encode_set_lfsr")
        _lfsr_loaded.add(device.index)
    return lib.bts_encode_launch


def bts_encode(q: torch.Tensor, generator: str = "bresenham") -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes ``[R, C]`` -> (packed streams ``[R, C, 4]`` int32, signs
    ``[R, C]`` int8 in {+1, -1})."""
    refuse_grad("bts_encode", q)
    if generator not in GENERATOR_IDS:
        raise ValueError(f"unknown generator {generator!r}; valid: {', '.join(GENERATORS)}")
    if q.device.type == "cpu":
        return bts_encode_ref(q, generator)
    if q.device.type != "cuda":
        raise ValueError(f"bts_encode: tensor on {q.device}; it takes a CUDA or a CPU tensor")
    if q.dtype != torch.int8:
        raise TypeError(f"bts_encode takes int8 codes, got {q.dtype}")
    q = q.contiguous()
    words = torch.empty(*q.shape, N_WORDS, dtype=torch.int32, device=q.device)
    sign = torch.empty(q.shape, dtype=torch.int8, device=q.device)
    if q.numel() == 0:
        return words, sign
    rc = _lib(q.device)(q.data_ptr(), words.data_ptr(), sign.data_ptr(), q.numel(),
                        GENERATOR_IDS[generator], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "bts_encode")
    bts_encode.launches += 1
    return words, sign


bts_encode.launches = 0
