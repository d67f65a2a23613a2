"""Plain PyTorch version of the B-to-S encoder kernel, taken a slice of
codes at a time so a full weight's 128 bits per code never exist at once.

It follows the reference's Pallas kernel (``bts_encode_kernel``), which
takes each code's magnitude in int32: an int8 -128 has magnitude 128 and
the full stream.  ``core.bitstream.encode_signed`` takes the magnitude in
int8 as the reference's functional model does, so the two differ at -128
only; ``quantize`` never gives that code."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.bitstream import N_WORDS, encode

_CHUNK = 1 << 20  # codes per slice


def bts_encode_ref(q: torch.Tensor, generator: str = "bresenham") -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes ``[R, C]`` -> (words ``[R, C, 4]`` int32, signs ``[R, C]``
    int8 in {+1, -1})."""
    flat = q.reshape(-1)
    words = torch.empty(flat.numel(), N_WORDS, dtype=torch.int32, device=q.device)
    sign = torch.empty(flat.numel(), dtype=torch.int8, device=q.device)
    for i in range(0, flat.numel(), _CHUNK):
        q32 = flat[i:i + _CHUNK].to(torch.int32)
        words[i:i + _CHUNK] = encode(q32.abs(), generator)
        sign[i:i + _CHUNK] = torch.where(q32 < 0, -1, 1)
    return words.reshape(*q.shape, N_WORDS), sign.reshape(q.shape)
