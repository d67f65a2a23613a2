"""Plain PyTorch version of the B-to-S encoder kernel: the functional
model ``core.bitstream.encode_signed`` with int8 signs, taken a slice of
codes at a time so a full weight's 128 bits per code never exist at once."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.bitstream import N_WORDS, encode_signed

_CHUNK = 1 << 20  # codes per slice


def bts_encode_ref(q: torch.Tensor, generator: str = "bresenham") -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes ``[R, C]`` -> (words ``[R, C, 4]`` int32, signs ``[R, C]``
    int8 in {+1, -1})."""
    flat = q.reshape(-1)
    words = torch.empty(flat.numel(), N_WORDS, dtype=torch.int32, device=q.device)
    sign = torch.empty(flat.numel(), dtype=torch.int8, device=q.device)
    for i in range(0, flat.numel(), _CHUNK):
        w, s = encode_signed(flat[i:i + _CHUNK], generator)
        words[i:i + _CHUNK], sign[i:i + _CHUNK] = w, s
    return words.reshape(*q.shape, N_WORDS), sign.reshape(q.shape)
