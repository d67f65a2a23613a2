"""Stochastic bit-stream generation — the B-to-S converter (paper Fig. 3).

Port of ``repro.core.bitstream``.  A magnitude m in 0..127 becomes a
128-bit stream with exactly m ones; the generator decides where they sit:

* ``thermometer`` — ones in positions [0, m) (a unary counter);
* ``bresenham``   — m ones evenly spaced, with the +64 counter preset that
  makes the AND against a thermometer stream count round(m_x*m_w/128);
* ``lfsr``        — ones at the visit order of a maximal 7-bit LFSR.

Streams are packed little-endian into 4 words per operand: word ``w`` bit
``b`` is stream position ``32*w + b``.  The reference stores the words as
``uint32``; the port stores them as ``int32`` with the same bit pattern
(PyTorch has no shifts for ``uint32`` on the CPU), so
``words.numpy().view(np.uint32)`` equals the reference's array.  Shifts
that could reach bit 31 run in int64.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.quant import STREAM_LEN

N_WORDS = STREAM_LEN // 32  # 4
GENERATORS = ("thermometer", "bresenham", "lfsr")


def _lfsr_order() -> tuple:
    """A fixed permutation of 0..127 modelling the LFSR visit order: a
    7-bit maximal LFSR (taps x^7 + x^6 + 1) from state 1, state 0 last."""
    state, order = 1, []
    for _ in range(127):
        order.append(state)
        bit = ((state >> 6) ^ (state >> 5)) & 1
        state = ((state << 1) | bit) & 0x7F
    order.append(0)
    return tuple(order)


LFSR_ORDER = _lfsr_order()


def stream_bits(mag: torch.Tensor, generator: str = "bresenham", phase: int = 0) -> torch.Tensor:
    """Magnitudes (0..127, any shape) -> bits ``(..., 128)`` int32 in {0, 1}.

    ``phase`` rotates the stream (hardware staggers counter phases and LFSR
    seeds across lanes)."""
    mag = torch.as_tensor(mag).to(torch.int32)
    i = (torch.arange(STREAM_LEN, dtype=torch.int32, device=mag.device) + phase) % STREAM_LEN
    m = mag[..., None]
    if generator == "thermometer":
        bits = i < m
    elif generator == "bresenham":
        off = STREAM_LEN // 2
        return ((i + 1) * m + off) // STREAM_LEN - (i * m + off) // STREAM_LEN
    elif generator == "lfsr":
        order = torch.tensor(LFSR_ORDER, dtype=torch.int32, device=mag.device)
        bits = order[i.long()] < m
    else:
        raise ValueError(f"unknown generator {generator!r}; valid: {', '.join(GENERATORS)}")
    return bits.to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``(..., 128)`` {0,1} -> ``(..., 4)`` int32 words (uint32 bit pattern),
    little-endian within each word.  The sum wraps modulo 2^32 as the
    reference's ``uint32`` sum does, which matters only for the -1 "bits"
    of a wrapped magnitude (:func:`encode_signed` at -128)."""
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], N_WORDS, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = (b << shifts).sum(-1) & 0xFFFFFFFF  # 0 .. 2**32 - 1
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` int32 words -> ``(..., 128)`` int32 {0, 1}."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = (packed.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], STREAM_LEN).to(torch.int32)


def encode(mag: torch.Tensor, generator: str = "bresenham", phase: int = 0) -> torch.Tensor:
    """Magnitudes -> packed streams ``(..., 4)`` int32.  The B-to-S circuit."""
    return pack_bits(stream_bits(mag, generator, phase))


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (uint32 bit pattern), as int32: a SWAR
    count in int64 on the word's 32 bits, where nothing can overflow."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    return ((v + (v >> 16)) & 0x3F).to(torch.int32)


def popcount(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Total set bits across the word axis (the PCA charge count), int32."""
    return popcount_words(packed).sum(dim=axis, dtype=torch.int32)


def encode_signed(q: torch.Tensor, generator: str = "bresenham",
                  phase: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes -> (packed magnitudes ``(..., 4)`` int32, sign ``(...)``
    int32 in {+1, -1}).  Zero has sign +1 and an empty stream.

    The magnitude is taken in the codes' own dtype, as the reference's
    ``jnp.abs`` does: an int8 -128 wraps to -128, and that negative
    "magnitude" goes through the generator's formula as it is, giving
    ``[1, 1, 1, 1]`` under bresenham (a -1 at every position, summed
    modulo 2^32 per word) and the empty stream under thermometer and lfsr.
    ``quantize`` never gives -128 (it clips to +-127)."""
    q = torch.as_tensor(q)
    sign = torch.where(q < 0, -1, 1).to(torch.int32)
    return encode(q.abs().to(torch.int32), generator, phase), sign
