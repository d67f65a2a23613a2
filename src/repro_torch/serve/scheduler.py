"""Scheduling helpers (port of the part of ``repro.serve.scheduler`` that
blocking admission uses; the chunked-prefill scheduler comes later)."""
from __future__ import annotations


def pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= ``n``, clamped to ``cap`` (0 for n <= 0)."""
    if n <= 0:
        return 0
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)
