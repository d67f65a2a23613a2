"""Serving fault classes (port of the part of ``repro.serve.faults`` the
engine raises or reports).

A fault names the engine slots it implicates (``slots``); every other slot
committed its work before the fault was raised and stays identical to a
fault-free run.  The named slots' requests are already ended, with their
pre-fault tokens and ``fault_reason`` set to the fault class.  Without a
supervisor (a later slice) the fault propagates to the caller, who may go
on calling ``run()``.  ``pool_pressure`` is the ``fault_reason`` of a
queued request the degraded-mode ladder sheds (``serve/scheduler.py``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

FAULT_NONFINITE = "nonfinite_logits"
FAULT_POOL_PRESSURE = "pool_pressure"


class NonFiniteLogitsError(RuntimeError):
    """Non-finite logits detected on the named slots."""

    def __init__(self, message: str, slots: Sequence[int] = ()):
        super().__init__(message)
        self.slots: Tuple[int, ...] = tuple(slots)
