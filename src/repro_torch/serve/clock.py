"""The one wall-clock entry point of the port's serving stack.

The engine reads time only through an injected ``clock`` callable, so a
replay harness can drive it on a virtual clock; ``ServeEngine(clock=None)``
falls back to :data:`wall_clock`, the single ambient read.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

wall_clock: Callable[[], float] = time.time


def resolve_clock(clock: Optional[Callable[[], float]]) -> Callable[[], float]:
    """Injected clock if given, else the ambient wall clock."""
    return clock if clock is not None else wall_clock
