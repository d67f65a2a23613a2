"""PyTorch/CUDA port of the ASTRA reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``configs``, ``core``, ``models``, ``kernels``, ``serve``,
``launch``) so each module has an obvious counterpart, and imports
nothing from it.  Entry points run on the card (``cuda``) unless the
caller passes ``device="cpu"``; on a CPU tensor every kernel wrapper runs
its plain PyTorch version instead of launching the CUDA kernel.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
