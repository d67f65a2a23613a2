"""Build hand-written CUDA kernels with ``nvcc`` and bind them with ctypes.

Each kernel package keeps its sources under ``csrc/``.  At first use the
sources are compiled for Hopper (``sm_90a``) into a shared library with a
plain C interface, cached under ``build/torch_kernels/`` in the checkout
(listed in ``.gitignore``) and keyed by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one loads at once.  Nothing
is compiled at import time: the CPU tests import every module and never
reach a build.

:func:`build_all` starts one ``nvcc`` per library at the same time and
waits for all of them, so a fresh checkout pays for the slowest build,
not the sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> sources (relative to this package)
LIBRARIES: Dict[str, Tuple[str, ...]] = {
    "int8_matmul": ("int8_matmul/csrc/int8_matmul.cu",),
    "paged_attention": ("paged_attention/csrc/paged_attention.cu",),
}

_loaded: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}  # wall time of each build this process ran
build_logs: Dict[str, str] = {}  # nvcc/ptxas output of each build


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels build only on a machine with the toolkit")
    return found


def _target(name: str) -> Tuple[Path, List[Path]]:
    srcs = [_PKG / s for s in LIBRARIES[name]]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so", srcs


def _start(name: str):
    """Start compiling ``name`` (None when a built library is cached)."""
    out, srcs = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file


def build_all(names: Sequence[str] = tuple(LIBRARIES)) -> None:
    """Compile every named library in parallel (no-op for cached ones)."""
    started = {n: _start(n) for n in names}
    errors = []
    for n, s in started.items():
        if s is not None:
            try:
                _finish(n, s)
            except RuntimeError as e:  # finish the others, then report all
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiling it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(_target(name)[0]))
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
