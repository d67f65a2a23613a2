"""Build hand-written CUDA kernels with ``nvcc`` and bind them with ctypes;
the launch helpers the wrappers share (``check``, ``sm_count``, ``split_k``).

Each kernel package keeps its sources under ``csrc/``.  At first use the
sources are compiled for Hopper (``sm_90a``) into a shared library with a
plain C interface, cached under ``build/torch_kernels/`` in the checkout
(listed in ``.gitignore``) and keyed by a hash of the flags, the sources
and every header they include (``common/hopper.cuh`` is shared by six
libraries and the rate probe), so an edited source or header rebuilds and an unchanged one
loads at once.  Nothing is compiled at import time: the CPU tests import
every module and never reach a build.

:func:`build_all` starts one ``nvcc`` per library at the same time and
waits for all of them, so a fresh checkout pays for the slowest build,
not the sum.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "torch_kernels"
# --split-compile=0: the device-code optimizer of one source runs on every
# core, not one (the attention sources instantiate dozens of kernels)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0")
# head dims the attention kernels (flash, decode over both layouts, paged
# prefill) are instantiated for: the switch in each attention source
HEAD_DIMS = (16, 64, 128, 256)

# library name -> sources (relative to this package)
LIBRARIES: Dict[str, Tuple[str, ...]] = {
    "int8_matmul": ("int8_matmul/csrc/int8_matmul.cu",),
    "int8_gemm_sm90": ("int8_matmul/csrc/int8_gemm_sm90.cu",),
    "decode": ("paged_attention/csrc/decode.cu",),
    "paged_prefill": ("paged_attention/csrc/paged_prefill.cu",),
    "flash_attention": ("flash_attention/csrc/flash_attention.cu",),
    "bts_encode": ("bts_encode/csrc/bts_encode.cu",),
    "stoch_matmul": ("stoch_matmul/csrc/stoch_matmul.cu",),
    "stoch_gemm_sm90": ("stoch_matmul/csrc/stoch_gemm_sm90.cu",),
    "rglru_scan": ("rglru_scan/csrc/rglru_scan.cu",),
}
# rate probes that replace no kernel (chip_smoke.py's probe phase), built
# on demand and never by build_all
PROBES: Dict[str, Tuple[str, ...]] = {
    "stoch_probe": ("stoch_matmul/csrc/stoch_probe.cu",),
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


def _sources(name: str) -> Tuple[str, ...]:
    return LIBRARIES[name] if name in LIBRARIES else PROBES[name]


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def headers(name: str) -> List[Path]:
    """The headers that library ``name``'s sources include with quotes
    (``#include "..."``, resolved against the including file's directory),
    and the headers those include, in the order first met."""
    found: List[Path] = []
    todo = [_PKG / s for s in _sources(name)]
    while todo:
        f = todo.pop(0)
        for inc in _INCLUDE.findall(f.read_text(encoding="utf-8")):
            path = (f.parent / inc).resolve()
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def _target(name: str) -> Tuple[Path, List[Path]]:
    """The cached library's path, keyed by the flags and the bytes of the
    sources and of every header they include, and the sources."""
    srcs = [_PKG / s for s in _sources(name)]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in srcs + headers(name):
        h.update(f.read_bytes())
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


def aligned(t):
    """``t`` contiguous with a 16-byte aligned start, copied only when it is
    not (the kernels read 16-byte vectors)."""
    import torch

    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(blocks: int, k: int, step: int, want: int) -> Tuple[int, int]:
    """(K per split, number of splits) for a kernel whose ``blocks`` output
    tiles walk K in ``step``s: when they are fewer than ``want`` blocks, K
    is split across more blocks (each split a multiple of ``step`` and at
    least two steps long) whose int32 partial sums meet by atomic add,
    which is exact in any order."""
    splits = 1
    if blocks < want:
        splits = max(1, min(-(-want // blocks), -(-k // (2 * step))))
    kps = -(-k // splits)
    kps = -(-kps // step) * step
    return kps, -(-k // kps)
