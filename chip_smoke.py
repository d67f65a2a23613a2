"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

  python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``src/`` (one ``nvcc``
per library, all started together), holds each kernel against its plain
PyTorch version at the shapes the serving path gives it (the integer
kernels bit for bit), times it beside its bound, then serves stablelm-1.6b
at its published widths, cut to ``SL_LAYERS`` of its 24 layers (random
weights from a seed), through
``repro_torch.serve.ServeEngine`` on the paged KV pool under the
``exact``, ``int8``, ``sc`` (bit-true stochastic streams) and ``mixed``
(int8 qk/pv, stochastic projections) plans, on dense per-slot caches
under ``exact`` and ``int8`` (``exact-dense``, ``int8-dense``: the flash
kernel, on ``wgmma`` with TMA-fed K/V tiles, and the decode kernel, split
over the keys and merged), calibrates static scales with
``Model.calibrate`` and serves the calibrated ``int8`` plan and the
``exact`` plan on an int8 KV pool (``int8-kvq``, ``exact-kvq``: the
paged kernels' dequantizing branch), then serves full-width
recurrentgemma-2b (RG-LRU + sliding-window local attention, head dim
256) on dense per-slot caches under ``exact`` and ``int8`` (``rg-exact``,
``rg-int8``: the ``rglru_scan`` kernel in every recurrent layer's
prefill, flash attention with window 2048 and dense decode on the
rings) and on the paged pool (``rg-exact-paged``: the rings through the
block table, decoded by the paged kernel once per local layer and step,
admission prefilled dense and scattered into the pools), then serves
full-width granite-moe-1b-a400m (mixture-of-experts MLPs; attention at
GQA 2) on the pool, on dense caches and chunked (``moe-exact``,
``moe-int8``, ``moe-experts-int8`` with the expert products on the
batched int8 entry, ``moe-exact-dense``, ``moe-exact-chunked``: each decode
chunk launches its layout's decode kernel once per layer and step; a
profiled chunk gives the expert products' and the routing, dispatch
and combine's device time) and full-width xlstm-125m on its dense
recurrent states (``xl-exact``: no attention kernel; ``xl-int8``: the
int8 GEMM's two kernels), checking that
every request gets its tokens, the logits are finite, the prefix cache
hits where it may, and that each serving run itself launched every
kernel of its plan's path and no kernel of the other layout (for a
stateful stack on the pool: none in its decode chunks).  The open-loop
path ``ServeFrontend`` -> ``EngineSupervisor`` -> ``ServeEngine`` replays
a mixed traffic trace at full-width stablelm-1.6b in wall time
(``[traffic]``: TTFT and inter-token latency percentiles while prompts
are admitted mid-decode) and twice in virtual time, clean and under
injected step errors, NaN logits and pool pressure with retries
(``[traffic faults]``: conservation, a clean audit, and the tokens of
every untouched request admitted in the same packed round as in the
clean replay equal to the clean replay's; a request whose round moved
may round otherwise, so those are counted).  Paged decode is timed at
recurrentgemma's rings (``[time paged decode rg]``), and paged decode,
causal prefill and the batched int8 entry at granite's shapes (``[time
... moe]``).  Reduced float32 models of all four families are served on
the card and on the CPU, and their greedy tokens compared (recurrentgemma
on dense caches and on the paged pool, its rings wrapping; granite with
its expert sites quantized in one run).  Training (``[train ...]``):
full-width qwen1.5-0.5b through ``repro_torch.launch.train.main`` (16
steps at batch 8 x 128, checkpoints every 8, then the same run with a
fault at step 11: its loss trajectory must equal the clean run's bit for
bit, and the loss must fall; step time, tokens/s, peak memory and a
checkpoint save are measured), recurrentgemma-2b at full width cut to one
pattern period with every gradient leaf through the scan kernel's
backward held against autograd through the plain loop (the scan's
launches per step asserted), granite-moe-1b-a400m whole for 4 steps
(finite loss and gradients, load-balance loss above 0), reduced models'
losses card against CPU, and ``Model.loss`` under ``flash`` and ``int8``
refused.  Sharded training (``[shard]``): two ranks spawned on the card
over a gloo group (``FileStore``), the collectives gloo takes on CUDA
tensors printed, full-width qwen1.5-0.5b on a data 2 x model 1 mesh for 4
ZeRO-3 steps held against ``[train]``'s first losses (each rank's step ms
and peak memory printed), and a reduced float32 qwen3-moe-30b-a3b's two
sharded steps held against the one-process card steps.  One int8
product runs on ``wgmma`` with TMA-fed tiles at admission and on a
weight-streaming kernel at decode: both are held bit for bit at
stablelm's and recurrentgemma's serving shapes, at every shape the
granite and xLSTM int8 runs gave them and the batched entry (recorded
while those runs serve) and at each kernel's edges, each model's decode step and
admission pass are timed summed (admission beside ``torch._int_mm``),
short admissions time the ``wgmma`` kernel split against unsplit, and
every int8 serving run must launch both.  The stochastic GEMM's serving
path reads both operands as int8 codes, expands each to the sign planes
of its stream while staging it and sums the signed popcounts on the
binary tensor cores (``stoch_gemm_sm90.cu``: ``mma.sync`` at decode,
``wgmma`` at admission); a probe phase first measures the rates that
route rests on (``[probe]``: ``mma.sync`` and ``wgmma`` b1 products,
shared-memory table lookups).  It and the CUDA-core kernel's packed and
codes entries (``stoch_matmul.cu``) are held bit for bit under all 9
generator pairings and timed beside each other; the ``sc`` and ``mixed``
runs must launch both binary kernels and no ``bts_encode``, prepare
included, and log their weight cache's bytes (int8 codes).  The batched
int8 qk/pv products of at most 16 rows run on a kernel that streams each
product in a block of its own, those of more than 16 rows (the ``mixed``
admissions) on one that takes a tile of 32 rows by the whole N a block
(both ``int8_gemm_sm90.cu``), each timed beside ``mma.sync`` at the same
shapes, which no ``mixed`` run may launch.  ``rglru_scan`` scans chunks
of the sequence in parallel (timed at one admission and a full window,
and inside a profiled ``rg-exact`` admission).  Every paged admission runs the
causal prefill kernels of ``paged_prefill.cu`` (``wgmma`` tiles gathered
through the block table for a bf16 pool, float32 FMA tiles for float32
and int8 pools): checked on every pool, head dim and block sizes 8, 12,
16 and 128 (``[paged prefill]``), timed at a cold and a warm admission
beside flash attention at the cold shape (``[time paged prefill]``).
Decode on both layouts is one split kernel and one merge
(``decode.cu``), reading keys from the dense cache or through the block
table; paged decode is checked on every pool, head dim and block sizes
8, 12, 16 and 128 (``[paged decode]``).  The logs also give the
redesigned kernels' shared memory (``[tiles]``), the decode split counts,
and each profiled decode chunk's decode kernels (split and merge, per
layout), int8 GEMM kernels and fills.  Any
failure raises and exits non-zero.  The
line before the last is a JSON object with one entry per kernel; the last
line is the device record.  Needs one CUDA device and
the sources of this checkout; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12  # H100 SXM: HBM3 bandwidth
# dense tensor-core peaks, per second; "popc": the CUDA cores' population
# counts, 16 per clock per SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) x 132 SMs x 1980 MHz boost
# "fp32": float32 FMA outside the tensor cores (67 TFLOP/s), the int8
# KV pool's attention, which computes on dequantized float32 K/V.  The
# binary tensor cores' rates are measured (probe_routes): none is published
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "popc": 16 * 132 * 1.98e9, "fp32": 67e12}
D, F, V = 2048, 5632, 100352  # stablelm-1.6b d_model, d_ff, vocab
# stablelm's serving, profile and traffic runs keep its published widths and
# cut its depth to SL_LAYERS of its 24 layers: a serving step is host-bound,
# per layer, and the training phases need the time.  The kernel timings below
# keep the 24-layer step (DECODE_GEMMS, PREFILL_GEMMS)
SL_LAYERS = 8
BS, HD = 16, 64  # KV block size, head dim
# (M, K, N) of the int8 GEMMs -> how many of each one forward pass runs
# (24 layers x q,k,v,o / up,gate / down, + lm_head): one decode step at 8
# slots, and an admission prefill of ~3k suffix tokens (ragged M)
DECODE_GEMMS = {(8, D, D): 24 * 4, (8, D, F): 24 * 2, (8, F, D): 24, (8, D, V): 1}
PREFILL_GEMMS = {(1531, D, D): 24 * 4, (3072, D, F): 24 * 2, (3072, F, D): 24, (1531, D, V): 1}
# each int8 GEMM kernel's edges (M, K, N): one activation row, 16 (two n8
# tiles), 17 (wgmma on a split K), N past a tile, K past a step, few weight
# rows with long K, ragged M, N and K at once, and K % 16 != 0 (the mma
# kernel)
INT8_EDGES = [(1, D, D), (16, D, D), (17, D, D), (8, D, 129), (8, 2064, D), (16, 12288, 40),
              (1531, 2064, 129), (8, 2056, D), (1531, 2056, 129)]
SRC_INT8 = "src/repro_torch/kernels/int8_matmul/csrc/int8_gemm_sm90.cu"
SRC_INT8_MMA = "src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu"
DECODE_FILLS = [130, 170, 230, 290, 330, 370, 400, 410]  # kv_len of 8 slots mid-run
# the sc plan runs every weight GEMM of DECODE_GEMMS through the stochastic
# GEMM; its admission prefill packs 4 requests of up to 160 tokens into 640
# rows, the lm_head included (the prefill's logits cover every position)
SC_PREFILL_GEMMS = {(640, D, D): 24 * 4, (640, D, F): 24 * 2, (640, F, D): 24, (640, D, V): 1}
SC_PREFILL_GEMM = (640, D, F)
# (B, M, K, N) of the batched int8 qk and pv products of one decode layer
# under mixed: 8 slots x 32 KV heads, one query row, the 32-block view
QKPV_DECODE = [(256, 1, HD, 512), (256, 1, 512, HD)]
# and of one admission of the 4 sc/mixed requests (64-160 tokens): 4 slots
# x 32 KV heads, 160 query rows against the 11-block (176-position) view
QKPV_ADMISSION = [(128, 160, HD, 176), (128, 160, 176, HD)]
# paged attention against its plain version: float32 1e-4 (same math; the
# kernel takes keys 32-64 at a time and rescales); bf16 2e-2 (the kernel
# rounds p to bf16 before the PV product, as the reference kernel does;
# the plain version keeps p in float32: 2^-8 relative on O(1) outputs)
F32_TOL, BF16_TOL = 1e-4, 2e-2
# the int8-pool branch against its plain version: float32 on both sides
# (q float32, K/V dequantized to the same float32 k * scale), so F32_TOL
INT8_POOL_TOL = F32_TOL
# flash attention against its plain version: float32 within F32_TOL; bf16
# within FLASH_BF16 = (atol, rtol), |got - want| <= atol + rtol * |want|
# per element.  The plain version rounds p to bf16 as the kernel does, but
# against the row's final max where the kernel uses its running max, and
# both outputs are rounded to bf16: a small drift plus one output ulp,
# which is at most 2^-7 of |want| and so grows with the output (1.56e-2
# on outputs in [2, 4)).  Dense decode as paged decode (F32_TOL /
# BF16_TOL): its output stays float32, and only its p is rounded to bf16.
FLASH_BF16 = (4e-3, 2.0 ** -7)
# paged kernel checks: block sizes 8, 12 (not a multiple of 8; most
# 16-key decode chunks start inside a block), 16 (the serving pool's) and
# 128 (a 64-key prefill tile, or a short decode split, inside one block);
# causal prefill suffix lengths 1, 37 (fold boundaries inside a 64-row
# tile) and 65 (a row past a tile)
PAGED_BLOCKS = (8, 12, 16, 128)
PREFILL_LENS = (1, 37, 65)
# the warm admission: 8 suffixes of 128 after a shared 256-token prefix
# already in the pool (what the prefix-sharing requests send)
WARM_PREFIX, WARM_S = 256, 128
SRC_PREFILL = "src/repro_torch/kernels/paged_attention/csrc/paged_prefill.cu"
DENSE_S = 512  # dense cache positions per slot: the serving runs' max_len
WIDE_HDS = (128, 256)  # the head dims beyond stablelm's, checked on every attention kernel
HEAD_DIMS_ALL = (16, HD) + WIDE_HDS  # every head dim the attention kernels are built for
SERVING_DRAWS = 4  # input draws each new kernel is held on at the serving shapes
# decode on both layouts: one split kernel and one merge kernel
SRC_DECODE = "src/repro_torch/kernels/paged_attention/csrc/decode.cu"
SRC_FLASH = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"


def held(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float = 0.0) -> tuple:
    """(max |got - want|, the largest share of its element's allowance
    ``atol + rtol * |want|``); the check holds when the share is at most 1."""
    diff, want = (got.float() - want.float()).abs(), want.float()
    return diff.max().item(), (diff / (atol + rtol * want.abs())).max().item()


def log(msg: str) -> None:
    print(msg, flush=True)


def n_sm(dev) -> int:
    """The device's SMs (an H100's 132 for a CPU rehearsal)."""
    from repro_torch.kernels import _build

    return _build.sm_count(dev.index or 0) if dev.type == "cuda" else 132


def bound_ms(n_bytes: float, ops: float, kind):
    """The least time the card could take: max(bytes / HBM rate, ops /
    peak rate of the operand type, ``kind`` naming it in ``PEAK_OPS`` or
    giving it per second), and which of the two it is."""
    peak = PEAK_OPS[kind] if isinstance(kind, str) else kind
    t_b, t_o = n_bytes / HBM_BYTES_S, ops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


_FLUSH = {}


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, CUDA events around
    each, with a 256 MB write between launches so L2 (50 MB) starts cold,
    as it does inside a decode step that streams gigabytes of weights.

    The device first spins (``torch.cuda._sleep``) while the host queues
    every launch, so the events time the kernels and not the host's gaps
    between them; if the spin ended before the host had queued them all,
    the spin doubles and the measurement is taken again."""
    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()  # warm-up
    cycles = 1 << 25  # ~20 ms at the H100's clock
    for _ in range(6):
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda._sleep(cycles)
        spin = torch.cuda.Event()
        spin.record()
        for a, b in events:
            _FLUSH["buf"].zero_()
            a.record()
            fn()
            b.record()
        queued_in_time = not spin.query()
        torch.cuda.synchronize()
        if queued_in_time:
            break
        cycles *= 2
    else:
        raise RuntimeError("the host could not queue the timed launches ahead of the device")
    return sum(a.elapsed_time(b) for a, b in events) / reps


def wall_ms(fn, reps: int = 1) -> float:
    """Mean time of ``reps`` calls on the host's clock, the device
    synchronized before and after.  For plain versions that launch more
    small kernels per call than the device's launch queue holds, so the
    queued-launch method of ``time_ms`` cannot take them; their host gaps
    are included, which is small beside the hundreds of milliseconds they
    run."""
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _check_paged_decode(dev, g, pool, qdt, tol) -> None:
    """Paged decode (``decode.cu`` through the block table) against its
    plain version on a ``pool`` (float32, bf16 or int8) with ``qdt``
    queries, at every head dim and block size ``PAGED_BLOCKS``: G 1, 2, 4
    and 10, softcap 0 and 30, kv_len 0 (zeros), 1, BS, BS + 1 and the
    whole table, table entries at scratch block 0, several splits a slot.
    The output comes in ``qdt``, within ``tol``; each call counts one
    launch (and one on the int8 branch for an int8 pool)."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref

    fn = pa.paged_attention_decode
    name = f"{str(pool).split('.')[-1]} pool, {str(qdt).split('.')[-1]} q"
    for hd in HEAD_DIMS_ALL:
        worst, n = 0.0, 0
        for bs in PAGED_BLOCKS:
            kvh = 8
            w = -(-80 // bs) + 1  # 80 positions and a block past them
            nb = 5 * w + 1
            kv_len = torch.tensor([0, 1, bs, bs + 1, w * bs], dtype=torch.int32, device=dev)
            table = torch.randint(1, nb, (5, w), generator=g, device=dev, dtype=torch.int32)
            table[1, 0] = table[4, w - 2] = 0  # entries at scratch block 0
            if pool == torch.int8:
                kp, vp, *scales = _int8_pool(g, dev, nb, kvh, hd, bs)
            else:
                kp, vp = (torch.randn(nb, kvh, bs, hd, generator=g, device=dev).to(pool)
                          for _ in range(2))
                scales = []
            kw = dict(zip(("k_scale", "v_scale"), scales))
            for grp in (1, 2, 4, 10):  # 2: granite's group; 10: the 16-row tile
                for softcap in (0.0, 30.0):
                    q = torch.randn(5, kvh * grp, hd, generator=g, device=dev).to(qdt)
                    before = (fn.launches, fn.int8_launches)
                    got = fn(q, kp, vp, table, kv_len, *scales, softcap=softcap)
                    counted = (fn.launches - before[0], fn.int8_launches - before[1])
                    if dev.type == "cuda":
                        assert counted == (1, int(pool == torch.int8)), counted
                    assert got.dtype == qdt and got.shape == q.shape
                    want = paged_decode_ref(q, kp, vp, table, kv_len, softcap=softcap, **kw)
                    err = (got.float() - want).abs().max().item()
                    assert err <= tol, (name, hd, bs, grp, softcap, err)
                    assert not got[0].any(), "kv_len 0 must give zeros"
                    worst, n = max(worst, err), n + 1
        log(f"[paged decode] {name} hd={hd}: {n} cases (BS {PAGED_BLOCKS}, G 1/2/4/10, softcap "
            f"0/30, kv_len 0 / 1 / BS / BS + 1 / W * BS, scratch-block entries, "
            f"{decode_splits(dev, 5, 8, 88)} splits at BS 8): max|kernel-plain| {worst:.2e} "
            f"<= {tol}")


def check_kernels(dev, g) -> None:
    """Phases 2-4: every kernel against its plain version on the card."""
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        _check_paged_decode(dev, g, dtype, dtype, tol)
    for m, k, n in [*DECODE_GEMMS, *PREFILL_GEMMS, *RG_DECODE_GEMMS, *RG_PREFILL_GEMMS,
                    *INT8_EDGES]:
        hold_int8_gemm(dev, g, m, k, n)


def hold_int8_gemm(dev, g, m: int, k: int, n: int, batch: int = 0) -> str:
    """The int8 GEMM (``batch == 0``) or its batched entry (``batch``
    products) at one shape on random codes: int32 accumulators equal to
    the plain version's bit for bit, and the kernel its plan picks (and
    no other) launched.  Returns that kernel's path."""
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref

    lead = (batch,) if batch else ()
    x = torch.randint(-127, 128, (*lead, m, k), generator=g, device=dev, dtype=torch.int8)
    w_t = torch.randint(-127, 128, (*lead, n, k), generator=g, device=dev, dtype=torch.int8)
    fn = i8.int8_gemm_batched if batch else i8.int8_gemm
    if batch:
        path, how = i8.int8_batched_plan(m, n, k), f"B={batch} "
    else:
        plan = i8.int8_gemm_plan(m, n, k, n_sm(dev))
        path, how = plan.path, ""
    before = dict(fn.paths)
    assert torch.equal(fn(x, w_t), int8_matmul_acc_ref(x, w_t)), (batch, m, k, n)
    moved = {p for p, c in fn.paths.items() if c != before[p]}
    assert moved == ({path} if dev.type == "cuda" else set()), (batch, m, k, n, path, moved)
    detail = "" if batch else f", grid {plan.grid}, {plan.splits} K splits"
    log(f"[int8 gemm{' batched' if batch else ''}] {how}M={m} K={k} N={n} ({path}{detail}): "
        "int32 accumulators equal the plain version bit for bit")
    return path


class _ShapeLog:
    """A kernel wrapper in its module's place that records each call's
    operand shapes (``int8_gemm``: (M, K, N); ``int8_gemm_batched``: (B,
    M, K, N)); its counters stay the wrapped function's."""

    def __init__(self, fn, shapes: set):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_shapes", shapes)

    def __call__(self, x, w_t):
        self._shapes.add((*x.shape, w_t.shape[-2]))
        return self._fn(x, w_t)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def int8_shapes():
    """Record the shapes the serving path gives the int8 GEMM and its
    batched entry while the block runs: yields ``{"int8_gemm": set,
    "int8_gemm_batched": set}``."""
    from repro_torch.kernels.int8_matmul import ops as i8

    seen = {"int8_gemm": set(), "int8_gemm_batched": set()}
    saved = {name: getattr(i8, name) for name in seen}
    for name, fn in saved.items():
        setattr(i8, name, _ShapeLog(fn, seen[name]))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(i8, name, fn)


def hold_served_int8_shapes(dev, seen: dict, label: str) -> None:
    """Every shape ``seen`` (:func:`int8_shapes`) held bit for bit on fresh
    random codes, each on the kernel its plan picks."""
    g = torch.Generator(device=dev).manual_seed(77)
    paths = {}
    for m, k, n in sorted(seen["int8_gemm"]):
        p = hold_int8_gemm(dev, g, m, k, n)
        paths[p] = paths.get(p, 0) + 1
    for b, m, k, n in sorted(seen["int8_gemm_batched"]):
        p = hold_int8_gemm(dev, g, m, k, n, batch=b)
        paths[f"batched {p}"] = paths.get(f"batched {p}", 0) + 1
    assert paths, (label, "no int8 product ran")
    log(f"[int8 gemm {label}] every shape the run gave the int8 GEMM ({len(seen['int8_gemm'])}) "
        f"and its batched entry ({len(seen['int8_gemm_batched'])}) held bit for bit, by "
        f"kernel: {paths}")
    _free(dev)


def time_kernels(dev, g, timer=time_ms) -> dict:
    """Phase 5: each kernel at the serving path's shapes beside its bound,
    and held there against its plain version (bf16 attention within
    ``BF16_TOL``, the int8 GEMM bit for bit)."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref

    out = {}
    h = kvh = 32
    w, nb = 32, 321
    kv_len = torch.tensor(DECODE_FILLS, dtype=torch.int32, device=dev)
    table = (torch.randperm(nb - 1, generator=g, device=dev)[: 8 * w].reshape(8, w) + 1).int()
    q = torch.randn(8, h, HD, generator=g, device=dev).bfloat16()
    kp = torch.randn(nb, kvh, BS, HD, generator=g, device=dev).bfloat16()
    vp = torch.randn(nb, kvh, BS, HD, generator=g, device=dev).bfloat16()
    k_ms = timer(lambda: pa.paged_attention_decode(q, kp, vp, table, kv_len))
    p_ms = timer(lambda: paged_decode_ref(q, kp, vp, table, kv_len))
    err = (pa.paged_attention_decode(q, kp, vp, table, kv_len).float()
           - paged_decode_ref(q, kp, vp, table, kv_len)).abs().max().item()
    assert err <= BF16_TOL, ("paged decode at serving shapes", err)
    fill = sum(DECODE_FILLS)
    n_bytes = 2 * q.numel() * 2 + 2 * fill * kvh * HD * 2 + table.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * fill * h * HD, "bf16")
    out["paged_attention_decode"] = dict(
        name="paged_attention_decode", route="cuda", source=SRC_DECODE,
        replaces="src/repro/kernels/paged_attention/kernel.py:146", max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[time paged decode] B=8 H=32 hd=64 bf16 kv_len {DECODE_FILLS}, "
        f"{decode_splits(dev, 8, kvh, w * BS)} splits: max|kernel-plain| "
        f"{err:.2e} <= {BF16_TOL}; kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms "
        f"{b_ms:.4f} ({b_by}) library_ms none (no single PyTorch call attends through a "
        "block table)")

    out["paged_attention_prefill"] = dict(
        name="paged_attention_prefill", route="cuda", source=SRC_PREFILL,
        replaces="src/repro/kernels/paged_attention/kernel.py:146", library_ms=None,
        **time_paged_prefill(dev, g, kp, vp, table, (), BF16_TOL, timer))

    out.update(time_int8_gemms(dev, g, "int8_gemm", DECODE_GEMMS, PREFILL_GEMMS, timer))
    return out


def time_paged_prefill(dev, g, kp, vp, table, scales, tol, timer=time_ms) -> dict:
    """The causal prefill kernel at the serving path's two admissions, on
    the pool ``kp``/``vp`` (32 KV heads of ``HD`` in blocks of ``BS``;
    ``scales`` its int8 scales or ``()``): cold, 8 suffixes of 384 from
    position 0 (the first 24 blocks of ``table``'s rows), and warm, 8
    suffixes of ``WARM_S`` after a ``WARM_PREFIX``-token prefix that the 8
    slots share.  Each is held against the plain version within ``tol``
    and timed beside its bound: each pool block the table reaches read
    once, q read and o written once (in the query dtype: bf16 for a bf16
    pool, float32 otherwise); 4 operations per visible (row, key) pair
    and head-dim element, on the tensor cores for bf16 and the CUDA cores
    for float32.  Flash attention of the query dtype is timed at the cold
    shape beside it, on dense K/V (the yardstick: the same causal work
    without the table).  A bf16 pool is also timed cold in blocks of 12,
    which its kernel gathers by ``cp.async`` (blocks of 16: TMA boxes).
    Returns the cold shape's numbers at ``BS``."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_prefill_ref

    h = kvh = kp.shape[1]
    qdt = torch.bfloat16 if kp.dtype == torch.bfloat16 else torch.float32
    pool = "int8" if scales else str(kp.dtype).split(".")[-1]
    kw = dict(zip(("k_scale", "v_scale"), scales))
    shared = table[0, : WARM_PREFIX // BS]  # the prefix's blocks, in every slot's table
    warm = torch.cat([shared.expand(8, -1),
                      table[:, WARM_PREFIX // BS: (WARM_PREFIX + WARM_S) // BS]], 1)
    cases = [("cold", 384, 0, BS, kp, vp, table[:, : 384 // BS].contiguous()),
             ("warm", WARM_S, WARM_PREFIX, BS, kp, vp, warm.contiguous())]
    if qdt == torch.bfloat16:  # the same cold admission in blocks of 12: the cp.async route
        kp12, vp12 = (torch.randn(8 * 32 + 1, kvh, 12, HD, generator=g, device=dev).to(qdt)
                      for _ in range(2))
        tbl12 = (torch.randperm(8 * 32, generator=g, device=dev).reshape(8, 32) + 1).int()
        cases.append(("cold", 384, 0, 12, kp12, vp12, tbl12))
    out = {}
    for label, s, n, bs, k_pool, v_pool, tbl in cases:
        start = torch.full((8,), n, dtype=torch.int32, device=dev)
        qs = torch.randn(8, h, s, HD, generator=g, device=dev).to(qdt)

        def kernel():
            return pa.paged_attention_prefill(qs, k_pool, v_pool, tbl, start, *scales)

        def plain():
            return paged_prefill_ref(qs, k_pool, v_pool, tbl, start, **kw)

        err = (kernel().float() - plain()).abs().max().item()
        assert err <= tol, (f"paged prefill {pool} pool {label} at serving shapes", err)
        k_ms, p_ms = timer(kernel, reps=5), timer(plain, reps=3)
        pairs = 8 * sum(n + i + 1 for i in range(s))  # visible (row, key) pairs per head
        ops = 4 * pairs * h * HD
        n_bytes = (2 * qs.numel() * qs.element_size()
                   + 2 * torch.unique(tbl).numel() * kvh * bs * HD * k_pool.element_size()
                   + tbl.numel() * 4 + start.numel() * 4 + 2 * kvh * 4 * bool(scales))
        b_ms, b_by = bound_ms(n_bytes, ops, "bf16" if qdt == torch.bfloat16 else "fp32")
        yard = ""
        if label == "cold" and bs == BS:
            qf, kf, vf = (torch.randn(8, h, s, HD, generator=g, device=dev).to(qdt)
                          for _ in range(3))
            f_ms = timer(lambda: fa.flash_attention(qf, kf, vf, causal=True), reps=5)
            yard = (f"; flash_ms {f_ms:.4f} (flash attention's {str(qdt).split('.')[-1]} "
                    "kernel, the same causal work on dense K/V)")
            out = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
        route = "" if qdt != torch.bfloat16 else (", TMA boxes" if bs % 8 == 0 else ", cp.async")
        log(f"[time paged prefill] {pool} pool {label}: B=8 S={s} from position {n} H={h} "
            f"hd={HD} BS={bs}{route}: max|kernel-plain| {err:.2e} <= {tol}; kernel_ms {k_ms:.4f} "
            f"plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms none (no single "
            f"PyTorch call attends through a block table){yard}; kernel "
            f"{ops / max(k_ms, 1e-9) / 1e9:.2f} TFLOP/s")
    return out


def time_int8_gemms(dev, g, name: str, decode: dict, prefill: dict, timer=time_ms,
                    plain_timer=time_ms) -> dict:
    """The int8 GEMM at one model's shapes, two kernel-table rows: ``name``,
    every weight GEMM of one decode step (``decode``: (M, K, N) -> count
    per step; the stream kernel), and ``name_admission``, every weight GEMM
    of one admission pass (``prefill``, counted the same way; the wgmma
    kernel) beside ``torch._int_mm`` on the same operands.  Each shape is
    held bit for bit against the plain version and timed; the rows sum
    over the pass, the bound over the pass's bytes and operations."""
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref

    rows = {}
    for phase, shapes in (("decode", decode), ("admission", prefill)):
        if not shapes:  # a row of one phase only
            continue
        k_ms = p_ms = l_ms = 0.0
        n_bytes = ops = err = 0
        paths = set()
        for (m, k, n), count in shapes.items():
            x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
            w_t = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
            plan = i8.int8_gemm_plan(m, n, k, n_sm(dev))
            paths.add(plan.path)
            diff = i8.int8_gemm(x, w_t).long() - int8_matmul_acc_ref(x, w_t).long()
            err = max(err, diff.abs().max().item())
            del diff
            t_k = timer(lambda: i8.int8_gemm(x, w_t), reps=10 if phase == "decode" else 5)
            t_p = plain_timer(lambda: int8_matmul_acc_ref(x, w_t),
                              reps=3 if phase == "decode" else 1)
            k_ms += count * t_k
            p_ms += count * t_p
            b_shape = m * k + n * k + 4 * m * n
            n_bytes += count * b_shape
            ops += count * 2 * m * n * k
            bb, by = bound_ms(b_shape, 2 * m * n * k, "int8")
            if phase == "decode":
                lib = "library_ms none (torch._int_mm takes M > 16 only)"
            else:
                t_l = timer(lambda: torch._int_mm(x, w_t.t()), reps=5)
                l_ms += count * t_l
                lib = f"library_ms {t_l:.4f} (torch._int_mm, kernel/library {t_k / t_l:.2f}x)"
            log(f"[time {name}] {phase} M={m} K={k} N={n} x{count} per pass ({plan.path}, "
                f"grid {plan.grid}, {plan.splits} K splits): kernel_ms {t_k:.4f} "
                f"plain_ms {t_p:.4f} bound_ms {bb:.4f} ({by}, {bb / t_k:.1%} of it) "
                f"{lib}; "
                f"{2 * m * n * k / max(t_k, 1e-9) / 1e9:.1f} TOPS")
            del x, w_t
        assert err == 0, (name, phase, err)
        b_ms, b_by = bound_ms(n_bytes, ops, "int8")
        lib = (f"library_ms {l_ms:.4f} (torch._int_mm summed the same way, kernel/library "
               f"{k_ms / l_ms:.2f}x)" if phase == "admission" else "library_ms none")
        log(f"[time {name}] all weight GEMMs of one {phase} pass, weighted by their counts "
            f"(path {'/'.join(sorted(paths))}): kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
            f"bound_ms {b_ms:.4f} ({b_by}, {b_ms / k_ms:.1%} of it) {lib}")
        row = name if phase == "decode" else f"{name}_admission"
        kernel = "stream" if phase == "decode" else "wgmma"
        rows[row] = dict(
            name=row, route="cuda", wrapper=f"int8_gemm_{kernel}",
            source=SRC_INT8, replaces="src/repro/kernels/int8_matmul/kernel.py:38",
            max_abs_err=float(err), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=l_ms if phase == "admission" else None)
        _free(dev)

    # short admissions (one and two 128-row tiles), where the plan may split
    # K: the wgmma kernel unsplit and split to about one block per SM, each
    # held bit for bit; int8_gemm_plan's split rule is set from these times
    for m in (64, 256):
        for (_, k, n), count in prefill.items():
            if count == 1:  # the head: its tiles fill the card at any M
                continue
            x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
            w_t = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
            ref = int8_matmul_acc_ref(x, w_t)
            plan = i8.int8_gemm_plan(m, n, k, n_sm(dev))
            times = []
            for want in (0, n_sm(dev)):
                p = i8.wgmma_plan(m, n, k, want)
                assert torch.equal(i8.run_plan(x, w_t, p), ref), (name, m, k, n, p.splits)
                times.append(f"{p.splits} splits {timer(lambda: i8.run_plan(x, w_t, p)):.4f} ms")
            log(f"[time {name}] short admission M={m} K={k} N={n}, {plan.grid[0] * plan.grid[1]} "
                f"tiles: wgmma {', '.join(times)}; the plan takes {plan.splits} splits")
            del x, w_t, ref
    return rows


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _event_ms(fn) -> float:
    """Device time of one call of ``fn`` between CUDA events."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def probe_routes(dev, card: str, target_ms: float = 20.0) -> dict:
    """Phase 1b: the rates the stochastic GEMM's candidate routes rest on
    (``stoch_probe.cu``), each as one launch of about ``target_ms`` over 4
    blocks an SM: ``mma.sync`` m16n8k256 b1 ``.and.popc`` and ``wgmma``
    m64n128k256 b1 in bit-MACs per second, random byte lookups into the
    16,641-byte pair table
    and random 16-byte lookups into a 128 KB table in lookups per second.
    Each is turned into signed products per second: 512 bit-MACs a
    product of sign planes (384 for ``2 * same - popc(X & W)``), one byte
    lookup a product, 8 products a 16-byte lookup of a per-position table
    of eight rows' signed products.  Returns the rates by name."""
    import ctypes

    from repro_torch.kernels import _build

    lib = _build.load("stoch_probe")
    fn = lib.stoch_probe_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks, threads = 4 * n_sm(dev), 256
    lookups, chains = lib.stoch_probe_lookups(), lib.stoch_probe_chains()
    g = torch.Generator(device=dev).manual_seed(7)
    idx = torch.randint(0, 2**31 - 1, (blocks * threads * lookups,), generator=g, device=dev,
                        dtype=torch.int32)
    table = torch.randint(0, 129, (129 * 129 + 15,), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    table_v4 = torch.randint(-2**31, 2**31 - 1, (8192 * 4,), generator=g, device=dev,
                             dtype=torch.int32)
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def timed(launch, work_per_iter: float, iters: int = 64) -> float:
        """Work per second of ``launch(iters)``, sized to about target_ms."""
        launch(iters)
        t = _event_ms(lambda: launch(iters))
        iters = max(iters, int(iters * target_ms / max(t, 1e-3)))
        return work_per_iter * iters / (_event_ms(lambda: launch(iters)) * 1e-3)

    def probe(kind, tbl):
        return lambda iters: _build.check(fn(kind, tbl.data_ptr(), idx.data_ptr(),
                                             out.data_ptr(), blocks, threads, iters, stream),
                                          f"stoch_probe {kind}")

    warps = blocks * threads // 32
    rates = {"mma_b1": timed(probe(0, table), warps * chains * 16 * 8 * 256),
             "lds_u8": timed(probe(1, table), blocks * threads * lookups),
             "lds_v4": timed(probe(2, table_v4), blocks * threads * lookups)}
    wout = torch.empty(blocks * 128, dtype=torch.int32, device=dev)
    rates["wgmma_b1"] = timed(
        lambda iters: _build.check(fn(3, table.data_ptr(), idx.data_ptr(), wout.data_ptr(),
                                      blocks, 128, iters, stream), "stoch_probe 3"),
        blocks * 64 * 128 * 256)
    log(f"[probe] {card}; {blocks} blocks x {threads} threads")
    log(f"[probe] mma.sync m16n8k256 b1 .and.popc {rates['mma_b1'] / 1e12:.2f} T bit-MAC/s = "
        f"{rates['mma_b1'] / 512 / 1e12:.4f} T products/s of sign planes (512 bit-MACs each) / "
        f"{rates['mma_b1'] / 384 / 1e12:.4f} (384: 2 * same - popc(X & W))")
    log(f"[probe] wgmma m64n128k256 b1 .and.popc {rates['wgmma_b1'] / 1e12:.2f} T bit-MAC/s "
        f"= {rates['wgmma_b1'] / 512 / 1e12:.4f} T products/s of sign planes (512) / "
        f"{rates['wgmma_b1'] / 384 / 1e12:.4f} (384)")
    log(f"[probe] shared-memory pair table (16,641 B), random byte lookups, 32 lanes on "
        f"independent indices: {rates['lds_u8'] / 1e12:.4f} T lookups/s = T products/s")
    log(f"[probe] 128 KB shared table, random 16-byte lookups: {rates['lds_v4'] / 1e12:.4f} T "
        f"lookups/s = {8 * rates['lds_v4'] / 1e12:.4f} T products/s at 8 signed products a "
        "lookup")
    del idx, table, table_v4, out, wout
    return rates


def _codes(g, dev, *shape) -> torch.Tensor:
    """Random int8 codes in [-127, 127], as quantize gives them."""
    return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)


def _signed_streams(q: torch.Tensor, gen: str):
    """``core.bitstream.encode_signed`` of int8 codes ``q`` (the reference's
    staging: -128's magnitude wraps in int8), a slice of codes at a time so
    a full weight's bits never exist at once: (words ``[..., 4]`` int32,
    signs int8)."""
    from repro_torch.core.bitstream import N_WORDS, encode_signed

    flat = q.reshape(-1)
    words = torch.empty(flat.numel(), N_WORDS, dtype=torch.int32, device=q.device)
    sign = torch.empty(flat.numel(), dtype=torch.int8, device=q.device)
    for i in range(0, flat.numel(), 1 << 20):
        w, s = encode_signed(flat[i:i + (1 << 20)], gen)
        words[i:i + (1 << 20)], sign[i:i + (1 << 20)] = w, s
    return words.reshape(*q.shape, N_WORDS), sign.reshape(q.shape)


def check_stochastic(dev, g) -> None:
    """The stochastic kernels and the batched int8 entry against their plain
    versions on the card, bit for bit.  ``bts_encode`` under every
    generator over every int8 code -128..127 (at -128 the full stream, as
    the reference's Pallas kernel gives it) and at ragged, activation and
    full weight shapes.  The stochastic GEMM on each of its entries against
    one plain result (``core.bitstream.encode_signed`` of both operands'
    codes, the reference's staging, where -128 wraps, a slice at a time; then
    ``stoch_matmul_packed_ref``): on ``stoch_matmul.cu`` the packed entry
    and the codes entry (activation codes against the weight's streams),
    on ``stoch_gemm_sm90.cu`` the codes x codes entry and its batched
    entry, under all 9 generator pairings at ragged M/N/K (both of its
    kernels: M of 1-16 on ``stream``, 17 and more on ``wgmma``, K off the
    16-byte and 4-byte paths, a K split), every code -127..127 among the
    activations, every code -128..127 on both sides, and a batch; at the
    decode shapes (M = 8 against every weight, the lm_head included), the
    sc admission shape and the batched decode qk/pv shapes one pairing
    each, in turn; the kernel each took asserted.  The batched int8 GEMM
    at the decode qk/pv shapes and ragged ones on its stream kernel, at
    the mixed admission's shapes and ragged ones past 16 rows on its tiles
    kernel, and with K % 16 != 0 or past 4096 on ``mma.sync``, -128 among
    each case's codes, the kernel's counter asserted each time."""
    from repro_torch.core.bitstream import GENERATORS
    from repro_torch.kernels.bts_encode import bts_encode
    from repro_torch.kernels.bts_encode.ref import bts_encode_ref
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref
    from repro_torch.kernels.stoch_matmul import ops as sm
    from repro_torch.kernels.stoch_matmul.ref import stoch_gemm_codes_ref, stoch_matmul_packed_ref

    def codes(*shape):
        return _codes(g, dev, *shape)

    for gen in GENERATORS:
        shapes = []
        for q in (torch.arange(-128, 128, device=dev).to(torch.int8), codes(37, 50),
                  codes(1, 3), codes(8, F), codes(D, F)):
            words, sign = bts_encode(q, gen)
            want_w, want_s = bts_encode_ref(q, gen)
            assert torch.equal(words, want_w) and torch.equal(sign, want_s), (gen, q.shape)
            if q.dim() == 1:  # code -128 first: the Pallas kernel's full stream
                assert words[0].eq(-1).all() and sign[0] == -1, gen
            shapes.append(tuple(q.shape))
        log(f"[bts encode] {gen} at {shapes} (every code -128..127 first; -128: the full "
            "stream): words and signs equal the plain version bit for bit")
    pairs = [(x, w) for x in GENERATORS for w in GENERATORS]
    ragged = [((), 5, 100, 33), ((), 70, 1000, 129), ((), 1, 17, 5), ((), 9, 2048, 200),
              ((), 2, 255, 40), ((4,), 3, 64, 40), ((), 16, 130, 47), ((), 17, 64, 16),
              ((), 200, 2056, 300), ((3,), 40, 100, 20), ((), 3, 256, 33), ((), 40, 256, 9)]
    cases = [(lead, m, k, n, p) for lead, m, k, n in ragged for p in pairs]
    cases += [((), m, k, n, pairs[i % len(pairs)])
              for i, (m, k, n) in enumerate(list(DECODE_GEMMS) + [SC_PREFILL_GEMM])]
    cases += [((b,), m, k, n, pairs[i]) for i, (b, m, k, n) in enumerate(QKPV_DECODE)]
    fns = (sm.stoch_matmul_packed, sm.stoch_matmul_codes, sm.stoch_matmul_codes_batched,
           sm.stoch_gemm_codes)
    for lead, m, k, n, (x_gen, w_gen) in cases:
        xq, wq = codes(*lead, m, k), codes(*lead, n, k)
        if k == 255:  # every code quantize gives, in both orders
            xq[0] = torch.arange(-127, 128, dtype=torch.int8, device=dev)
            xq[1] = xq[0].flip(0)
        if k == 256:  # every int8 code, -128 included, on both sides
            xq[0] = wq[0] = torch.arange(-128, 128, device=dev).to(torch.int8)
            xq[1] = wq[1] = xq[0].flip(0)
        (xs, sx), (ws, sw) = _signed_streams(xq, x_gen), _signed_streams(wq, w_gen)
        want = stoch_matmul_packed_ref(xs, sx, ws, sw)
        if k == 256:  # code -128: the binary kernels' own plain version agrees
            assert torch.equal(want.cpu(), stoch_gemm_codes_ref(xq.cpu(), wq.cpu(), x_gen,
                                                                w_gen)), (lead, m, n)
        before = [f.launches for f in fns]
        kernel = sm.stoch_gemm_plan(m, n, k, n_sm(dev), lead[0] if lead else 1)[0]
        paths = {f: dict(f.paths) for f in fns[2:]}
        forms = ["packed"]
        assert torch.equal(sm.stoch_matmul_packed(xs, sx, ws, sw), want), (lead, m, k, n)
        if not lead:
            assert torch.equal(sm.stoch_matmul_codes(xq, ws, sw, x_gen), want), (m, k, n)
            assert torch.equal(sm.stoch_gemm_codes(xq, wq, x_gen, w_gen), want), (
                m, k, n, x_gen, w_gen, kernel)
            forms += ["codes", f"codes x codes ({kernel})"]
        xb, wb = (xq, wq) if lead else (xq[None], wq[None])
        got = sm.stoch_matmul_codes_batched(xb, wb, x_gen, w_gen)
        assert torch.equal(got if lead else got[0], want), (lead, m, k, n, x_gen, w_gen)
        forms.append(f"batched codes x codes ({kernel})")
        assert [f.launches - b for f, b in zip(fns, before)] == [1, int(not lead), 1,
                                                                 int(not lead)]
        for f, old in paths.items():
            moved = {p: c - old[p] for p, c in f.paths.items() if c != old[p]}
            assert moved == ({kernel: 1} if f.launches > before[fns.index(f)] else {}), (
                f.__name__, moved, kernel)
        log(f"[stoch matmul] {'B=%d ' % lead[0] if lead else ''}M={m} K={k} N={n} "
            f"({x_gen} x {w_gen}): {', '.join(forms)} int32 accumulators equal the plain "
            "version bit for bit")
        del xq, wq, xs, sx, ws, sw, want, got
    batched = [(b, m, k, n, "stream") for b, m, k, n in QKPV_DECODE]
    batched += [(4, m, k, n, "stream" if k % 16 == 0 else "mma")
                for m in (1, 3, 16) for k in (64, 100, 512) for n in (5, 512, 513)]
    batched += [(b, m, k, n, "tiles") for b, m, k, n in QKPV_ADMISSION]
    # the tiles kernel's edges: one row past an m16 pair, N of one column
    # and N % 4 != 0 (4-byte stores), N cut into two and three tiles, K at
    # the limit of 4096 in stages, past it (mma.sync), and a long M
    batched += [(4, 17, 64, 1, "tiles"), (3, 45, 96, 33, "tiles"), (2, 33, 4096, 257, "tiles"),
                (2, 300, 64, 513, "tiles"), (2, 40, 4112, 64, "mma"), (1, 1531, 128, 384, "tiles")]
    batched += [(3, 5, 100, 33, "mma"), (2, 9, 4096, 40, "stream")]
    fn = i8.int8_gemm_batched
    for b, m, k, n, path in batched:
        x, w_t = codes(b, m, k), codes(b, n, k)
        x[0, 0], w_t[0, 0] = -128, -128  # every int8 code, -128 included
        before = dict(fn.paths)
        assert torch.equal(fn(x, w_t), int8_matmul_acc_ref(x, w_t)), (b, m, k, n)
        moved = {p: c - before[p] for p, c in fn.paths.items() if c != before[p]}
        assert moved == {path: 1}, (b, m, k, n, moved)
    log(f"[int8 gemm batched] {len(batched)} batches (B, M, K, N, kernel) "
        f"{[c for c in batched]}: int32 accumulators equal the plain version bit for bit, "
        "each on the kernel int8_batched_plan picks")


def time_stochastic(dev, g, timer=time_ms, plain_timer=wall_ms, rates=None) -> dict:
    """The stochastic kernels and the batched int8 entry at the serving
    path's shapes beside their bounds.  The weight encodes ``bts_encode``
    would run for ``stoch_matmul_codes`` (169 weights; the serving path
    launches none).  One ``sc`` decode step (M = 8, every weight GEMM of
    ``DECODE_GEMMS``) on the binary tensor-core kernel
    (``stoch_gemm_codes``, the serving path), beside the CUDA-core kernel's
    codes entry (the parent's serving path) and packed entry; one ``sc``
    admission pass (``SC_PREFILL_GEMMS``, M = 640) on the binary kernel
    beside the codes entry.  The binary rows' bounds take the products, 384
    bit-MACs each, over the highest binary rate that ``probe_routes``
    measured (``wgmma``'s; ``rates``, probed here when not given): NVIDIA
    publishes no single-bit tensor-core rate.
    The batched int8 qk/pv products of one ``mixed`` decode step (24
    layers x qk, pv) on the stream kernel and of one ``mixed`` admission
    pass on the tiles kernel, each beside ``mma.sync`` at the same
    shapes, qk and pv each beside its own bound."""
    from repro_torch.kernels.bts_encode import bts_encode
    from repro_torch.kernels.bts_encode.ref import bts_encode_ref
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref
    from repro_torch.kernels.stoch_matmul import ops as sm
    from repro_torch.kernels.stoch_matmul.ref import (
        stoch_gemm_codes_ref, stoch_matmul_codes_ref, stoch_matmul_packed_ref,
    )

    def codes(*shape):
        return _codes(g, dev, *shape)

    if rates is None:
        rates = probe_routes(dev, card_line())
    # the least time of a signed product on the card, whichever kernel runs
    # it: the fewest bit-MACs the function needs (384: 2 same - popc(X & W))
    # at the highest binary rate measured (wgmma; it takes n8 with swapped
    # operands, so M = 8 can use it too)
    b1 = rates["wgmma_b1"] / 384
    out = {}
    # the weight encodes: every weight [N, K] of a stablelm layer (q, k, v,
    # o; up, gate; down) and the lm_head, once each
    weights = {(D, D): 24 * 4, (F, D): 24 * 2, (D, F): 24, (V, D): 1}
    k_ms = p_ms = 0.0
    n_bytes = err = 0
    for (r, c), count in weights.items():
        q = codes(r, c)
        w_k, s_k = bts_encode(q, "bresenham")
        w_p, s_p = bts_encode_ref(q, "bresenham")
        err = max(err, (w_k.long() - w_p.long()).abs().max().item(),
                  (s_k.long() - s_p.long()).abs().max().item())
        del w_k, s_k, w_p, s_p
        t_k = timer(lambda: bts_encode(q, "bresenham"), reps=3)
        t_p = plain_timer(lambda: bts_encode_ref(q, "bresenham"))
        k_ms, p_ms, n_bytes = k_ms + count * t_k, p_ms + count * t_p, n_bytes + count * 18 * r * c
        bb, _ = bound_ms(18 * r * c, 0, "int8")
        log(f"[time bts encode] weight {r} x {c} (bresenham) x{count}: kernel_ms {t_k:.4f} "
            f"plain_ms {t_p:.4f} bound_ms {bb:.4f} (bytes)")
        del q
        _free(dev)
    assert err == 0, ("bts_encode at the weight shapes", err)
    b_ms, b_by = bound_ms(n_bytes, 0, "int8")
    out["bts_encode"] = dict(
        name="bts_encode", route="cuda",
        source="src/repro_torch/kernels/bts_encode/csrc/bts_encode.cu",
        replaces="src/repro/kernels/bts_encode/kernel.py:54", max_abs_err=float(err),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[time bts encode] every weight's streams (169 weights): kernel_ms "
        f"{k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms none (no "
        "PyTorch call encodes stochastic streams)")

    replaces = "src/repro/kernels/stoch_matmul/kernel.py:50"
    src_b1 = "src/repro_torch/kernels/stoch_matmul/csrc/stoch_gemm_sm90.cu"
    src_cc = "src/repro_torch/kernels/stoch_matmul/csrc/stoch_matmul.cu"
    # per entry: [kernel ms, plain ms, bytes, ops] summed over the step
    step = {e: [0.0, 0.0, 0, 0] for e in ("b1", "codes", "packed")}
    err = 0
    for (m, k, n), count in DECODE_GEMMS.items():
        xq, wq = codes(m, k), codes(n, k)
        assert sm.stoch_gemm_plan(m, n, k, n_sm(dev))[0] == "stream", (m, k, n)
        got = sm.stoch_gemm_codes(xq, wq, "thermometer", "bresenham")
        err = max(err, (got.long() - stoch_gemm_codes_ref(xq, wq).long()).abs().max().item())
        ws, sw = bts_encode(wq, "bresenham")
        xs, sx = bts_encode(xq, "thermometer")
        assert torch.equal(sm.stoch_matmul_codes(xq, ws, sw, "thermometer"), got)
        assert torch.equal(sm.stoch_matmul_packed(xs, sx, ws, sw), got)
        runs = {
            "b1": (lambda: sm.stoch_gemm_codes(xq, wq, "thermometer", "bresenham"),
                   lambda: stoch_gemm_codes_ref(xq, wq), (m + n) * k + 4 * m * n, m * n * k),
            "codes": (lambda: sm.stoch_matmul_codes(xq, ws, sw, "thermometer"),
                      lambda: stoch_matmul_codes_ref(xq, ws, sw, "thermometer"),
                      (m + 17 * n) * k + 4 * m * n, 4 * m * n * k),
            "packed": (lambda: sm.stoch_matmul_packed(xs, sx, ws, sw),
                       lambda: stoch_matmul_packed_ref(xs, sx, ws, sw),
                       17 * (m + n) * k + 4 * m * n, 4 * m * n * k)}
        times = {}
        for e, (fn, plain, nb, ops) in runs.items():
            times[e] = timer(fn)
            acc = step[e]
            acc[0] += count * times[e]
            acc[1] += count * plain_timer(plain)
            acc[2] += count * nb
            acc[3] += count * ops
        bb, by = bound_ms((m + n) * k + 4 * m * n, m * n * k, b1)
        log(f"[time stoch matmul] M={m} K={k} N={n} x{count} per step: binary kernel_ms "
            f"{times['b1']:.4f} bound_ms {bb:.4f} ({by}); codes entry {times['codes']:.4f}; "
            f"packed entry {times['packed']:.4f}")
        del xq, wq, ws, sw, xs, sx, got
        _free(dev)
    assert err == 0, ("stoch_gemm_codes at decode shapes", err)
    rows = (("stoch_matmul", "b1", src_b1, ("stoch_gemm_codes_stream",
                                           "stoch_matmul_codes_batched_stream"), b1,
             "products at the measured wgmma b1 rate, 384 bit-MACs each"),
            ("stoch_matmul_codes", "codes", src_cc, "stoch_matmul_codes", PEAK_OPS["popc"],
             "popcounts"),
            ("stoch_matmul_packed", "packed", src_cc, "stoch_matmul_packed", PEAK_OPS["popc"],
             "popcounts"))
    for row, e, src, wrapper, peak, what in rows:
        k_ms, p_ms, nb, ops = step[e]
        b_ms, b_by = bound_ms(nb, ops, peak)
        out[row] = dict(name=row, route="cuda", wrapper=wrapper, source=src, replaces=replaces,
                        max_abs_err=float(err), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
        log(f"[time stoch matmul] all weight GEMMs of one sc decode step (M=8), {row}: "
            f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}, "
            f"{b_ms / k_ms:.1%} of it; bytes alone {nb / HBM_BYTES_S * 1e3:.4f}, "
            f"{what} {ops / peak * 1e3:.4f}) library_ms none (no PyTorch call computes an "
            "AND-popcount product)")
    log(f"[time stoch matmul] decode step: binary / codes entry "
        f"{step['b1'][0] / step['codes'][0]:.4f}, binary / packed "
        f"{step['b1'][0] / step['packed'][0]:.4f}")

    # the sc admission pass: every weight GEMM at the 4 packed prompts' 640 rows
    k_ms = p_ms = c_ms = 0.0
    nb = ops = err = 0
    for (m, k, n), count in SC_PREFILL_GEMMS.items():
        xq, wq = codes(m, k), codes(n, k)
        assert sm.stoch_gemm_plan(m, n, k, n_sm(dev))[0] == "wgmma", (m, k, n)
        got = sm.stoch_gemm_codes(xq, wq, "thermometer", "bresenham")
        err = max(err, (got.long() - stoch_gemm_codes_ref(xq, wq).long()).abs().max().item())
        t_k = timer(lambda: sm.stoch_gemm_codes(xq, wq, "thermometer", "bresenham"), reps=3)
        t_p = plain_timer(lambda: stoch_gemm_codes_ref(xq, wq))
        ws, sw = bts_encode(wq, "bresenham")
        assert torch.equal(sm.stoch_matmul_codes(xq, ws, sw, "thermometer"), got)
        t_c = timer(lambda: sm.stoch_matmul_codes(xq, ws, sw, "thermometer"), reps=1)
        k_ms, p_ms, c_ms = k_ms + count * t_k, p_ms + count * t_p, c_ms + count * t_c
        nb += count * ((m + n) * k + 4 * m * n)
        ops += count * m * n * k
        bb, by = bound_ms((m + n) * k + 4 * m * n, m * n * k, b1)
        log(f"[time stoch matmul] admission M={m} K={k} N={n} x{count} per pass: binary "
            f"kernel_ms {t_k:.4f} plain_ms {t_p:.4f} bound_ms {bb:.4f} ({by}); codes entry "
            f"{t_c:.4f}; binary {m * n * k / max(t_k, 1e-9) / 1e9:.2f} T products/s")
        del xq, wq, ws, sw, got
        _free(dev)
    assert err == 0, ("stoch_gemm_codes at the sc admission shapes", err)
    b_ms, b_by = bound_ms(nb, ops, b1)
    out["stoch_matmul_admission"] = dict(
        name="stoch_matmul_admission", route="cuda",
        wrapper=("stoch_gemm_codes_wgmma", "stoch_matmul_codes_batched_wgmma"), source=src_b1,
        replaces=replaces, max_abs_err=float(err), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"[time stoch matmul] all weight GEMMs of one sc admission pass (M=640): binary "
        f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}: products at "
        f"the measured wgmma b1 rate, 384 bit-MACs each; {b_ms / k_ms:.1%} of it) library_ms "
        f"none; codes entry "
        f"{c_ms:.4f} (binary / codes {k_ms / c_ms:.4f})")

    for phase, shapes in (("decode", QKPV_DECODE), ("admission", QKPV_ADMISSION)):
        k_ms = p_ms = mma_ms = 0.0
        n_bytes = ops = err = 0
        for b, m, k, n in shapes:
            x, w_t = codes(b, m, k), codes(b, n, k)
            path = i8.int8_batched_plan(m, n, k)
            diff = i8.int8_gemm_batched(x, w_t).long() - int8_matmul_acc_ref(x, w_t).long()
            err = max(err, diff.abs().max().item())
            t_k = timer(lambda: i8.int8_gemm_batched(x, w_t))
            t_p = timer(lambda: int8_matmul_acc_ref(x, w_t), reps=3)
            t_m = t_k if path == "mma" else timer(lambda: i8._launch(x, w_t, "mma.sync"))
            k_ms, p_ms, mma_ms = k_ms + 24 * t_k, p_ms + 24 * t_p, mma_ms + 24 * t_m
            nb = b * (m + n) * k + 4 * b * m * n
            n_bytes += 24 * nb
            ops += 24 * 2 * b * m * n * k
            bb, by = bound_ms(nb, 2 * b * m * n * k, "int8")
            log(f"[time int8 gemm batched] {phase} B={b} M={m} K={k} N={n} x24 per pass "
                f"({path}): kernel_ms {t_k:.4f} (mma.sync {t_m:.4f}) plain_ms {t_p:.4f} "
                f"bound_ms {bb:.4f} ({by}, {bb / t_k:.1%} of it)")
            del x, w_t, diff
        assert err == 0, ("int8 gemm batched", phase, err)
        b_ms, b_by = bound_ms(n_bytes, ops, "int8")
        row = "int8_gemm_batched" if phase == "decode" else "int8_gemm_batched_admission"
        _, m0, k0, n0 = shapes[0]
        kernel = i8.int8_batched_plan(m0, n0, k0)
        out[row] = dict(
            name=row, route="cuda", wrapper=f"int8_gemm_batched_{kernel}",
            source=SRC_INT8_MMA if kernel == "mma" else SRC_INT8,
            replaces="src/repro/kernels/int8_matmul/kernel.py:38", max_abs_err=float(err),
            ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(f"[time int8 gemm batched] all qk/pv products of one mixed {phase} pass ({kernel}): "
            f"kernel_ms {k_ms:.4f} (mma.sync at the same shapes {mma_ms:.4f}) plain_ms "
            f"{p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}, {b_ms / k_ms:.1%} of it) library_ms none "
            "(no single PyTorch call gives a batch of int8 products in int32: torch._int_mm "
            "takes one 2-D product)")
    return out


def _int8_pool(g, dev, n_blocks, kvh, hd, bs=BS):
    """Random int8 K/V pools and per-KV-head float32 scales (what
    calibration gives: ~absmax / 127)."""
    pools = [torch.randint(-127, 128, (n_blocks, kvh, bs, hd), generator=g, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(kvh, generator=g, device=dev) * 0.02 + 0.01 for _ in range(2)]
    return (*pools, *scales)


def check_int8_pool(dev, g) -> None:
    """Paged decode's int8-pool branch against its plain version
    (``_check_paged_decode``): float32 queries within ``INT8_POOL_TOL``,
    and bf16 queries (the serving model's, the output written in bf16)
    within ``BF16_TOL``.  Its causal prefill: ``check_paged_prefill``."""
    for qdt, tol in ((torch.float32, INT8_POOL_TOL), (torch.bfloat16, BF16_TOL)):
        _check_paged_decode(dev, g, torch.int8, qdt, tol)


def time_int8_pool(dev, g, timer=time_ms) -> dict:
    """The int8-pool branch at the serving shapes — decode of 8 slots x 32
    heads x 64 at ``DECODE_FILLS``, causal prefill at the cold and warm
    admissions (``time_paged_prefill``) — held against its plain version
    within ``INT8_POOL_TOL`` and timed beside its bound (int8 K/V read
    once, float32 queries and outputs; float32 operations)."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref

    out = {}
    replaces = "src/repro/kernels/paged_attention/kernel.py:146"  # its int8 branch, :96-98
    h = kvh = 32
    w, nb = 32, 321
    kv_len = torch.tensor(DECODE_FILLS, dtype=torch.int32, device=dev)
    table = (torch.randperm(nb - 1, generator=g, device=dev)[: 8 * w].reshape(8, w) + 1).int()
    q = torch.randn(8, h, HD, generator=g, device=dev)
    kp, vp, ks, vs = _int8_pool(g, dev, nb, kvh, HD)

    def kernel():
        return pa.paged_attention_decode(q, kp, vp, table, kv_len, ks, vs)

    def plain():
        return paged_decode_ref(q, kp, vp, table, kv_len, k_scale=ks, v_scale=vs)

    err = (kernel() - plain()).abs().max().item()
    assert err <= INT8_POOL_TOL, ("int8 pool decode at serving shapes", err)
    k_ms, p_ms = timer(kernel), timer(plain)
    fill = sum(DECODE_FILLS)
    n_bytes = 2 * q.numel() * 4 + 2 * fill * kvh * HD + table.numel() * 4 + 2 * kvh * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * fill * h * HD, "fp32")
    out["paged_attention_decode_int8"] = dict(
        name="paged_attention_decode_int8", route="cuda", source=SRC_DECODE, replaces=replaces,
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)
    log(f"[time int8 pool decode] B=8 H=32 hd=64 int8 K/V, f32 q, kv_len {DECODE_FILLS}, "
        f"{decode_splits(dev, 8, kvh, w * BS)} splits: "
        f"max|kernel-plain| {err:.2e} <= {INT8_POOL_TOL}; kernel_ms {k_ms:.4f} plain_ms "
        f"{p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}; {n_bytes / 1e6:.2f} MB) library_ms none "
        "(no PyTorch call attends through a block table)")

    out["paged_attention_prefill_int8"] = dict(
        name="paged_attention_prefill_int8", route="cuda", source=SRC_PREFILL,
        replaces=replaces, library_ms=None,
        **time_paged_prefill(dev, g, kp, vp, table, (ks, vs), INT8_POOL_TOL, timer))
    return out


def check_paged_prefill(dev, g) -> None:
    """The causal prefill kernels (``paged_prefill.cu``) against their plain
    version on every pool (float32 and int8 within ``F32_TOL`` /
    ``INT8_POOL_TOL``, bf16 within ``BF16_TOL``) and head dim, G 1, 2, 4
    and 10, block sizes ``PAGED_BLOCKS``, suffix lengths ``PREFILL_LENS``,
    softcap 0 and 30, starts at 0, mid-block, on a block edge, past one
    and two blocks in, through tables with scratch-block entries; each
    call counts one launch (and one on the int8 branch for an int8
    pool)."""
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_prefill_ref

    fn = pa.paged_attention_prefill
    for name, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL), ("int8", INT8_POOL_TOL)):
        for hd in HEAD_DIMS_ALL:
            worst, n = 0.0, 0
            for bs in PAGED_BLOCKS:
                kvh = 4
                w = -(-(2 * bs + max(PREFILL_LENS)) // bs) + 1
                nb = 5 * w + 1
                start = torch.tensor([0, bs // 2, bs, bs + 7, 2 * bs], dtype=torch.int32,
                                     device=dev)
                table = torch.randint(1, nb, (5, w), generator=g, device=dev, dtype=torch.int32)
                table[1, 0] = table[4, -1] = 0  # entries at scratch block 0
                if name == "int8":
                    kp, vp, *scales = _int8_pool(g, dev, nb, kvh, hd, bs)
                    qdt = torch.float32
                else:
                    qdt = getattr(torch, name)
                    kp, vp = (torch.randn(nb, kvh, bs, hd, generator=g, device=dev).to(qdt)
                              for _ in range(2))
                    scales = []
                kw = dict(zip(("k_scale", "v_scale"), scales))
                for grp in (1, 2, 4, 10):
                    for s in PREFILL_LENS:
                        for softcap in (0.0, 30.0):
                            q = torch.randn(5, kvh * grp, s, hd, generator=g,
                                            device=dev).to(qdt)
                            before = (fn.launches, fn.int8_launches)
                            got = fn(q, kp, vp, table, start, *scales, softcap=softcap)
                            counted = (fn.launches - before[0], fn.int8_launches - before[1])
                            if dev.type == "cuda":
                                assert counted == (1, int(name == "int8")), counted
                            assert got.dtype == qdt and got.shape == q.shape
                            want = paged_prefill_ref(q, kp, vp, table, start, softcap=softcap,
                                                     **kw)
                            err = (got.float() - want).abs().max().item()
                            assert err <= tol, (name, hd, bs, grp, s, softcap, err)
                            worst, n = max(worst, err), n + 1
            log(f"[paged prefill] {name} pool hd={hd}: {n} cases (BS {PAGED_BLOCKS}, G 1/2/4/10, "
                f"S {PREFILL_LENS}, softcap 0/30, starts 0 / mid-block / block edge / past it "
                f"/ 2 blocks): max|kernel-plain| {worst:.2e} <= {tol}")


def check_prefill_padding(dev, g) -> None:
    """A suffix row's output must not depend on the rows packed beside it:
    the G query heads are folded over the padded suffix length, so the
    padding decides which rows share a 64-row tile.  For every pool, head
    dim 64 and 256, G 1, 4 and 10 and softcap 0 and 30, 8 real suffix rows
    (starts 0 and 32) alone and padded to 24 and 64 rows (the extra rows
    random) give bit-identical outputs for the real rows."""
    from repro_torch.kernels.paged_attention import ops as pa

    fn, bs, kvh, w = pa.paged_attention_prefill, BS, 4, 8
    start = torch.tensor([0, 32], dtype=torch.int32, device=dev)
    table = (torch.randperm(2 * w, generator=g, device=dev).reshape(2, w) + 1).int()
    n = 0
    for name in ("float32", "bfloat16", "int8"):
        for hd in (HD, 256):
            if name == "int8":
                kp, vp, *scales = _int8_pool(g, dev, 2 * w + 1, kvh, hd, bs)
                qdt = torch.float32
            else:
                qdt = getattr(torch, name)
                kp, vp = (torch.randn(2 * w + 1, kvh, bs, hd, generator=g, device=dev).to(qdt)
                          for _ in range(2))
                scales = []
            for grp in (1, 4, 10):
                for softcap in (0.0, 30.0):
                    q = torch.randn(2, kvh * grp, 64, hd, generator=g, device=dev).to(qdt)
                    alone = fn(q[:, :, :8].contiguous(), kp, vp, table, start, *scales,
                               softcap=softcap)
                    for s in (24, 64):
                        got = fn(q[:, :, :s].contiguous(), kp, vp, table, start, *scales,
                                 softcap=softcap)[:, :, :8]
                        # the plain version on the CPU makes no such promise
                        assert dev.type != "cuda" or torch.equal(got, alone), \
                            (name, hd, grp, softcap, s)
                        n += 1
    log(f"[paged prefill padding] {n} cases (float32 / bf16 / int8 pools, hd {HD} and 256, G "
        "1/4/10, softcap 0/30, 8 real rows at starts 0 and 32 padded to 24 and 64): the real "
        "rows' outputs bit-identical to those of the unpadded suffix")


def check_dense(dev, g) -> None:
    """Flash attention and dense decode against their plain versions at
    reduced shapes: flash at head dims 16, 64, 128 and 256, G = 1, 2, 4, 8
    (llama-3.2-vision's), causal with window 0 and 24, softcap 0 and 30, Sq
    = Sk not a multiple of the 64-row or 32/64-key tiles (and one
    non-causal case over 128 keys); dense decode over S = 100 positions
    (not a multiple of the 64-key chunk), G = 1, 2 (granite's), 4, 10, with
    kv_len 0, 1, S and between, softcap 0 and 30.  Each is ``held`` to
    ``F32_TOL`` in float32, flash to ``FLASH_BF16`` and dense decode to
    ``BF16_TOL`` in bf16; each call counts one launch."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import dense_decode_ref

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    for dtype, fa_tol, dd_tol in ((torch.float32, (F32_TOL,), F32_TOL),
                                  (torch.bfloat16, FLASH_BF16, BF16_TOL)):
        name = str(dtype).split(".")[-1]
        worst, share, n = 0.0, 0.0, 0
        for hd in HEAD_DIMS_ALL:
            for grp in (1, 2, 4, 8):
                for window in (0, 24):
                    for softcap in (0.0, 30.0):
                        kvh, s = 3, (37 if grp >= 4 else 100)
                        q = randn(2, kvh * grp, s, hd, dtype=dtype)
                        k, v = randn(2, kvh, s, hd, dtype=dtype), randn(2, kvh, s, hd, dtype=dtype)
                        before = fa.flash_attention.launches
                        got = fa.flash_attention(q, k, v, causal=True, window=window,
                                                 softcap=softcap)
                        assert fa.flash_attention.launches == before + 1
                        want = flash_attention_ref(q, k, v, causal=True, window=window,
                                                   softcap=softcap)
                        assert got.dtype == dtype and got.shape == q.shape
                        err, sh = held(got, want, *fa_tol)
                        assert sh <= 1, ("flash", name, hd, grp, window, softcap, err, sh)
                        worst, share, n = max(worst, err), max(share, sh), n + 1
            q = randn(2, 4, 50, hd, dtype=dtype)
            k, v = randn(2, 2, 128, hd, dtype=dtype), randn(2, 2, 128, hd, dtype=dtype)
            err, sh = held(fa.flash_attention(q, k, v, causal=False),
                           flash_attention_ref(q, k, v, causal=False), *fa_tol)
            assert sh <= 1, ("flash non-causal", name, hd, err, sh)
            worst, share, n = max(worst, err), max(share, sh), n + 1
        log(f"[flash] {name} {n} cases (hd 16/64/128/256, G 1/2/4/8, causal window 0/24, softcap "
            f"0/30, S 37/100; non-causal Sk 128): max|kernel-plain| {worst:.2e}, "
            f"{share:.3f} of the allowance")
        worst, share = 0.0, 0.0
        for hd in HEAD_DIMS_ALL:
            for grp in (1, 2, 4, 10):
                for softcap in (0.0, 30.0):
                    kvh, s = 4, 100
                    kv_len = torch.tensor([0, 1, 37, 64, 65, s], dtype=torch.int32, device=dev)
                    q = randn(6, kvh * grp, hd, dtype=dtype)
                    k, v = randn(6, kvh, s, hd, dtype=dtype), randn(6, kvh, s, hd, dtype=dtype)
                    before = pa.dense_attention_decode.launches
                    got = pa.dense_attention_decode(q, k, v, kv_len, softcap=softcap)
                    assert pa.dense_attention_decode.launches == before + 1
                    want = dense_decode_ref(q, k, v, kv_len, softcap=softcap)
                    err, sh = held(got, want, dd_tol)
                    assert sh <= 1, ("dense decode", name, hd, grp, softcap, err, sh)
                    assert not got[0].any(), "kv_len 0 must give zeros"
                    worst, share = max(worst, err), max(share, sh)
        log(f"[dense decode] {name} hd 16/64/128/256, G 1/2/4/10, softcap 0/30, S=100, kv_len "
            f"[0, 1, 37, 64, 65, 100]: max|kernel-plain| {worst:.2e}, {share:.3f} of the "
            "allowance")


def decode_splits(dev, b: int, kvh: int, s: int):
    """The decode kernel's split count for ``b`` slots x ``kvh`` KV heads
    over ``s`` key positions (a dense cache's length, or the table's ``W *
    BS``) on ``dev`` (None off the card)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention.ops import decode_split_plan

    if dev.type != "cuda":
        return None
    return decode_split_plan(b, kvh, s, _build.sm_count(dev.index or 0))


def time_dense(dev, g, timer=time_ms) -> dict:
    """Flash attention and dense decode at the serving shapes, held against
    their plain versions (``held``, on ``SERVING_DRAWS`` draws of the
    inputs each, the last one timed) and timed beside their bounds and one
    PyTorch call computing the same function
    (``scaled_dot_product_attention``, a yardstick only): flash = one
    admission prefill of 8 prompts packed to 384 tokens, 32 heads x 64,
    bf16, causal; dense decode = 8 slots of 32 heads x 64 over
    ``DENSE_S``-position caches at ``DECODE_FILLS`` (only the live
    positions count toward the bound)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import dense_decode_ref

    out = {}
    h = kvh = 32
    s = 384
    errs = []
    for _ in range(SERVING_DRAWS):
        q, k, v = (torch.randn(8, h, s, HD, generator=g, device=dev).bfloat16()
                   for _ in range(3))
        err, sh = held(fa.flash_attention(q, k, v, causal=True),
                       flash_attention_ref(q, k, v, causal=True), *FLASH_BF16)
        assert sh <= 1, ("flash at serving shapes", err, sh)
        errs.append((err, sh))
    err = max(e for e, _ in errs)

    def kernel():
        return fa.flash_attention(q, k, v, causal=True)

    def plain():
        return flash_attention_ref(q, k, v, causal=True)

    k_ms, p_ms = timer(kernel, reps=5), timer(plain, reps=3)
    l_ms = timer(lambda: sdpa(q, k, v, is_causal=True), reps=5)
    pairs = 8 * s * (s + 1) // 2  # causal (row, key) pairs per head
    n_bytes = 4 * q.numel() * 2  # q, k, v read and o written once, bf16
    b_ms, b_by = bound_ms(n_bytes, 4 * pairs * h * HD, "bf16")
    out["flash_attention"] = dict(
        name="flash_attention", route="cuda", source=SRC_FLASH,
        replaces="src/repro/kernels/flash_attention/kernel.py:85", max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
    log(f"[time flash] B=8 S=384 H=32 hd=64 bf16 causal: max|kernel-plain| (share of the "
        f"allowance) per draw {', '.join(f'{e:.2e} ({r:.3f})' for e, r in errs)}; kernel_ms "
        f"{k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {l_ms:.4f} "
        f"(scaled_dot_product_attention, is_causal); kernel "
        f"{4 * pairs * h * HD / max(k_ms, 1e-9) / 1e9:.2f} TFLOP/s")

    kv_len = torch.tensor(DECODE_FILLS, dtype=torch.int32, device=dev)
    mask = (torch.arange(DENSE_S, device=dev)[None] < kv_len[:, None])[:, None, None]
    errs = []
    for _ in range(SERVING_DRAWS):
        qd = torch.randn(8, h, HD, generator=g, device=dev).bfloat16()
        kc, vc = (torch.randn(8, kvh, DENSE_S, HD, generator=g, device=dev).bfloat16()
                  for _ in range(2))
        err, sh = held(pa.dense_attention_decode(qd, kc, vc, kv_len),
                       dense_decode_ref(qd, kc, vc, kv_len), BF16_TOL)
        assert sh <= 1, ("dense decode at serving shapes", err, sh)
        errs.append((err, sh))
    err = max(e for e, _ in errs)

    def kernel_d():
        return pa.dense_attention_decode(qd, kc, vc, kv_len)

    def plain_d():
        return dense_decode_ref(qd, kc, vc, kv_len)

    k_ms, p_ms = timer(kernel_d), timer(plain_d)
    l_ms = timer(lambda: sdpa(qd[:, :, None], kc, vc, attn_mask=mask))
    fill = sum(DECODE_FILLS)
    n_bytes = 2 * qd.numel() * 2 + 2 * fill * kvh * HD * 2 + kv_len.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * fill * h * HD, "bf16")
    out["dense_attention_decode"] = dict(
        name="dense_attention_decode", route="cuda", source=SRC_DECODE,
        replaces="src/repro/kernels/paged_attention/kernel.py:212", max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
    log(f"[time dense decode] B=8 H=32 hd=64 bf16 S={DENSE_S} kv_len {DECODE_FILLS}, "
        f"{decode_splits(dev, 8, kvh, DENSE_S)} splits: "
        f"max|kernel-plain| (share of the allowance) per draw "
        f"{', '.join(f'{e:.2e} ({r:.3f})' for e, r in errs)}; kernel_ms {k_ms:.4f} plain_ms "
        f"{p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {l_ms:.4f} "
        "(scaled_dot_product_attention over the whole cache with a length mask)")
    return out


# recurrentgemma-2b: rglru_scan at d_rnn 2560 over one 8-prompt admission
# of 256 tokens and over a full 2048-position window, and a reduced ragged
# shape; float32 within RG_TOL = rtol = atol (the reference kernel test's:
# the kernel folds carries across chunks and its FMA rounds a * h + b once,
# where the loop runs in order and rounds twice)
RG_D, RG_HD, RG_H, RG_WINDOW, RG_F, RG_V = 2560, 256, 10, 2048, 7680, 256000
# (M, K, N) of its int8 GEMMs: one decode step at 8 slots (18 rglru layers
# x in_proj d -> 2 d_rnn, gates a and x and out_proj at d x d; 8 local
# layers x q and o at d x d, k and v at d -> hd; 26 layers x up, gate and
# down; the tied head) and the 8 x 256-token admission, whose full-sequence
# prefill takes every position through each of them, the head included
RG_DECODE_GEMMS = {(8, RG_D, 2 * RG_D): 18, (8, RG_D, RG_D): 18 * 3 + 8 * 2,
                   (8, RG_D, RG_HD): 8 * 2, (8, RG_D, RG_F): 26 * 2, (8, RG_F, RG_D): 26,
                   (8, RG_D, RG_V): 1}
RG_PREFILL_GEMMS = {(8 * 256, k, n): c for (_, k, n), c in RG_DECODE_GEMMS.items()}
RG_SHAPES = [(3, 37, 130), (8, 256, RG_D), (8, 2048, RG_D)]
RG_TOL = 2e-5
RG_DECODE_FILLS = [260, 264, 268, 272, 276, 280, 284, 288]  # kv_len of 8 slots mid-run
# kernel rows timed at recurrentgemma's shapes: their launches are the rg runs'
RG_ROWS = ("rglru_scan", "rglru_scan_window", "flash_attention_hd256",
           "dense_attention_decode_hd256", "int8_gemm_rg", "int8_gemm_rg_admission",
           "paged_attention_decode_rg")


def check_rglru(dev, g) -> None:
    """The linear-recurrence kernel against its plain loop at ``RG_SHAPES``
    (decays uniform in [0.2, 0.999], as the reference kernel test draws
    them), one launch counted per call."""
    from repro_torch.kernels.rglru_scan import ops as rg
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    for b, s, d in RG_SHAPES:
        a = torch.rand(b, s, d, generator=g, device=dev) * 0.799 + 0.2
        x = torch.randn(b, s, d, generator=g, device=dev)
        before = rg.rglru_scan.launches
        got = rg.rglru_scan(a, x)
        assert rg.rglru_scan.launches == before + 1 and got.dtype == torch.float32
        err, sh = held(got, rglru_scan_ref(a, x), RG_TOL, RG_TOL)
        assert sh <= 1, ("rglru_scan", b, s, d, err, sh)
        log(f"[rglru_scan] B={b} S={s} D={d} float32: max|kernel-plain| {err:.2e}, {sh:.3f} "
            f"of the allowance {RG_TOL} + {RG_TOL} |want|")


def time_rglru(dev, g, timer=time_ms, plain_timer=wall_ms) -> dict:
    """The scan at one admission's shape ``[8, 256, 2560]`` (the row
    ``rglru_scan``) and at a full window ``[8, 2048, 2560]``
    (``rglru_scan_window``) beside its bound (3 x 4 bytes per element over
    the HBM rate) and the plain loop (on the host's clock: one small launch
    per step).  Each row's launches are the serving runs' launches at its
    sequence length (``rglru_scan_s<S>``)."""
    from repro_torch.kernels.rglru_scan import ops as rg
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    out = {}
    for b, s, d in RG_SHAPES[1:]:
        a = torch.rand(b, s, d, generator=g, device=dev) * 0.799 + 0.2
        x = torch.randn(b, s, d, generator=g, device=dev)
        err, sh = held(rg.rglru_scan(a, x), rglru_scan_ref(a, x), RG_TOL, RG_TOL)
        assert sh <= 1, ("rglru_scan at serving shapes", err, sh)
        k_ms = timer(lambda: rg.rglru_scan(a, x))
        p_ms = plain_timer(lambda: rglru_scan_ref(a, x))
        b_ms, b_by = bound_ms(3 * a.numel() * 4, 2 * a.numel(), "fp32")
        log(f"[time rglru_scan] B={b} S={s} D={d} float32: max|kernel-plain| {err:.2e}; "
            f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} (host clock) bound_ms {b_ms:.4f} "
            f"({b_by}, {b_ms / k_ms:.1%} of it) library_ms none (no single PyTorch call "
            f"computes a linear recurrence); kernel {3 * a.numel() * 4 / max(k_ms, 1e-9) / 1e9:.2f}"
            " TB/s")
        row = "rglru_scan" if (b, s, d) == RG_SHAPES[1] else "rglru_scan_window"
        out[row] = dict(
            name=row, route="cuda", wrapper=f"rglru_scan_s{s}",
            source="src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
            replaces="src/repro/kernels/rglru_scan/kernel.py:46", max_abs_err=err,
            ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return out


def check_wide_attention(dev, g) -> None:
    """Flash attention at recurrentgemma's shape where its window binds:
    ``[2, 10, 2560, 256]`` queries over one KV head, causal, window 2048,
    in float32 (``F32_TOL``) and bf16 (``FLASH_BF16``)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    s = 2560
    for dtype, tol in ((torch.float32, (F32_TOL,)), (torch.bfloat16, FLASH_BF16)):
        q = torch.randn(2, RG_H, s, RG_HD, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(2, 1, s, RG_HD, generator=g, device=dev).to(dtype) for _ in range(2))
        err, sh = held(fa.flash_attention(q, k, v, causal=True, window=RG_WINDOW),
                       flash_attention_ref(q, k, v, causal=True, window=RG_WINDOW), *tol)
        assert sh <= 1, ("flash window 2048", dtype, err, sh)
        log(f"[flash] {str(dtype).split('.')[-1]} B=2 H={RG_H} KV=1 S={s} hd={RG_HD} causal window "
            f"{RG_WINDOW}: max|kernel-plain| {err:.2e}, {sh:.3f} of the allowance")


def time_wide_attention(dev, g, timer=time_ms) -> dict:
    """Flash attention and dense decode at recurrentgemma-2b's serving
    shapes (10 query heads over 1 KV head of 256), bf16, held against
    their plain versions and timed beside their bounds and
    ``scaled_dot_product_attention`` (a yardstick only): flash = one
    admission of 8 prompts of 256 tokens (window 2048 does not bind), and
    the window-binding ``S = 2560`` for the log; dense decode = 8 slots
    over 2048-position rings at ``RG_DECODE_FILLS``."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import dense_decode_ref

    out = {}
    for b, s in ((8, 256), (2, 2560)):
        q = torch.randn(b, RG_H, s, RG_HD, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(b, 1, s, RG_HD, generator=g, device=dev).bfloat16()
                for _ in range(2))
        err, sh = held(fa.flash_attention(q, k, v, causal=True, window=RG_WINDOW),
                       flash_attention_ref(q, k, v, causal=True, window=RG_WINDOW), *FLASH_BF16)
        assert sh <= 1, ("flash hd 256 at serving shapes", b, s, err, sh)
        i = torch.arange(s, device=dev)
        mask = (i[:, None] >= i[None]) & (i[:, None] - i[None] < RG_WINDOW)
        ke, ve = k.expand(b, RG_H, s, RG_HD), v.expand(b, RG_H, s, RG_HD)
        k_ms = timer(lambda: fa.flash_attention(q, k, v, causal=True, window=RG_WINDOW), reps=5)
        p_ms = timer(lambda: flash_attention_ref(q, k, v, causal=True, window=RG_WINDOW),
                     reps=3)
        l_ms = timer(lambda: sdpa(q, ke, ve, attn_mask=mask), reps=5)
        pairs = int(mask.sum().item()) * b  # visible (row, key) pairs per head
        n_bytes = (2 * q.numel() + 2 * k.numel()) * 2  # q, k, v read and o written once
        b_ms, b_by = bound_ms(n_bytes, 4 * pairs * RG_H * RG_HD, "bf16")
        log(f"[time flash] B={b} S={s} H={RG_H} KV=1 hd={RG_HD} bf16 causal window {RG_WINDOW}: "
            f"max|kernel-plain| {err:.2e} ({sh:.3f}); kernel_ms {k_ms:.4f} plain_ms "
            f"{p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {l_ms:.4f} "
            "(scaled_dot_product_attention, windowed causal mask, K/V expanded); kernel "
            f"{4 * pairs * RG_H * RG_HD / max(k_ms, 1e-9) / 1e9:.2f} TFLOP/s")
        if s == 256:
            out["flash_attention_hd256"] = dict(
                name="flash_attention_hd256", route="cuda", wrapper="flash_attention",
                source=SRC_FLASH, replaces="src/repro/kernels/flash_attention/kernel.py:85",
                max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
        del q, k, v, ke, ve, mask

    kv_len = torch.tensor(RG_DECODE_FILLS, dtype=torch.int32, device=dev)
    mask = (torch.arange(RG_WINDOW, device=dev)[None] < kv_len[:, None])[:, None, None]
    errs = []
    for _ in range(SERVING_DRAWS):
        qd = torch.randn(8, RG_H, RG_HD, generator=g, device=dev).bfloat16()
        kc, vc = (torch.randn(8, 1, RG_WINDOW, RG_HD, generator=g, device=dev).bfloat16()
                  for _ in range(2))
        err, sh = held(pa.dense_attention_decode(qd, kc, vc, kv_len),
                       dense_decode_ref(qd, kc, vc, kv_len), BF16_TOL)
        assert sh <= 1, ("dense decode hd 256 at serving shapes", err, sh)
        errs.append(err)
    err = max(errs)
    ke, ve = kc.expand(8, RG_H, RG_WINDOW, RG_HD), vc.expand(8, RG_H, RG_WINDOW, RG_HD)
    k_ms = timer(lambda: pa.dense_attention_decode(qd, kc, vc, kv_len))
    p_ms = timer(lambda: dense_decode_ref(qd, kc, vc, kv_len))
    l_ms = timer(lambda: sdpa(qd[:, :, None], ke, ve, attn_mask=mask))
    fill = sum(RG_DECODE_FILLS)
    n_bytes = 2 * qd.numel() * 2 + 2 * fill * RG_HD * 2 + kv_len.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * fill * RG_H * RG_HD, "bf16")
    out["dense_attention_decode_hd256"] = dict(
        name="dense_attention_decode_hd256", route="cuda", wrapper="dense_attention_decode",
        source=SRC_DECODE, replaces="src/repro/kernels/paged_attention/kernel.py:212",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=l_ms)
    log(f"[time dense decode] B=8 H={RG_H} KV=1 hd={RG_HD} bf16 S={RG_WINDOW} kv_len "
        f"{RG_DECODE_FILLS}, {decode_splits(dev, 8, 1, RG_WINDOW)} splits: max|kernel-plain| per "
        f"draw {', '.join(f'{e:.2e}' for e in errs)}; "
        f"kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms "
        f"{l_ms:.4f} (scaled_dot_product_attention over the whole ring with a length mask)")
    return out


def time_rg_paged_decode(dev, g, timer=time_ms) -> dict:
    """Paged decode at recurrentgemma-2b's local rings on the pool: 8 slots
    x 10 query heads over 1 KV head of 256, each slot's 2048-position ring
    through a 128-wide table of 16-position blocks (distinct random
    physical blocks), kv_len ``RG_DECODE_FILLS`` (260-288: the split plan,
    chosen from the table's 2048 positions alone, leaves most splits with
    no live key).  Held against ``paged_decode_ref`` on a bf16 pool
    (``BF16_TOL``, ``SERVING_DRAWS`` draws) and on an int8 pool with
    per-head scales (float32 queries, ``INT8_POOL_TOL``); timed on the bf16
    pool beside its bound (q read and o written once, the live keys' K and
    V and their table entries read once), the plain version,
    ``scaled_dot_product_attention`` over the gathered ring with a length
    mask (the gather made before the timing) and, for the log, the dense
    decode kernel over the same ring laid out contiguously."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref

    fn = pa.paged_attention_decode
    w = RG_WINDOW // BS
    nb = 8 * w + 1
    kv_len = torch.tensor(RG_DECODE_FILLS, dtype=torch.int32, device=dev)
    table = (torch.randperm(nb - 1, generator=g, device=dev).reshape(8, w) + 1).int()
    errs = []
    for _ in range(SERVING_DRAWS):
        q = torch.randn(8, RG_H, RG_HD, generator=g, device=dev).bfloat16()
        kp, vp = (torch.randn(nb, 1, BS, RG_HD, generator=g, device=dev).bfloat16()
                  for _ in range(2))
        before = fn.launches
        err, sh = held(fn(q, kp, vp, table, kv_len), paged_decode_ref(q, kp, vp, table, kv_len),
                       BF16_TOL)
        assert sh <= 1 and fn.launches == before + (dev.type == "cuda"), \
            ("paged decode at recurrentgemma's rings", err, sh)
        errs.append(err)
    ki, vi, ks, vs = _int8_pool(g, dev, nb, 1, RG_HD)
    qf = torch.randn(8, RG_H, RG_HD, generator=g, device=dev)
    before = fn.int8_launches
    err8, sh8 = held(fn(qf, ki, vi, table, kv_len, ks, vs),
                     paged_decode_ref(qf, ki, vi, table, kv_len, k_scale=ks, v_scale=vs),
                     INT8_POOL_TOL)
    assert sh8 <= 1 and fn.int8_launches == before + (dev.type == "cuda"), \
        ("int8 pool at recurrentgemma's rings", err8, sh8)
    err = max(errs)

    def ring(pool):  # [8, 1, 2048, 256]: each slot's ring gathered through the table
        return pool[table.long()].movedim(1, 2).reshape(8, 1, RG_WINDOW, RG_HD)

    kr, vr = ring(kp), ring(vp)
    ke, ve = kr.expand(8, RG_H, RG_WINDOW, RG_HD), vr.expand(8, RG_H, RG_WINDOW, RG_HD)
    mask = (torch.arange(RG_WINDOW, device=dev)[None] < kv_len[:, None])[:, None, None]
    k_ms = timer(lambda: fn(q, kp, vp, table, kv_len))
    p_ms = timer(lambda: paged_decode_ref(q, kp, vp, table, kv_len))
    l_ms = timer(lambda: sdpa(q[:, :, None], ke, ve, attn_mask=mask))
    d_ms = timer(lambda: pa.dense_attention_decode(q, kr, vr, kv_len))
    fill = sum(RG_DECODE_FILLS)
    live_blocks = sum(-(-n // BS) for n in RG_DECODE_FILLS)
    n_bytes = 2 * q.numel() * 2 + 2 * fill * RG_HD * 2 + live_blocks * 4 + kv_len.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * fill * RG_H * RG_HD, "bf16")
    log(f"[time paged decode rg] B=8 H={RG_H} KV=1 hd={RG_HD} bf16 ring {RG_WINDOW} through a "
        f"{w}-wide table of {BS}-position blocks, kv_len {RG_DECODE_FILLS}, "
        f"{decode_splits(dev, 8, 1, w * BS)} splits: max|kernel-plain| per draw "
        f"{', '.join(f'{e:.2e}' for e in errs)} (<= {BF16_TOL}); int8 pool, float32 q: "
        f"{err8:.2e} (<= {INT8_POOL_TOL}); kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms "
        f"{b_ms:.4f} ({b_by}, {b_ms / k_ms:.1%} of it) library_ms {l_ms:.4f} "
        "(scaled_dot_product_attention over the gathered ring with a length mask); dense "
        f"decode kernel over the same ring, contiguous: {d_ms:.4f} ms")
    return {"paged_attention_decode_rg": dict(
        name="paged_attention_decode_rg", route="cuda", wrapper="paged_attention_decode",
        source=SRC_DECODE, replaces="src/repro/kernels/paged_attention/kernel.py:146",
        max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=l_ms)}


def make_prompts(vocab: int, rng) -> list:
    """12 prompts of 96-384 tokens; six share a 256-token prefix, and three
    of those (8-10) are admitted only after the first retirements, so
    they hit the prefix cache."""
    prefix = rng.integers(0, vocab, 256, dtype=np.int32)
    lens = [384, 96, 300, 128, 352, 200, 272, 160, 320, 288, 368, 112]
    shared = {0, 2, 4, 8, 9, 10}
    return [np.concatenate([prefix, rng.integers(0, vocab, n - 256, dtype=np.int32)])
            if i in shared else rng.integers(0, vocab, n, dtype=np.int32)
            for i, n in enumerate(lens)]


def make_rg_prompts(vocab: int, rng) -> list:
    """8 prompts of 256 tokens (one equal-length admission: the full-sequence
    prefill, rglru_scan in every recurrent layer), then 4 of 64-160 tokens
    (admitted when the first 8 retire: the masked token-by-token scan)."""
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in [256] * 8 + [160, 64, 128, 96]]


def make_sc_prompts(vocab: int, rng) -> list:
    """4 prompts of 64-160 tokens: the stochastic plans' request set, sized
    so their bit-true prefill stays a few seconds."""
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in (160, 64, 128, 96)]


# the kernels each plan's serving path must launch: qk/pv run in the paged
# kernel when exact (its int8 branch on an int8 pool); under mixed they are
# int8 and take the gathered view, on the batched entry's tiles kernel at
# admission and its stream kernel at decode; on dense caches (-dense)
# prefill runs the flash kernel and decode the dense decode kernel.  The
# int8 GEMM's admissions (M > 16) take its wgmma kernel and its decode
# steps (8 slots) the weight-streaming kernel.  The sc projections run the
# binary stochastic GEMM (stoch_gemm_codes: wgmma at admission, the
# mma.sync stream kernel at decode) on the weights' cached codes; no
# serving run launches bts_encode, prepare included (serve asserts both).
INT8_KERNELS = ("int8_gemm", "int8_gemm_wgmma", "int8_gemm_stream")
PLAN_KERNELS = {
    "exact": ("paged_attention_decode", "paged_attention_prefill"),
    "int8": ("paged_attention_decode", "paged_attention_prefill") + INT8_KERNELS,
    "sc": ("paged_attention_decode", "paged_attention_prefill", "stoch_gemm_codes",
           "stoch_gemm_codes_stream", "stoch_gemm_codes_wgmma"),
    "mixed": ("stoch_gemm_codes", "stoch_gemm_codes_stream", "stoch_gemm_codes_wgmma",
              "int8_gemm_batched", "int8_gemm_batched_stream", "int8_gemm_batched_tiles"),
    "exact-kvq": ("paged_attention_decode", "paged_attention_prefill",
                  "paged_attention_decode_int8", "paged_attention_prefill_int8"),
    "int8-kvq": ("paged_attention_decode", "paged_attention_prefill",
                 "paged_attention_decode_int8", "paged_attention_prefill_int8") + INT8_KERNELS,
    "exact-dense": ("flash_attention", "dense_attention_decode"),
    "int8-dense": ("flash_attention", "dense_attention_decode") + INT8_KERNELS,
    "rg-exact": ("flash_attention", "dense_attention_decode", "rglru_scan"),
    "rg-int8": ("flash_attention", "dense_attention_decode", "rglru_scan") + INT8_KERNELS,
    # chunked prefill: paged chunks through the causal prefill kernel at
    # in-block starts; dense chunks through the windowed masked scan, whose
    # steps are dense decode steps; the blocking runs of the 4 short
    # prompts beside them (mixed lengths: flash on stablelm, the masked
    # scan on recurrentgemma)
    "exact-chunked": ("paged_attention_decode", "paged_attention_prefill"),
    "exact-dense-short": ("flash_attention", "dense_attention_decode"),
    "exact-dense-chunked": ("dense_attention_decode",),
    "rg-exact-short": ("dense_attention_decode",),
    "rg-exact-chunked": ("dense_attention_decode",),
    # recurrentgemma on the paged pool: its local rings decode through the
    # paged kernel; admission prefills dense (flash and the scan for the
    # equal-length round, the masked scan's dense decode steps for the
    # mixed one) and scatters into the pools
    "rg-exact-paged": ("paged_attention_decode", "flash_attention", "rglru_scan",
                       "dense_attention_decode"),
    # the open-loop replay of a mixed trace (stablelm, paged, prefix on)
    "traffic": ("paged_attention_decode", "paged_attention_prefill"),
    # granite-moe-1b-a400m: the attention kernels at GQA 2 (its expert
    # products are plain bf16 products under exact and int8: uniform int8
    # leaves the MoE sites exact, as the reference's does; the plan that
    # quantizes them runs the batched int8 entry, its stream kernel at
    # decode and its tiles kernel at admission)
    "moe-exact": ("paged_attention_decode", "paged_attention_prefill"),
    "moe-int8": ("paged_attention_decode", "paged_attention_prefill") + INT8_KERNELS,
    "moe-experts-int8": ("paged_attention_decode", "paged_attention_prefill",
                         "int8_gemm_batched", "int8_gemm_batched_stream",
                         "int8_gemm_batched_tiles"),
    "moe-exact-dense": ("flash_attention", "dense_attention_decode"),
    "moe-exact-chunked": ("paged_attention_decode", "paged_attention_prefill"),
    # xlstm-125m: no attention layer; under int8 its projections
    "xl-exact": (),
    "xl-int8": INT8_KERNELS,
    # llama-3.2-vision-90b, one period, served text-only: every admission
    # is the masked scan (dense decode steps on the 4 attn layers; the
    # xattn layer runs plain attention over its zeroed cross cache), its
    # caches block-scattered into the pool; decode through the pool.  All
    # its int8 products have 8 rows or fewer (the scan's steps, decode): the
    # stream kernel only
    "vlm-exact": ("paged_attention_decode", "dense_attention_decode"),
    "vlm-int8": ("paged_attention_decode", "dense_attention_decode", "int8_gemm",
                 "int8_gemm_stream"),
    "vlm-exact-dense": ("dense_attention_decode",),
    "vlm-exact-dense-chunked": ("dense_attention_decode",),
    # musicgen-large: a pure attn stack, served like stablelm on its
    # [4, S] codebook grids
    "mg-exact": ("paged_attention_decode", "paged_attention_prefill"),
    "mg-int8": ("paged_attention_decode", "paged_attention_prefill") + INT8_KERNELS,
    "mg-exact-dense": ("flash_attention", "dense_attention_decode"),
    "mg-exact-chunked": ("paged_attention_decode", "paged_attention_prefill"),
}
ATTENTION_KERNELS = ("paged_attention_decode", "paged_attention_prefill",
                     "dense_attention_decode", "flash_attention")
# kernels a plan's serving path must not launch: mixed's qk/pv (K % 16 ==
# 0, K <= 4096 at every length it serves) never reach mma.sync; a dense
# chunked run takes no full-sequence pass
PLAN_ABSENT = {"mixed": ("int8_gemm_batched_mma",),
               "rg-exact-paged": ("paged_attention_prefill",),
               "exact-dense-chunked": ("flash_attention", "rglru_scan"),
               "rg-exact-short": ("flash_attention", "rglru_scan"),
               "rg-exact-chunked": ("flash_attention", "rglru_scan"),
               "moe-exact": ("int8_gemm", "int8_gemm_batched"),
               "moe-int8": ("int8_gemm_batched",),
               "moe-experts-int8": ("int8_gemm",),
               "xl-exact": ATTENTION_KERNELS + ("int8_gemm", "rglru_scan"),
               "xl-int8": ATTENTION_KERNELS + ("int8_gemm_batched", "rglru_scan"),
               "vlm-exact": ("paged_attention_prefill", "flash_attention", "int8_gemm"),
               "vlm-int8": ("paged_attention_prefill", "flash_attention", "int8_gemm_wgmma",
                            "int8_gemm_batched"),
               "vlm-exact-dense": ("flash_attention", "int8_gemm"),
               "vlm-exact-dense-chunked": ("flash_attention", "int8_gemm"),
               "mg-exact": ("int8_gemm", "int8_gemm_batched"),
               "mg-int8": ("int8_gemm_batched",)}
# kernels of one KV layout, which a serving run on the other must not
# launch: in the whole run, but for a stateful stack on the paged pool
# inside its decode chunks only (its admission prefills dense before the
# scatter into the pools)
LAYOUT_KERNELS = {
    "paged": ("paged_attention_decode", "paged_attention_prefill",
              "paged_attention_decode_int8", "paged_attention_prefill_int8"),
    "dense": ("flash_attention", "dense_attention_decode"),
}


# each serving run's launches by phase: label -> {"decode": [(steps, launches
# of that decode chunk)], "admission": [(prompt lengths, launches of that
# dense packed prefill)]} (filled by serve)
PHASES = {}


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _count_phases(engine, label: str) -> None:
    """Record ``engine``'s launches per decode chunk and per dense packed
    prefill into ``PHASES[label]`` (host-side counters: no sync)."""
    from repro_torch.kernels import launch_counts

    rec = PHASES[label] = {"decode": [], "admission": []}
    fused, small = engine._fused, engine._packed_prefill_small

    def fused_counted(*a, **kw):
        before = launch_counts()
        out = fused(*a, **kw)
        rec["decode"].append((kw["steps"], _delta(before, launch_counts())))
        return out

    def small_counted(reqs):
        before = launch_counts()
        out = small(reqs)
        rec["admission"].append(([r.prompt_len for r in reqs], _delta(before, launch_counts())))
        return out

    engine._fused, engine._packed_prefill_small = fused_counted, small_counted


def plain_runs(*plans) -> list:
    """Serving runs ``(label, plan, kv_quant)`` of preset plans on a
    pool in the model dtype."""
    return [(p, p, "none") for p in plans]


def _serving_model(cfg, dev, plan, kv_quant="none"):
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions

    return Model(cfg, ModelOptions(plan=plan, attn_impl="flash", kv_quant=kv_quant), device=dev)


def _sc_weights(tree) -> list:
    """The weights' cached sc codes (``wsc_t``) in a prepared param tree."""
    from repro_torch.core.ossm import WeightCodes

    if isinstance(tree, WeightCodes):
        return [tree]
    if isinstance(tree, dict):
        return [w for v in tree.values() for w in _sc_weights(v)]
    if isinstance(tree, (list, tuple)):
        return [w for v in tree for w in _sc_weights(v)]
    return []


def serve(cfg, params, prompts, dev, runs, gen: int, max_len: int = 512,
          kv_block_size: int = BS, chunk_tokens: int = 0, summary=None):
    """Phase 6: the engine for each ``(label, plan, kv_quant)`` run on the
    paged pool (``kv_block_size > 0``) or dense per-slot caches (0);
    returns each run's launches per kernel, counted from the engine's
    construction (``prepare`` launches nothing: the sc weights are cached as
    int8 codes, whose bytes the log gives) to the end of that serving run
    (no ``bts_encode`` at all), and its greedy tokens ``[requests, gen]``.  On the paged
    pool, plans that may reuse prefixes (exact, or static calibrated
    scales) must hit the prefix cache; on dense caches ``kv_stats`` and
    ``prefix_stats`` are empty.  No kernel of the other layout may launch.
    A stateful stack (recurrent or windowed layers) on the paged pool
    admits through a dense prefill, so the dense kernels are forbidden in
    its decode chunks only (``PHASES``), its pools hold only its attention
    layers' K and V, and its prefix cache is off.
    One run's prepared weight caches (int8 codes, cast copies) are freed
    before the next run's are made.  ``chunk_tokens > 0`` admits through
    the chunked-prefill scheduler at that budget, and some prompt must be
    split (more chunks than requests).  ``summary`` (a dict), if given,
    takes each run's mean TTFT, prefill and decode tok/s, scheduler
    counters and first request's modeled ASTRA report by label."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import dense_state_summary
    from repro_torch.models.attention import KVCache
    from repro_torch.models.rglru import RGLRUState
    from repro_torch.serve import ServeConfig, ServeEngine

    dense = kv_block_size == 0
    stateful = any(k != "attn" for k in cfg.layer_kinds)
    n_pools = sum(k in ("attn", "local") for k in cfg.layer_kinds)
    serve_cfg = ServeConfig(max_slots=8, max_len=max_len, chunk_steps=8,
                            kv_block_size=kv_block_size, attn_impl="flash", seed=0,
                            prefill_chunk_tokens=chunk_tokens)
    by_plan, tokens = {}, {}
    for label, plan, kv_quant in runs:
        model = _serving_model(cfg, dev, plan, kv_quant)
        warm = ServeEngine(model, params, serve_cfg, device=dev)
        warm.generate_batch(prompts[1:2], 2)
        del warm
        _free(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()  # from prepare on: the weight encodes count
        engine = ServeEngine(model, params, serve_cfg, device=dev)  # fresh: no warm prefix
        _count_phases(engine, label)
        _sync(dev)
        prepared = launch_counts()
        t0 = time.perf_counter()
        outs = engine.generate_batch(prompts, gen)
        _sync(dev)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        assert [o.gen_len for o in outs] == [gen] * len(prompts), [o.gen_len for o in outs]
        assert all(((o.tokens >= 0) & (o.tokens < cfg.vocab)).all() for o in outs)
        ps, st, kv = engine.prefix_stats, engine.phase_stats, engine.kv_stats
        sc_w = _sc_weights(engine.params)
        assert all(w.q.dtype == torch.int8 for w in sc_w), label
        sc_line = (f"; sc weight cache {len(sc_w)} weights as int8 codes, "
                   f"{sum(w.q.numel() + 4 * w.scale.numel() for w in sc_w) / 1e9:.4f} GB"
                   if sc_w else "")
        if dev.type == "cuda":
            assert sum(prepared.values()) == 0, (label, "prepare launched a kernel", prepared)
            assert counts["bts_encode"] == 0, (label, "bts_encode launched while serving",
                                               counts["bts_encode"])
            missing = [k for k in PLAN_KERNELS[label] if counts[k] == 0]
            assert not missing, (label, "kernels of the path never launched", missing, counts)
            absent = [k for k in PLAN_ABSENT.get(label, ()) if counts[k]]
            assert not absent, (label, "kernels off the path launched", absent, counts)
            if dense or not stateful:
                stray = [k for k in LAYOUT_KERNELS["paged" if dense else "dense"] if counts[k]]
            else:
                stray = [(k, d[k]) for _, d in PHASES[label]["decode"]
                         for k in LAYOUT_KERNELS["dense"] if d.get(k)]
            assert not stray, (label, "kernels of the other KV layout launched", stray, counts)
        if dense:
            assert kv == {} and ps == {}, (label, kv, ps)
            for state, kind in zip(engine._states["layers"], cfg.layer_kinds):
                if kind == "rglru":
                    assert isinstance(state, RGLRUState), label
                    assert state.h.shape == (8, cfg.d_rnn), label
                elif kind in ("mlstm", "slstm"):  # slot-indexed float32 recurrent states
                    assert type(state).__name__ == f"{kind[0].upper()}LSTMState", label
                    assert all(t.shape[0] == 8 and t.dtype == torch.float32
                               for t in state), label
                else:  # a cross cache holds the vision positions, a ring the window
                    ring = (cfg.vision_tokens if kind == "xattn" else
                            min(max_len, cfg.window) if kind == "local" else max_len)
                    shape = (8, cfg.n_kv_heads, ring, cfg.head_dim)
                    assert isinstance(state, KVCache) and tuple(state.k.shape) == shape, label
            kv_line = "dense " + dense_state_summary(engine._states, cfg)
        else:
            if stateful:  # rings and recurrent states cannot resume from pooled blocks
                assert not kv["prefix_cache"] and "recurrent/windowed" in \
                    kv["prefix_cache_off_reason"], (label, kv)
            elif plan == "exact" or kv_quant != "none":  # exact or static calibrated scales
                assert kv["prefix_cache"] and ps["hits"] > 0, (label, ps)
            else:
                assert not kv["prefix_cache"]  # dynamic scales: reuse gated off
            item = 1 if kv_quant == "int8" else (2 if cfg.dtype == "bfloat16" else 4)
            assert kv["kv_quant"] == kv_quant
            assert kv["bytes_per_block"] == (n_pools * 2 * cfg.n_kv_heads * BS
                                             * cfg.head_dim * item)
            kv_line = (f"kv pool {kv_quant} {kv['bytes_per_block']} B/block, "
                       f"{kv['pool_bytes']} B; prefix {ps or 'off: ' + kv.get('prefix_cache_off_reason', '')}")
        sched = engine.scheduler_stats
        if chunk_tokens:
            assert sched["active"] and sched["prefill_chunks"] > len(prompts), (label, sched)
        ttft = np.mean([o.timing.ttft_s for o in outs]) * 1e3
        if summary is not None:
            summary[label] = dict(ttft_ms=ttft, prefill_tps=st["prefill_tokens"] / st["prefill_s"],
                                  decode_tps=st["decode_tokens"] / st["decode_s"], sched=sched,
                                  kv=kv,
                                  hardware=outs[0].hardware, prompt=outs[0].prompt.shape[-1])
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
        log(f"[serve {label}] {cfg.name} ({cfg.n_layers}L d{cfg.d_model}), "
            f"{len(prompts)} requests x {gen} tokens, 8 slots: decode "
            f"{st['decode_tokens'] / st['decode_s']:.1f} tok/s ({st['decode_tokens']} "
            f"tokens in {st['decode_s']:.3f} s), prefill "
            f"{st['prefill_tokens'] / st['prefill_s']:.1f} tok/s, mean TTFT {ttft:.1f} ms, "
            f"end to end {len(prompts) * gen / wall:.1f} tok/s in {wall:.2f} s; {kv_line}; "
            f"scheduler {sched}; launches {counts}; peak memory {peak:.1f} GiB{sc_line}")
        by_plan[label] = counts
        tokens[label] = np.stack([o.tokens for o in outs])
        del engine
        _free(dev)
    return by_plan, tokens


# the open-loop replay: the mixed suite (chat, summarize, fan-out with
# shared prefixes) at 4 requests a second, 32 requests, seed 0
TRAFFIC = dict(suite="mixed", rate_rps=4.0, n=32, seed=0)
TRAFFIC_STEP_S = 0.05  # virtual seconds an engine round costs in the virtual replays
TRAFFIC_FAULT_KINDS = ("step_error", "nonfinite_logits", "pool_pressure")


def _traffic_stack_factory(cfg, params, dev, trace):
    """``stack(clock, injector=None, retries=0)``: a fresh front-end over a
    supervisor (delivering ``injector``'s faults, when given, and auditing
    every step) over a fresh engine (``exact``, paged pool of
    ``BS``-position blocks, 8 slots, prefix cache on)."""
    from repro_torch.serve import (
        EngineSupervisor, FrontendConfig, ServeConfig, ServeEngine, ServeFrontend,
    )
    from repro_torch.traffic import trace_max_len

    model = _serving_model(cfg, dev, "exact")
    scfg = ServeConfig(max_slots=8, max_len=-(-trace_max_len(trace) // BS) * BS, chunk_steps=8,
                       kv_block_size=BS, seed=0)

    def stack(clock, injector=None, retries=0):
        eng = ServeEngine(model, params, scfg, device=dev, clock=clock)
        return ServeFrontend(eng, FrontendConfig(max_retries=retries), clock=clock,
                             supervisor=EngineSupervisor(eng, injector))
    return stack


def _traffic_lines(tag, cfg, trace, r, m, extra="") -> None:
    ttfts = [o.timing.ttft_s for o in r.outputs
             if o.reject_reason is None and o.fault_reason is None]
    log(f"[{tag}] {cfg.name} exact, paged pool (block {BS}, 8 slots, prefix cache on): "
        f"{trace.suite} trace, {len(trace)} requests at {trace.rate_rps:g} rps "
        f"({trace.arrival}, seed {trace.seed}) replayed in {r.duration_s:.3f} s{extra}: "
        f"completed {m['n_completed']}/{m['n_offered']}, rejected "
        f"{m['rejected_by_reason'] or 0}, faulted {m['faulted_by_reason'] or 0}; "
        f"{m['completed_tok_s']:.1f} tok/s; TTFT p50/p95/p99/max "
        f"{m['ttft_p50_s'] * 1e3:.1f} / {m['ttft_p95_s'] * 1e3:.1f} / "
        f"{m['ttft_p99_s'] * 1e3:.1f} / {max(ttfts, default=0.0) * 1e3:.1f} ms; ITL "
        f"p50/p95/p99 {m['itl_p50_s'] * 1e3:.2f} / {m['itl_p95_s'] * 1e3:.2f} / "
        f"{m['itl_p99_s'] * 1e3:.2f} ms (each request's mean gap), max "
        f"{m['itl_max_s'] * 1e3:.2f} ms; queue p50 {m['queue_p50_s'] * 1e3:.1f} ms, "
        f"high-water depth {r.stats['max_queue_depth']}")


def _audit_clean(fe) -> str:
    """Audit the front-end's engine at the end of a replay (held blocks
    declared); every step's audit ran.  Returns the count for the log."""
    sup = fe.supervisor
    report = fe.engine.audit(external_refs=sup.held_blocks)
    assert report["leaked_blocks"] == 0 and sup.stats["audits_run"] == sup.stats["steps"]
    return f"{sup.stats['audits_run']} audits clean"


def serve_traffic(cfg, params, dev) -> dict:
    """``[traffic]``: the open-loop path ``ServeFrontend`` ->
    ``EngineSupervisor`` -> ``ServeEngine`` at full width: ``TRAFFIC``'s
    trace replayed in wall time (arrivals slept for, every timestamp the
    host's clock, an audit every step) after a warm replay of its first 8
    requests on a throwaway virtual-clock stack;
    completed/offered, rejections by reason, TTFT and ITL p50/p95/p99 and
    max (ITL percentiles over each request's mean gap, max over every gap),
    the kernels launched (counts reset just before the replay).  Returns
    those launches."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.traffic import VirtualClock, evaluate, generate_trace, replay_trace

    trace = generate_trace(vocab=cfg.vocab, **TRAFFIC)
    stack = _traffic_stack_factory(cfg, params, dev, trace)
    # warm: the trace's first 8 requests in virtual time on a throwaway stack
    replay_trace(stack(VirtualClock()), dataclasses.replace(trace, requests=trace.requests[:8]),
                 virtual_step_s=TRAFFIC_STEP_S)
    _free(dev)
    fe = stack(None)
    _sync(dev)
    reset_launches()
    r = replay_trace(fe, trace)
    _sync(dev)
    counts = launch_counts()
    m = evaluate(r.outputs, r.duration_s, offered_rps=trace.rate_rps)
    assert m["n_offered"] == len(trace) == m["n_completed"], m
    for rid in r.request_ids:
        out = r.outputs_by_id[rid]
        assert np.array_equal(r.token_streams[rid], out.tokens), rid
        assert ((out.tokens >= 0) & (out.tokens < cfg.vocab)).all()
    _traffic_lines("traffic", cfg, trace, r, m, " (wall clock)")
    log(f"[traffic] launches {counts}; prefix {fe.engine.prefix_stats}; {_audit_clean(fe)}")
    if dev.type == "cuda":
        missing = [k for k in PLAN_KERNELS["traffic"] if counts[k] == 0]
        stray = [k for k in LAYOUT_KERNELS["dense"] if counts[k]]
        assert not missing and not stray, (missing, stray, counts)
    del fe
    _free(dev)
    return {"traffic": counts}


def gemm_rows_by_packing(dev) -> str:
    """How a bf16 product's rows depend on the rows packed with them: the
    share of output elements of a few rows (8 and 24, as one or a few short
    prompts give) that differ in some bit from the same rows inside a
    256-row product, at stablelm's projection shapes.  cuBLAS picks a
    split-K kernel for a few rows at a long K (the down projection's 5632),
    whose partial sums add in another order."""
    g = torch.Generator(device=dev).manual_seed(0)
    parts = []
    for k, n in ((D, D), (D, F), (F, D)):
        w = (torch.randn(k, n, generator=g, device=dev) * 0.02).bfloat16()
        x = torch.randn(256, k, generator=g, device=dev).bfloat16()
        big = x @ w
        for lo, m in ((0, 8), (64, 24)):
            share = ((x[lo:lo + m] @ w) != big[lo:lo + m]).float().mean().item()
            parts.append(f"K {k} N {n} rows {lo}+{m}: {share:.4f}")
    return "; ".join(parts)


def _log_admissions(fe) -> list:
    """Record every paged admission round of ``fe``'s engine: a list with
    one entry a round, each member's (request id, prefix start, the rounds
    whose prefill wrote its matched prefix blocks, None for a block none
    wrote)."""
    eng = fe.engine
    rounds, writer, bs, prefill = [], {}, eng._block_size, eng._prefill_paged

    def logged(slot_ids, reqs):
        out = prefill(slot_ids, reqs)
        members = []
        for i, req, start in zip(out[0], out[1], out[3]):
            blocks = eng._slot_blocks[i]
            members.append((req.id, start, tuple(writer.get(b) for b in blocks[:start // bs])))
            writer.update((b, len(rounds)) for b in blocks[start // bs:])
        if members:
            rounds.append(members)
        return out
    eng._prefill_paged = logged
    return rounds


def _rounds_alike(faulted, clean, f_index, c_index):
    """``alike(r)``: whether the faulted replay's admission round ``r``
    packed the same requests (trace indices, via ``*_index`` from request
    id) at the same prefix starts, in the same order, as a round of the
    clean replay, every member's prefix blocks written by rounds alike in
    turn and matching the clean round's."""
    c_round = {c_index[rid]: r for r, members in enumerate(clean) for rid, _, _ in members}

    def sig(members, index):
        return [(index[rid], start) for rid, start, _ in members]

    @functools.cache
    def alike(r):
        members = faulted[r]
        twin = clean[c_round[f_index[members[0][0]]]]
        return sig(members, f_index) == sig(twin, c_index) and all(
            len(fs) == len(cs) and all(s is not None and alike(s)
                                       and c_round[f_index[faulted[s][0][0]]] == t
                                       for s, t in zip(fs, cs))
            for (_, _, fs), (_, _, cs) in zip(members, twin))
    return alike


def traffic_faults(cfg, params, dev) -> None:
    """``[traffic faults]``: ``TRAFFIC``'s trace twice in virtual time
    (``TRAFFIC_STEP_S`` a round): clean, then with
    ``ServeFaultInjector.periodic(100 * 32 + 4, every=4,
    TRAFFIC_FAULT_KINDS, seed=0)`` and 2 retries.  Asserts conservation
    (offered = completed + rejected + faulted + cancelled) and a clean
    ``audit()`` at the end.  Faults move admissions, so the faulted replay
    packs other prompts together, and a bf16 product's row rounds
    otherwise beside other rows (``gemm_rows_by_packing``).  So of the
    requests no fault touched (never faulted, never retried), those
    admitted in a round alike the clean replay's (``_rounds_alike``) must
    have its tokens; the others are counted."""
    from repro_torch.serve import ServeFaultInjector
    from repro_torch.traffic import VirtualClock, evaluate, generate_trace, replay_trace

    trace = generate_trace(vocab=cfg.vocab, **TRAFFIC)
    stack = _traffic_stack_factory(cfg, params, dev, trace)
    fe = stack(VirtualClock())
    clean_rounds = _log_admissions(fe)
    clean = replay_trace(fe, trace, virtual_step_s=TRAFFIC_STEP_S)
    del fe
    _free(dev)
    inj = ServeFaultInjector.periodic(n_steps=100 * len(trace) + 4, every=4,
                                      kinds=TRAFFIC_FAULT_KINDS, seed=0)
    fe = stack(VirtualClock(), inj, retries=2)
    rounds = _log_admissions(fe)
    retried = set()
    fe.on_retry = retried.add  # the replay chains its own hook after this one
    rf = replay_trace(fe, trace, virtual_step_s=TRAFFIC_STEP_S)
    mf = evaluate(rf.outputs, rf.duration_s, offered_rps=trace.rate_rps)
    assert mf["n_offered"] == len(trace) == (mf["n_completed"] + mf["n_rejected"]
                                            + mf["n_faulted"] + mf["n_cancelled"]), mf
    audits = _audit_clean(fe)
    f_index = {rid: i for i, rid in enumerate(rf.request_ids)}
    alike = _rounds_alike(rounds, clean_rounds, f_index,
                          {rid: i for i, rid in enumerate(clean.request_ids)})
    last_round = {rid: r for r, members in enumerate(rounds) for rid, _, _ in members}
    held = moved = moved_same = retried_same = n_retried_done = 0
    for i, rid in enumerate(rf.request_ids):
        out, want = rf.outputs_by_id[rid], clean.outputs_by_id[clean.request_ids[i]]
        if out.fault_reason is None and out.reject_reason is None:
            equal = np.array_equal(out.tokens, want.tokens)
            if rid in retried:
                n_retried_done += 1
                retried_same += equal
            elif alike(last_round[rid]):
                assert equal, (i, out.tokens, want.tokens)
                held += 1
            else:
                moved += 1
                moved_same += equal
    assert held > 0, (held, moved)
    sup, eng_st = fe.supervisor, fe.engine.stats()
    _traffic_lines("traffic faults", cfg, trace, rf, mf,
                   f" (virtual clock, {TRAFFIC_STEP_S} s a round)")
    mc = evaluate(clean.outputs, clean.duration_s, offered_rps=trace.rate_rps)
    _traffic_lines("traffic faults", cfg, trace, clean, mc, " (virtual clock, clean)")
    log(f"[traffic faults] {sup.stats['faults_injected']} faults injected over "
        f"{sup.stats['steps']} supervised steps ({TRAFFIC_FAULT_KINDS}, every 4, seed 0): "
        f"{eng_st['n_quarantined']} quarantined, {eng_st['n_shed']} shed, "
        f"{fe.stats['retries']} retries, degraded transitions "
        f"{[n for _, n in eng_st['degraded_transitions']]}; conservation {mf['n_offered']} = "
        f"{mf['n_completed']} + {mf['n_rejected']} + {mf['n_faulted']} + {mf['n_cancelled']}; "
        f"{audits}; untouched requests: {held} admitted in a round alike the clean "
        f"replay's, tokens equal (asserted), {moved_same}/{moved} in a moved round with "
        f"tokens equal (reported); {retried_same}/{n_retried_done} retried-then-completed "
        f"equal (reported); admission rounds {len(rounds)} (clean {len(clean_rounds)})")
    log("[traffic faults] share of a few rows' outputs that differ from the same rows inside "
        f"a 256-row bf16 product (cuBLAS as configured by default): {gemm_rows_by_packing(dev)}")
    del fe
    _free(dev)


def chunked_beside_blocking(summary, chunked: str, blocking: str, tokens) -> None:
    """One line: a chunked run's mean TTFT, prefill and decode tok/s beside
    its blocking run's from the same call, its scheduler counters, and the
    greedy agreement of the two (reported, not gated: the two compute the
    same function in different orders)."""
    c, b = summary[chunked], summary[blocking]
    agree = (tokens[chunked] == tokens[blocking]).mean()
    log(f"[chunked {chunked}] mean TTFT {c['ttft_ms']:.1f} ms (blocking {blocking}: "
        f"{b['ttft_ms']:.1f}), prefill {c['prefill_tps']:.1f} tok/s ({b['prefill_tps']:.1f}), "
        f"decode {c['decode_tps']:.1f} tok/s ({b['decode_tps']:.1f}); scheduler {c['sched']}; "
        f"greedy tokens equal to the blocking run's: {agree:.1%} (reported, not gated)")


def log_astra(cfg, summary, label: str) -> None:
    """A served request's ``RequestOutput.hardware``: the modeled cost on the
    ASTRA photonic chip (the paper's simulator), not the card's."""
    hw, prompt = summary[label]["hardware"], summary[label]["prompt"]
    assert hw is not None and hw.energy_j > 0 and hw.latency_s > 0, label
    top = ", ".join(f"{k} {e / hw.energy_j:.1%}" for k, e in hw.energy_by_site[:3])
    log(f"[astra model] {cfg.name} request 0 of {label} (prompt {prompt} tokens, "
        f"{hw.cached_prompt_tokens} from the prefix cache): modeled ASTRA photonic chip "
        f"latency {hw.latency_s * 1e6:.3f} us, energy {hw.energy_j * 1e3:.3f} mJ, "
        f"{hw.energy_per_mac_j * 1e12:.3f} pJ/MAC over {hw.macs} MACs; top sites {top} "
        "(the paper's chip model, not a measurement of this card)")


def calibrate(cfg, params, prompts, dev):
    """Phase 6b: ``Model.calibrate`` of the int8 plan over the packed
    prompts, on the card; returns the calibrated plan.  Every GEMM site
    gets a static activation scale and every KV storage site a per-head
    scale vector, all finite and positive."""
    from repro_torch.core.plan import kv_sites, model_sites
    from repro_torch.serve.prefill import pack_prompts

    model = _serving_model(cfg, dev, "int8")
    tokens, _ = pack_prompts(prompts, cfg, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    plan = model.calibrate(params, {"tokens": tokens}).plan
    _sync(dev)
    secs = time.perf_counter() - t0
    assert {s for s, _ in plan.act_scales} == set(model_sites(cfg)), len(plan.act_scales)
    assert {s for s, _ in plan.kv_scales} == set(kv_sites(cfg)), len(plan.kv_scales)
    vals = [a for _, a in plan.act_scales] + [x for _, v in plan.kv_scales for x in v]
    assert all(np.isfinite(vals)) and min(vals) > 0, (min(vals), max(vals))
    log(f"[calibrate] {cfg.name} int8 plan over {tuple(tokens.shape)} packed prompt tokens "
        f"on {dev}: {len(plan.act_scales)} site activation scales + {len(plan.kv_scales)} KV "
        f"storage-site scales ({cfg.n_kv_heads} heads each) in {secs:.2f} s; act scales "
        f"{min(a for _, a in plan.act_scales):.3e}..{max(a for _, a in plan.act_scales):.3e}")
    del model
    _free(dev)
    return plan


RANGES = ("moe.", "xattn.")  # the profiler ranges moe_ranges and xattn_ranges open


def profile_decode_chunk(cfg, params, prompts, dev, runs, kv_block_size: int = BS,
                         max_len: int = 512, scan_ms=None) -> None:
    """Where a decode chunk's time goes: one engine round of 8 decode steps
    (8 slots, up to 8 of them busy) under ``torch.profiler`` — host time of
    the round against the device time of the kernels it ran (their sum over
    the round; the rest of the round the device is idle), the decode
    kernels' share of that device time (split and merge, dense or paged),
    and the int8 GEMM kernels and the fill/memset kernels the round ran.
    With ``scan_ms`` (``rglru_scan``'s isolated time, which ``time_ms``
    takes with L2 flushed), the first run's admission round (the
    full-sequence prefill of 8 prompts and the first chunk) is profiled
    too, for the scan's device time inside it, where a and b (21 MB each
    at recurrentgemma's admission) come from the layer's gates just
    before."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serve import ServeConfig, ServeEngine

    serve_cfg = ServeConfig(max_slots=8, max_len=max_len, chunk_steps=8,
                            kv_block_size=kv_block_size, attn_impl="flash")
    busy = min(8, len(prompts))
    for label, plan, kv_quant in runs:
        engine = ServeEngine(_serving_model(cfg, dev, plan, kv_quant), params, serve_cfg,
                             device=dev)
        for p in prompts[:8]:
            engine.submit(p, 32)
        if scan_ms is not None and label == runs[0][0]:
            # kernels only: recording the round's host ops as well cost the
            # run about 12 s on an H100's host
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                engine.step()  # admission prefill + the first chunk
                _sync(dev)
            scan = [(e.self_device_time_total, e.count) for e in prof.key_averages()
                    if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                    and "rglru_scan" in e.key]
            n = sum(c for _, c in scan)
            assert n == cfg.layer_kinds.count("rglru"), (label, n)
            ms = sum(t for t, _ in scan) / 1e3
            log(f"[profile {label} admission] 8 x {len(prompts[0])} tokens, one engine round: "
                f"rglru_scan {ms:.4f} ms over {n} launches, {ms / n:.4f} ms a launch against "
                f"{scan_ms:.4f} isolated (L2 flushed)")
        else:
            engine.step()  # admission prefill + the first chunk, untraced
        _sync(dev)
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()  # a pure decode chunk: 8 steps
            _sync(dev)
            host_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        assert counts["bts_encode"] == 0, (label, "bts_encode launched in a decode chunk", counts)
        if dev.type == "cuda" and label in ("sc", "mixed"):
            assert counts["stoch_gemm_codes_stream"] > 0, (label, counts)
        events = prof.key_averages()
        rows = [(getattr(e, "self_device_time_total", 0.0), e.key, e.count) for e in events]
        # the device rows alone (kernels, memsets, copies: device_type CUDA),
        # so each device event counts once and not again in the CPU op above it
        on_dev = [r for e, r in zip(events, rows)
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                  and not r[1].startswith(RANGES)]
        once_ms = sum(r[0] for r in on_dev) / 1e3
        top = sorted(rows, reverse=True)[:5]
        share = f"{once_ms / host_ms:.1%}" if once_ms > 0 else "not measured"
        # the decode kernels of each layout, told apart by their Layout
        # template argument (Dense, Paged)
        detail = ""
        for layout in ("Dense", "Paged"):
            split, merge = ([r for r in on_dev if f"decode_{k}_kernel" in r[1] and layout in r[1]]
                            for k in ("split", "merge"))
            ms = sum(r[0] for r in split + merge) / 1e3
            if split and once_ms > 0:
                detail += (f"; {layout.lower()} decode kernels {ms:.2f} ms ({ms / once_ms:.1%} "
                           f"of the device time; split {sum(r[0] for r in split) / 1e3:.2f} "
                           f"ms x{sum(r[2] for r in split)}, merge "
                           f"{sum(r[0] for r in merge) / 1e3:.2f} ms x{sum(r[2] for r in merge)})")
        # the int8 GEMM's kernels, and every fill or memset kernel the chunk
        # ran: a GEMM zeroing its output would add one per GEMM against the
        # same chunk under exact (a dynamic activation scale adds one too:
        # quantize's ones_like)
        gemm = [r for r in on_dev if "int8_gemm" in r[1] and "batched" not in r[1]
                and "true>" not in r[1]]
        fills = [r for r in on_dev if "fill" in r[1].lower() or "memset" in r[1].lower()]
        if gemm:
            detail += (f"; int8 GEMM kernels {sum(r[0] for r in gemm) / 1e3:.2f} ms over "
                       f"{sum(r[2] for r in gemm)} launches ("
                       + ", ".join(f"{r[1][:48]} x{r[2]}" for r in gemm) + ")")
        # the stochastic plans' kernels: the encoder (none: both operands
        # are codes), the stochastic GEMM (either library), and the
        # batched int8 qk/pv GEMM (its stream kernel, or mma.sync's batched
        # instantiation, ``..., true>``)
        for what, pick in (("bts_encode", lambda k: "bts_encode" in k),
                           ("stochastic GEMM", lambda k: "stoch_matmul" in k
                            or "stoch_gemm" in k),
                           ("batched int8 GEMM", lambda k: "int8_gemm_batched" in k
                            or ("int8_gemm_kernel" in k and "true>" in k))):
            rs = [r for r in on_dev if pick(r[1])]
            if rs or label in ("sc", "mixed"):
                detail += (f"; {what} {sum(r[0] for r in rs) / 1e3:.2f} ms over "
                           f"{sum(r[2] for r in rs)} launches")
        # the MoE layer's parts under moe_ranges, the cross-attention
        # layers under xattn_ranges: the device time of the kernels each
        # range launched, and the host time inside it
        for e in events:
            if e.key.startswith(RANGES) and getattr(e, "device_type", None) != \
                    torch.autograd.DeviceType.CUDA and once_ms > 0:
                r_ms = getattr(e, "device_time_total", 0.0) / 1e3
                detail += (f"; {e.key} device {r_ms:.2f} ms ({r_ms / once_ms:.1%} of the device "
                           f"time), host {e.cpu_time_total / 1e3:.1f} ms over {e.count} calls")
        detail += f"; counted launches {{{', '.join(f'{k}: {v}' for k, v in counts.items() if v)}}}"
        detail += (f"; fill/memset kernels: {sum(r[2] for r in fills)} launches ("
                   + (", ".join(f"{r[1][:72]} x{r[2]}" for r in fills) or "none") + ")")
        log(f"[profile {label}] one decode chunk (8 steps x 8 slots, {busy} busy): host "
            f"{host_ms:.1f} ms (profiled), device kernels {once_ms:.2f} ms, device busy "
            f"{share}{detail}; top: "
            + "; ".join(f"{k[:48]} {t / 1e3:.2f} ms x{c}" for t, k, c in top))
        del engine
        _free(dev)


def flash_vs_naive(cfg, params, prompts, dev) -> None:
    """First-step logits of the kernel path against plain attention over
    the gathered view, on the same device.  Tolerance: relative L2 5e-2 —
    both carry bf16 activations through every layer, the two attention
    paths round at different places (the kernel rounds p to bf16, sums
    keys in another order), and bf16 keeps 2^-8 = 4e-3 relative per
    rounding, compounded along the residual stream and the head."""
    from repro_torch.models.attention import BlockTables
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions
    from repro_torch.serve.prefill import pack_prompts, prefill_paged_suffix

    probe = [prompts[0], prompts[3], prompts[5]]
    w = -(-max(len(p) for p in probe) // BS) + 1
    rows = torch.arange(1, 1 + 3 * w, device=dev, dtype=torch.int32).reshape(3, w)
    res = {}
    nxt = None  # both paths decode the same token: the flash path's greedy pick
    for impl in ("flash", "naive"):
        model = Model(cfg, ModelOptions(plan="exact", attn_impl=impl), device=dev)
        prm = model.prepare(params)
        states = model.init_decode_state(3, w * BS, paged=(1 + 3 * w, BS))
        toks, lengths = pack_prompts(probe, cfg, device=dev)
        lg, states = prefill_paged_suffix(model, prm, toks, lengths, states, rows,
                                          torch.zeros(3, dtype=torch.int32, device=dev), w)
        if nxt is None:
            nxt = lg[:, -1:].argmax(-1).int()
        step, _ = model.decode(prm, nxt, states, lengths.long(), BlockTables(rows))
        assert lg.shape == (3, 1, cfg.vocab) and step.shape == (3, 1, cfg.vocab)
        assert torch.isfinite(lg).all() and torch.isfinite(step).all()
        res[impl] = (lg.float(), step.float())
        del prm, states
    rel = [((a - b).norm() / b.norm()).item() for a, b in zip(res["flash"], res["naive"])]
    agree = (res["flash"][0].argmax(-1) == res["naive"][0].argmax(-1)).float().mean().item()
    log(f"[flash vs naive] first-step logits relative L2: prefill {rel[0]:.2e}, decode "
        f"{rel[1]:.2e} (< 5e-2); greedy first tokens agree {agree:.0%}")
    assert max(rel) < 5e-2, rel


def small_card_vs_cpu(dev) -> None:
    """A reduced float32 stablelm served with the kernels on ``dev`` and with
    their plain versions on the CPU: greedy tokens must agree.  On the
    paged pool all of them under exact; under int8, sc, mixed and the
    calibrated int8 plan on an int8 pool the integer products are exact
    given the codes, but a last-bit difference in a float activation can
    move one code, so 90%.  On dense caches (the flash and dense decode
    kernels) all of them under all four plans.  Both sides of the
    int8-pool case use the scales one CPU calibration gave.  Then chunked
    prefill on dense caches under exact, all tokens equal: max_len 30 (not
    a power of two) and a budget of 16, whose second round plans 4 tokens
    of one prompt beside 12 of the other, so the first row's gated window
    steps sit past its cache (their writes clamped, ``kv_len`` at the
    cache length)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.prefill import pack_prompts

    small = get_arch("stablelm-1.6b").reduced(dtype="float32")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, small.vocab, n, dtype=np.int32) for n in (5, 19, 12, 33, 8)]
    params = Model(small, device="cpu").init(seed=3)
    calibrated = Model(small, ModelOptions(plan="int8"), device="cpu").calibrate(
        params, {"tokens": pack_prompts(prompts, small)[0]}).plan
    runs = [(label, plan, kv_quant, 8) for label, plan, kv_quant in
            plain_runs("exact", "int8", "sc", "mixed") + [("int8-kvq", calibrated, "int8")]]
    runs += [(f"{label}-dense", plan, kv_quant, 0)
             for label, plan, kv_quant in plain_runs("exact", "int8", "sc", "mixed")]
    for label, plan, kv_quant, bs in runs:
        scfg = ServeConfig(max_slots=3, max_len=64, chunk_steps=4, kv_block_size=bs)
        toks = {}
        for where in ("cpu", dev):
            m = Model(small, ModelOptions(plan=plan, attn_impl="flash", kv_quant=kv_quant),
                      device=where)
            outs = ServeEngine(m, _to(params, m.device), scfg,
                               device=where).generate_batch(prompts, 10)
            toks[str(where)] = np.stack([o.tokens for o in outs])
        agree = (toks["cpu"] == toks[str(dev)]).mean()
        log(f"[small {label}] reduced stablelm float32 on {dev} (kernels) vs cpu (plain "
            f"versions): {agree:.0%} of greedy tokens equal")
        assert agree == 1.0 if plan == "exact" or bs == 0 else agree >= 0.9, (label, agree)
    chunked = [rng.integers(0, small.vocab, n, dtype=np.int32) for n in (20, 26)]
    scfg = ServeConfig(max_slots=2, max_len=30, chunk_steps=3, kv_block_size=0,
                       prefill_chunk_tokens=16)
    toks = {}
    for where in ("cpu", dev):
        m = Model(small, ModelOptions(plan="exact", attn_impl="flash"), device=where)
        eng = ServeEngine(m, _to(params, m.device), scfg, device=where)
        toks[str(where)] = np.stack([o.tokens for o in eng.generate_batch(chunked, 4)])
        assert eng.scheduler_stats["prefill_chunks"] == 4, eng.scheduler_stats
    agree = (toks["cpu"] == toks[str(dev)]).mean()
    log(f"[small exact-dense-chunked] reduced stablelm float32, max_len 30, budget 16 (gated "
        f"steps past the cache) on {dev} vs cpu: {agree:.0%} of greedy tokens equal")
    assert agree == 1.0, agree


def serve_rg(cfg, dev, scan_ms: float, summary: dict) -> dict:
    """Full-width recurrentgemma-2b (bf16, random weights from seed 0) on
    dense per-slot caches under ``exact`` and ``int8`` (``rg-exact``,
    ``rg-int8``): 8 prompts of 256 tokens (one full-sequence admission,
    whose 18 rglru layers each launch ``rglru_scan`` once), then 4 of
    64-160 tokens (the masked scan: no scan launch), 32 new tokens each,
    max_len 2048 (the window: rings of 2048 positions).  Asserts every
    request's tokens, finite logits of a prefill and of every decode step
    (the engine raises on a non-finite one), each plan's kernels launched
    and no paged kernel; profiles ``rglru_scan`` inside an admission
    (``scan_ms``: its isolated time).  Then the 4 short prompts alone,
    blocking (``rg-exact-short``) and chunked at 64 tokens a round
    (``rg-exact-chunked``), 16 new each, max_len 512.  Then the 12 prompts
    again on the paged pool (``rg-exact-paged``: block 16, max_len 2048,
    the rings through the table), its launches held per phase
    (:func:`check_rg_paged_phases`) and its greedy agreement with
    ``rg-exact`` reported.  Returns each run's launches."""
    from repro_torch.models.model import Model

    n_rglru = cfg.layer_kinds.count("rglru")
    params = Model(cfg, device=dev).init(seed=0)
    prompts = make_rg_prompts(cfg.vocab, np.random.default_rng(2))
    model = _serving_model(cfg, dev, "exact")
    probe = torch.as_tensor(prompts[8][None, :64], device=dev)
    logits, _ = model.prefill(model.prepare(params), {"tokens": probe}, max_len=cfg.window)
    assert logits.shape == (*probe.shape, cfg.vocab) and torch.isfinite(logits).all()
    del model, logits
    int8_prefill_bit_for_bit(cfg, params, dev, probe, max_len=cfg.window)
    runs = [("rg-exact", "exact", "none"), ("rg-int8", "int8", "none")]
    launches, tokens = serve(cfg, params, prompts, dev, runs, gen=32, max_len=cfg.window,
                             kv_block_size=0)
    admission = f"rglru_scan_s{RG_SHAPES[1][1]}"
    for label, counts in launches.items():  # the two full runs
        # one full-sequence admission (the 8 equal prompts of 256 tokens);
        # the masked scan takes none
        assert counts["rglru_scan"] == counts.get(admission, 0) == n_rglru, (label, counts)
    agree = (tokens["rg-int8"] == tokens["rg-exact"]).mean()
    log(f"[agreement rg-int8] greedy tokens equal to rg-exact: {agree:.1%} (reported, not "
        "gated: random weights at bf16)")
    # chunked prefill: the 4 masked-scan prompts, blocking and chunked at a
    # budget of 64 tokens a round (max_len 512: no ring wraps)
    short_tokens = {}
    for label, budget in (("rg-exact-short", 0), ("rg-exact-chunked", 64)):
        counts, toks = serve(cfg, params, prompts[8:], dev, [(label, "exact", "none")], gen=16,
                             kv_block_size=0, chunk_tokens=budget, summary=summary)
        launches.update(counts)
        short_tokens.update(toks)
    chunked_beside_blocking(summary, "rg-exact-chunked", "rg-exact-short", short_tokens)
    profile_decode_chunk(cfg, params, prompts, dev, runs, kv_block_size=0, max_len=cfg.window,
                         scan_ms=scan_ms)
    counts, paged_tokens = serve(cfg, params, prompts, dev, [("rg-exact-paged", "exact", "none")],
                                 gen=32, max_len=cfg.window, summary=summary)
    launches.update(counts)
    check_rg_paged_phases(cfg, dev)
    kv = summary["rg-exact-paged"]["kv"]
    agree = (paged_tokens["rg-exact-paged"] == tokens["rg-exact"]).mean()
    log(f"[rg-exact-paged] kv_stats: bytes_per_block {kv['bytes_per_block']} (8 local layers x "
        f"K and V x {BS} x {RG_HD} x 2 B), {kv['pool_blocks']} blocks, {kv['pool_bytes']} B; "
        f"prefix cache off: {kv['prefix_cache_off_reason']}; greedy tokens equal to rg-exact's "
        f"(dense rings): {agree:.1%} (reported, not gated: bf16, two different decode kernels)")
    del params
    _free(dev)
    return launches


def check_rg_paged_phases(cfg, dev) -> None:
    """``rg-exact-paged``'s launches by phase: every decode chunk launches
    ``paged_attention_decode`` once per local layer and step and no dense
    kernel; the equal-length admission launches ``flash_attention`` once
    per local layer and ``rglru_scan`` once per recurrent layer; a
    mixed-length admission takes the masked scan (dense decode steps, no
    flash, no scan)."""
    n_local, n_rglru = cfg.layer_kinds.count("local"), cfg.layer_kinds.count("rglru")
    rec = PHASES["rg-exact-paged"]
    if dev.type != "cuda":  # the plain versions count nothing
        return
    for steps, d in rec["decode"]:
        assert d.get("paged_attention_decode") == n_local * steps, (steps, d)
        assert not any(d.get(k) for k in ("dense_attention_decode", "flash_attention",
                                          "rglru_scan")), d
    equal = 0
    for lens, d in rec["admission"]:
        if len(set(lens)) == 1:
            equal += 1
            assert d.get("flash_attention") == n_local and d.get("rglru_scan") == n_rglru, d
        else:
            assert not d.get("flash_attention") and not d.get("rglru_scan"), d
            assert d.get("dense_attention_decode"), d
    assert equal >= 1, rec["admission"]
    log(f"[rg-exact-paged] {len(rec['decode'])} decode chunks: paged_attention_decode "
        f"{n_local} x steps each, no dense kernel; admissions "
        + "; ".join(f"{sorted(set(l))} x{len(l)}: flash {d.get('flash_attention', 0)}, "
                    f"rglru_scan {d.get('rglru_scan', 0)}, dense decode "
                    f"{d.get('dense_attention_decode', 0)}" for l, d in rec["admission"]))


def small_rg_paged_card_vs_cpu(dev) -> None:
    """The reduced float32 recurrentgemma (window 8) on the paged pool
    (``kv_block_size 4``, max_len 48): prompts up to 33 tokens, so the
    rings wrap through the table in admission and decode, served with the
    kernels on ``dev`` and their plain versions on the CPU under all four
    plans: every greedy token equal."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions
    from repro_torch.serve import ServeConfig, ServeEngine

    small = get_arch("recurrentgemma-2b").reduced(dtype="float32", window=8)
    rng = np.random.default_rng(9)
    params = Model(small, device="cpu").init(seed=4)
    scfg = ServeConfig(max_slots=3, max_len=48, chunk_steps=4, kv_block_size=4)
    for label in ("exact", "int8", "sc", "mixed"):
        agree = []
        for group in ((5, 19, 12, 33, 8), (16, 16)):
            prompts = [rng.integers(0, small.vocab, n, dtype=np.int32) for n in group]
            toks = {}
            for where in ("cpu", dev):
                m = Model(small, ModelOptions(plan=label, attn_impl="flash"), device=where)
                eng = ServeEngine(m, _to(params, m.device), scfg, device=where)
                assert eng._ring_len == 8 and eng.kv_stats["block_size"] == 4
                toks[str(where)] = np.concatenate([o.tokens for o in
                                                   eng.generate_batch(prompts, 10)])
            agree.append((toks["cpu"] == toks[str(dev)]).mean())
        log(f"[small rg-exact-paged {label}] reduced recurrentgemma float32 window 8 on the "
            f"paged pool (block 4) on {dev} (kernels) vs cpu (plain versions), mixed / equal "
            f"prompt lengths: {' / '.join(f'{a:.0%}' for a in agree)} of greedy tokens equal")
        assert min(agree) == 1.0, (label, agree)


def small_rg_card_vs_cpu(dev) -> None:
    """A reduced float32 recurrentgemma (window 8, prompts up to 33 tokens,
    so rings wrap and the masked scan runs past the window) served with
    the kernels on ``dev`` and their plain versions on the CPU, on dense
    caches under all four plans: every greedy token equal; then chunked
    prefill under exact (budget 5 a round, prompts past the window), every
    token equal."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions
    from repro_torch.serve import ServeConfig, ServeEngine

    small = get_arch("recurrentgemma-2b").reduced(dtype="float32", window=8)
    rng = np.random.default_rng(8)
    lens = [(5, 19, 12, 33, 8), (16, 16)]  # mixed (masked scan), equal (full sequence)
    params = Model(small, device="cpu").init(seed=4)
    for label in ("exact", "int8", "sc", "mixed"):
        scfg = ServeConfig(max_slots=3, max_len=48, chunk_steps=4, kv_block_size=0)
        agree = []
        for group in lens:
            prompts = [rng.integers(0, small.vocab, n, dtype=np.int32) for n in group]
            toks = {}
            for where in ("cpu", dev):
                m = Model(small, ModelOptions(plan=label, attn_impl="flash"), device=where)
                outs = ServeEngine(m, _to(params, m.device), scfg,
                                   device=where).generate_batch(prompts, 10)
                toks[str(where)] = np.concatenate([o.tokens for o in outs])
            agree.append((toks["cpu"] == toks[str(dev)]).mean())
        log(f"[small rg-{label}] reduced recurrentgemma float32 window 8 on {dev} (kernels) "
            f"vs cpu (plain versions), mixed / equal prompt lengths: "
            f"{' / '.join(f'{a:.0%}' for a in agree)} of greedy tokens equal")
        assert min(agree) == 1.0, (label, agree)
    prompts = [rng.integers(0, small.vocab, n, dtype=np.int32) for n in (5, 19, 12, 33, 8)]
    scfg = ServeConfig(max_slots=3, max_len=48, chunk_steps=4, kv_block_size=0,
                       prefill_chunk_tokens=5)
    toks = {}
    for where in ("cpu", dev):
        m = Model(small, ModelOptions(plan="exact", attn_impl="flash"), device=where)
        eng = ServeEngine(m, _to(params, m.device), scfg, device=where)
        toks[str(where)] = np.concatenate([o.tokens for o in eng.generate_batch(prompts, 10)])
        assert eng.scheduler_stats["prefill_chunks"] > len(prompts), eng.scheduler_stats
    agree = (toks["cpu"] == toks[str(dev)]).mean()
    log(f"[small rg-exact-chunked] reduced recurrentgemma float32 window 8, budget 5 on {dev} "
        f"vs cpu: {agree:.0%} of greedy tokens equal")
    assert agree == 1.0, agree


# granite-moe-1b-a400m: 24 attn layers, 16 query heads over 8 KV heads of
# 64 (GQA 2), a MoE MLP of 32 experts, top-8, expert width 512; one paged
# admission packs 8 prompts of up to 384 tokens: 3072 tokens, 6 groups of
# 512, each (group, expert) buffer 512 rows when drop-free
GM_D, GM_H, GM_KVH, GM_E, GM_K, GM_F, GM_V = 1024, 16, 8, 32, 8, 512, 49155
GM_ADMISSION = 8 * 384
XL_D, XL_H, XL_V = 768, 4, 50304  # xlstm-125m
# kernel rows timed at granite's shapes: their launches are the granite
# runs' (the batched int8 entry's those of moe-experts-int8, the one run
# whose plan quantizes the expert sites)
MOE_ROWS = ("paged_attention_decode_moe", "paged_attention_prefill_moe",
            "int8_gemm_batched_moe")
MOE_EXPERTS_INT8 = {"*.expert_*": "int8", "default": "exact"}
# the batched int8 entry's shape (B, M, K, N) at the first admission of
# moe-experts-int8 (8 prompts padded to 384 tokens: 6 groups of 512, each
# expert's 6 buffers of 512 rows in one product), the shape its row times
GM_EXPERT_UP = (GM_E, GM_ADMISSION, GM_D, GM_F)


def time_moe_kernels(dev, g, timer=time_ms) -> dict:
    """The kernels at granite-moe-1b-a400m's shapes: paged decode and one
    cold causal admission of 8 x 384 at 16 query heads over 8 KV heads of
    64 (GQA 2: the group no stablelm run takes; :func:`time_attention_rows`).
    The batched int8 entry at one admission's expert product
    (``GM_EXPERT_UP``, the up projection, experts-major: ``[E, G * 512,
    D]`` codes against ``[E, F, D]``, the 6 groups of each expert in one
    product; ``moe-experts-int8`` gives it this shape at its first
    admission, and its launches are that run's), held bit for bit and
    timed beside its bound and the plain version; the down projection's
    shape is held and logged."""
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref

    out = time_attention_rows(dev, g, "moe", GM_H, GM_KVH, HD,
                              ("paged_decode", "paged_prefill"), timer)
    n_groups = GM_ADMISSION // 512
    rows = n_groups * 512
    for k, n, row in ((GM_D, GM_F, True), (GM_F, GM_D, False)):
        x = torch.randint(-127, 128, (GM_E, rows, k), generator=g, device=dev, dtype=torch.int8)
        w_t = torch.randint(-127, 128, (GM_E, n, k), generator=g, device=dev, dtype=torch.int8)
        path = i8.int8_batched_plan(rows, n, k)
        before = dict(i8.int8_gemm_batched.paths)
        got = i8.int8_gemm_batched(x, w_t)
        moved = {p for p, c in i8.int8_gemm_batched.paths.items() if c != before[p]}
        assert moved == ({path} if dev.type == "cuda" else set()), (moved, path)
        err = (got.long() - int8_matmul_acc_ref(x, w_t).long()).abs().max().item()
        assert err == 0, ("batched int8 entry at the expert products", k, n, err)
        del got
        k_ms = timer(lambda: i8.int8_gemm_batched(x, w_t), reps=5)
        p_ms = timer(lambda: int8_matmul_acc_ref(x, w_t), reps=3)
        ops = 2 * GM_E * rows * n * k
        b_ms, b_by = bound_ms(x.numel() + w_t.numel() + 4 * GM_E * rows * n, ops, "int8")
        log(f"[time int8_gemm_batched moe] one admission's expert {'up' if row else 'down'} "
            f"product: {GM_E} experts x [{rows}, {k}] x [{k}, {n}] ({n_groups} groups of 512 "
            f"rows an expert, {path}): bit for bit; kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
            f"bound_ms {b_ms:.4f} ({b_by}, {b_ms / k_ms:.1%} of it) library_ms none (no "
            f"PyTorch call gives a batch of int8 products in int32); "
            f"{ops / max(k_ms, 1e-9) / 1e9:.1f} TOPS")
        if row:
            out["int8_gemm_batched_moe"] = dict(
                name="int8_gemm_batched_moe", route="cuda", wrapper="int8_gemm_batched",
                source=SRC_INT8, replaces="src/repro/kernels/int8_matmul/kernel.py:38",
                max_abs_err=float(err), ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
        del x, w_t
        _free(dev)
    return out


@contextlib.contextmanager
def moe_ranges():
    """The MoE layer's parts under profiler ranges while the block runs:
    ``moe.experts`` (each expert product) and ``moe.dispatch`` (the
    router, the buffer positions, the dispatch and the combine)."""
    from torch.profiler import record_function

    from repro_torch.models import moe

    saved = {n: getattr(moe, n) for n in ("astra_batched_matmul", "route", "positions",
                                          "dispatch", "combine")}

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    for n, fn in saved.items():
        setattr(moe, n, ranged("moe.experts" if n == "astra_batched_matmul" else "moe.dispatch",
                               fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(moe, n, fn)


def check_layer_launches(cfg, label: str, dev, kernel: str) -> None:
    """Every decode chunk of run ``label`` launched ``kernel`` once per
    attention layer and step (``PHASES``; the plain versions count
    nothing on the CPU)."""
    n_attn = sum(k in ("attn", "local") for k in cfg.layer_kinds)
    chunks = PHASES[label]["decode"]
    assert chunks, label
    if dev.type == "cuda":
        for steps, d in chunks:
            assert d.get(kernel) == n_attn * steps, (label, kernel, steps, d)
    log(f"[{label}] {len(chunks)} decode chunks: {kernel} {n_attn} x steps each "
        + ("(held)" if dev.type == "cuda" else "(not held: plain versions on the CPU)"))


def int8_prefill_bit_for_bit(cfg, params, dev, probe=None, max_len: int = 0) -> None:
    """One prefill of ``probe`` (``[1, S]`` tokens; by default 64 made-up
    ones) at full width under ``int8``, caches of ``max_len`` positions
    (S by default): the logits through the int8 GEMM kernel equal those
    through its plain version in its place, bit for bit."""
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref

    model = _serving_model(cfg, dev, "int8")
    prepared = model.prepare(params)
    if probe is None:
        probe = torch.arange(64, device=dev, dtype=torch.int32)[None] * 7 % cfg.vocab
    tokens = probe.shape[-1]
    max_len = max_len or tokens
    got, _ = model.prefill(prepared, {"tokens": probe}, max_len=max_len)
    kernel, i8.int8_gemm = i8.int8_gemm, int8_matmul_acc_ref
    try:
        want, _ = model.prefill(prepared, {"tokens": probe}, max_len=max_len)
    finally:
        i8.int8_gemm = kernel
    assert got.shape == (1, tokens, cfg.vocab) and torch.isfinite(got).all()
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
    log(f"[{cfg.name} int8 prefill] {tokens} tokens: logits through the int8 GEMM kernel equal "
        "those through its plain version bit for bit")
    del model, prepared, got, want
    _free(dev)


def int8_logit_margins(cfg, params, prompts, dev, label: str) -> None:
    """How near a greedy choice lies to a tie, beside how far the int8
    plan moves the logits: one prefill of the first 8 prompts' first 96
    tokens under ``exact`` and under ``int8``; at the last position the
    exact logits' top-1 minus top-2 margin, their spread over the vocab
    (std), max |int8 - exact| over the vocab, and the share of the 8
    whose first greedy token the two plans agree on."""
    probe = torch.as_tensor(np.stack([p[:96] for p in prompts[:8]]), device=dev)
    last = {}
    for plan in ("exact", "int8"):
        model = _serving_model(cfg, dev, plan)
        logits, _ = model.prefill(model.prepare(params), {"tokens": probe}, max_len=96)
        assert torch.isfinite(logits).all(), plan
        last[plan] = logits[:, -1].float()
        del model, logits
        _free(dev)
    top2 = last["exact"].topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    moved = (last["int8"] - last["exact"]).abs().amax(-1)
    agree = (last["int8"].argmax(-1) == last["exact"].argmax(-1)).float().mean().item()
    log(f"[margin {label}] {cfg.name}, 8 prompts x 96 tokens, last position: exact top-1 minus "
        f"top-2 median {margin.median().item():.4f} (min {margin.min().item():.4f}, max "
        f"{margin.max().item():.4f}), exact logits' std over the vocab median "
        f"{last['exact'].std(-1).median().item():.4f}; max|int8 - exact| over the vocab median "
        f"{moved.median().item():.4f} (max {moved.max().item():.4f}); first greedy token equal "
        f"in {agree:.0%} of the 8")


def serve_moe(cfg, dev, summary: dict) -> dict:
    """Full-width granite-moe-1b-a400m (bf16, random weights from seed 0),
    ``max_len 512``, the 12 prompts of ``make_prompts`` (six share a
    256-token prefix), 32 new each: ``moe-exact`` and ``moe-int8`` on the
    paged pool (block 16, prefix cache on where the KV is deterministic),
    ``moe-experts-int8`` (paged, the expert sites int8: the batched int8
    entry at the expert products), ``moe-exact-dense`` on dense per-slot
    caches and ``moe-exact-chunked`` (budget 256).  Every shape the int8
    runs gave the int8 GEMM and its batched entry is then held bit for
    bit (:func:`int8_shapes`).  Each decode chunk launches the decode kernel of its
    layout once per layer and step; one decode chunk of ``moe-exact`` is
    profiled with the MoE layer's parts under ranges.  Greedy agreement
    with ``moe-exact`` is reported.
    Returns each run's launches."""
    from repro_torch.models.model import Model

    params = Model(cfg, device=dev).init(seed=0)
    prompts = make_prompts(cfg.vocab, np.random.default_rng(3))
    int8_prefill_bit_for_bit(cfg, params, dev)
    runs = [("moe-exact", "exact", "none"), ("moe-int8", "int8", "none")]
    with int8_shapes() as seen:
        launches, tokens = serve(cfg, params, prompts, dev, runs, gen=32, summary=summary)
    hold_served_int8_shapes(dev, seen, "moe-int8")
    with int8_shapes() as seen:
        counts, toks = serve(cfg, params, prompts, dev,
                             [("moe-experts-int8", MOE_EXPERTS_INT8, "none")], gen=32,
                             summary=summary)
    launches.update(counts)
    tokens.update(toks)
    assert dev.type != "cuda" or GM_EXPERT_UP in seen["int8_gemm_batched"], \
        ("the timed expert product never ran", GM_EXPERT_UP, seen["int8_gemm_batched"])
    hold_served_int8_shapes(dev, seen, "moe-experts-int8")
    for label, bs, budget, kernel in (("moe-exact-dense", 0, 0, "dense_attention_decode"),
                                      ("moe-exact-chunked", BS, 256, "paged_attention_decode")):
        counts, toks = serve(cfg, params, prompts, dev, [(label, "exact", "none")], gen=32,
                             kv_block_size=bs, chunk_tokens=budget, summary=summary)
        launches.update(counts)
        tokens.update(toks)
        check_layer_launches(cfg, label, dev, kernel)
    for label in ("moe-exact", "moe-int8", "moe-experts-int8"):
        check_layer_launches(cfg, label, dev, "paged_attention_decode")
    for label in ("moe-int8", "moe-experts-int8", "moe-exact-dense", "moe-exact-chunked"):
        agree = (tokens[label] == tokens["moe-exact"]).mean()
        log(f"[agreement {label}] greedy tokens equal to moe-exact: {agree:.1%} (reported, not "
            "gated: random weights at bf16)")
    chunked_beside_blocking(summary, "moe-exact-chunked", "moe-exact", tokens)
    int8_logit_margins(cfg, params, prompts, dev, "moe")
    with moe_ranges():
        profile_decode_chunk(cfg, params, prompts, dev, runs[:1])
    del params
    _free(dev)
    return launches


def serve_xlstm(cfg, dev, summary: dict) -> dict:
    """Full-width xlstm-125m (bf16, random weights from seed 0) on its
    dense per-slot recurrent states (its only layout), ``max_len 512``:
    8 prompts of 256 tokens (one full-sequence admission), then 4 of
    64-160 (the masked scan), 32 new each, under ``exact`` (``xl-exact``:
    no attention kernel launches) and ``int8`` (``xl-int8``: the int8
    GEMM's ``stream`` and ``wgmma`` kernels, each shape it gave them held
    bit for bit after the run).  One decode chunk of ``xl-exact`` is
    profiled.  Returns each run's launches."""
    from repro_torch.models.model import Model

    params = Model(cfg, device=dev).init(seed=0)
    prompts = make_rg_prompts(cfg.vocab, np.random.default_rng(4))
    int8_prefill_bit_for_bit(cfg, params, dev)
    runs = [("xl-exact", "exact", "none"), ("xl-int8", "int8", "none")]
    with int8_shapes() as seen:
        launches, tokens = serve(cfg, params, prompts, dev, runs, gen=32, kv_block_size=0,
                                 summary=summary)
    hold_served_int8_shapes(dev, seen, "xl-int8")
    agree = (tokens["xl-int8"] == tokens["xl-exact"]).mean()
    log(f"[agreement xl-int8] greedy tokens equal to xl-exact: {agree:.1%} (reported, not "
        "gated: random weights at bf16)")
    int8_logit_margins(cfg, params, prompts, dev, "xl")
    profile_decode_chunk(cfg, params, prompts, dev, runs[:1], kv_block_size=0)
    del params
    _free(dev)
    return launches


def small_moe_card_vs_cpu(dev) -> None:
    """A reduced float32 granite (2 layers, 4 experts, top-2) served with
    the kernels on ``dev`` and their plain versions on the CPU, as the
    stablelm ``[small ...]`` phase gates it: on the paged pool (block 8)
    every token under exact, 90% under int8 and under the plan that
    quantizes the expert sites (the batched int8 entry at the experts'
    shapes: its launches asserted); on dense caches every token under
    exact and int8."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions
    from repro_torch.serve import ServeConfig, ServeEngine

    small = get_arch("granite-moe-1b-a400m").reduced(dtype="float32", n_layers=2)
    rng = np.random.default_rng(10)
    prefix = rng.integers(0, small.vocab, 16, dtype=np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, small.vocab, n, dtype=np.int32)])
               for n in (5, 19, 2)] + [rng.integers(0, small.vocab, n, dtype=np.int32)
                                       for n in (12, 33, 8)]
    params = Model(small, device="cpu").init(seed=5)
    runs = [("exact", "exact", 8), ("int8", "int8", 8), ("experts-int8", MOE_EXPERTS_INT8, 8),
            ("exact-dense", "exact", 0), ("int8-dense", "int8", 0)]
    for label, plan, bs in runs:
        scfg = ServeConfig(max_slots=3, max_len=64, chunk_steps=4, kv_block_size=bs)
        toks = {}
        for where in ("cpu", dev):
            m = Model(small, ModelOptions(plan=plan, attn_impl="flash"), device=where)
            reset_launches()
            outs = ServeEngine(m, _to(params, m.device), scfg,
                               device=where).generate_batch(prompts, 10)
            toks[str(where)] = np.stack([o.tokens for o in outs])
        counts = launch_counts()
        if label == "experts-int8" and dev.type == "cuda":
            assert counts["int8_gemm_batched"] > 0, counts
        agree = (toks["cpu"] == toks[str(dev)]).mean()
        log(f"[small moe {label}] reduced granite float32 on {dev} (kernels) vs cpu (plain "
            f"versions): {agree:.0%} of greedy tokens equal; card launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        assert agree == 1.0 if plan == "exact" or bs == 0 else agree >= 0.9, (label, agree)


@contextlib.contextmanager
def quantized_activations():
    """Record every ``quantize`` call while the block runs: the activations
    the GEMM sites quantize (per tensor), the batched qk/pv products'
    operands (per product and per output column) and the weights' at
    ``prepare``; yields a list of ``(input as float32, codes, scale)``,
    each on the CPU."""
    from repro_torch.core import astra_layer

    calls, fn = [], astra_layer.quantize

    def logged(x, axis=None, scale=None):
        q = fn(x, axis, scale)
        calls.append((x.detach().float().cpu(), q.q.cpu(), q.scale.float().cpu()))
        return q

    astra_layer.quantize = logged
    try:
        yield calls
    finally:
        astra_layer.quantize = fn


def code_flip_witness(cpu_calls: list, card_calls: list) -> dict:
    """Card and CPU quantized activations compared call by call (both
    served the same requests, so the calls line up until a token
    differs): the first call whose codes differ, how many moved and by
    how much, how near their values lie to a rounding boundary (in code
    units, from the CPU's values) and how far the float inputs of the
    calls before it differ (max |card - cpu| over max |cpu|)."""
    before = 0.0
    for i, ((xa, qa, sa), (xb, qb, sb)) in enumerate(zip(cpu_calls, card_calls)):
        assert xa.shape == xb.shape, (i, xa.shape, xb.shape)
        if torch.equal(qa, qb):
            before = max(before, ((xa - xb).abs().max() / xa.abs().max().clamp_min(1e-30)).item())
            continue
        moved = qa != qb
        units = (xa / sa)[moved]
        return dict(call=i, calls=len(cpu_calls), shape=tuple(xa.shape),
                    moved=int(moved.sum()), of=qa.numel(),
                    step=int((qa.int() - qb.int()).abs().max()),
                    boundary=float(((units - units.floor()) - 0.5).abs().max()),
                    rel_before=before,
                    rel_here=((xa - xb).abs().max() / xa.abs().max()).item())
    return dict(call=None, calls=len(cpu_calls), rel_before=before)


def small_xlstm_card_vs_cpu(dev) -> None:
    """A reduced float32 xlstm (one unit: mlstm x 3, slstm) served with the
    kernels on ``dev`` and their plain versions on the CPU, on its dense
    states under exact and int8, mixed prompt lengths (the masked scan)
    and equal ones (the full-sequence pass).  Under exact every greedy
    token is equal.  Under int8 the card also serves with the int8 GEMM's
    plain version in the kernel's place, and every token must equal the
    kernel's (the kernel is not where the card and the CPU part); and
    every quantized activation of both sides is recorded
    (:func:`quantized_activations`) and compared call by call
    (:func:`code_flip_witness`): the float32 ops outside the GEMM round
    otherwise on the card than on the CPU, and a value within a rounding
    error of a half code moves one code, whose product then differs and
    the greedy tokens with it.  So a group whose tokens differ must show
    such a flip: before it every code equal and the float inputs within
    1e-4 of each other (relative to the tensor's absmax), at it codes
    moved by one only, each from a value within 1e-3 code units of the
    half.  All tokens together are gated at 90%, as the quantized stablelm
    ``[small ...]`` runs on the pool are."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions
    from repro_torch.serve import ServeConfig, ServeEngine

    small = get_arch("xlstm-125m").reduced(dtype="float32")
    rng = np.random.default_rng(11)
    params = Model(small, device="cpu").init(seed=6)
    scfg = ServeConfig(max_slots=3, max_len=48, chunk_steps=4, kv_block_size=0)

    def served(label, where, prompts):
        m = Model(small, ModelOptions(plan=label, attn_impl="flash"), device=where)
        outs = ServeEngine(m, _to(params, m.device), scfg, device=where).generate_batch(
            prompts, 10)
        return np.concatenate([o.tokens for o in outs])

    for label in ("exact", "int8"):
        agree, same, witness = [], [], []
        for group in ((5, 19, 12, 33, 8), (16, 16)):
            prompts = [rng.integers(0, small.vocab, n, dtype=np.int32) for n in group]
            with quantized_activations() as cpu_calls:
                cpu = served(label, "cpu", prompts)
            with quantized_activations() as card_calls:
                card = served(label, dev, prompts)
            agree.append((cpu == card).mean())
            if label == "int8":
                kernel, i8.int8_gemm = i8.int8_gemm, int8_matmul_acc_ref
                try:
                    plain = served(label, dev, prompts)
                finally:
                    i8.int8_gemm = kernel
                same.append((plain == card).mean())
                w = code_flip_witness(cpu_calls, card_calls)
                witness.append(w)
                log(f"[small xlstm int8 witness] prompts {group}: {agree[-1]:.0%} of greedy "
                    f"tokens equal; {w['calls']} quantized activations a side; "
                    + (f"first code moved at call {w['call']} (input {w['shape']}): "
                       f"{w['moved']} of {w['of']} codes, by at most {w['step']}, their values "
                       f"at most {w['boundary']:.2e} code units from the half; float inputs "
                       f"there max|card-cpu|/max|cpu| {w['rel_here']:.2e}, "
                       if w["call"] is not None else "no code moved; ")
                    + f"before it at most {w['rel_before']:.2e}")
                assert w["rel_before"] <= 1e-4, w
                if agree[-1] < 1.0:
                    assert w["call"] is not None, ("tokens differ with every code equal", w)
                if w["call"] is not None:
                    assert w["step"] == 1 and w["boundary"] <= 1e-3, w
            else:
                assert not cpu_calls and not card_calls
        total = sum(a * n for a, n in zip(agree, (5, 2))) / 7
        log(f"[small xlstm {label}] reduced xlstm float32 on {dev} (kernels) vs cpu (plain "
            f"versions), mixed / equal prompt lengths: "
            f"{' / '.join(f'{a:.0%}' for a in agree)} of greedy tokens equal ({total:.1%} of "
            "all)" + (f"; the card with the int8 GEMM's plain version in the kernel's place: "
                      f"{' / '.join(f'{a:.0%}' for a in same)} equal to the kernel's"
                      if same else ""))
        assert (min(agree) == 1.0 if label == "exact" else total >= 0.9), (label, agree)
        assert all(a == 1.0 for a in same), (label, same)

# llama-3.2-vision-90b at its published widths, cut to one pattern period
# (attn x 4, xattn): float32 masters and a bf16 copy are ~5.1 GB a layer and
# 10.5 GB of embedding and head, so one period is ~36 GB under exact (~42 GB
# with int8's codes beside it) and two would be ~62 GB before activations
LL_D, LL_H, LL_KVH, LL_HD, LL_F, LL_V, LL_T = 8192, 64, 8, 128, 28672, 128256, 6404
LL_LAYERS = 5
# musicgen-large whole: 48 attn layers, 32 heads over 32 KV heads of 64, 4
# codebooks of 2048 (4 embedding tables summed, 4 heads)
MG_D, MG_H, MG_HD, MG_F, MG_V, MG_C = 2048, 32, 64, 8192, 2048, 4
# kernel rows timed at these models' shapes: their launches are the
# model's serving runs'
VLM_ROWS = ("paged_attention_decode_vlm", "dense_attention_decode_vlm", "flash_attention_vlm",
            "int8_gemm_vlm")
MG_ROWS = ("paged_attention_decode_mg", "paged_attention_prefill_mg", "int8_gemm_mg")
# the stream kernel's decode-step products timed as rows (M = 8 slots):
# llama's MLP (up and gate, down; 5 layers) and musicgen's 4 codebook heads
VLM_DECODE_GEMMS = {(8, LL_D, LL_F): 2 * LL_LAYERS, (8, LL_F, LL_D): LL_LAYERS}
MG_DECODE_GEMMS = {(8, MG_D, MG_V): MG_C}
# [vision prefill]: 4 prompts of mixed lengths with bf16 embeddings, caches
# of VISION_MAX_LEN positions, 8 greedy steps; each step against a full
# forward over the row's prompt and fed tokens, as a relative L2 of the
# logits over the vocab and of the cross-attention layer's output over
# d_model.  exact: both sides carry bf16 activations, and the decode kernel
# and flash (or cuBLAS at another M) round at different places, as in
# [flash vs naive].  int8: besides, every activation takes a dynamic
# per-tensor scale over the rows of its own call (4 rows in a decode step,
# the whole row in the forward), so the two are two quantizations of one
# function.  The limits are constants, set between the sound runs' largest
# reading and the smallest that a fault of the cross-attention path gives
# (VISION_FAULTS, measured in every run beside the sound one).  On the H100
# the sound runs' cross output reads at most 1.311e-02 (exact) and 0.1534
# (int8), every fault 1.000 or more, and the logits 1.381e-02 and 0.1905.
# With random weights the cross layer moves the logits by 2-3% only, so a
# cross fault leaves them inside their limits (0.022-0.028 under exact,
# 0.162 under int8): the layer's output is the gate that sees it.
VISION_LENS = (160, 64, 128, 96)
VISION_MAX_LEN = 256
VISION_STEPS = 8
VISION_LOGIT_TOL = {"exact": 5e-2, "int8": 0.25}
VISION_XATTN_TOL = {"exact": 0.1, "int8": 0.5}
# faults of the cross caches the decode steps read, each a bug the path
# could have: the cache never written (a text-only prefill), K and V
# swapped (the projections bound to the wrong site), V at twice its scale
# (a wrong per-tensor scale), another row's image (a wrong slot index)
VISION_FAULTS = {
    "zeroed": lambda k, v: (torch.zeros_like(k), torch.zeros_like(v)),
    "k/v swapped": lambda k, v: (v, k),
    "v x2": lambda k, v: (k, 2 * v),
    "rows rolled": lambda k, v: (k.roll(1, 0), v.roll(1, 0)),
}


def make_vlm_prompts(vocab: int, rng) -> list:
    """8 text prompts of 64-160 tokens (one blocking admission of all 8)."""
    return [rng.integers(0, vocab, n, dtype=np.int32)
            for n in (160, 64, 128, 96, 144, 80, 112, 72)]


def make_mg_prompts(vocab: int, rng) -> list:
    """``make_prompts``' 12 requests as ``[4, n]`` codebook grids: six share
    a 256-position prefix grid, three of those admitted after the first
    retirements (prefix hits)."""
    prefix = rng.integers(0, vocab, (MG_C, 256), dtype=np.int32)
    lens = [384, 96, 300, 128, 352, 200, 272, 160, 320, 288, 368, 112]
    shared = {0, 2, 4, 8, 9, 10}
    return [np.concatenate([prefix, rng.integers(0, vocab, (MG_C, n - 256), dtype=np.int32)],
                           axis=1)
            if i in shared else rng.integers(0, vocab, (MG_C, n), dtype=np.int32)
            for i, n in enumerate(lens)]


def time_attention_rows(dev, g, tag: str, h: int, kvh: int, hd: int, kinds,
                        timer=time_ms) -> dict:
    """The attention kernels at one model's heads (``h`` query heads over
    ``kvh`` KV heads of ``hd``, bf16), each held against its plain version
    (``BF16_TOL``; decode on ``SERVING_DRAWS`` draws, the launch counter
    moved once a call on the card) and timed beside its bound, the plain
    version and ``scaled_dot_product_attention`` (KV heads repeated to the
    query heads and the gather made before the timing).  ``kinds`` from
    ``paged_decode`` (8 slots at ``DECODE_FILLS`` through a table of
    ``BS``-position blocks, ``DENSE_S`` wide), ``dense_decode`` (the same
    fills over ``DENSE_S``-position caches), ``paged_prefill`` (one cold
    admission of 8 x 384 from position 0) and ``flash`` (causal over the
    ``[vision prefill]`` pass's padded batch, ``len(VISION_LENS)`` x
    ``max(VISION_LENS)``, held to ``FLASH_BF16``).  Returns the rows
    ``<kernel>_<tag>``."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import (
        dense_decode_ref, paged_decode_ref, paged_prefill_ref,
    )

    out = {}
    grp = h // kvh
    w = DENSE_S // BS
    nb = 8 * w + 1
    kv_len = torch.tensor(DECODE_FILLS, dtype=torch.int32, device=dev)
    table = (torch.randperm(nb - 1, generator=g, device=dev).reshape(8, w) + 1).int()
    mask = (torch.arange(DENSE_S, device=dev)[None] < kv_len[:, None])[:, None, None]
    fill = sum(DECODE_FILLS)
    decode_shape = (f"B=8 H={h} KV={kvh} hd={hd} bf16 kv_len {DECODE_FILLS}, "
                    f"{decode_splits(dev, 8, kvh, DENSE_S)} splits")

    def gathered(pool, tbl):  # [8, H, positions, hd]: each KV head repeated
        view = pool[tbl.long()].movedim(1, 2).reshape(8, kvh, tbl.shape[1] * BS, hd)
        return view.repeat_interleave(grp, dim=1)

    def row(name, wrapper, src, replaces, errs, k_ms, p_ms, l_ms, n_bytes, ops, what, shape,
            lib, tol=f"{BF16_TOL}"):
        b_ms, b_by = bound_ms(n_bytes, ops, "bf16")
        out[name] = dict(name=name, route="cuda", wrapper=wrapper, source=src,
                         replaces=replaces, max_abs_err=max(errs), ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
        log(f"[time {what} {tag}] {shape}: max|kernel-plain| per "
            f"draw {', '.join(f'{e:.2e}' for e in errs)} (<= {tol}); kernel_ms {k_ms:.4f} "
            f"plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}, {b_ms / k_ms:.1%} of it) "
            f"library_ms {l_ms:.4f} ({lib})")

    kp = vp = None
    if "paged_decode" in kinds or "paged_prefill" in kinds:
        fn, errs = pa.paged_attention_decode, []
        for _ in range(SERVING_DRAWS):
            q = torch.randn(8, h, hd, generator=g, device=dev).bfloat16()
            kp, vp = (torch.randn(nb, kvh, BS, hd, generator=g, device=dev).bfloat16()
                      for _ in range(2))
            before = fn.launches
            err, sh = held(fn(q, kp, vp, table, kv_len),
                           paged_decode_ref(q, kp, vp, table, kv_len), BF16_TOL)
            assert sh <= 1 and fn.launches == before + (dev.type == "cuda"), \
                (f"paged decode at {tag}'s shapes", err, sh)
            errs.append(err)
    if "paged_decode" in kinds:
        ke, ve = gathered(kp, table), gathered(vp, table)
        live_blocks = sum(-(-n // BS) for n in DECODE_FILLS)
        row(f"paged_attention_decode_{tag}", "paged_attention_decode", SRC_DECODE,
            "src/repro/kernels/paged_attention/kernel.py:146", errs,
            timer(lambda: fn(q, kp, vp, table, kv_len)),
            timer(lambda: paged_decode_ref(q, kp, vp, table, kv_len)),
            timer(lambda: sdpa(q[:, :, None], ke, ve, attn_mask=mask)),
            2 * q.numel() * 2 + 2 * fill * kvh * hd * 2 + live_blocks * 4 + kv_len.numel() * 4,
            4 * fill * h * hd, "paged decode", decode_shape,
            "scaled_dot_product_attention over the gathered view, length mask")
        del ke, ve
    if "dense_decode" in kinds:
        fn, errs = pa.dense_attention_decode, []
        for _ in range(SERVING_DRAWS):
            qd = torch.randn(8, h, hd, generator=g, device=dev).bfloat16()
            kc, vc = (torch.randn(8, kvh, DENSE_S, hd, generator=g, device=dev).bfloat16()
                      for _ in range(2))
            before = fn.launches
            err, sh = held(fn(qd, kc, vc, kv_len), dense_decode_ref(qd, kc, vc, kv_len),
                           BF16_TOL)
            assert sh <= 1 and fn.launches == before + (dev.type == "cuda"), \
                (f"dense decode at {tag}'s shapes", err, sh)
            errs.append(err)
        kr, vr = kc.repeat_interleave(grp, dim=1), vc.repeat_interleave(grp, dim=1)
        row(f"dense_attention_decode_{tag}", "dense_attention_decode", SRC_DECODE,
            "src/repro/kernels/paged_attention/kernel.py:212", errs,
            timer(lambda: fn(qd, kc, vc, kv_len)),
            timer(lambda: dense_decode_ref(qd, kc, vc, kv_len)),
            timer(lambda: sdpa(qd[:, :, None], kr, vr, attn_mask=mask)),
            2 * qd.numel() * 2 + 2 * fill * kvh * hd * 2 + kv_len.numel() * 4,
            4 * fill * h * hd, "dense decode", decode_shape,
            "scaled_dot_product_attention over the whole cache, length mask")
        del kc, vc, kr, vr
    if "paged_prefill" in kinds:
        s = 384
        tbl = table[:, : s // BS].contiguous()
        start = torch.zeros(8, dtype=torch.int32, device=dev)
        qs = torch.randn(8, h, s, hd, generator=g, device=dev).bfloat16()
        fn = pa.paged_attention_prefill
        before = fn.launches
        err, sh = held(fn(qs, kp, vp, tbl, start), paged_prefill_ref(qs, kp, vp, tbl, start),
                       BF16_TOL)
        assert sh <= 1 and fn.launches == before + (dev.type == "cuda"), \
            (f"paged prefill at {tag}'s shapes", err, sh)
        kd, vd = gathered(kp, tbl), gathered(vp, tbl)
        row(f"paged_attention_prefill_{tag}", "paged_attention_prefill", SRC_PREFILL,
            "src/repro/kernels/paged_attention/kernel.py:146", [err],
            timer(lambda: fn(qs, kp, vp, tbl, start), reps=5),
            timer(lambda: paged_prefill_ref(qs, kp, vp, tbl, start), reps=3),
            timer(lambda: sdpa(qs, kd, vd, is_causal=True), reps=5),
            2 * qs.numel() * 2 + 2 * torch.unique(tbl).numel() * kvh * BS * hd * 2
            + tbl.numel() * 4 + start.numel() * 4,
            4 * 8 * s * (s + 1) // 2 * h * hd, "paged prefill",
            f"cold: B=8 S={s} from position 0 H={h} KV={kvh} hd={hd} BS={BS}",
            "scaled_dot_product_attention, is_causal, over the gathered K/V")
        del qs, kd, vd
    if "flash" in kinds:
        fb, fs = len(VISION_LENS), max(VISION_LENS)
        fn, errs = fa.flash_attention, []
        for _ in range(SERVING_DRAWS):
            qf = torch.randn(fb, h, fs, hd, generator=g, device=dev).bfloat16()
            kf, vf = (torch.randn(fb, kvh, fs, hd, generator=g, device=dev).bfloat16()
                      for _ in range(2))
            before = fn.launches
            err, sh = held(fn(qf, kf, vf, causal=True),
                           flash_attention_ref(qf, kf, vf, causal=True), *FLASH_BF16)
            assert sh <= 1 and fn.launches == before + (dev.type == "cuda"), \
                (f"flash at {tag}'s shapes", err, sh)
            errs.append(err)
        kr, vr = kf.repeat_interleave(grp, dim=1), vf.repeat_interleave(grp, dim=1)
        row(f"flash_attention_{tag}", "flash_attention", SRC_FLASH,
            "src/repro/kernels/flash_attention/kernel.py:85", errs,
            timer(lambda: fn(qf, kf, vf, causal=True)),
            timer(lambda: flash_attention_ref(qf, kf, vf, causal=True), reps=3),
            timer(lambda: sdpa(qf, kr, vr, is_causal=True)),
            2 * qf.numel() * 2 + 2 * kf.numel() * 2,
            4 * fb * fs * (fs + 1) // 2 * h * hd, "flash",
            f"causal: B={fb} S={fs} H={h} KV={kvh} hd={hd} bf16 (the vision prefill's padded "
            "pass)", "scaled_dot_product_attention, is_causal, K/V repeated to the query heads",
            tol=f"{FLASH_BF16[0]} + {FLASH_BF16[1]} x |plain|")
        del qf, kf, vf, kr, vr
    del kp, vp
    _free(dev)
    return out


def time_vlm_mg_kernels(dev, g, timer=time_ms, plain_timer=time_ms) -> dict:
    """The ported kernels at llama-3.2-vision-90b's and musicgen-large's
    shapes: paged and dense decode at 64 heads over 8 KV heads of 128
    (GQA 8) and flash over ``[vision prefill]``'s padded batch at the same
    heads, paged decode and a cold causal prefill at musicgen's 32 heads
    over 32 of 64, and the int8 GEMM's stream kernel at one decode step's
    llama MLP products and musicgen's 4 codebook heads (``[8, 2048] x
    [2048, 2048]``), held bit for bit."""
    out = time_attention_rows(dev, g, "vlm", LL_H, LL_KVH, LL_HD,
                              ("paged_decode", "dense_decode", "flash"), timer)
    out.update(time_int8_gemms(dev, g, "int8_gemm_vlm", VLM_DECODE_GEMMS, {}, timer,
                               plain_timer))
    out.update(time_attention_rows(dev, g, "mg", MG_H, MG_H, MG_HD,
                                   ("paged_decode", "paged_prefill"), timer))
    out.update(time_int8_gemms(dev, g, "int8_gemm_mg", MG_DECODE_GEMMS, {}, timer, plain_timer))
    return out


@contextlib.contextmanager
def xattn_ranges():
    """Each cross-attention layer's decode under an ``xattn.decode``
    profiler range while the block runs."""
    from torch.profiler import record_function

    from repro_torch.models import attention

    fn = attention.attn_decode

    def ranged(*a, **kw):
        if kw.get("kind") != "xattn":
            return fn(*a, **kw)
        with record_function("xattn.decode"):
            return fn(*a, **kw)

    attention.attn_decode = ranged
    try:
        yield
    finally:
        attention.attn_decode = fn


def check_scan_admissions(cfg, label: str, dev) -> None:
    """Every blocking admission of run ``label`` was the masked scan: the
    dense decode kernel once per attention layer and scan step (the
    padded prompt's length), no flash and no paged prefill (``PHASES``)."""
    n_attn = sum(k in ("attn", "local") for k in cfg.layer_kinds)
    adm = PHASES[label]["admission"]
    assert adm, label
    if dev.type == "cuda":
        for lens, d in adm:
            assert d.get("dense_attention_decode") == n_attn * max(lens), (label, lens, d)
            assert not d.get("flash_attention") and not d.get("paged_attention_prefill"), d
    log(f"[{label}] {len(adm)} admissions ({', '.join(str(max(l)) for l, _ in adm)} scan "
        f"steps): dense_attention_decode {n_attn} x steps, no flash, no paged prefill "
        + ("(held)" if dev.type == "cuda" else "(not held: plain versions on the CPU)"))


@contextlib.contextmanager
def xattn_outputs():
    """Each cross-attention layer's output (``attn_seq`` or ``attn_decode``
    with ``kind="xattn"``), float32, in call order."""
    from repro_torch.models import attention

    fns, seen = (attention.attn_seq, attention.attn_decode), []

    def recorded(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            if kw.get("kind") == "xattn":
                seen.append(out[0].float())
            return out
        return call

    attention.attn_seq, attention.attn_decode = (recorded(fn) for fn in fns)
    try:
        yield seen
    finally:
        attention.attn_seq, attention.attn_decode = fns


def vision_prefill(cfg, params, dev) -> dict:
    """The vision entry point at full width: ``packed_prefill`` of 4 prompts
    of mixed lengths (``VISION_LENS``) with seeded bf16 embeddings ``[4,
    vision_tokens, d_model]`` under ``exact`` and ``int8``: the
    full-sequence pass (flash once per ``attn`` layer, the cross caches of
    all the vision positions), then ``VISION_STEPS`` greedy steps through
    ``Model.decode`` on its states.  Each step is held against one full
    forward per row over its prompt and fed tokens with its embeddings:
    the logits (and the prefill's last) to ``VISION_LOGIT_TOL``, the cross
    layer's output to ``VISION_XATTN_TOL``.  Then each of
    ``VISION_FAULTS`` is put into the cross caches and the same tokens
    are fed again: every fault must break the cross layer's limit.  Logs
    how far the int8 forward lies from the exact one, and how far the
    embeddings move the last logits from a text-only pass (the same
    forward with zero embeddings: zero cross K and V, what the engine's
    zeroed cross caches hold).  Under ``int8`` every int8 GEMM shape it
    gave (the cross K/V projection at M = 4 x vision_tokens among them) is
    held bit for bit.  Returns each plan's launches (``vision-<plan>``:
    the prefill and the sound decode steps)."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.transformer import forward
    from repro_torch.serve import pack_prompts, packed_prefill

    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in VISION_LENS]
    g = torch.Generator(device=dev).manual_seed(8)
    b = len(prompts)
    vis = torch.randn(b, cfg.vision_tokens, cfg.d_model, generator=g, device=dev).bfloat16()
    n_attn = cfg.layer_kinds.count("attn")
    cross = cfg.layer_kinds.index("xattn")
    assert cfg.layer_kinds.count("xattn") == 1, cfg.layer_kinds
    exact = _serving_model(cfg, dev, "exact")
    exact_prm = exact.prepare(params)
    launches = {}

    def rel(got, want):
        return ((got.float() - want).norm() / want.norm()).item()

    def rows_of(model, prm, seqs):  # each row's logits and cross output at the compared positions
        logits, xs = [], []
        for i, (n, seq) in enumerate(zip(VISION_LENS, seqs)):
            with xattn_outputs() as x:
                full, _ = forward(prm, seq[None], cfg, model.opts, vision_embeds=vis[i:i + 1])
            logits.append(full[0, n - 1:n + VISION_STEPS].float())
            xs.append(x[0][0, n:n + VISION_STEPS])
            del full, x
        return logits, xs

    def decode(model, prm, states, tokens):  # steps fed ``tokens`` [b, steps] or greedy
        pos, tok, logits, xs = lengths.long(), tokens[:, :1], [], []
        fed = []
        for t in range(VISION_STEPS):
            fed.append(tok)
            with xattn_outputs() as x:
                lg, states = model.decode(prm, tok, states, pos)
            assert torch.isfinite(lg).all()
            logits.append(lg)
            xs.append(x[0])
            pos = pos + 1
            tok = (tokens[:, t + 1:t + 2] if t + 1 < tokens.shape[1]
                   else lg[:, -1].argmax(-1)[:, None].int())
        return torch.cat(fed, dim=-1), logits, xs, states

    def readings(logits, xs, full, xfull):  # per (step, row): logits, cross output
        lr = [rel(lg[i, -1], full[i][t + 1]) for t, lg in enumerate(logits) for i in range(b)]
        xr = [rel(x[i, 0], xfull[i][t]) for t, x in enumerate(xs) for i in range(b)]
        return lr, xr

    for plan in ("exact", "int8"):
        model = exact if plan == "exact" else _serving_model(cfg, dev, plan)
        prm = exact_prm if plan == "exact" else model.prepare(params)
        toks, lengths = pack_prompts(prompts, cfg, device=dev)
        with int8_shapes() as seen:
            reset_launches()
            _sync(dev)
            t0 = time.perf_counter()
            last, states = packed_prefill(model, prm, toks, lengths, VISION_MAX_LEN,
                                          vision_embeds=vis)
            _sync(dev)
            pre_s = time.perf_counter() - t0
            counts = launch_counts()
            c = states["layers"][cross]
            assert tuple(c.k.shape) == (b, cfg.n_kv_heads, cfg.vision_tokens, cfg.head_dim)
            assert c.k.abs().amax() > 0
            if dev.type == "cuda":
                assert counts["flash_attention"] == n_attn, counts
            first = last[:, -1].argmax(-1)[:, None].int()
            fed, logits, xs, states = decode(model, prm, states, first)
            launches[f"vision-{plan}"] = after = launch_counts()  # the prefill's and the steps'
            if dev.type == "cuda":
                assert after["flash_attention"] == n_attn, after
                assert after["dense_attention_decode"] == n_attn * VISION_STEPS, after
            seqs = [torch.cat([toks[i, :n], fed[i]]) for i, n in enumerate(VISION_LENS)]
            full, xfull = rows_of(model, prm, seqs)
            lr, xr = readings(logits, xs, full, xfull)
            lr = [rel(last[i, -1], full[i][0]) for i in range(b)] + lr
            text, _ = forward(prm, toks, cfg, model.opts, vision_embeds=torch.zeros_like(vis))
            text_last = text[torch.arange(b, device=dev), lengths.long() - 1].float()
            moved = ((last[:, -1].float() - text_last).norm(dim=-1)
                     / text_last.norm(dim=-1))
            same = (last[:, -1].argmax(-1) == text_last.argmax(-1)).float().mean().item()
            del text, text_last
        faults = {}
        for name, fault in VISION_FAULTS.items():
            bad = {**states, "layers": list(states["layers"])}
            bad["layers"][cross] = type(c)(*fault(c.k, c.v))
            _, f_logits, f_xs, _ = decode(model, prm, bad, fed)
            faults[name] = readings(f_logits, f_xs, full, xfull)
            del bad, f_logits, f_xs
        own = ""
        if plan != "exact":  # the int8 forward's distance from the exact function, logged
            ref, _ = rows_of(exact, exact_prm, seqs)
            q = [rel(f, r) for fi, ri in zip(full, ref) for f, r in zip(fi, ri)]
            own = (f"; the int8 forward lies {max(q):.3e} (median {float(np.median(q)):.3e}) "
                   "from the exact forward over the same tokens")
            del ref
        log(f"[vision prefill {plan}] {cfg.name} ({cfg.n_layers}L d{cfg.d_model}), "
            f"{b} prompts {list(VISION_LENS)} with bf16 embeddings {tuple(vis.shape)}: "
            f"full-sequence prefill {pre_s:.3f} s, flash x{n_attn}, cross caches of "
            f"{cfg.vision_tokens} positions; {VISION_STEPS} greedy steps (dense decode "
            f"x{n_attn} a step) against a full forward per row: relative L2 of the logits max "
            f"{max(lr):.3e}, median {float(np.median(lr)):.3e} (< {VISION_LOGIT_TOL[plan]}), "
            f"of the cross layer's output max {max(xr):.3e}, median "
            f"{float(np.median(xr)):.3e} (< {VISION_XATTN_TOL[plan]}){own}; the embeddings "
            f"move the last logits from a text-only pass (zero embeddings) by a relative L2 "
            f"of {', '.join(f'{m:.3f}' for m in moved.tolist())}, greedy first token "
            f"unchanged in {same:.0%} of the {b}")
        log(f"[vision faults {plan}] the same tokens fed with a fault in the cross caches, max "
            "relative L2 of the cross layer's output / of the logits: "
            + "; ".join(f"{k} {max(x):.3e} / {max(lg):.3e}" for k, (lg, x) in faults.items())
            + f" (each must pass the cross limit {VISION_XATTN_TOL[plan]})")
        assert max(lr) < VISION_LOGIT_TOL[plan], (plan, max(lr))
        assert max(xr) < VISION_XATTN_TOL[plan], (plan, max(xr))
        for name, (_, x) in faults.items():
            assert max(x) > VISION_XATTN_TOL[plan], (plan, name, max(x))
        del states, logits, last, full, xfull, c
        if plan != "exact":
            del model, prm
        _free(dev)
        if plan == "int8":
            shape = (b * cfg.vision_tokens, cfg.d_model, cfg.kv_dim)
            assert shape in seen["int8_gemm"], (shape, sorted(seen["int8_gemm"]))
            hold_served_int8_shapes(dev, seen, "vision-int8")
    del exact, exact_prm
    _free(dev)
    return launches


def serve_vlm(cfg, dev, summary: dict) -> dict:
    """llama-3.2-vision-90b at its published widths, one period (bf16,
    random weights from seed 0), served text-only as the reference engine
    serves it, ``max_len 512``, 8 prompts of 64-160 tokens, 16 new each:
    ``vlm-exact`` and ``vlm-int8`` on the paged pool (the stack is stateful
    there: prefix cache off with the reference's reason, blocking
    admission through the masked scan and a block scatter; decode through
    the pool on the 4 attn layers, plain attention over the zeroed cross
    cache), ``vlm-exact-dense`` and ``vlm-exact-dense-chunked`` (budget
    64).  Asserts each run's kernels by phase (:func:`check_scan_admissions`,
    :func:`check_layer_launches`), holds every int8 shape ``vlm-int8``
    gave bit for bit, runs :func:`vision_prefill` and profiles one
    ``vlm-exact`` decode chunk with the cross-attention layer under a
    range.  Returns each run's launches."""
    from repro_torch.models.model import Model

    params = Model(cfg, device=dev).init(seed=0)
    prompts = make_vlm_prompts(cfg.vocab, np.random.default_rng(5))
    runs = [("vlm-exact", "exact", "none"), ("vlm-int8", "int8", "none")]
    with int8_shapes() as seen:
        launches, tokens = serve(cfg, params, prompts, dev, runs, gen=16, summary=summary)
    hold_served_int8_shapes(dev, seen, "vlm-int8")
    for label, budget in (("vlm-exact-dense", 0), ("vlm-exact-dense-chunked", 64)):
        counts, toks = serve(cfg, params, prompts, dev, [(label, "exact", "none")], gen=16,
                             kv_block_size=0, chunk_tokens=budget, summary=summary)
        launches.update(counts)
        tokens.update(toks)
    for label in ("vlm-exact", "vlm-int8", "vlm-exact-dense"):
        check_scan_admissions(cfg, label, dev)
    for label, kernel in (("vlm-exact", "paged_attention_decode"),
                          ("vlm-int8", "paged_attention_decode"),
                          ("vlm-exact-dense", "dense_attention_decode"),
                          ("vlm-exact-dense-chunked", "dense_attention_decode")):
        check_layer_launches(cfg, label, dev, kernel)
    for label in ("vlm-int8", "vlm-exact-dense", "vlm-exact-dense-chunked"):
        agree = (tokens[label] == tokens["vlm-exact"]).mean()
        log(f"[agreement {label}] greedy tokens equal to vlm-exact: {agree:.1%} (reported, not "
            "gated: random weights at bf16)")
    chunked_beside_blocking(summary, "vlm-exact-dense-chunked", "vlm-exact-dense", tokens)
    kv = summary["vlm-exact"]["kv"]
    log(f"[vlm-exact] kv_stats: bytes_per_block {kv['bytes_per_block']} (4 attn layers x K and "
        f"V x {BS} x {LL_KVH} x {LL_HD} x 2 B), {kv['pool_blocks']} blocks; prefix cache off: "
        f"{kv['prefix_cache_off_reason']}; cross caches dense by slot, 2 x 8 x {LL_KVH} x "
        f"{cfg.vision_tokens} x {LL_HD} x 2 B = "
        f"{2 * 8 * LL_KVH * cfg.vision_tokens * LL_HD * 2 / 1e6:.1f} MB")
    launches.update(vision_prefill(cfg, params, dev))
    with xattn_ranges():
        profile_decode_chunk(cfg, params, prompts, dev, runs[:1])
    del params
    _free(dev)
    return launches


def serve_mg(cfg, dev, summary: dict) -> dict:
    """musicgen-large whole (bf16, random weights from seed 0), ``max_len
    512``, the 12 ``[4, 96-384]`` grids of :func:`make_mg_prompts`, 32 new
    each (``[4, 32]`` grids): ``mg-exact`` (prefix hits asserted) and
    ``mg-int8`` on the paged pool, ``mg-exact-dense`` and
    ``mg-exact-chunked`` (paged, budget 256).  Each decode chunk launches
    its layout's decode kernel once per layer and step; every int8 shape
    ``mg-int8`` gave is held bit for bit, the 4 codebook heads' ``[8,
    2048] x [2048, 2048]`` among them.  Returns each run's launches."""
    from repro_torch.models.model import Model

    params = Model(cfg, device=dev).init(seed=0)
    prompts = make_mg_prompts(cfg.vocab, np.random.default_rng(7))
    runs = [("mg-exact", "exact", "none"), ("mg-int8", "int8", "none")]
    with int8_shapes() as seen:
        launches, tokens = serve(cfg, params, prompts, dev, runs, gen=32, summary=summary)
    assert tokens["mg-exact"].shape == (len(prompts), MG_C, 32), tokens["mg-exact"].shape
    assert dev.type != "cuda" or (8, cfg.d_model, cfg.vocab) in seen["int8_gemm"], \
        sorted(seen["int8_gemm"])
    hold_served_int8_shapes(dev, seen, "mg-int8")
    for label, bs, budget, kernel in (("mg-exact-dense", 0, 0, "dense_attention_decode"),
                                      ("mg-exact-chunked", BS, 256, "paged_attention_decode")):
        counts, toks = serve(cfg, params, prompts, dev, [(label, "exact", "none")], gen=32,
                             kv_block_size=bs, chunk_tokens=budget, summary=summary)
        launches.update(counts)
        tokens.update(toks)
        check_layer_launches(cfg, label, dev, kernel)
    for label in ("mg-exact", "mg-int8"):
        check_layer_launches(cfg, label, dev, "paged_attention_decode")
    for label in ("mg-int8", "mg-exact-dense", "mg-exact-chunked"):
        agree = (tokens[label] == tokens["mg-exact"]).mean()
        log(f"[agreement {label}] greedy tokens equal to mg-exact: {agree:.1%} (reported, not "
            "gated: random weights at bf16)")
    chunked_beside_blocking(summary, "mg-exact-chunked", "mg-exact", tokens)
    log_astra(cfg, summary, "mg-exact")
    del params
    _free(dev)
    return launches


def small_vlm_mg_card_vs_cpu(dev) -> None:
    """Reduced float32 llama-3.2-vision (one period) and musicgen (2
    layers, ``[4, n]`` grids sharing a prefix) served with the kernels on
    ``dev`` and their plain versions on the CPU, under all four plans, on
    the paged pool (block 8) and on dense caches.  Under exact every greedy
    token is equal.  Under a quantized plan the integer products are exact
    given the codes, but a float32 op outside them can round otherwise on
    the card, and a value within a rounding error of a half code then
    moves that code, and every greedy token after it may differ: where
    tokens differ, every quantized tensor of both sides (the qk/pv
    operands included) is compared call by call
    (:func:`code_flip_witness`) and the difference must have
    that witness: before the first moved code the float inputs within 1e-4
    (relative to the tensor's absmax), at it codes moved by one, each from
    a value within 1e-3 code units of the half.  The share of equal tokens
    is reported."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions
    from repro_torch.serve import ServeConfig, ServeEngine

    for name, tag, red in (("llama-3.2-vision-90b", "vlm", {}),
                           ("musicgen-large", "mg", dict(n_layers=2))):
        small = get_arch(name).reduced(dtype="float32", **red)
        rng = np.random.default_rng(12)
        lead = small.token_lead
        prefix = rng.integers(0, small.vocab, lead + (16,), dtype=np.int32)
        prompts = [np.concatenate([prefix, rng.integers(0, small.vocab, lead + (n,),
                                                        dtype=np.int32)], axis=-1)
                   for n in (5, 19)] + [rng.integers(0, small.vocab, lead + (n,), dtype=np.int32)
                                        for n in (12, 33, 8)]
        params = Model(small, device="cpu").init(seed=8)
        for plan in ("exact", "int8", "sc", "mixed"):
            for bs in (8, 0):
                scfg = ServeConfig(max_slots=3, max_len=64, chunk_steps=4, kv_block_size=bs)
                toks, calls = {}, {}
                for where in ("cpu", dev):
                    m = Model(small, ModelOptions(plan=plan, attn_impl="flash"), device=where)
                    with quantized_activations() as calls[str(where)]:
                        outs = ServeEngine(m, _to(params, m.device), scfg,
                                           device=where).generate_batch(prompts, 10)
                    toks[str(where)] = np.stack([o.tokens for o in outs])
                agree = (toks["cpu"] == toks[str(dev)]).mean()
                label = f"{plan}{'-dense' if bs == 0 else ''}"
                line = (f"[small {tag} {label}] reduced {name} float32 on {dev} (kernels) vs "
                        f"cpu (plain versions): {agree:.0%} of greedy tokens equal")
                if agree < 1.0:
                    w = code_flip_witness(calls["cpu"], calls[str(dev)])
                    line += ("; " + (f"first code moved at call {w['call']} of {w['calls']} "
                                     f"(input {w['shape']}): {w['moved']} of {w['of']} codes, by "
                                     f"at most {w['step']}, their values at most "
                                     f"{w['boundary']:.2e} code units from the half; float "
                                     f"inputs before it within {w['rel_before']:.2e}"
                                     if w["call"] is not None else "no code moved"))
                    log(line)
                    assert plan != "exact", (tag, label, agree)
                    assert w["call"] is not None and w["step"] == 1 and \
                        w["boundary"] <= 1e-3 and w["rel_before"] <= 1e-4, (tag, label, w)
                else:
                    log(line)


def log_tiles() -> None:
    """Dynamic shared memory of the redesigned kernels at each head dim, as
    their launches request it (ptxas reports static shared memory only)."""
    from repro_torch.kernels import _build

    flash = _build.load("flash_attention").flash_attention_smem_bytes
    decode = _build.load("decode").decode_smem_bytes
    prefill = _build.load("paged_prefill").paged_prefill_smem_bytes
    int8 = _build.load("int8_gemm_sm90").int8_gemm_smem_bytes
    log(f"[tiles] int8 GEMM: wgmma kernel {int8(0)} B (3 stages of 128 x 128-byte X and Wt "
        f"slabs); stream kernel M <= 8 / M <= 16: {int8(1)} / {int8(2)} B (4 warps x 6 stages "
        "of 16 weight rows and the X rows, 128 K bytes each)")
    b1 = _build.load("stoch_gemm_sm90").stoch_gemm_smem_bytes
    log(f"[tiles] binary stochastic GEMM: wgmma kernel {b1()} B (2 stages of the W tile as "
        "sign planes and as streams, 128 rows x 8 codes x 48 bytes, and the two stream tables "
        "in 8 copies)")
    batched = _build.load("int8_gemm_sm90").int8_gemm_batched_smem_bytes
    log("[tiles] int8 batched stream kernel, one product a block: "
        + ", ".join(f"M={m} K={k} N={n} {batched(m, n, k)} B" for _, m, k, n in QKPV_DECODE))
    # the tiles kernel's geometry as its launch computes it
    geo_fn = _build.load("int8_gemm_sm90").int8_gemm_batched_tiles_geometry
    geo_fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    parts = []
    for b, m, k, n in QKPV_ADMISSION + [(2, 33, 4096, 257), (2, 300, 64, 513)]:
        geo = (ctypes.c_int * 6)()  # bn, tiles_n, K pieces a stage, pitch, out pitch, smem
        geo_fn(m, n, k, geo)
        bn, tiles_n, kc, _, _, smem = geo
        parts.append(f"M={m} K={k} N={n} {smem} B ({b * -(-m // 32) * tiles_n} blocks of 32 x "
                     f"{bn}, {16 * kc} K bytes a stage)")
    log("[tiles] int8 batched tiles kernel, the output staged over the operand rows: "
        + ", ".join(parts))
    scan = _build.load("rglru_scan").rglru_scan_smem_bytes()
    log(f"[tiles] rglru_scan: {scan} B static a block (3 stages of 32 steps x 32 channels of "
        "a and b, and the 8 warps' end values)")
    for hd in HEAD_DIMS_ALL:
        tiles = "; ".join(f"{name} G 1/4/10 {decode(hd, c, 1)}/{decode(hd, c, 4)}/"
                          f"{decode(hd, c, 10)} B"
                          for name, c in (("bf16", 1), ("float32", 0), ("int8 pool", 2)))
        log(f"[tiles] hd {hd}: flash bf16 {flash(hd, 1)} B, float32 {flash(hd, 0)} B; decode "
            f"split kernel (a paged block adds its table slice) {tiles}; paged prefill bf16 "
            f"{prefill(hd, 1)} B, float32 pool {prefill(hd, 0)} B, int8 pool {prefill(hd, 2)} B")


# ------------------------------------------------------------------ training
# [train]: qwen1.5-0.5b at its published widths through the train driver's
# main(), with the reference CLI's --batch 8 --seq 128 --lr 1e-3; a clean
# run of 16 steps checkpointing every 8 and a run with a fault at step 11,
# which restores step 7's checkpoint and replays 8-15
QWEN_TRAIN = ["--arch", "qwen1.5-0.5b", "--steps", "16", "--batch", "8", "--seq", "128",
              "--lr", "1e-3", "--ckpt-every", "8", "--log-every", "4"]
QWEN_FAIL_AT = 11
TRAIN_TIMED_STEPS = 8  # steps timed one by one after the runs, each ended by a sync
# [train rglru]: recurrentgemma-2b cut to one pattern period at B 2, S 256,
# float32; every leaf's gradient with the kernel-backed scan against the
# plain loop's under autograd, within RG_TRAIN_TOL of the leaf's largest
# magnitude (the kernel folds carries in another order and rounds each
# a * h + b once: ~1e-6 relative per state, summed over 256 steps)
RG_TRAIN_B, RG_TRAIN_S = 2, 256
RG_TRAIN_TOL = 1e-4
# [train moe]: granite-moe-1b-a400m whole, 4 steps at B 8, S 128
GM_TRAIN_STEPS, GM_TRAIN_B, GM_TRAIN_S = 4, 8, 128
# [train card vs CPU]: reduced float32 models, 3 steps from one seed and one
# init; losses within SMALL_TRAIN_TOL (float32 with TF32 off: the card's
# GEMMs, the scan kernel and reductions sum in other orders)
SMALL_TRAIN_STEPS, SMALL_TRAIN_TOL = 3, 1e-4
SMALL_TRAIN = ("qwen1.5-0.5b", "granite-moe-1b-a400m", "recurrentgemma-2b")


def _loss_and_grads(model, params, batch):
    """(loss, aux, the gradient of every leaf of ``params``), as
    ``launch.train.build_train_step`` takes them."""
    from repro_torch import tree as tree_util

    live = [p.detach().requires_grad_(True) for p in tree_util.leaves(params)]
    loss, m = model.loss(tree_util.unflatten(params, live), batch)
    return loss.detach(), m["aux"].detach(), torch.autograd.grad(loss, live)


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # initializes the allocator if nothing did yet
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else float("nan")


def profile_train_step(model, params, opt, batch, dev, ocfg) -> dict:
    """``[profile train]``: one train step split on the host's clock into
    forward and loss, backward and AdamW (each ended by a sync), then one
    step under ``torch.profiler``: its host time against the device time
    of the kernels it ran (their sum: the rest of the step the device
    idles), how many it launched, and the three that took longest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree as tree_util
    from repro_torch.launch.train import build_train_step
    from repro_torch.optim import adamw_update, cosine_schedule

    _sync(dev)
    t0 = time.perf_counter()
    live = [p.detach().requires_grad_(True) for p in tree_util.leaves(params)]
    loss, _ = model.loss(tree_util.unflatten(params, live), batch)
    _sync(dev)
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, live)
    _sync(dev)
    t2 = time.perf_counter()
    adamw_update(params, tree_util.unflatten(params, list(grads)), opt, ocfg,
                 cosine_schedule(opt["step"], 20, 100))
    _sync(dev)
    t3 = time.perf_counter()
    del live, loss, grads
    step = build_train_step(model, ocfg, 100, 20)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t4 = time.perf_counter()
        step(params, opt, batch)
        _sync(dev)
        host_ms = (time.perf_counter() - t4) * 1e3
    on_dev = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(r[0] for r in on_dev) / 1e3
    out = dict(forward_ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3,
               adamw_ms=(t3 - t2) * 1e3, host_ms=host_ms, device_ms=dev_ms,
               kernels=sum(r[2] for r in on_dev))
    top = "; ".join(f"{k[:60]} {t / 1e3:.2f} ms x{c}" for t, k, c in sorted(on_dev)[::-1][:3])
    busy = f"{dev_ms / host_ms:.1%}" if dev_ms > 0 else "not measured"
    log(f"[profile train] one step: forward and loss {out['forward_ms']:.1f} ms, backward "
        f"{out['backward_ms']:.1f} ms, AdamW {out['adamw_ms']:.1f} ms (host clock, each ended "
        f"by a sync); profiled: host {host_ms:.1f} ms, device kernels {dev_ms:.2f} ms over "
        f"{out['kernels']} launches, device busy {busy}; longest: {top}")
    return out


def train_qwen(cfg, dev, argv) -> dict:
    """Phase ``[train]``: the driver's clean run (``launch.train.main`` on
    ``argv``, whose ``--arch`` is ``cfg``) and its faulted run,
    their loss trajectories equal bit for bit over every step, the loss
    falling, and the costs: peak device memory of the clean run, one
    synchronous save of the whole state (params, ``m``, ``v``) and the
    median of ``TRAIN_TIMED_STEPS`` steps timed one by one.  The
    checkpoints go to a temporary directory that is removed after."""
    import shutil
    import statistics
    import tempfile

    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.data import DataConfig, SyntheticLMDataset, batch_to
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig

    steps, batch, seq = (int(argv[argv.index(f) + 1]) for f in ("--steps", "--batch", "--seq"))
    root = tempfile.mkdtemp(prefix="train_ckpt_")
    out = {}
    try:
        log(f"[train] checkpoints under {root}: {shutil.disk_usage(root).free / 2**30:.1f} GiB "
            "free")
        reset_launches()
        _reset_peak(dev)
        clean = train.main(argv + ["--ckpt-dir", os.path.join(root, "clean")])
        peak = _peak_gb(dev)
        counts = {k: v for k, v in launch_counts().items() if v}
        shutil.rmtree(os.path.join(root, "clean"))
        faulted = train.main(argv + ["--ckpt-dir", os.path.join(root, "faulted"),
                                     "--fail-at", str(QWEN_FAIL_AT)])
        shutil.rmtree(os.path.join(root, "faulted"))
        cl = [clean["metrics"][s]["loss"] for s in range(steps)]
        fl = [faulted["metrics"][s]["loss"] for s in range(steps)]
        moved = [s for s in range(steps) if cl[s] != fl[s]]
        log(f"[train] clean losses {cl}")
        log(f"[train] faulted run (fault at step {QWEN_FAIL_AT}, restarts "
            f"{faulted['restarts']}): losses equal to the clean run's at "
            f"{steps - len(moved)} of {steps} steps; differing at {moved}")
        assert faulted["restarts"] == 1 and clean["restarts"] == 0
        assert not moved, [(s, cl[s], fl[s]) for s in moved]
        first, last = float(np.mean(cl[:3])), float(np.mean(cl[-3:]))
        assert last < first, (first, last)
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(root, "timed"), steps - 1, clean["state"])
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        shutil.rmtree(os.path.join(root, "timed"))
        model = Model(cfg, device=dev)
        step = train.build_train_step(model, AdamWConfig(lr=1e-3), steps + TRAIN_TIMED_STEPS,
                                      20)
        ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                           seed=0))
        params, opt = clean["state"]["params"], clean["state"]["opt"]
        del clean, faulted
        times = []
        for s in range(steps, steps + TRAIN_TIMED_STEPS):
            b = batch_to(ds.batch_at(s), dev)
            _sync(dev)
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            loss = float(m["loss"])  # waits for the step
            times.append((time.perf_counter() - t0) * 1e3)
            assert np.isfinite(loss)
        prof = profile_train_step(model, params, opt, b, dev, AdamWConfig(lr=1e-3))
        n_params = sum(p.numel() for p in tree_util.leaves(params))
        step_ms = statistics.median(times)
        out = dict(step_ms=step_ms, tok_s=batch * seq / step_ms * 1e3, peak_gb=peak,
                   save_s=save_s, ckpt_gb=ckpt_bytes / 1e9, loss_first3=first, loss_last3=last,
                   losses=cl, **prof)
        log(f"[train] {cfg.name} ({cfg.n_layers}L d{cfg.d_model}, {n_params / 1e6:.1f}M "
            f"params, float32 masters, bf16 compute), batch {batch} x {seq}: loss "
            f"{first:.4f} -> {last:.4f} (mean of the first and last 3 steps); step "
            f"{step_ms:.1f} ms median of {TRAIN_TIMED_STEPS} ({min(times):.1f}-{max(times):.1f}),"
            f" {out['tok_s']:.0f} training tok/s; peak device memory {out['peak_gb']:.2f} GB "
            f"(max_memory_allocated, clean run); one synchronous checkpoint save "
            f"{save_s:.2f} s for {out['ckpt_gb']:.2f} GB; kernels launched in the clean run: "
            f"{counts or 'none (plain attention, exact plan: no hand-written kernel on this path)'}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def train_rglru(cfg, dev, timer=time_ms) -> dict:
    """Phase ``[train rglru]``: ``cfg`` is recurrentgemma-2b at published
    widths cut to one pattern period (``rglru``, ``rglru``, ``local``),
    float32.  One
    loss and gradient through the kernel-backed scan must launch the scan
    3 times per ``rglru`` layer (forward, remat's recompute, backward) and
    its backward once per layer; every leaf's gradient is held against the
    same loss with autograd through the plain loop, on the card.  The
    backward's kernel launch is timed beside the forward's at this shape.
    Returns the launch counts of the kernel-backed step (the ``train``
    entry of the scan row's ``launches_by_plan``)."""
    import repro_torch.kernels.rglru_scan as rg_pkg
    from repro_torch import tree as tree_util
    from repro_torch.data import DataConfig, SyntheticLMDataset, batch_to
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.rglru_scan import ops as rg
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    from repro_torch.models.model import Model

    model = Model(cfg, device=dev)
    params = model.init(seed=0)
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=RG_TRAIN_S,
                                       global_batch=RG_TRAIN_B, seed=0))
    batch = batch_to(ds.batch_at(0), dev)
    reset_launches()
    loss, _, got = _loss_and_grads(model, params, batch)
    _sync(dev)
    counts = launch_counts()
    n = cfg.layer_kinds.count("rglru")
    assert counts["rglru_scan"] == 3 * n and counts["rglru_scan_backward"] == n, counts
    assert counts[f"rglru_scan_s{RG_TRAIN_S}"] == 3 * n
    real = rg_pkg.rglru_scan
    rg_pkg.rglru_scan = rglru_scan_ref  # the models import the package's attribute
    try:
        plain_loss, _, want = _loss_and_grads(model, params, batch)
    finally:
        rg_pkg.rglru_scan = real
    worst, names = 0.0, []
    for (name, _), g, w in zip(tree_util.paths(params), got, want):
        share = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if share > worst:
            worst, names = share, [name]
    assert worst <= RG_TRAIN_TOL, (worst, names)
    assert abs(float(loss) - float(plain_loss)) <= 1e-5 * abs(float(plain_loss))
    # the backward's kernel launch at this shape, beside the forward's
    gen = torch.Generator(device=dev).manual_seed(7)
    shape = (RG_TRAIN_B, RG_TRAIN_S, cfg.d_rnn)
    a = torch.rand(*shape, generator=gen, device=dev) * 0.799 + 0.2
    x = torch.randn(*shape, generator=gen, device=dev)
    dh = torch.randn(*shape, generator=gen, device=dev)
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1).flip(1).contiguous()
    dh_rev = dh.flip(1).contiguous()
    fwd_ms = timer(lambda: rg._scan(a, x))
    bwd_ms = timer(lambda: rg._scan(a_next, dh_rev))
    ta, tx = a.clone().requires_grad_(True), x.clone().requires_grad_(True)
    h = rg.rglru_scan(ta, tx)
    whole_ms = timer(lambda: torch.autograd.grad(h, (ta, tx), dh, retain_graph=True))
    log(f"[train rglru] {cfg.name} one period ({'/'.join(cfg.layer_kinds)}, d{cfg.d_model}, "
        f"d_rnn {cfg.d_rnn}, vocab {cfg.vocab}) float32, B {RG_TRAIN_B} S {RG_TRAIN_S}: loss "
        f"{float(loss):.6f} (plain scan {float(plain_loss):.6f}); every leaf's gradient within "
        f"{worst:.2e} of its largest magnitude (limit {RG_TRAIN_TOL}; worst {names}); scan "
        f"launches in one loss and gradient: {counts['rglru_scan']} = 3 x {n} rglru layers "
        f"(forward, remat recompute, backward), backward {counts['rglru_scan_backward']}")
    log(f"[time rglru_scan backward] B={RG_TRAIN_B} S={RG_TRAIN_S} D={cfg.d_rnn}: backward "
        f"kernel launch {bwd_ms:.4f} ms beside the forward's {fwd_ms:.4f} ms at this shape; "
        f"the whole backward (shift, flips, the launch, da = g h_prev) {whole_ms:.4f} ms")
    del params, got, want
    _free(dev)
    return {"counts": counts, "bwd_ms": bwd_ms, "fwd_ms": fwd_ms, "whole_ms": whole_ms,
            "worst": worst}


def train_moe(cfg, dev) -> dict:
    """Phase ``[train moe]``: ``cfg`` is granite-moe-1b-a400m whole
    (float32 masters, bf16 compute); ``GM_TRAIN_STEPS`` steps of loss, gradient
    and AdamW with no checkpoint; the loss, every gradient and the
    load-balance loss finite, the latter above 0."""
    from repro_torch import tree as tree_util
    from repro_torch.data import DataConfig, SyntheticLMDataset, batch_to
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule

    model = Model(cfg, device=dev)
    params = model.init(seed=0)
    opt = adamw_init(params)
    n_params = sum(p.numel() for p in tree_util.leaves(params))
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=GM_TRAIN_S,
                                       global_batch=GM_TRAIN_B, seed=0))
    ocfg = AdamWConfig(lr=1e-3)
    _reset_peak(dev)
    rows, times = [], []
    for s in range(GM_TRAIN_STEPS):
        b = batch_to(ds.batch_at(s), dev)
        _sync(dev)
        t0 = time.perf_counter()
        loss, aux, grads = _loss_and_grads(model, params, b)
        finite = torch.stack([g.isfinite().all() for g in grads]).all()
        params, opt, st = adamw_update(params, tree_util.unflatten(params, list(grads)), opt,
                                       ocfg, cosine_schedule(opt["step"], 1, GM_TRAIN_STEPS))
        rows.append((float(loss), float(aux), bool(finite), float(st["grad_norm"])))
        times.append((time.perf_counter() - t0) * 1e3)
        del grads
    peak = _peak_gb(dev)
    log(f"[train moe] {cfg.name} ({cfg.n_layers}L d{cfg.d_model}, {cfg.moe.n_experts} experts "
        f"top-{cfg.moe.top_k}, {n_params / 1e9:.3f}B params), batch {GM_TRAIN_B} x "
        f"{GM_TRAIN_S}: (loss, aux, grads finite, grad norm) per step {rows}; step "
        f"{times[-1]:.1f} ms (the last; the first {times[0]:.1f}); peak device memory "
        f"{peak:.2f} GB")
    for loss, aux, finite, gnorm in rows:
        assert np.isfinite(loss) and np.isfinite(gnorm) and finite and aux > 0, rows
    del params, opt
    _free(dev)
    return {"step_ms": times[-1], "peak_gb": peak, "rows": rows}


def train_card_vs_cpu(dev) -> None:
    """Phase ``[train card vs CPU]``: reduced float32 qwen, granite and
    recurrentgemma, ``SMALL_TRAIN_STEPS`` steps of the train step on the
    card and on the CPU from one init (made on the CPU) and one batch
    sequence; losses within ``SMALL_TRAIN_TOL``."""
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticLMDataset, batch_to
    from repro_torch.launch.train import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig, adamw_init

    cpu = torch.device("cpu")
    for name in SMALL_TRAIN:
        cfg = get_arch(name).reduced(dtype="float32")
        init = Model(cfg, device=cpu).init(seed=0)
        ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2, seed=0))
        losses = {}
        for side, d in (("cpu", cpu), ("card", dev)):
            step = build_train_step(Model(cfg, device=d), AdamWConfig(lr=1e-3),
                                    SMALL_TRAIN_STEPS, 1)
            params = _to(init, d)
            opt = adamw_init(params)
            losses[side] = []
            for s in range(SMALL_TRAIN_STEPS):
                params, opt, m = step(params, opt, batch_to(ds.batch_at(s), d))
                losses[side].append(float(m["loss"]))
        diff = max(abs(a - b) for a, b in zip(losses["cpu"], losses["card"]))
        log(f"[train card vs CPU] {cfg.name} float32, {SMALL_TRAIN_STEPS} steps: card "
            f"{losses['card']} CPU {losses['cpu']}; max |diff| {diff:.2e} (limit "
            f"{SMALL_TRAIN_TOL})")
        assert diff <= SMALL_TRAIN_TOL, (name, losses)


def train_guard(dev) -> None:
    """Phase ``[train guard]``: ``Model.loss`` on the card under
    ``attn_impl="flash"`` and under ``int8`` raises (the kernels have no
    backward, and rounding has no gradient), never detaches."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions

    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = tree_util.map_leaves(lambda t: t.requires_grad_(True),
                                  Model(cfg, device=dev).init(seed=0))
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), device=dev)}
    for label, opts in (("flash", ModelOptions(attn_impl="flash")),
                        ("int8", ModelOptions(plan="int8"))):
        try:
            Model(cfg, opts, device=dev).loss(params, batch)
        except RuntimeError as e:
            assert "has no backward" in str(e), e
            log(f"[train guard] Model.loss under {label} on {dev}: refused ({e})")
        else:
            raise AssertionError(f"Model.loss under {label} returned instead of raising")


# [shard]: the sharded ZeRO-3 step (repro_torch.parallel.step) on two ranks
# sharing cuda:0, a gloo group over a FileStore in a temporary directory;
# full-width qwen1.5-0.5b on data 2 x model 1 under tp_fsdp, [train]'s seed,
# lr, warmup, total steps and batch, its losses held within SHARD_TOL of
# [train]'s first clean losses (bf16 compute: each rank runs half the rows,
# so cuBLAS may pick other kernels).  The warmup makes the held steps'
# updates small (learning-rate scales 0, 0.05, 0.10, 0.15), too small to
# move those losses past SHARD_TOL, so the update is held on its own: the
# params after the held steps, gathered, against a one-process run of the
# same steps on rank 0, as |sharded - one-process| / |one-process - start|
# over every leaf (within SHARD_UPDATE_TOL) and per leaf (SHARD_LEAF_TOL).
# Two controls read the same gap and must lie past SHARD_UPDATE_TOL: a
# state left unchanged (1 by construction) and a step on rank 0's rows
# alone (what a step that skips the gradient sum over the data-parallel
# ranks does).  Then reduced float32 qwen3-moe-30b-a3b from a state two
# one-process card steps left, SHARD_MOE_STEPS sharded steps against the
# one-process card steps: losses within 1e-5, aux within 1e-6 relative,
# every updated leaf within 1e-5 of its largest magnitude
SHARD_STEPS, SHARD_TOL = 4, 5e-3
SHARD_UPDATE_TOL, SHARD_LEAF_TOL = 0.25, 0.5
SHARD_MOE_STEPS, SHARD_MOE_B, SHARD_MOE_S = 2, 8, 128  # 1024 tokens: a group of 512 a rank
SHARD_MOE_WARM = 2  # one-process steps before the held ones


def _moe_shard_setup(dev):
    """(cfg, model, the state after SHARD_MOE_WARM one-process steps, the
    held steps' batches, the one-process step) for the MoE check."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_arch("qwen3-moe-30b-a3b").reduced(dtype="float32", n_layers=2)
    model = Model(cfg, device=dev)
    step = build_train_step(model, AdamWConfig(lr=1e-3), 8, 1)
    rng = np.random.default_rng(7)
    batches = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (SHARD_MOE_B, SHARD_MOE_S))
                                           .astype(np.int32)).to(dev)}
               for _ in range(SHARD_MOE_WARM + SHARD_MOE_STEPS)]
    params = model.init(seed=0)
    state = {"params": params, "opt": adamw_init(params)}
    for b in batches[:SHARD_MOE_WARM]:
        p, o, _ = step(state["params"], state["opt"], b)
        state = {"params": p, "opt": o}
    return cfg, model, state, batches[SHARD_MOE_WARM:], step


def _update_gap(got, want, start):
    """(|got - want| / |want - start| over every leaf, that ratio for each
    leaf whose ``want`` moved, as {index: ratio}): how far ``got``'s
    update lies from ``want``'s, as a share of ``want``'s."""
    num = den = 0.0
    per_leaf = {}
    for i, (g, w, s0) in enumerate(zip(got, want, start)):
        d = float(torch.sum(torch.square(g.float() - w.float())))
        u = float(torch.sum(torch.square(w.float() - s0.float())))
        num, den = num + d, den + u
        if u > 0:
            per_leaf[i] = (d / u) ** 0.5
    return (num / den) ** 0.5, per_leaf


def _shard_update_check(model, dev, ds, lr, total, got, half) -> dict:
    """The sharded run's params after SHARD_STEPS steps (``got``, full)
    against a one-process run of the same steps from the same init, and
    the two controls' gaps (``_update_gap``): the init itself (a state
    left unchanged) and a one-process run on each batch's first ``half``
    rows (rank 0's rows: a step that skips the gradient sum)."""
    from repro_torch import tree as tree_util
    from repro_torch.data import batch_to
    from repro_torch.launch.train import build_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    def run(rows):
        step = build_train_step(model, AdamWConfig(lr=lr), total, 20)
        params = model.init(seed=0)
        opt = adamw_init(params)
        losses, norms = [], []
        for s in range(SHARD_STEPS):
            b = {k: v[:rows] for k, v in batch_to(ds.batch_at(s), dev).items()}
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        return tree_util.leaves(params), losses, norms

    start = tree_util.leaves(model.init(seed=0))
    want, losses, norms = run(None)
    names = [p for p, _ in tree_util.paths(model.param_shapes())]
    gap, per_leaf = _update_gap(got, want, start)
    worst = sorted(per_leaf, key=per_leaf.get)[::-1][:3]
    own = run(half)[0]
    rec = {"gap": gap, "worst": [(names[i], per_leaf[i]) for i in worst],
           "unchanged_gap": _update_gap(start, want, start)[0],
           "own_rows_gap": _update_gap(own, want, start)[0],
           "one_process_losses": losses, "one_process_grad_norms": norms}
    del own, want, start
    return rec


def shard_rank(rank, world, out, qwen_argv, dev_type="cuda", reduced=False) -> None:
    """One rank of ``[shard]`` (spawned by ``repro_torch.parallel.spawn``):
    the collectives probe, the full-width qwen steps, the MoE check; each
    rank writes its record to ``out``.  ``dev_type="cpu"`` and ``reduced``
    rehearse it on the CPU."""
    import statistics

    import torch.distributed as dist

    from repro_torch import tree as tree_util
    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.mesh import MeshShape, make_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.step import build_sharded_train_step, probe_collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0) if dev_type == "cuda" else torch.device(dev_type)
    rec = {"rank": rank, "probe": probe_collectives(dev)}
    mesh = make_mesh(MeshShape((2, 1), ("data", "model")), dev_type)
    steps, batch, seq = (int(qwen_argv[qwen_argv.index(f) + 1])
                         for f in ("--steps", "--batch", "--seq"))
    lr = float(qwen_argv[qwen_argv.index("--lr") + 1])
    cfg = get_arch("qwen1.5-0.5b")
    cfg = cfg.reduced() if reduced else cfg
    model = Model(cfg, device=dev)
    step = build_sharded_train_step(model, AdamWConfig(lr=lr), mesh, "tp_fsdp", steps, 20)
    params = model.init(seed=0)
    state = step.shard_state({"params": params, "opt": adamw_init(params)})
    del params
    rec["local_gb"] = sum(t.to_local().numel() * 4 for part in (
        state["params"], state["opt"]["m"], state["opt"]["v"])
        for t in tree_util.leaves(part)) / 1e9
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0))
    _free(dev)
    _reset_peak(dev)
    losses, norms, times = [], [], []
    for s in range(SHARD_STEPS):
        _sync(dev)
        t0 = time.perf_counter()
        p, o, m = step(state["params"], state["opt"], ds.batch_at(s))
        losses.append(float(m["loss"]))  # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(m["grad_norm"]))
        state = {"params": p, "opt": o}
    rec.update(losses=losses, grad_norms=norms, step_ms=times,
               median_ms=statistics.median(times), peak_gb=_peak_gb(dev))
    got = [step.gather(t) for t in tree_util.leaves(state["params"])]
    del state, p, o, step
    _free(dev)
    if rank == 0:
        rec["update"] = _shard_update_check(model, dev, ds, lr, steps, got, batch // 2)
    del got, model
    _free(dev)
    dist.barrier()

    # the MoE check: the one-process card steps, then the sharded ones
    mcfg, mmodel, start, batches, one_step = _moe_shard_setup(dev)
    want, st = [], start
    for b in batches:
        with torch.no_grad():
            aux = float(mmodel.loss(st["params"], b)[1]["aux"])
        p, o, m = one_step(st["params"], st["opt"], b)
        want.append((float(m["loss"]), aux))
        st = {"params": p, "opt": o}
    ref_leaves = [tree_util.leaves(st["params"]), tree_util.leaves(st["opt"]["m"]),
                  tree_util.leaves(st["opt"]["v"])]
    mstep = build_sharded_train_step(mmodel, AdamWConfig(lr=1e-3), mesh, "tp_fsdp", 8, 1)
    sst = mstep.shard_state(start)
    got = []
    for b in batches:
        p, o, m = mstep(sst["params"], sst["opt"], {"tokens": b["tokens"].cpu()})
        got.append((float(m["loss"]), float(m["aux"])))
        sst = {"params": p, "opt": o}
    full = mstep.full_state(sst)
    errs = []
    for mine, ref in zip([tree_util.leaves(full["params"]), tree_util.leaves(full["opt"]["m"]),
                          tree_util.leaves(full["opt"]["v"])], ref_leaves):
        errs += [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                 for a, b in zip(mine, ref)]
    rec["moe"] = {"losses": [g[0] for g in got], "one_process_losses": [w[0] for w in want],
                  "aux": [g[1] for g in got], "max_leaf_rel": max(errs),
                  "one_process_aux": [a for _, a in want]}
    with open(os.path.join(out, f"shard_{rank}.json"), "w") as f:
        json.dump(rec, f)


def shard_phase(dev, train_out: dict, reduced: bool = False) -> None:
    """Phase ``[shard]``: two ranks on ``dev`` (see ``shard_rank``); the
    probe, the losses against ``[train]``'s, each rank's peak memory and
    step times, the MoE check.  Raises on any gap past its bound."""
    import tempfile

    from repro_torch.parallel.spawn import spawn

    _free(dev)
    out = tempfile.mkdtemp(prefix="shard_")
    try:
        spawn(shard_rank, 2, out, QWEN_TRAIN, dev.type, reduced, store_dir=out)
        recs = []
        for r in range(2):
            with open(os.path.join(out, f"shard_{r}.json")) as f:
                recs.append(json.load(f))
    finally:
        import shutil

        shutil.rmtree(out, ignore_errors=True)
    where = torch.cuda.get_device_name(0) if dev.type == "cuda" else dev.type
    log(f"[shard] gloo on {dev.type} tensors of {where}: {recs[0]['probe']}")
    want = train_out["losses"][:SHARD_STEPS]
    got = recs[0]["losses"]
    gaps = [abs(a - b) for a, b in zip(got, want)]
    log(f"[shard] qwen1.5-0.5b full width, mesh data 2 x model 1 (tp_fsdp), batch "
        f"{QWEN_TRAIN[QWEN_TRAIN.index('--batch') + 1]} x {QWEN_TRAIN[QWEN_TRAIN.index('--seq') + 1]}"
        f": losses {got} against [train]'s {want}: largest gap {max(gaps):.3e} "
        f"(bound {SHARD_TOL})")
    for rec in recs:
        log(f"[shard] rank {rec['rank']}: step ms {[round(t, 1) for t in rec['step_ms']]} "
            f"(median {rec['median_ms']:.1f}); peak device memory {rec['peak_gb']:.2f} GB "
            f"(max_memory_allocated over the steps; [train]'s one process: "
            f"{train_out['peak_gb']:.2f} GB); params + m + v held {rec['local_gb']:.2f} GB")
    upd = recs[0]["update"]
    ngap = max(abs(a - b) / b for a, b in zip(recs[0]["grad_norms"],
                                              upd["one_process_grad_norms"]))
    log(f"[shard] update after {SHARD_STEPS} steps against a one-process run of them on rank "
        f"0: gap {upd['gap']:.3e} of the one-process update over every leaf (bound "
        f"{SHARD_UPDATE_TOL}), the three largest of one leaf "
        f"{', '.join(f'{n} {g:.3e}' for n, g in upd['worst'])} (bound "
        f"{SHARD_LEAF_TOL}); controls: state unchanged {upd['unchanged_gap']:.3e}, "
        f"rank 0's rows alone {upd['own_rows_gap']:.3e}; grad norms {recs[0]['grad_norms']} "
        f"against the one-process {upd['one_process_grad_norms']} (largest relative gap "
        f"{ngap:.3e}); the one-process losses {upd['one_process_losses']}")
    assert recs[0]["losses"] == recs[1]["losses"], "the ranks disagree on the loss"
    assert max(gaps) <= SHARD_TOL, (got, want)
    assert upd["gap"] <= SHARD_UPDATE_TOL and upd["worst"][0][1] <= SHARD_LEAF_TOL, upd
    assert min(upd["unchanged_gap"], upd["own_rows_gap"]) > SHARD_UPDATE_TOL, upd
    moe = recs[0]["moe"]
    lgap = max(abs(a - b) for a, b in zip(moe["losses"], moe["one_process_losses"]))
    agap = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(moe["aux"], moe["one_process_aux"]))
    log(f"[shard moe] reduced float32 qwen3-moe-30b-a3b, {SHARD_MOE_STEPS} steps on data 2 x "
        f"model 1 against the one-process card steps: losses {moe['losses']} vs "
        f"{moe['one_process_losses']} (gap {lgap:.3e}), aux gap {agap:.3e}, largest updated "
        f"leaf gap {moe['max_leaf_rel']:.3e} of its largest magnitude")
    assert lgap < 1e-5 and agap <= 1e-6 and moe["max_leaf_rel"] <= 1e-5, moe


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _free(dev) -> None:
    """Drop what the last engine held (its prepared weight caches)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible (torch.cuda.is_available() is False)")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import _build
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 references stay float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # phase 1: the device and the build
    start = time.perf_counter()

    def elapsed(phase: str) -> None:  # where the run's time limit goes
        log(f"[elapsed] {phase}: {time.perf_counter() - start:.1f} s since the start")

    smi = card_line()
    log(smi)
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] nvcc for {len(_build.build_seconds)} libraries in parallel: "
        f"{time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in _build.build_seconds.items()) + ")")
    for name, text in _build.build_logs.items():  # one line per kernel: registers, spills
        entry = spill = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "spill stores" in line:
                spill = line.strip()
            elif "registers" in line:
                log(f"[ptxas {name}] {entry}: {line.split(':', 1)[-1].strip()}; {spill}")
            elif "wgmma" in line or "warning" in line.lower():
                log(f"[ptxas {name}] {line.strip()}")

    log_tiles()
    rates = probe_routes(dev, smi)
    g = torch.Generator(device=dev).manual_seed(1234)
    check_kernels(dev, g)
    check_int8_pool(dev, g)
    check_paged_prefill(dev, g)
    check_prefill_padding(dev, g)
    check_dense(dev, g)
    check_wide_attention(dev, g)
    check_rglru(dev, g)
    check_stochastic(dev, g)
    elapsed("build, probe and kernel checks")
    kernels = {**time_kernels(dev, g), **time_int8_pool(dev, g), **time_dense(dev, g),
               **time_stochastic(dev, g, rates=rates), **time_rglru(dev, g),
               **time_wide_attention(dev, g), **time_rg_paged_decode(dev, g),
               **time_int8_gemms(dev, g, "int8_gemm_rg", RG_DECODE_GEMMS, RG_PREFILL_GEMMS),
               **time_moe_kernels(dev, g)}
    elapsed("kernel timings, all but llama-3.2-vision's and musicgen's")
    kernels.update(time_vlm_mg_kernels(dev, g))
    elapsed("kernel timings")

    cfg = get_arch("stablelm-1.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab,
            cfg.dtype) == (24, 2048, 32, 64, 5632, 100352, "bfloat16")
    cfg = dataclasses.replace(cfg, n_layers=SL_LAYERS)  # published widths, depth cut
    params = Model(cfg, device=dev).init(seed=0)
    prompts = make_prompts(cfg.vocab, np.random.default_rng(0))
    summary = {}
    launches, tokens = serve(cfg, params, prompts, dev, plain_runs("exact", "int8"), gen=32,
                             summary=summary)
    chunked_launches, chunked_tokens = serve(cfg, params, prompts, dev,
                                             [("exact-chunked", "exact", "none")], gen=32,
                                             chunk_tokens=256, summary=summary)
    launches.update(chunked_launches)
    chunked_beside_blocking(summary, "exact-chunked", "exact", {**tokens, **chunked_tokens})
    log_astra(cfg, summary, "exact")
    elapsed("exact-chunked")
    profile_decode_chunk(cfg, params, prompts, dev, plain_runs("exact", "int8"))
    # the dense per-slot layout: flash prefill, dense decode
    dense_runs = [("exact-dense", "exact", "none"), ("int8-dense", "int8", "none")]
    dense_launches, dense_tokens = serve(cfg, params, prompts, dev, dense_runs, gen=32,
                                         kv_block_size=0)
    launches.update(dense_launches)
    for label, toks in dense_tokens.items():
        agree = (toks == tokens["exact"]).mean()
        log(f"[agreement {label}] greedy tokens equal to the paged exact run: {agree:.1%} "
            "(reported, not gated: random weights at bf16)")
    profile_decode_chunk(cfg, params, prompts, dev, dense_runs, kv_block_size=0)
    # chunked prefill on dense caches: the sc runs' 4 prompts, blocking and
    # chunked at a budget of 64 tokens a round
    sc_prompts = make_sc_prompts(cfg.vocab, np.random.default_rng(1))
    short_launches, short_tokens = {}, {}
    for label, budget in (("exact-dense-short", 0), ("exact-dense-chunked", 64)):
        counts, toks = serve(cfg, params, sc_prompts, dev, [(label, "exact", "none")], gen=16,
                             kv_block_size=0, chunk_tokens=budget, summary=summary)
        short_launches.update(counts)
        short_tokens.update(toks)
    launches.update(short_launches)
    chunked_beside_blocking(summary, "exact-dense-chunked", "exact-dense-short", short_tokens)
    elapsed("exact-dense-chunked")
    flash_vs_naive(cfg, params, prompts, dev)
    # calibrated static scales: the int8 plan and exact's KV on an int8 pool
    plan = calibrate(cfg, params, prompts, dev)
    kvq_runs = [("int8-kvq", plan, "int8"),
                ("exact-kvq", dataclasses.replace(ExecutionPlan.from_spec("exact"),
                                                  kv_scales=plan.kv_scales), "int8")]
    kvq_launches, kvq_tokens = serve(cfg, params, prompts, dev, kvq_runs, gen=32)
    launches.update(kvq_launches)
    for label, toks in kvq_tokens.items():
        agree = (toks == tokens["exact"]).mean()
        log(f"[agreement {label}] greedy tokens equal to the bf16-pool exact run: {agree:.1%} "
            "(reported, not gated: random weights at bf16)")
    profile_decode_chunk(cfg, params, prompts, dev, kvq_runs)
    launches.update(serve(cfg, params, sc_prompts, dev, plain_runs("sc", "mixed"), gen=16)[0])
    profile_decode_chunk(cfg, params, sc_prompts, dev, plain_runs("sc", "mixed"))
    _free(dev)
    launches.update(serve_traffic(cfg, params, dev))
    elapsed("traffic")
    traffic_faults(cfg, params, dev)
    del params
    _free(dev)  # the sc weight caches go before recurrentgemma's weights come
    elapsed("stablelm-1.6b serving")
    rg = get_arch("recurrentgemma-2b")
    assert (rg.n_layers, rg.d_model, rg.n_heads, rg.n_kv_heads, rg.head_dim, rg.d_rnn,
            rg.window, rg.vocab, rg.dtype) == (26, RG_D, RG_H, 1, RG_HD, RG_D, RG_WINDOW,
                                               256000, "bfloat16")
    assert rg.layer_kinds.count("rglru") == 18 and rg.layer_kinds.count("local") == 8
    rg_launches = serve_rg(rg, dev, kernels["rglru_scan"]["ms"], summary)
    elapsed("recurrentgemma-2b serving")
    gm = get_arch("granite-moe-1b-a400m")
    assert (gm.n_layers, gm.d_model, gm.n_heads, gm.n_kv_heads, gm.head_dim, gm.vocab,
            gm.dtype, gm.tie_embeddings) == (24, GM_D, GM_H, GM_KVH, HD, GM_V, "bfloat16", True)
    assert (gm.moe.n_experts, gm.moe.top_k, gm.moe.d_expert, gm.act) == (GM_E, GM_K, GM_F,
                                                                         "swiglu")
    moe_launches = serve_moe(gm, dev, summary)
    elapsed("granite-moe-1b-a400m serving")
    xl = get_arch("xlstm-125m")
    assert (xl.n_layers, xl.d_model, xl.n_heads, xl.vocab, xl.dtype, xl.block_pattern) == (
        12, XL_D, XL_H, XL_V, "bfloat16", ("mlstm", "mlstm", "mlstm", "slstm"))
    serve_xlstm(xl, dev, summary)
    elapsed("xlstm-125m serving")
    ll = dataclasses.replace(get_arch("llama-3.2-vision-90b"), n_layers=LL_LAYERS)
    assert (ll.d_model, ll.n_heads, ll.n_kv_heads, ll.head_dim, ll.d_ff, ll.vocab,
            ll.vision_tokens, ll.dtype) == (LL_D, LL_H, LL_KVH, LL_HD, LL_F, LL_V, LL_T,
                                            "bfloat16")
    assert ll.layer_kinds == ("attn",) * 4 + ("xattn",)
    vlm_launches = serve_vlm(ll, dev, summary)
    elapsed("llama-3.2-vision-90b serving")
    mg = get_arch("musicgen-large")
    assert (mg.n_layers, mg.d_model, mg.n_heads, mg.n_kv_heads, mg.head_dim, mg.d_ff, mg.vocab,
            mg.n_codebooks, mg.norm, mg.act, mg.dtype) == (48, MG_D, MG_H, MG_H, MG_HD, MG_F,
                                                           MG_V, MG_C, "layernorm", "gelu",
                                                           "bfloat16")
    mg_launches = serve_mg(mg, dev, summary)
    elapsed("musicgen-large serving")
    log("[decode beside stablelm] decode tok/s in this call: "
        + ", ".join(f"{k} {summary[k]['decode_tps']:.1f} (TTFT {summary[k]['ttft_ms']:.1f} ms)"
                    for k in ("exact", "vlm-exact", "vlm-exact-dense", "mg-exact")))
    small_card_vs_cpu(dev)
    small_rg_card_vs_cpu(dev)
    small_rg_paged_card_vs_cpu(dev)
    small_moe_card_vs_cpu(dev)
    small_xlstm_card_vs_cpu(dev)
    elapsed("card against CPU, all but llama-3.2-vision and musicgen")
    small_vlm_mg_card_vs_cpu(dev)
    elapsed("card against CPU")

    # training: qwen through the driver, the scan's gradient, MoE, card vs CPU
    qwen = get_arch("qwen1.5-0.5b")
    assert (qwen.n_layers, qwen.d_model, qwen.n_heads, qwen.head_dim, qwen.d_ff, qwen.vocab,
            qwen.tie_embeddings, qwen.dtype) == (24, 1024, 16, 64, 2816, 151936, True,
                                                 "bfloat16")
    train_out = train_qwen(qwen, dev, QWEN_TRAIN)
    elapsed("train")
    rg_train = dataclasses.replace(rg, n_layers=len(rg.block_pattern), dtype="float32")
    assert (rg_train.layer_kinds, rg_train.n_pattern_units) == (("rglru", "rglru", "local"), 1)
    rg_launches["train"] = train_rglru(rg_train, dev)["counts"]
    elapsed("train rglru")
    train_moe(gm, dev)
    elapsed("train moe")
    train_card_vs_cpu(dev)
    train_guard(dev)
    elapsed("train card vs CPU")
    shard_phase(dev, train_out)
    elapsed("shard")

    # launches: summed over the serving runs of the row's model (the rows
    # at recurrentgemma's shapes over its runs and its training step,
    # ``train``, whose scan launches at S 256 fall in the rglru_scan row; those at granite's,
    # llama-3.2-vision's and musicgen's over theirs, the others over the
    # stablelm runs) and over the row's wrappers (the binary stochastic GEMM's two
    # entries, counted by kernel); launches_by_plan: each run's own
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_plan",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    def count(c, w):  # a length's key exists once a run launched the scan at it
        return c.get(w, 0) if w.startswith("rglru_scan_s") else c[w]

    for name, rec in kernels.items():
        wrappers = rec.get("wrapper", name)
        wrappers = (wrappers,) if isinstance(wrappers, str) else wrappers
        runs = (rg_launches if name in RG_ROWS else moe_launches if name in MOE_ROWS
                else vlm_launches if name in VLM_ROWS else mg_launches if name in MG_ROWS
                else launches)
        rec["launches_by_plan"] = {label: sum(count(c, w) for w in wrappers)
                                   for label, c in runs.items()}
        rec["launches"] = sum(rec["launches_by_plan"].values())
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
