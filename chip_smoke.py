"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

  python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``src/`` (one ``nvcc``
per library, all started together), holds each kernel against its plain
PyTorch version at the shapes the serving path gives it (the integer
kernels bit for bit), times it beside its bound, then serves full-width
stablelm-1.6b (random weights from a seed) through
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
rings), checking that every request gets its tokens, the logits are
finite, the prefix cache hits where it may, and that each serving run
itself launched every kernel of its plan's path and no kernel of the
other layout.  Reduced float32 models of both families are served on the
card and on the CPU, and their greedy tokens compared.  One int8
product runs on ``wgmma`` with TMA-fed tiles at admission and on a
weight-streaming kernel at decode: both are held bit for bit at every
serving shape and at each kernel's edges, each model's decode step and
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

import ctypes
import dataclasses
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
    queries, at every head dim and block size ``PAGED_BLOCKS``: G 1, 4
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
            for grp in (1, 4, 10):  # 10: the 16-row tile
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
        log(f"[paged decode] {name} hd={hd}: {n} cases (BS {PAGED_BLOCKS}, G 1/4/10, softcap "
            f"0/30, kv_len 0 / 1 / BS / BS + 1 / W * BS, scratch-block entries, "
            f"{decode_splits(dev, 5, 8, 88)} splits at BS 8): max|kernel-plain| {worst:.2e} "
            f"<= {tol}")


def check_kernels(dev, g) -> None:
    """Phases 2-4: every kernel against its plain version on the card."""
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        _check_paged_decode(dev, g, dtype, dtype, tol)
    for m, k, n in [*DECODE_GEMMS, *PREFILL_GEMMS, *RG_DECODE_GEMMS, *RG_PREFILL_GEMMS,
                    *INT8_EDGES]:
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w_t = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        plan = i8.int8_gemm_plan(m, n, k, n_sm(dev))
        before = dict(i8.int8_gemm.paths)
        assert torch.equal(i8.int8_gemm(x, w_t), int8_matmul_acc_ref(x, w_t)), (m, k, n)
        moved = {p for p, c in i8.int8_gemm.paths.items() if c != before[p]}
        assert moved == ({plan.path} if dev.type == "cuda" else set()), (m, k, n, plan, moved)
        log(f"[int8 gemm] M={m} K={k} N={n} ({plan.path}, grid {plan.grid}, {plan.splits} K "
            "splits): int32 accumulators equal the plain version bit for bit")


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
    ``INT8_POOL_TOL``, bf16 within ``BF16_TOL``) and head dim, G 1, 4 and
    10, block sizes ``PAGED_BLOCKS``, suffix lengths ``PREFILL_LENS``,
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
                for grp in (1, 4, 10):
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
            log(f"[paged prefill] {name} pool hd={hd}: {n} cases (BS {PAGED_BLOCKS}, G 1/4/10, "
                f"S {PREFILL_LENS}, softcap 0/30, starts 0 / mid-block / block edge / past it "
                f"/ 2 blocks): max|kernel-plain| {worst:.2e} <= {tol}")


def check_dense(dev, g) -> None:
    """Flash attention and dense decode against their plain versions at
    reduced shapes: flash at head dims 16 and 64, G = 1, 2, 4, causal with
    window 0 and 24, softcap 0 and 30, Sq = Sk not a multiple of the 64-row
    or 32/64-key tiles (and one non-causal case over 128 keys); dense decode
    over S = 100 positions (not a multiple of the 64-key chunk) with
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
            for grp in (1, 2, 4):
                for window in (0, 24):
                    for softcap in (0.0, 30.0):
                        kvh, s = 3, (37 if grp == 4 else 100)
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
        log(f"[flash] {name} {n} cases (hd 16/64/128/256, G 1/2/4, causal window 0/24, softcap "
            f"0/30, S 37/100; non-causal Sk 128): max|kernel-plain| {worst:.2e}, "
            f"{share:.3f} of the allowance")
        worst, share = 0.0, 0.0
        for hd in HEAD_DIMS_ALL:
            for grp in (1, 4, 10):
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
        log(f"[dense decode] {name} hd 16/64/128/256, G 1/4/10, softcap 0/30, S=100, kv_len "
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
           "dense_attention_decode_hd256", "int8_gemm_rg", "int8_gemm_rg_admission")


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
}
# kernels a plan's serving path must not launch: mixed's qk/pv (K % 16 ==
# 0, K <= 4096 at every length it serves) never reach mma.sync; a dense
# chunked run takes no full-sequence pass
PLAN_ABSENT = {"mixed": ("int8_gemm_batched_mma",),
               "exact-dense-chunked": ("flash_attention", "rglru_scan"),
               "rg-exact-short": ("flash_attention", "rglru_scan"),
               "rg-exact-chunked": ("flash_attention", "rglru_scan")}
# kernels of one KV layout, which a serving run on the other must not launch
LAYOUT_KERNELS = {
    "paged": ("paged_attention_decode", "paged_attention_prefill",
              "paged_attention_decode_int8", "paged_attention_prefill_int8"),
    "dense": ("flash_attention", "dense_attention_decode"),
}


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
            stray = [k for k in LAYOUT_KERNELS["paged" if dense else "dense"] if counts[k]]
            assert not stray, (label, "kernels of the other KV layout launched", stray, counts)
        if dense:
            assert kv == {} and ps == {}, (label, kv, ps)
            for state, kind in zip(engine._states["layers"], cfg.layer_kinds):
                if kind == "rglru":
                    assert isinstance(state, RGLRUState), label
                    assert state.h.shape == (8, cfg.d_rnn), label
                else:
                    ring = min(max_len, cfg.window) if kind == "local" else max_len
                    shape = (8, cfg.n_kv_heads, ring, cfg.head_dim)
                    assert isinstance(state, KVCache) and tuple(state.k.shape) == shape, label
            kv_line = "dense " + dense_state_summary(engine._states, cfg)
        else:
            if plan == "exact" or kv_quant != "none":  # exact or static calibrated scales
                assert kv["prefix_cache"] and ps["hits"] > 0, (label, ps)
            else:
                assert not kv["prefix_cache"]  # dynamic scales: reuse gated off
            item = 1 if kv_quant == "int8" else (2 if cfg.dtype == "bfloat16" else 4)
            assert kv["kv_quant"] == kv_quant
            assert kv["bytes_per_block"] == (cfg.n_layers * 2 * cfg.n_kv_heads * BS
                                             * cfg.head_dim * item)
            kv_line = (f"kv pool {kv_quant} {kv['bytes_per_block']} B/block, "
                       f"{kv['pool_bytes']} B; prefix {ps or 'off'}")
        sched = engine.scheduler_stats
        if chunk_tokens:
            assert sched["active"] and sched["prefill_chunks"] > len(prompts), (label, sched)
        ttft = np.mean([o.timing.ttft_s for o in outs]) * 1e3
        if summary is not None:
            summary[label] = dict(ttft_ms=ttft, prefill_tps=st["prefill_tokens"] / st["prefill_s"],
                                  decode_tps=st["decode_tokens"] / st["decode_s"], sched=sched,
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
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
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
    (``rg-exact-chunked``), 16 new each, max_len 512.  Returns each run's
    launches."""
    from repro_torch.models.model import Model

    n_rglru = cfg.layer_kinds.count("rglru")
    params = Model(cfg, device=dev).init(seed=0)
    prompts = make_rg_prompts(cfg.vocab, np.random.default_rng(2))
    model = _serving_model(cfg, dev, "exact")
    probe = torch.as_tensor(prompts[8][None, :64], device=dev)
    logits, _ = model.prefill(model.prepare(params), {"tokens": probe}, max_len=cfg.window)
    assert logits.shape == (*probe.shape, cfg.vocab) and torch.isfinite(logits).all()
    del model, logits
    # the int8 path at full width: the same prefill through the GEMM kernel
    # and through its plain version in its place, logits equal bit for bit
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref

    model = _serving_model(cfg, dev, "int8")
    prepared = model.prepare(params)
    got, _ = model.prefill(prepared, {"tokens": probe}, max_len=cfg.window)
    kernel, i8.int8_gemm = i8.int8_gemm, int8_matmul_acc_ref
    try:
        want, _ = model.prefill(prepared, {"tokens": probe}, max_len=cfg.window)
    finally:
        i8.int8_gemm = kernel
    assert torch.isfinite(got).all() and torch.equal(got, want), \
        (got.float() - want.float()).abs().max().item()
    log(f"[rg-int8 prefill] recurrentgemma-2b {probe.shape[-1]} tokens under int8: logits "
        "through the int8 GEMM kernel equal those through its plain version bit for bit")
    del model, prepared, got, want
    _free(dev)
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
    del params
    _free(dev)
    return launches


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
    check_dense(dev, g)
    check_wide_attention(dev, g)
    check_rglru(dev, g)
    check_stochastic(dev, g)
    elapsed("build, probe and kernel checks")
    kernels = {**time_kernels(dev, g), **time_int8_pool(dev, g), **time_dense(dev, g),
               **time_stochastic(dev, g, rates=rates), **time_rglru(dev, g),
               **time_wide_attention(dev, g),
               **time_int8_gemms(dev, g, "int8_gemm_rg", RG_DECODE_GEMMS, RG_PREFILL_GEMMS)}
    elapsed("kernel timings")

    cfg = get_arch("stablelm-1.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab,
            cfg.dtype) == (24, 2048, 32, 64, 5632, 100352, "bfloat16")
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
    small_card_vs_cpu(dev)
    small_rg_card_vs_cpu(dev)
    elapsed("card against CPU")

    # launches: summed over the serving runs of the row's model (the rows
    # at recurrentgemma's shapes over rg-exact and rg-int8, the others over
    # the eight stablelm runs) and over the row's wrappers (the binary
    # stochastic GEMM's two entries, counted by kernel); launches_by_plan:
    # each run's own
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_plan",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    def count(c, w):  # a length's key exists once a run launched the scan at it
        return c.get(w, 0) if w.startswith("rglru_scan_s") else c[w]

    for name, rec in kernels.items():
        wrappers = rec.get("wrapper", name)
        wrappers = (wrappers,) if isinstance(wrappers, str) else wrappers
        runs = rg_launches if name in RG_ROWS else launches
        rec["launches_by_plan"] = {label: sum(count(c, w) for w in wrappers)
                                   for label, c in runs.items()}
        rec["launches"] = sum(rec["launches_by_plan"].values())
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
