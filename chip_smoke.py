"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

  python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``src/`` (one ``nvcc``
per library, all started together), holds each kernel against its plain
PyTorch version at the shapes the serving path gives it, times it beside
its bound, then serves full-width stablelm-1.6b (random weights from a
seed) through ``repro_torch.serve.ServeEngine`` on the paged KV pool
under the ``exact`` and ``int8`` plans, checking that every request gets
its tokens, the logits are finite, the prefix cache hits, and that the
serving run itself launched every kernel.  Any failure raises and exits
non-zero.  The line before the last is a JSON object with one entry per
kernel; the last line is the device record.  Needs one CUDA device and
the sources of this checkout; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12  # H100 SXM: HBM3 bandwidth
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks, per second
D, F, V = 2048, 5632, 100352  # stablelm-1.6b d_model, d_ff, vocab
BS, HD = 16, 64  # KV block size, head dim
# (M, K, N) of the int8 GEMMs: one decode step at 8 slots (with how many
# of each a step runs: 24 layers x q,k,v,o / up,gate / down, + lm_head),
# and an admission prefill of ~3k suffix tokens (ragged M)
DECODE_GEMMS = {(8, D, D): 24 * 4, (8, D, F): 24 * 2, (8, F, D): 24, (8, D, V): 1}
PREFILL_GEMMS = [(1531, D, D), (3072, D, F), (3072, F, D), (1531, D, V)]
DECODE_FILLS = [130, 170, 230, 290, 330, 370, 400, 410]  # kv_len of 8 slots mid-run
# paged attention against its plain version: float32 1e-4 (same math; the
# kernel takes keys 32-64 at a time and rescales); bf16 2e-2 (the kernel
# rounds p to bf16 before the PV product, as the reference kernel does;
# the plain version keeps p in float32: 2^-8 relative on O(1) outputs)
F32_TOL, BF16_TOL = 1e-4, 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, ops: float, kind: str):
    """The least time the card could take: max(bytes / HBM rate, ops /
    peak rate of the operand type), and which of the two it is."""
    t_b, t_o = n_bytes / HBM_BYTES_S, ops / PEAK_OPS[kind]
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


def check_kernels(dev, g) -> None:
    """Phases 2-4: every kernel against its plain version on the card."""
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref, paged_prefill_ref

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).split(".")[-1]
        for grp in (1, 4):
            for softcap in (0.0, 30.0):
                kvh, w, nb = 8, 5, 48
                kv_len = torch.tensor([0, 1, BS, BS + 1, w * BS], dtype=torch.int32, device=dev)
                table = torch.randint(1, nb, (5, w), generator=g, device=dev, dtype=torch.int32)
                table[1, 0] = 0  # entries at scratch block 0
                table[4, 3] = 0
                q = randn(5, kvh * grp, HD, dtype=dtype)
                kp, vp = randn(nb, kvh, BS, HD, dtype=dtype), randn(nb, kvh, BS, HD, dtype=dtype)
                got = pa.paged_attention_decode(q, kp, vp, table, kv_len, softcap=softcap)
                want = paged_decode_ref(q, kp, vp, table, kv_len, softcap=softcap)
                err = (got.float() - want).abs().max().item()
                assert err <= tol, (name, grp, softcap, err)
                assert not got[0].any(), "kv_len 0 must give zeros"
                log(f"[paged decode] {name} G={grp} softcap={softcap} kv_len "
                    f"{kv_len.tolist()}: max|kernel-plain| {err:.2e} <= {tol}")
        for grp in (1, 4):
            kvh, w, nb, s = 4, 8, 64, 37
            start = torch.tensor([0, 7, BS, BS + 9, 3 * BS], dtype=torch.int32, device=dev)
            table = torch.randint(1, nb, (5, w), generator=g, device=dev, dtype=torch.int32)
            q = randn(5, kvh * grp, s, HD, dtype=dtype)
            kp, vp = randn(nb, kvh, BS, HD, dtype=dtype), randn(nb, kvh, BS, HD, dtype=dtype)
            got = pa.paged_attention_prefill(q, kp, vp, table, start, softcap=0.0)
            want = paged_prefill_ref(q, kp, vp, table, start, softcap=0.0)
            err = (got.float() - want).abs().max().item()
            assert err <= tol, (name, grp, err)
            log(f"[paged prefill] {name} G={grp} S={s} starts {start.tolist()}: "
                f"max|kernel-plain| {err:.2e} <= {tol}")
    for m, k, n in list(DECODE_GEMMS) + PREFILL_GEMMS:
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w_t = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        assert torch.equal(i8.int8_gemm(x, w_t), int8_matmul_acc_ref(x, w_t)), (m, k, n)
        log(f"[int8 gemm] M={m} K={k} N={n}: int32 accumulators equal the plain "
            "version bit for bit")


def time_kernels(dev, g, timer=time_ms) -> dict:
    """Phase 5: each kernel at the serving path's shapes beside its bound,
    and held there against its plain version (bf16 attention within
    ``BF16_TOL``, the int8 GEMM bit for bit)."""
    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref, paged_prefill_ref

    out = {}
    src_pa = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
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
        name="paged_attention_decode", route="cuda", source=src_pa,
        replaces="src/repro/kernels/paged_attention/kernel.py:146", max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[time paged decode] B=8 H=32 hd=64 bf16 kv_len {DECODE_FILLS}: max|kernel-plain| "
        f"{err:.2e} <= {BF16_TOL}; kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms "
        f"{b_ms:.4f} ({b_by}) library_ms none (no single PyTorch call attends through a "
        "block table)")

    s = 384  # 8 cold suffixes of 384 tokens: one admission prefill
    start = torch.zeros(8, dtype=torch.int32, device=dev)
    qs = torch.randn(8, h, s, HD, generator=g, device=dev).bfloat16()
    tbl = table[:, : s // BS].contiguous()
    k_ms = timer(lambda: pa.paged_attention_prefill(qs, kp, vp, tbl, start), reps=5)
    p_ms = timer(lambda: paged_prefill_ref(qs, kp, vp, tbl, start), reps=3)
    err = (pa.paged_attention_prefill(qs, kp, vp, tbl, start).float()
           - paged_prefill_ref(qs, kp, vp, tbl, start)).abs().max().item()
    assert err <= BF16_TOL, ("paged prefill at serving shapes", err)
    pairs =8 * s * (s + 1) // 2  # causal (row, key) pairs per head
    n_bytes = 2 * qs.numel() * 2 + 2 * 8 * s * kvh * HD * 2 + tbl.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * pairs * h * HD, "bf16")
    out["paged_attention_prefill"] = dict(
        name="paged_attention_prefill", route="cuda", source=src_pa,
        replaces="src/repro/kernels/paged_attention/kernel.py:146", max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[time paged prefill] B=8 S=384 H=32 hd=64 bf16 cold: max|kernel-plain| "
        f"{err:.2e} <= {BF16_TOL}; kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms none (no single "
        "PyTorch call attends through a block table)")

    k_ms = p_ms = 0.0
    n_bytes = ops = err = 0
    for (m, k, n), count in DECODE_GEMMS.items():
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w_t = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        diff = i8.int8_gemm(x, w_t).long() - int8_matmul_acc_ref(x, w_t).long()
        err = max(err, diff.abs().max().item())
        t_k = timer(lambda: i8.int8_gemm(x, w_t))
        t_p = timer(lambda: int8_matmul_acc_ref(x, w_t), reps=3)
        k_ms += count * t_k
        p_ms += count * t_p
        n_bytes += count * (m * k + n * k + 4 * m * n)
        ops += count * 2 * m * n * k
        bb, _ = bound_ms(m * k + n * k + 4 * m * n, 2 * m * n * k, "int8")
        log(f"[time int8 gemm] M={m} K={k} N={n} x{count} per step: kernel_ms {t_k:.4f} "
            f"plain_ms {t_p:.4f} bound_ms {bb:.4f} library_ms none (torch._int_mm "
            "takes M > 16 only)")
    assert err == 0, ("int8 gemm at decode shapes", err)
    b_ms, b_by = bound_ms(n_bytes, ops, "int8")
    out["int8_gemm"] = dict(
        name="int8_gemm", route="cuda",
        source="src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu",
        replaces="src/repro/kernels/int8_matmul/kernel.py:38", max_abs_err=float(err),
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[time int8 gemm] all weight GEMMs of one decode step (M=8): kernel_ms {k_ms:.4f} "
        f"plain_ms {p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms none")
    for m, k, n in PREFILL_GEMMS:
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w_t = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        t_k = timer(lambda: i8.int8_gemm(x, w_t), reps=5)
        t_l = timer(lambda: torch._int_mm(x, w_t.t()), reps=5)
        bb, by = bound_ms(m * k + n * k + 4 * m * n, 2 * m * n * k, "int8")
        log(f"[time int8 gemm] prefill M={m} K={k} N={n}: kernel_ms {t_k:.4f} bound_ms "
            f"{bb:.4f} ({by}) library_ms {t_l:.4f} (torch._int_mm); kernel "
            f"{2 * m * n * k / max(t_k, 1e-9) / 1e9:.1f} TOPS")
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


def serve(cfg, params, prompts, dev, gen: int = 32, max_len: int = 512) -> dict:
    """Phase 6: the engine under both plans; returns, for each plan, the
    launches per kernel as counted inside that serving run only."""
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions
    from repro_torch.serve import ServeConfig, ServeEngine

    serve_cfg = ServeConfig(max_slots=8, max_len=max_len, chunk_steps=8, kv_block_size=BS,
                            attn_impl="flash", seed=0)
    by_plan = {}
    for plan in ("exact", "int8"):
        model = Model(cfg, ModelOptions(plan=plan, attn_impl="flash"), device=dev)
        ServeEngine(model, params, serve_cfg, device=dev).generate_batch(prompts[1:2], 2)
        engine = ServeEngine(model, params, serve_cfg, device=dev)  # fresh: no warm prefix
        _sync(dev)
        reset_launches()
        t0 = time.perf_counter()
        outs = engine.generate_batch(prompts, gen)
        _sync(dev)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        assert [o.gen_len for o in outs] == [gen] * len(prompts), [o.gen_len for o in outs]
        assert all(((o.tokens >= 0) & (o.tokens < cfg.vocab)).all() for o in outs)
        ps, st = engine.prefix_stats, engine.phase_stats
        if dev.type == "cuda":
            assert counts["paged_attention_decode"] > 0, counts
            assert counts["paged_attention_prefill"] > 0, counts
            assert plan == "exact" or counts["int8_gemm"] > 0, counts
        if plan == "exact":
            assert ps["hits"] > 0, ps
        else:
            assert not engine.kv_stats["prefix_cache"]  # dynamic scales: reuse gated off
        ttft = np.mean([o.timing.ttft_s for o in outs]) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
        log(f"[serve {plan}] {cfg.name} ({cfg.n_layers}L d{cfg.d_model}), "
            f"{len(prompts)} requests x {gen} tokens, 8 slots: decode "
            f"{st['decode_tokens'] / st['decode_s']:.1f} tok/s ({st['decode_tokens']} "
            f"tokens in {st['decode_s']:.3f} s), prefill "
            f"{st['prefill_tokens'] / st['prefill_s']:.1f} tok/s, mean TTFT {ttft:.1f} ms, "
            f"end to end {len(prompts) * gen / wall:.1f} tok/s in {wall:.2f} s; prefix "
            f"{ps or 'off'}; launches {counts}; peak memory {peak:.1f} GiB")
        by_plan[plan] = counts
        del engine
    return by_plan


def profile_decode_chunk(cfg, params, prompts, dev) -> None:
    """Where a decode chunk's time goes: one engine round of 8 decode steps
    at 8 busy slots under ``torch.profiler`` — host time of the round
    against the device time of the kernels it ran (their sum over the
    round; the rest of the round the device is idle)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions
    from repro_torch.serve import ServeConfig, ServeEngine

    serve_cfg = ServeConfig(max_slots=8, max_len=512, chunk_steps=8, kv_block_size=BS,
                            attn_impl="flash")
    for plan in ("exact", "int8"):
        model = Model(cfg, ModelOptions(plan=plan, attn_impl="flash"), device=dev)
        engine = ServeEngine(model, params, serve_cfg, device=dev)
        for p in prompts[:8]:
            engine.submit(p, 32)
        engine.step()  # admission prefill + the first chunk, untraced
        _sync(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()  # a pure decode chunk: 8 steps x 8 slots
            _sync(dev)
            host_ms = (time.perf_counter() - t0) * 1e3
        rows = [(getattr(e, "self_device_time_total", 0.0), e.key, e.count)
                for e in prof.key_averages()]
        dev_ms = sum(r[0] for r in rows) / 1e3
        top = sorted(rows, reverse=True)[:5]
        share = f"{dev_ms / host_ms:.1%}" if dev_ms > 0 else "not measured"
        log(f"[profile {plan}] one decode chunk (8 steps x 8 slots): host {host_ms:.1f} ms "
            f"(profiled), device kernels {dev_ms:.2f} ms, device busy {share}; top: "
            + "; ".join(f"{k[:48]} {t / 1e3:.2f} ms x{c}" for t, k, c in top))
        del engine


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
    their plain versions on the CPU: greedy tokens must agree (all of them
    under exact; under int8 a last-bit difference in an activation can move
    one code, so 90%)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import ModelOptions
    from repro_torch.serve import ServeConfig, ServeEngine

    small = get_arch("stablelm-1.6b").reduced(dtype="float32")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, small.vocab, n, dtype=np.int32) for n in (5, 19, 12, 33, 8)]
    scfg = ServeConfig(max_slots=3, max_len=64, chunk_steps=4, kv_block_size=8)
    params = Model(small, device="cpu").init(seed=3)
    for plan in ("exact", "int8"):
        toks = {}
        for where in ("cpu", dev):
            m = Model(small, ModelOptions(plan=plan, attn_impl="flash"), device=where)
            outs = ServeEngine(m, _to(params, m.device), scfg,
                               device=where).generate_batch(prompts, 10)
            toks[str(where)] = np.stack([o.tokens for o in outs])
        agree = (toks["cpu"] == toks[str(dev)]).mean()
        log(f"[small {plan}] reduced stablelm float32 on {dev} (kernels) vs cpu (plain "
            f"versions): {agree:.0%} of greedy tokens equal")
        assert agree == 1.0 if plan == "exact" else agree >= 0.9, (plan, agree)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible (torch.cuda.is_available() is False)")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 references stay float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # phase 1: the device and the build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] nvcc for {len(_build.build_seconds)} libraries in parallel: "
        f"{time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in _build.build_seconds.items()) + ")")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    g = torch.Generator(device=dev).manual_seed(1234)
    check_kernels(dev, g)
    kernels = time_kernels(dev, g)

    cfg = get_arch("stablelm-1.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab,
            cfg.dtype) == (24, 2048, 32, 64, 5632, 100352, "bfloat16")
    params = Model(cfg, device=dev).init(seed=0)
    prompts = make_prompts(cfg.vocab, np.random.default_rng(0))
    launches = serve(cfg, params, prompts, dev)
    profile_decode_chunk(cfg, params, prompts, dev)
    flash_vs_naive(cfg, params, prompts, dev)
    del params
    torch.cuda.empty_cache()
    small_card_vs_cpu(dev)

    # launches: summed over the two serving runs; launches_by_plan: each run's own
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_plan",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, rec in kernels.items():
        rec["launches_by_plan"] = {plan: c[name] for plan, c in launches.items()}
        rec["launches"] = sum(rec["launches_by_plan"].values())
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
