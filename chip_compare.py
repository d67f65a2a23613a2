"""Time two checkouts of this repo on one CUDA card, in turns.

  python3 chip_compare.py PARENT CHANGE [--phases time_rglru,time_batched,flush]

Runs the named phases of each checkout in a process of its own (both
import packages of the same names) in the order PARENT, CHANGE, CHANGE,
PARENT, so that drift of the card's clocks or of the host falls on both
alike, and prints each run's lines under its label.  Each process builds
its checkout's kernels first (cached under the checkout's ``build/``).

Phases:

* ``time_stochastic``: the checkout's own ``chip_smoke.time_stochastic``
  (the stochastic kernels and the batched int8 entry at the serving
  shapes, each beside its bound; the sc admission pass where the checkout
  times it);
* ``profile_sc``: one decode chunk (8 steps, 8 slots) of full-width
  stablelm-1.6b under the ``sc`` and ``mixed`` plans, random weights from
  seed 0, the 4 requests of ``chip_smoke.make_sc_prompts``, under
  ``torch.profiler``: host ms, device ms, and the device ms and launches of
  the B-to-S encoder, the stochastic GEMM (either library's kernels) and
  the batched int8 GEMM (kernels told apart by name, the same way for both
  checkouts);
* ``time_rglru``: the checkout's own ``chip_smoke.time_rglru`` (the scan at
  one recurrentgemma admission, ``[8, 256, 2560]``, and at a full window,
  ``[8, 2048, 2560]``, each beside its bound);
* ``time_batched``: the checkout's batched int8 entry at ``chip_smoke``'s
  ``QKPV_DECODE`` and ``QKPV_ADMISSION`` shapes, on the kernel its own plan
  picks (held bit for bit against the plain version first), each launch
  and a pass of 24 x qk + pv beside its byte bound;
* ``flush``: the scan at ``chip_smoke.RG_SHAPES``' two serving shapes and
  the batched entry at ``QKPV_ADMISSION``, each beside PyTorch moving the
  same output bytes (``torch.add`` of a and b into h: the scan's 12 bytes
  an element; ``fill_`` of the int32 output), under three flushes of L2
  between launches: ``chip_smoke.time_ms``'s 256 MB write (``dirty``: L2
  left full of lines to write back), a 256 MB read (``clean``), none
  (``warm``: the inputs may stay in L2);
* ``smoke``: the checkout's whole ``chip_smoke.py`` (from the checkout's
  root, which must exit 0) and then its card tests (``pytest --noconftest
  -m gpu tests/test_torch_gpu.py``), each in a process of its own: the
  seconds at which each phase's first line came (``[build]``, the first
  ``[time ...]``, the first serving run, the first recurrentgemma run, the
  first card-against-CPU comparison), every ``[serve ...]``,
  ``[profile ...]`` and ``[elapsed]`` line with its second, each part's
  seconds, and the run's last two lines (the kernels and the device).

Needs one CUDA device; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

PHASES = ("time_stochastic", "profile_sc", "time_rglru", "time_batched", "flush", "smoke")
# chip_smoke.py's phases, by the first line each prints
SMOKE_MARKS = (("kernels built", "[build]"), ("kernel checks done", "[time "),
               ("first stablelm run served", "[serve exact]"),
               ("first recurrentgemma run served", "[serve rg-exact]"),
               ("first card-against-CPU comparison", "[small "))
# kernel name -> the part it is reported under
PARTS = (("bts_encode", lambda k: "bts_encode_kernel" in k),
         ("stochastic GEMM", lambda k: "stoch_matmul_kernel" in k or "stoch_gemm" in k),
         ("batched int8 GEMM", lambda k: "int8_gemm_batched" in k
          or ("int8_gemm_kernel" in k and "true>" in k)))


def profile_sc(cs, dev) -> None:
    """One profiled decode chunk per stochastic plan, reported by part."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_arch("stablelm-1.6b")
    params = Model(cfg, device=dev).init(seed=0)
    prompts = cs.make_sc_prompts(cfg.vocab, np.random.default_rng(1))
    serve_cfg = ServeConfig(max_slots=8, max_len=512, chunk_steps=8, kv_block_size=cs.BS,
                            attn_impl="flash")
    for plan in ("sc", "mixed"):
        engine = ServeEngine(cs._serving_model(cfg, dev, plan), params, serve_cfg, device=dev)
        for p in prompts:
            engine.submit(p, 32)
        engine.step()  # admission prefill + the first chunk, untraced
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()  # a pure decode chunk: 8 steps
            torch.cuda.synchronize(dev)
            host_ms = (time.perf_counter() - t0) * 1e3
        on_dev = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        total = sum(r[0] for r in on_dev) / 1e3
        parts = []
        for name, pick in PARTS:
            rs = [r for r in on_dev if pick(r[1])]
            parts.append(f"{name} {sum(r[0] for r in rs) / 1e3:.3f} ms x{sum(r[2] for r in rs)}")
        print(f"[compare profile {plan}] one decode chunk: host {host_ms:.1f} ms, device "
              f"{total:.2f} ms; " + "; ".join(parts), flush=True)
        del engine
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()


def time_batched(cs, dev) -> None:
    """The batched int8 entry at the mixed plan's decode and admission
    qk/pv shapes, timed with the checkout's ``time_ms``."""
    import torch

    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_acc_ref

    g = torch.Generator(device=dev).manual_seed(7)
    for phase, shapes in (("decode", cs.QKPV_DECODE), ("admission", cs.QKPV_ADMISSION)):
        total = bound = 0.0
        for b, m, k, n in shapes:
            x = torch.randint(-127, 128, (b, m, k), generator=g, device=dev, dtype=torch.int8)
            w_t = torch.randint(-127, 128, (b, n, k), generator=g, device=dev, dtype=torch.int8)
            assert torch.equal(i8.int8_gemm_batched(x, w_t), int8_matmul_acc_ref(x, w_t))
            t = cs.time_ms(lambda: i8.int8_gemm_batched(x, w_t))
            b_ms = (b * (m + n) * k + 4 * b * m * n) / cs.HBM_BYTES_S * 1e3
            total, bound = total + 24 * t, bound + 24 * b_ms
            print(f"[compare batched] {phase} B={b} M={m} K={k} N={n} "
                  f"({i8.int8_batched_plan(m, n, k)}): {t:.4f} ms a launch, bound {b_ms:.4f} "
                  f"(bytes, {b_ms / t:.1%} of it)", flush=True)
        print(f"[compare batched] one mixed {phase} pass (24 x qk + pv): {total:.4f} ms, bound "
              f"{bound:.4f} ({bound / total:.1%} of it)", flush=True)


def flush(cs, dev) -> None:
    """The scan and the batched admission products under three L2 flushes,
    each beside PyTorch moving the same output bytes."""
    import torch

    from repro_torch.kernels.int8_matmul import ops as i8
    from repro_torch.kernels.rglru_scan import ops as rg

    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flushes = (("dirty", buf.zero_), ("clean", lambda: buf.view(torch.float32).sum()),
               ("warm", lambda: None))

    def timed(fn, between, reps=20):
        fn()  # warm-up
        torch.cuda.synchronize(dev)
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda._sleep(1 << 26)  # the host queues every launch before the device starts
        for a, b in events:
            between()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize(dev)
        return sum(a.elapsed_time(b) for a, b in events) / reps

    def report(what, n_bytes, pairs):
        bound = n_bytes / cs.HBM_BYTES_S * 1e3
        for label, between in flushes:
            times = ", ".join(f"{name} {t:.4f} ms ({bound / t:.1%})"
                              for name, t in ((name, timed(fn, between)) for name, fn in pairs))
            print(f"[compare flush] {what}, L2 {label}: {times} of the bound {bound:.4f}",
                  flush=True)

    g = torch.Generator(device=dev).manual_seed(11)
    for b, s, d in cs.RG_SHAPES[1:]:
        a = torch.rand(b, s, d, generator=g, device=dev) * 0.799 + 0.2
        x = torch.randn(b, s, d, generator=g, device=dev)
        h = torch.empty_like(a)
        report(f"rglru_scan B={b} S={s} D={d}", 12 * a.numel(),
               (("kernel", lambda: rg.rglru_scan(a, x)),
                ("torch.add", lambda: torch.add(a, x, out=h))))
        del a, x, h
    for b, m, k, n in cs.QKPV_ADMISSION:
        x = torch.randint(-127, 128, (b, m, k), generator=g, device=dev, dtype=torch.int8)
        w_t = torch.randint(-127, 128, (b, n, k), generator=g, device=dev, dtype=torch.int8)
        c = torch.empty((b, m, n), dtype=torch.int32, device=dev)
        report(f"int8_gemm_batched B={b} M={m} K={k} N={n} "
               f"({i8.int8_batched_plan(m, n, k)})", b * (m + n) * k + 4 * b * m * n,
               (("kernel", lambda: i8.int8_gemm_batched(x, w_t)),
                ("fill_ of the output", lambda: c.fill_(0))))
        del x, w_t, c


def smoke(tree: str) -> None:
    """The checkout's ``chip_smoke.py`` and its card tests, timed by phase."""
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=tree, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    marks, tail = dict(SMOKE_MARKS), []
    for line in proc.stdout:
        at = time.perf_counter() - t0
        tail = (tail + [line.rstrip()])[-40:]
        for name, prefix in list(marks.items()):
            if line.startswith(prefix):
                print(f"[compare smoke] {at:7.1f} s: {name}", flush=True)
                del marks[name]
        if line.startswith(("[serve ", "[elapsed]")):
            print(f"[compare smoke] {at:7.1f} s: {line.rstrip()[:240]}", flush=True)
        elif line.startswith("[profile "):
            print(f"[compare smoke] {at:7.1f} s: {line.rstrip()}", flush=True)
    rc = proc.wait()
    smoke_s = time.perf_counter() - t0
    if rc != 0:
        sys.exit(f"chip_compare: chip_smoke.py at {tree} exited {rc}:\n" + "\n".join(tail))
    print(f"[compare smoke] chip_smoke.py exit 0 in {smoke_s:.1f} s; its last two lines:\n"
          f"{tail[-2]}\n{tail[-1]}", flush=True)
    t1 = time.perf_counter()
    tests = subprocess.run([sys.executable, "-m", "pytest", "-q", "--noconftest", "-m", "gpu",
                            "-p", "no:cacheprovider", "tests/test_torch_gpu.py"], cwd=tree,
                           env=env, capture_output=True, text=True, check=False)
    tests_s = time.perf_counter() - t1
    last = tests.stdout.strip().splitlines()[-1] if tests.stdout.strip() else ""
    if tests.returncode != 0:
        sys.exit(f"chip_compare: card tests at {tree} exited {tests.returncode}:\n"
                 f"{tests.stdout[-4000:]}{tests.stderr[-2000:]}")
    print(f"[compare smoke] card tests: {last} ({tests_s:.1f} s); chip_smoke.py and the card "
          f"tests {smoke_s + tests_s:.1f} s", flush=True)


def child(tree: str, phases: str) -> None:
    """Run ``phases`` of the checkout at ``tree`` in this process."""
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import chip_smoke as cs
    import torch

    from repro_torch.kernels import _build

    assert os.path.dirname(os.path.abspath(cs.__file__)) == os.path.abspath(tree)
    if not torch.cuda.is_available():
        sys.exit("chip_compare: no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    phases = phases.split(",")
    if "smoke" in phases:  # first, so that chip_smoke.py builds the kernels itself
        smoke(os.path.abspath(tree))
    _build.build_all()
    dev = torch.device("cuda", 0)
    for phase in phases:
        if phase == "smoke":
            continue
        if phase == "time_stochastic":
            cs.time_stochastic(dev, torch.Generator(device=dev).manual_seed(1234))
        elif phase == "time_rglru":
            cs.time_rglru(dev, torch.Generator(device=dev).manual_seed(1234))
        elif phase == "time_batched":
            time_batched(cs, dev)
        elif phase == "flush":
            flush(cs, dev)
        else:
            profile_sc(cs, dev)
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.change, args.phases)
    if any(p not in PHASES for p in args.phases.split(",")):
        sys.exit(f"chip_compare: phases are {', '.join(PHASES)}")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for label, tree in (("parent", args.parent), ("change", args.change),
                        ("change", args.change), ("parent", args.parent)):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "-",
                              tree, "--phases", args.phases], capture_output=True, text=True,
                             env=env, check=False)
        for line in run.stdout.splitlines():
            print(f"[{label}] {line}", flush=True)
        if run.returncode != 0:
            sys.exit(f"chip_compare: {label} at {tree} failed ({run.returncode}):\n"
                     f"{run.stderr[-4000:]}")
        print(f"[{label}] done in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
