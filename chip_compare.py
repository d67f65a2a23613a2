"""Time two checkouts of this repo on one CUDA card, in turns.

  python3 chip_compare.py PARENT CHANGE [--phases time_stochastic,profile_sc]

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
  checkouts).

Needs one CUDA device; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

PHASES = ("time_stochastic", "profile_sc")
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
    _build.build_all()
    dev = torch.device("cuda", 0)
    for phase in phases.split(","):
        if phase == "time_stochastic":
            cs.time_stochastic(dev, torch.Generator(device=dev).manual_seed(1234))
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
