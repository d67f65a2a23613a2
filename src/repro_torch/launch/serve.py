"""Serving CLI over the port's engine.

Admits a batch of requests (uniform or mixed prompt lengths, random
tokens from ``--seed``) into ``ServeEngine`` on the paged KV pool and
reports measured decode tok/s, mean TTFT, the pool and prefix-cache
counters, and how many times each hand-written kernel launched.  Weights
are random (``init_params`` from ``--seed``).  Runs on the card unless
``--device cpu``; ``--attn-impl flash`` (the default) routes attention
through the paged-attention kernel.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
      --mode int8 --batch 12 --prompt-mix 96,256,384 --gen 32 --max-slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu --gen 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.plan import PRESET_PLANS, ExecutionPlan
from repro_torch.core.astra_layer import MODES
from repro_torch.kernels import _build, launch_counts, reset_launches
from repro_torch.models.model import Model
from repro_torch.models.transformer import ModelOptions
from repro_torch.serve import SamplerConfig, ServeConfig, ServeEngine


def prompt_lengths(args) -> list:
    if args.prompt_mix:
        mix = [int(x) for x in args.prompt_mix.split(",")]
        return [mix[i % len(mix)] for i in range(args.batch)]
    return [args.prompt_len] * args.batch


def make_prompts(cfg, lengths, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,), dtype=np.int32) for n in lengths]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--prompt-mix", default="",
                    help="comma list of prompt lengths cycled over the batch")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mode", default="int8", choices=list(MODES),
                    help="uniform execution mode (shorthand for --plan <mode>)")
    ap.add_argument("--plan", default="",
                    help=f"preset ({', '.join(sorted(PRESET_PLANS))}), uniform mode, "
                         "or JSON glob rules; overrides --mode")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--chunk-steps", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=0, help="0 = one per request")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-pool-blocks", type=int, default=0)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--attn-impl", default="flash", choices=list(ModelOptions.ATTN_IMPLS),
                    help="flash = the paged-attention kernel; naive = plain attention "
                         "over the gathered view")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        plan = ExecutionPlan.from_spec(args.plan or args.mode)
    except (ValueError, TypeError) as e:
        ap.error(f"--plan: {e}")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, ModelOptions(plan=plan, attn_impl=args.attn_impl), device=args.device)
    if model.device.type == "cuda":
        _build.build_all()
    params = model.init(args.seed)
    lengths = prompt_lengths(args)
    prompts = make_prompts(cfg, lengths, args.seed)
    serve_cfg = ServeConfig(
        max_slots=args.max_slots or len(prompts), max_len=max(lengths) + args.gen + 1,
        chunk_steps=args.chunk_steps, sampler=SamplerConfig(args.temperature, args.top_k),
        seed=args.seed, kv_block_size=args.kv_block_size,
        kv_pool_blocks=args.kv_pool_blocks, prefix_cache=not args.no_prefix_cache)
    engine = ServeEngine(model, params, serve_cfg, device=model.device)
    engine.generate_batch(prompts[:1], min(args.gen, 2))  # warm-up, not timed
    reset_launches()
    t0 = time.perf_counter()
    outs = engine.generate_batch(prompts, args.gen)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = max(time.perf_counter() - t0, 1e-9)
    n_tok = sum(o.gen_len for o in outs)
    ttft = np.mean([o.timing.ttft_s for o in outs])
    print(f"[{plan.name or args.plan or args.mode}] {len(outs)} requests (prompt lens "
          f"{sorted(set(lengths))}), {args.gen} new tokens each on {model.device}: "
          f"{n_tok / dt:.1f} tok/s, mean TTFT {ttft * 1e3:.1f} ms")
    kv = engine.kv_stats
    line = (f"  kv pool: {kv['pool_blocks']} blocks x {kv['block_size']} tok "
            f"({kv['bytes_per_block']} B/block, {kv['pool_bytes'] / 1e6:.2f} MB)")
    if not kv["prefix_cache"]:
        line += f"; prefix cache off: {kv['prefix_cache_off_reason']}"
    print(line)
    ps = engine.prefix_stats
    if ps:
        print(f"  prefix cache: {ps['hits']} hits / {ps['misses']} misses, "
              f"{ps['hit_tokens']} prompt tokens reused, {ps['evictions']} evictions")
    print(f"  kernel launches: {launch_counts()}")
    return outs


if __name__ == "__main__":
    main()
