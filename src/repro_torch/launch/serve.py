"""Serving CLI over the port's engine, and ``generate``, the simple entry point.

Admits a batch of requests (uniform or mixed prompt lengths, random
tokens from ``--seed``) into ``ServeEngine`` on the paged KV pool
(``--kv-block-size`` > 0, 16 by default) or on dense per-slot caches
(``--kv-block-size 0``) and reports measured tok/s, mean TTFT, the pool
and prefix-cache counters, and how many times each hand-written kernel
launched, then each request's modeled cost on the ASTRA photonic chip
(the paper's simulator, not a measurement of the serving device) and the
sites that modeled energy goes to.  Weights are random (``init_params``
from ``--seed``).  Runs on the card unless ``--device cpu``;
``--attn-impl flash`` (the default) routes attention through the kernels
(paged attention, or flash attention and the dense decode kernel on the
dense layout).
``--calibrate`` bakes static
activation and KV scales into the plan from one exact pass over the run's
packed prompts (which turns prefix reuse back on under ``int8``/``mixed``);
``--kv-quant int8`` then stores the pool as int8 blocks.
``--prefill-chunk-tokens N`` admits through the chunked-prefill scheduler
(prompts fed in chunks of a per-round budget of N tokens shared with
decode) and prints its counters; ``--no-degraded-mode`` makes a paged
engine raise where admission would wedge instead of shedding load.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
      --mode int8 --batch 12 --prompt-mix 96,256,384 --gen 32 --max-slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
      --mode sc --batch 4 --prompt-mix 64,160 --gen 16 --max-slots 8
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu --kv-block-size 0
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu --plan mixed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b --reduced \
      --device cpu --kv-block-size 0
  PYTHONPATH=src python -m repro_torch.launch.serve --mode int8 --calibrate --kv-quant int8
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu --mode int8 \
      --calibrate --kv-quant int8
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --prefill-chunk-tokens 8 --prompt-mix 5,12,20 --batch 5 --max-slots 3
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
from repro_torch.serve import (
    GREEDY, SamplerConfig, ServeConfig, ServeEngine, kv_quant_reject_reason,
    make_fused_decode, prefill_full_seq, sample_next_token,
)
from repro_torch.serve.prefill import pack_prompts


def generate(model: Model, params, prompts, gen_len: int, max_len: int,
             sampler: SamplerConfig = GREEDY, gen=None):
    """Uniform-length batch decode on dense per-slot caches: one packed
    prefill, then one fused decode of ``gen_len - 1`` steps.  ``prompts``
    ``[B, S0]``; ``gen`` an optional ``torch.Generator`` for sampling.
    Returns (prompt + generated tokens ``[B, S0 + gen_len]``, decode tok/s
    of the fused decode on the host's clock, ended by a device sync)."""
    dev = model.device
    prompts = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
    b, s0 = prompts.shape
    if gen_len == 0:
        return prompts, 0.0
    params = model.prepare(params)
    lengths = torch.full((b,), s0, dtype=torch.int32, device=dev)
    last_logits, state = prefill_full_seq(model, params, prompts, lengths, max_len)
    first = sample_next_token(last_logits, sampler, gen, model.cfg)
    pieces, tps = [prompts, first], 0.0
    if gen_len > 1:
        pos0 = torch.full((b,), s0, dtype=torch.int64, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        toks, _, _ = make_fused_decode(model)(params, first, state, pos0, gen,
                                               steps=gen_len - 1, sampler=sampler)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # only the steps inside the timed window: the first token came from prefill
        tps = b * (gen_len - 1) / max(time.perf_counter() - t0, 1e-9)
        pieces.append(toks)
    return torch.cat(pieces, dim=-1), tps


def dense_state_summary(states, cfg) -> str:
    """One line on the engine's dense per-slot states: each distinct
    cache shape with its layer count, and the recurrent states."""
    counts: dict = {}
    for st, kind in zip(states["layers"], cfg.layer_kinds):
        if kind == "rglru":
            key = f"RG-LRU states h {tuple(st.h.shape)} + conv {tuple(st.conv.shape)} float32"
        else:
            key = f"K and V {tuple(st.k.shape)} {cfg.dtype}" + (" (ring)" if kind == "local" else "")
        counts[key] = counts.get(key, 0) + 1
    return "; ".join(f"{n} layers x {k}" for k, n in counts.items())


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
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="positions per paged pool block; 0 = dense per-slot caches")
    ap.add_argument("--kv-pool-blocks", type=int, default=0)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--attn-impl", default="flash", choices=list(ModelOptions.ATTN_IMPLS),
                    help="flash = the attention kernels; naive = plain attention")
    ap.add_argument("--calibrate", action="store_true",
                    help="PTQ pass over the packed prompts: static per-site activation "
                         "scales and per-KV-head storage scales")
    ap.add_argument("--kv-quant", default="none", choices=list(ModelOptions.KV_QUANTS),
                    help="int8 = int8 KV pool with the calibrated scales (needs "
                         "--calibrate, or a plan that carries them)")
    ap.add_argument("--prefill-chunk-tokens", type=int, default=0,
                    help="chunked-prefill scheduler token budget per round; 0 = blocking "
                         "full-prompt admission")
    ap.add_argument("--no-degraded-mode", action="store_true",
                    help="disable the pool-pressure ladder: a stalled paged admission "
                         "then raises instead of flushing the prefix cache / shedding load")
    return ap


def check_flags(ap: argparse.ArgumentParser, args) -> None:
    """The reference CLI's refusals of flags that cannot apply."""
    if args.no_degraded_mode and args.kv_block_size == 0:
        ap.error("--no-degraded-mode only applies to the paged KV cache; the dense layout "
                 "has no block pool, hence no pressure ladder to disable")
    if args.prefill_chunk_tokens < 0:
        ap.error(f"--prefill-chunk-tokens: {args.prefill_chunk_tokens} is negative; pass a "
                 "per-round token budget or 0 for blocking full-prompt admission")


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    check_flags(ap, args)
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
    if args.calibrate:
        cal_tokens, _ = pack_prompts(prompts, cfg, device=model.device)
        model = model.calibrate(params, {"tokens": cal_tokens})
        print(f"calibrated {len(model.plan.act_scales)} site activation scales"
              f" + {len(model.plan.kv_scales)} KV storage-site scales")
    if args.kv_quant != "none":
        reason = kv_quant_reject_reason(model, args.kv_block_size)
        if reason is not None:
            ap.error(f"--kv-quant: {reason}")
    serve_cfg = ServeConfig(
        max_slots=args.max_slots or len(prompts), max_len=max(lengths) + args.gen + 1,
        chunk_steps=args.chunk_steps, sampler=SamplerConfig(args.temperature, args.top_k),
        seed=args.seed, kv_block_size=args.kv_block_size,
        kv_pool_blocks=args.kv_pool_blocks, prefix_cache=not args.no_prefix_cache,
        kv_quant=args.kv_quant, prefill_chunk_tokens=args.prefill_chunk_tokens,
        degraded_mode=not args.no_degraded_mode)
    try:
        engine = ServeEngine(model, params, serve_cfg, device=model.device)
    except (NotImplementedError, ValueError) as e:  # a refused configuration
        ap.error(str(e))
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
    if not kv:
        print(f"  kv cache: dense per-slot layout, {dense_state_summary(engine._states, cfg)}")
    else:
        line = (f"  kv pool: {kv['pool_blocks']} blocks x {kv['block_size']} tok, "
                f"{kv['kv_quant']} storage ({kv['bytes_per_block']} B/block, "
                f"{kv['pool_bytes'] / 1e6:.2f} MB)")
        if not kv["prefix_cache"]:
            line += f"; prefix cache off: {kv['prefix_cache_off_reason']}"
        print(line)
    ps = engine.prefix_stats
    if ps:
        print(f"  prefix cache: {ps['hits']} hits / {ps['misses']} misses, "
              f"{ps['hit_tokens']} prompt tokens reused, {ps['evictions']} evictions")
    sched = engine.scheduler_stats
    if sched["active"]:
        print(f"  scheduler: budget {sched['token_budget']} tok/round, "
              f"{sched['prefill_chunks']} prefill chunks / {sched['prefill_tokens']} tokens "
              f"over {sched['rounds']} rounds ({sched['starved_rounds']} decode-saturated)")
    print(f"  kernel launches: {launch_counts()}")
    print_hardware(outs)
    return outs


def print_hardware(outs) -> None:
    """Each request's modeled ASTRA cost and the five sites with the most
    modeled energy over all of them: the photonic chip's, as the paper's
    simulator gives it, not the serving device's."""
    site_energy: dict = {}
    for o in outs:
        hw = o.hardware
        print(f"  req {o.request_id}: prompt {o.prompt.shape[-1]:>4} gen {o.gen_len:>3} | "
              f"modeled ASTRA chip: latency {hw.latency_s * 1e6:.3f} us, energy "
              f"{hw.energy_j * 1e3:.3f} mJ, {hw.energy_per_mac_j * 1e12:.3f} pJ/MAC"
              + (f" ({hw.cached_prompt_tokens} prompt tokens from the prefix cache, "
                 "billed at zero)" if hw.cached_prompt_tokens else ""))
        for site, e in hw.energy_by_site:
            site_energy[site] = site_energy.get(site, 0.0) + e
    top = sorted(site_energy.items(), key=lambda kv: -kv[1])[:5]
    total = sum(site_energy.values()) or 1.0
    print("  modeled ASTRA energy by site (top 5): "
          + ", ".join(f"{s} {e / total * 100:.1f}%" for s, e in top))


if __name__ == "__main__":
    main()
