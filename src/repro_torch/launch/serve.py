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
recurrentgemma serves on either layout: on the paged pool its local rings
live in the blocks and its RG-LRU states stay by slot (prefix cache off,
blocking admission).  granite-moe-1b-a400m (MoE MLPs, pure global
attention) serves like the dense decoders, prefix reuse included;
xlstm-125m (mLSTM and sLSTM blocks, no attention layer) has no KV to pool
and serves on its dense per-slot recurrent states whatever
``--kv-block-size`` says.  llama-3.2-vision-90b (cross-attention every
fifth layer) serves text-only, as the reference's engine does: admission
is the masked scan against zeroed cross caches of ``vision_tokens``
positions, kept dense by slot (on the pool too, where the prefix cache
is then off and admission blocking).  musicgen-large takes ``[4, n]``
codebook grids (random, from ``--seed``) and gives ``[4, gen]`` tokens.

``--traffic-trace`` (a trace JSON, or an inline spec such as
``mixed:rate=4,n=32,seed=0``) replays an open-loop trace through
``ServeFrontend`` -> ``EngineSupervisor`` -> ``ServeEngine`` instead of one
batch, after a warm replay on a throwaway virtual-clock stack: in wall time
by default, or on a virtual clock with ``--virtual-step S`` seconds a
round.  It prints the ``[traffic]`` lines: completed/offered, rejections by
reason, queue wait, TTFT and ITL p50/p95/p99, the SLO line with
``--slo-ttft``/``--slo-itl``, and the fault counters.  The admission flags
(``--max-queue``, ``--queue-timeout``, ``--max-concurrency``,
``--deadline``, ``--max-retries``, ``--retry-backoff``) and the fault
injector (``--fault-every``, ``--fault-kinds``, ``--fault-seed``) apply to
the replay only.

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
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b --reduced \
      --device cpu --kv-block-size 4 --prompt-mix 5,12,20 --batch 5 --max-slots 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama-3.2-vision-90b --reduced \
      --device cpu --mode exact --prompt-mix 5,12,20 --batch 5 --max-slots 3
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large --reduced \
      --device cpu --mode exact --prompt-mix 5,12,20 --batch 5 --max-slots 3
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --traffic-trace 'mixed:rate=8,n=8' --virtual-step 0.05
  PYTHONPATH=src python -m repro_torch.launch.serve --mode exact --max-slots 8 \
      --traffic-trace 'mixed:rate=4,n=32,seed=0' --fault-every 4 \
      --fault-kinds step_error,nonfinite_logits,pool_pressure --max-retries 2
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.plan import PRESET_PLANS, ExecutionPlan
from repro_torch.core.astra_layer import MODES
from repro_torch.kernels import _build, launch_counts, reset_launches
from repro_torch.models.attention import KVCache
from repro_torch.models.model import Model
from repro_torch.models.transformer import ModelOptions
from repro_torch.serve import (
    FAULT_KINDS, GREEDY, EngineSupervisor, FrontendConfig, SamplerConfig, ServeConfig,
    ServeEngine, ServeFaultInjector, ServeFrontend, kv_quant_reject_reason,
    make_fused_decode, packed_prefill, sample_next_token,
)
from repro_torch.serve.prefill import pack_prompts
from repro_torch.traffic import (
    SLOConfig, TrafficTrace, VirtualClock, evaluate, generate_trace, parse_trace_spec,
    replay_trace, trace_max_len,
)


def generate(model: Model, params, prompts, gen_len: int, max_len: int,
             sampler: SamplerConfig = GREEDY, gen=None):
    """Uniform-length batch decode on dense per-slot caches: one packed
    prefill (``packed_prefill``: the full-sequence pass, or for a vision
    model the masked scan against zeroed cross caches), then one fused
    decode of ``gen_len - 1`` steps.  ``prompts`` ``[B, S0]`` (``[B, C,
    S0]`` multi-codebook); ``gen`` an optional ``torch.Generator`` for
    sampling.  Returns (prompt + generated tokens ``[B, S0 + gen_len]``
    (``[B, C, S0 + gen_len]``), decode tok/s of the fused decode on the
    host's clock, ended by a device sync)."""
    dev = model.device
    prompts = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
    b, s0 = prompts.shape[0], prompts.shape[-1]
    if gen_len == 0:
        return prompts, 0.0
    params = model.prepare(params)
    lengths = torch.full((b,), s0, dtype=torch.int32, device=dev)
    last_logits, state = packed_prefill(model, params, prompts, lengths, max_len)
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
    cache shape with its layer count, the cross caches with their vision
    positions, and the recurrent states (on the paged layout, what stays
    dense beside the pools)."""
    counts: dict = {}
    for st, kind in zip(states["layers"], cfg.layer_kinds):
        if kind in ("attn", "local") and not isinstance(st, KVCache):
            continue  # a block pool
        if kind == "xattn":
            key = (f"cross K and V {tuple(st.k.shape)} {cfg.dtype} ({cfg.vision_tokens} "
                   "vision positions)")
        elif kind == "rglru":
            key = f"RG-LRU states h {tuple(st.h.shape)} + conv {tuple(st.conv.shape)} float32"
        elif kind == "mlstm":
            key = (f"mLSTM states c {tuple(st.c.shape)} + n {tuple(st.n.shape)} + m "
                   f"{tuple(st.m.shape)} float32")
        elif kind == "slstm":
            key = f"sLSTM states c, n, m, h {tuple(st.c.shape)} float32"
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
    """Random prompts of ``lengths``: ``[n]`` tokens, or ``[C, n]`` grids
    for a multi-codebook model."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, cfg.token_lead + (n,), dtype=np.int32) for n in lengths]


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
    ap.add_argument("--max-slots", type=int, default=0,
                    help="engine slots (0 = one per request, traffic: 4)")
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
    ap.add_argument("--traffic-trace", default="",
                    help="open-loop replay instead of one batch: a trace JSON, or an "
                         "inline spec like 'chat:rate=4,n=32,seed=0'")
    ap.add_argument("--virtual-step", type=float, default=0.0,
                    help="replay on a virtual clock, each engine round costing this many "
                         "virtual seconds; 0 = wall-clock replay")
    ap.add_argument("--slo-ttft", type=float, default=0.0,
                    help="TTFT bound in seconds for the goodput line")
    ap.add_argument("--slo-itl", type=float, default=0.0,
                    help="max inter-token-gap bound in seconds for the goodput line")
    ap.add_argument("--max-queue", type=int, default=-1,
                    help="admission queue capacity (0 = no waiting room, -1 = unbounded); "
                         "overflow is rejected as queue_full (open-loop replay only)")
    ap.add_argument("--queue-timeout", type=float, default=0.0,
                    help="reject requests waiting longer than this many seconds "
                         "(queue_timeout); 0 = wait forever (open-loop replay only)")
    ap.add_argument("--max-concurrency", type=int, default=0,
                    help="most admitted requests in flight at once (open-loop replay "
                         "only); 0 = the engine's --max-slots")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="per-request end-to-end deadline in seconds; 0 = none "
                         "(open-loop replay only)")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="retries granted to requests ending in a retryable fault class; "
                         "0 = no retry (open-loop replay only)")
    ap.add_argument("--retry-backoff", type=float, default=0.5,
                    help="base retry backoff in seconds; attempt k waits "
                         "min(base * 2^(k-1), 8 * base) on the replay clock")
    ap.add_argument("--fault-every", type=int, default=0,
                    help="inject one deterministic fault every N supervisor steps; "
                         "0 = no injection (open-loop replay only)")
    ap.add_argument("--fault-kinds", default="step_error,nonfinite_logits",
                    help="comma list of fault kinds the injector draws from: "
                         "step_error, nonfinite_logits, pool_pressure, slow_step")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the injector's kind and victim draws")
    return ap


def check_flags(ap: argparse.ArgumentParser, args) -> None:
    """The reference CLI's refusals of flags that cannot apply."""
    if args.no_degraded_mode and args.kv_block_size == 0:
        ap.error("--no-degraded-mode only applies to the paged KV cache; the dense layout "
                 "has no block pool, hence no pressure ladder to disable")
    if args.prefill_chunk_tokens < 0:
        ap.error(f"--prefill-chunk-tokens: {args.prefill_chunk_tokens} is negative; pass a "
                 "per-round token budget or 0 for blocking full-prompt admission")
    if not args.traffic_trace:
        for flag, val, default in (
                ("--max-queue", args.max_queue, -1),
                ("--queue-timeout", args.queue_timeout, 0.0),
                ("--max-concurrency", args.max_concurrency, 0),
                ("--virtual-step", args.virtual_step, 0.0),
                ("--deadline", args.deadline, 0.0),
                ("--max-retries", args.max_retries, 0),
                ("--retry-backoff", args.retry_backoff, 0.5),
                ("--fault-every", args.fault_every, 0),
                ("--fault-kinds", args.fault_kinds, "step_error,nonfinite_logits"),
                ("--fault-seed", args.fault_seed, 0)):
            if val != default:
                ap.error(f"{flag} only applies to open-loop replay; pass "
                         "--traffic-trace <file or spec> to select it")
        return
    if args.deadline < 0:
        ap.error(f"--deadline: {args.deadline} is negative; pass an "
                 "end-to-end deadline in seconds > 0, or 0 to disable")
    if args.max_retries < 0:
        ap.error(f"--max-retries: {args.max_retries} is negative; pass the "
                 "retry attempts granted to retryable faults, or 0 to "
                 "disable retry")
    if args.retry_backoff < 0:
        ap.error(f"--retry-backoff: {args.retry_backoff} is negative; pass "
                 "a base backoff in seconds >= 0")
    if args.fault_every < 0:
        ap.error(f"--fault-every: {args.fault_every} is negative; pass an "
                 "injection period in supervisor steps, or 0 to disable")
    unknown = sorted(set(k for k in args.fault_kinds.split(",") if k) - set(FAULT_KINDS))
    if unknown:
        ap.error(f"--fault-kinds: unknown name(s): {', '.join(unknown)}; "
                 f"valid: {', '.join(FAULT_KINDS)}")
    if args.max_queue < -1:
        ap.error(f"--max-queue: {args.max_queue} is invalid; pass a queue "
                 "capacity >= 0 (0 = no waiting room) or -1 for unbounded")
    if args.queue_timeout < 0:
        ap.error(f"--queue-timeout: {args.queue_timeout} is negative; pass "
                 "a timeout in seconds > 0, or 0 to disable")
    if args.max_concurrency < 0:
        ap.error(f"--max-concurrency: {args.max_concurrency} is negative; "
                 "pass an in-flight cap >= 1 (must not exceed --max-slots) "
                 "or 0 to inherit the engine's max_slots")
    if args.virtual_step < 0:
        ap.error(f"--virtual-step: {args.virtual_step} is negative; pass a "
                 "virtual round time in seconds > 0, or 0 for wall-clock "
                 "replay")


def load_trace(ap: argparse.ArgumentParser, spec: str, cfg) -> TrafficTrace:
    """``--traffic-trace``: a JSON trace file, or an inline spec."""
    if os.path.exists(spec):
        return TrafficTrace.load(spec)
    try:
        kw = parse_trace_spec(spec)
    except ValueError as e:
        ap.error(f"--traffic-trace: {spec!r} is neither a file nor a valid spec: {e}")
    return generate_trace(vocab=cfg.vocab, n_codebooks=cfg.n_codebooks, **kw)


def run_traffic(model: Model, params, trace: TrafficTrace, args,
                ap: argparse.ArgumentParser):
    """Open-loop replay of ``trace`` through the front-end, the supervisor
    and the engine, after a warm replay on a throwaway virtual-clock stack;
    prints the ``[traffic]`` lines.  Returns the replay's outputs."""
    block = args.kv_block_size
    max_len = trace_max_len(trace)
    if block:
        max_len = -(-max_len // block) * block
    serve_cfg = ServeConfig(
        max_slots=args.max_slots or 4, max_len=max_len, chunk_steps=args.chunk_steps,
        sampler=SamplerConfig(args.temperature, args.top_k), seed=args.seed,
        kv_block_size=block, kv_pool_blocks=args.kv_pool_blocks,
        prefix_cache=not args.no_prefix_cache, kv_quant=args.kv_quant,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        degraded_mode=not args.no_degraded_mode)
    fe_cfg = FrontendConfig(  # check_flags has refused every value it would
        max_queue_depth=None if args.max_queue < 0 else args.max_queue,
        queue_timeout_s=args.queue_timeout or None,
        max_concurrency=args.max_concurrency or None,
        default_deadline_s=args.deadline or None,
        max_retries=args.max_retries, retry_backoff_s=args.retry_backoff)
    virtual = args.virtual_step > 0

    def stack(force_virtual=False, inject=False):
        clk = VirtualClock() if (virtual or force_virtual) else None
        eng = ServeEngine(model, params, serve_cfg, device=model.device, clock=clk)
        sup = None
        if inject and args.fault_every > 0:
            # a horizon the run cannot outlast
            inj = ServeFaultInjector.periodic(
                n_steps=100 * max(len(trace), 1) + args.fault_every, every=args.fault_every,
                kinds=[k for k in args.fault_kinds.split(",") if k], seed=args.fault_seed)
            sup = EngineSupervisor(eng, inj)
        elif args.fault_every > 0 or args.max_retries > 0 or args.deadline:
            sup = EngineSupervisor(eng)  # containment and audit, no injection
        try:
            return ServeFrontend(eng, fe_cfg, clock=clk, supervisor=sup)
        except ValueError as e:
            ap.error(str(e))

    try:
        warm = stack(force_virtual=True)
    except (NotImplementedError, ValueError) as e:  # a refused configuration
        ap.error(str(e))
    replay_trace(warm, trace, virtual_step_s=args.virtual_step or 0.05)
    frontend = stack(inject=True)
    reset_launches()
    result = replay_trace(frontend, trace,
                          virtual_step_s=args.virtual_step if virtual else None)
    slo = (SLOConfig(args.slo_ttft, args.slo_itl)
           if args.slo_ttft > 0 and args.slo_itl > 0 else None)
    m = evaluate(result.outputs, result.duration_s, slo, offered_rps=trace.rate_rps)
    print_traffic(trace, result, m, fe_cfg, slo, frontend,
                  f"virtual step={args.virtual_step}s" if virtual else "wall")
    print(f"  kernel launches: {launch_counts()}")
    return result.outputs


def print_traffic(trace, result, m, fe_cfg, slo, frontend, clock_kind: str) -> None:
    """The ``[traffic]`` lines of one replay (the reference CLI's)."""
    print(f"[traffic] {trace.suite} trace: {len(trace)} requests at "
          f"{trace.rate_rps:g} rps ({trace.arrival}), replayed in "
          f"{result.duration_s:.2f}s ({clock_kind})")
    print(f"  completed {m['n_completed']}/{m['n_offered']} "
          f"({m['completed_tok_s']:.1f} tok/s), rejected {m['n_rejected']} "
          f"{m['rejected_by_reason'] or ''}")
    st = result.stats
    print(f"  queue: p50 wait {m['queue_p50_s'] * 1e3:.1f} ms, high-water "
          f"depth {st['max_queue_depth']}"
          + (f" (cap {fe_cfg.max_queue_depth})" if fe_cfg.max_queue_depth is not None else ""))
    print(f"  TTFT p50/p95/p99: {m['ttft_p50_s'] * 1e3:.1f} / "
          f"{m['ttft_p95_s'] * 1e3:.1f} / {m['ttft_p99_s'] * 1e3:.1f} ms")
    print(f"  ITL  p50/p95/p99: {m['itl_p50_s'] * 1e3:.2f} / "
          f"{m['itl_p95_s'] * 1e3:.2f} / {m['itl_p99_s'] * 1e3:.2f} ms "
          f"(max {m['itl_max_s'] * 1e3:.2f} ms)")
    if slo is not None:
        print(f"  SLO (ttft<={slo.ttft_s}s, itl<={slo.itl_s}s): "
              f"{m['n_slo_met']}/{m['n_offered']} met "
              f"({m['slo_attainment']:.0%}), goodput {m['goodput_rps']:.2f} rps")
    if frontend.supervisor is not None:
        sup_st = frontend.supervisor.stats
        eng_st = frontend.engine.stats()
        print(f"  faults: {sup_st['faults_injected']} injected over "
              f"{sup_st['steps']} supervised steps, "
              f"{eng_st['n_quarantined']} quarantined / "
              f"{eng_st['n_cancelled']} cancelled / {eng_st['n_shed']} shed, "
              f"{st['retries']} retries, {sup_st['audits_run']} audits clean")
        if eng_st["degraded_transitions"]:
            path = " -> ".join(name for _, name in eng_st["degraded_transitions"])
            print(f"  degraded ladder: {path} (now {eng_st['degraded_level']})")


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
    if args.traffic_trace:
        return run_traffic(model, params, load_trace(ap, args.traffic_trace, cfg), args, ap)
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
        why = ("" if args.kv_block_size == 0 or engine._paged
               else " (no attn/local layer: no KV to pool)")
        print(f"  kv cache: dense per-slot layout{why}, "
              f"{dense_state_summary(engine._states, cfg)}")
    else:
        line = (f"  kv pool: {kv['pool_blocks']} blocks x {kv['block_size']} tok, "
                f"{kv['kv_quant']} storage ({kv['bytes_per_block']} B/block, "
                f"{kv['pool_bytes'] / 1e6:.2f} MB)")
        if not kv["prefix_cache"]:
            line += f"; prefix cache off: {kv['prefix_cache_off_reason']}"
        if "xattn" in cfg.layer_kinds:
            line += f"; dense beside it: {dense_state_summary(engine._states, cfg)}"
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
