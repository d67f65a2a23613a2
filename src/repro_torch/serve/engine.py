"""Continuous-batching serve engine over dense or paged KV.

Port of ``repro.serve.engine``: blocking or chunked admission, chunked
decode, retirement with each request's modeled ASTRA cost, the
exactly-once outbox and the degraded-mode ladder, on two KV layouts.
``kv_block_size=0`` (the default, as in the reference) keeps one dense
per-slot state per layer — a ``[max_slots, n_kv, max_len, hd]`` cache
(global attention), a ``window``-sized ring (local attention) or an
RG-LRU state — so it serves every ported block kind: blocking admission
runs one packed prefill of the admitted prompts (the full-sequence pass
where it is exact, else the masked token-by-token scan;
``packed_prefill``) and scatters each one's states into its slot.
``kv_block_size > 0`` stores KV in one block pool per layer with
radix-tree prefix reuse, for pure global-attention stacks only (refused
at construction otherwise).  Requests flow

  queue -> [admit: claim a free slot; paged: reserve blocks (reusing
            interned prefix blocks)]
        -> [prefill: dense packed prefill + scatter, or paged suffix
            prefill of the unmatched prompt; chunked: bounded chunks
            interleaved with decode]
        -> [decode chunks of ``min(chunk_steps, min(remaining))`` steps]
        -> [retire: release blocks, timing, modeled chip cost, outbox]

**Chunked prefill** (``prefill_chunk_tokens > 0``): admitted requests hold
their slot as ``PREFILLING`` while the token-budget scheduler
(``serve/scheduler.py``: FCFS, decode priority, one per-round budget)
feeds their prompts in bounded chunks, one dispatch a round before the
decode chunk.  Dense caches chunk through the windowed masked scan over
the engine's whole state (``prefill.prefill_window``); the paged pool
chunks through ``prefill_paged_suffix``, each chunk starting after the
prefix-cache hit and the request's own earlier chunks, at any in-block
offset.  A prefilling slot's table row stays at scratch until it decodes;
on dense caches the decode chunk gates the prefilling slots' state
updates (``active``).

**Degraded mode** (paged layout): a round whose admission could not
reserve blocks walks the ``DegradedLadder`` (flush the prefix tree, stop
prefix admission, shed the queue head as a ``pool_pressure`` output) and
relaxes one level a round with admission progress; with
``degraded_mode=False`` the engine raises when admission fails with every
slot free, where it would otherwise wait forever.

Every decode step runs all ``max_slots`` rows, free ones included (at
position 0 with a stale token, their writes landing in their own dense
row or in scratch block 0), exactly as the reference does: under a plan
with dynamic int8 scales the activation absmax spans every row, so the
port must carry the same rows to give the same tokens.
``ServeConfig.kv_quant="int8"`` stores the pool as int8 against the
plan's calibrated per-KV-head scales; the engine refuses it unless the KV
is a pure function of the token path on the paged layout
(:func:`kv_quant_reject_reason`).  A decode chunk whose logits go
non-finite on some slots commits every healthy slot first and then raises
``NonFiniteLogitsError`` naming exactly the bad ones: their tokens of that
chunk are dropped and their requests end at the pre-fault stream
(``RequestOutput.fault_reason``).  With ``astra_accounting`` (the
default) each output carries ``hardware``, its request's modeled cost on
the ASTRA photonic chip (``serve/accounting.py``; not a measurement of
the card), prompt tokens served from the prefix cache billed at zero.  On
the card the attention kernels exist for the head dims ``HEAD_DIMS``; a
model of another head dim is refused when the engine is built
(:func:`attn_kernel_reject_reason`).  Retries, the supervisor and the
front-end come with later slices (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.energy import AstraChipConfig
from repro_torch.core.plan import kv_sites, model_sites, validate_site_registry
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels._build import HEAD_DIMS
from repro_torch.models.attention import BlockTables
from repro_torch.models.model import Model
from repro_torch.models.transformer import (
    DENSE_KV_QUANT_REASON, PAGED_STATEFUL_REASON, PORTED_KINDS,
)
from repro_torch.serve.accounting import (
    RequestHardwareReport, RequestTiming, request_hardware_report, request_timing,
)
from repro_torch.serve.clock import resolve_clock
from repro_torch.serve.decode_loop import make_fused_decode
from repro_torch.serve.kv_pool import KVBlockPool
from repro_torch.serve.faults import FAULT_NONFINITE, FAULT_POOL_PRESSURE, NonFiniteLogitsError
from repro_torch.serve.prefill import (
    pack_prompts, packed_prefill, prefill_paged_suffix, prefill_window,
)
from repro_torch.serve.prefix_tree import RadixPrefixTree
from repro_torch.serve.sampling import GREEDY, SamplerConfig, sample_next_token
from repro_torch.serve.scheduler import (
    DegradedLadder, SchedulerConfig, TokenBudgetScheduler, pow2_bucket,
)
from repro_torch.serve.slots import SlotState, scatter_states


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_slots: int = 8
    max_len: int = 256  # per-slot positions (prompt + generated)
    chunk_steps: int = 8  # decode steps per engine round
    sampler: SamplerConfig = GREEDY
    seed: int = 0
    astra_accounting: bool = True  # each output's modeled ASTRA cost (``hardware``)
    kv_block_size: int = 0  # 0 = dense per-slot caches; > 0 = positions per pool block
    kv_pool_blocks: int = 0  # physical blocks incl. scratch; 0 = slot floor + 2 slots
    prefix_cache: bool = True  # radix-tree prefix reuse (paged layout only)
    # per-round token budget of the chunked-prefill scheduler, shared with
    # decode (which has priority); 0 = blocking full-prompt admission
    prefill_chunk_tokens: int = 0
    attn_impl: Optional[str] = None  # None inherits the model's; "naive" | "flash"
    kv_quant: Optional[str] = None  # None inherits the model's; "none" | "int8"
    # paged layout: walk the degraded-mode ladder on a stalled admission
    # round; False raises when admission fails with every slot free
    degraded_mode: bool = True


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    t_submit: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[-1])


@dataclasses.dataclass
class RequestOutput:
    request_id: int
    prompt: np.ndarray
    tokens: np.ndarray  # generated tokens [G]
    wall_time_s: float
    # the request's modeled cost on the ASTRA photonic chip (None without
    # astra_accounting); not a measurement of the serving device
    hardware: Optional[RequestHardwareReport] = None
    timing: Optional[RequestTiming] = None
    # set when a fault ended the request instead of its budget or EOS
    # ("nonfinite_logits", "pool_pressure"); ``tokens`` then holds its
    # pre-fault stream
    fault_reason: Optional[str] = None

    @property
    def gen_len(self) -> int:
        return int(self.tokens.shape[-1])


@dataclasses.dataclass
class _Slot:
    req: Request
    state: SlotState
    pos: int = 0  # absolute position of the next decode write
    remaining: int = 0  # tokens still to generate
    filled: int = 0  # prompt tokens resident (prefix-cached or prefilled)
    generated: List[np.ndarray] = dataclasses.field(default_factory=list)
    cached: int = 0  # prompt tokens served from the prefix cache
    t_admit: float = 0.0
    t_first: float = 0.0
    events: List[Tuple[float, int]] = dataclasses.field(default_factory=list)


@lru_cache(maxsize=256)
def _check_site_registry(cfg) -> None:
    """The executed GEMM sites against the simulator's ops, once per config:
    the accounting attributes energy by site."""
    validate_site_registry(cfg)


def _kv_deterministic(model: Model) -> bool:
    """Whether interned KV is a pure function of the token path: every
    GEMM site exact or with a static activation scale.  Dynamic scales
    depend on what else was packed into a prefill, so prefix reuse would
    make outputs depend on admission history."""
    for s in model_sites(model.cfg):
        cc = model.plan.resolve(s)
        if cc.mode != "exact" and cc.act_scale is None:
            return False
    return True


def kv_quant_reject_reason(model: Model, kv_block_size: int) -> Optional[str]:
    """Why ``kv_quant="int8"`` cannot run on this engine (None = legal).
    The prefix cache replays pooled int8 blocks, so their contents must be
    a pure function of the token path: the paged layout, static activation
    scales on every quantized GEMM site, and a calibrated scale for every
    KV storage site."""
    if kv_block_size <= 0:
        return DENSE_KV_QUANT_REASON
    if not _kv_deterministic(model):
        return ("kv_quant='int8' requires deterministic KV: every quantized GEMM site "
                "must carry a static calibrated act_scale — dynamic per-tensor scales "
                "would make pooled int8 blocks depend on admission history; run "
                "Model.calibrate or use an exact/static plan")
    missing = [s for s in kv_sites(model.cfg) if model.plan.kv_scale(s) is None]
    if missing:
        more = f" (+{len(missing) - 1} more site(s))" if len(missing) > 1 else ""
        return (f"kv_quant='int8' needs calibrated KV scales but the plan carries none "
                f"for {missing[0]!r}{more}; run Model.calibrate before enabling kv_quant")
    return None


def attn_kernel_reject_reason(head_dim: int, attn_impl: str,
                              device_type: str) -> Optional[str]:
    """Why the attention kernels cannot serve this model (None = they
    can): on the card, ``attn_impl="flash"`` launches kernels built for
    ``HEAD_DIMS`` only; the plain versions on the CPU and the
    ``naive`` path take any head dim."""
    if attn_impl == "flash" and device_type == "cuda" and head_dim not in HEAD_DIMS:
        return (f"head_dim {head_dim}: the CUDA attention kernels are built for head dims "
                f"{HEAD_DIMS}; serve with attn_impl='naive' or add the head dim to "
                "the kernels")
    return None


class ServeEngine:
    def __init__(self, model: Model, params, config: Optional[ServeConfig] = None, *,
                 chip: Optional[AstraChipConfig] = None, device: DeviceLike = None,
                 clock: Optional[Callable[[], float]] = None):
        """``device=None`` means the card (raises without one); it must be
        the model's device.  ``chip`` is the modeled ASTRA chip the
        accounting bills against (the default organization if None).
        ``clock`` replaces the wall clock for every timestamp (a replay
        harness passes a virtual one)."""
        config = ServeConfig() if config is None else config
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        if config.attn_impl is not None and config.attn_impl != model.opts.attn_impl:
            model = dataclasses.replace(
                model, opts=dataclasses.replace(model.opts, attn_impl=config.attn_impl))
        if config.kv_quant is not None and config.kv_quant != model.opts.kv_quant:
            # the engine owns the KV storage dtype, as it owns attn_impl
            model = dataclasses.replace(
                model, opts=dataclasses.replace(model.opts, kv_quant=config.kv_quant))
        if model.opts.kv_quant != "none":
            reason = kv_quant_reject_reason(model, config.kv_block_size)
            if reason is not None:
                raise ValueError(reason)
        cfg = model.cfg
        if any(k not in PORTED_KINDS for k in cfg.layer_kinds):
            raise NotImplementedError(f"{cfg.name}: serving ports {'/'.join(PORTED_KINDS)} "
                                      "stacks only (ROADMAP queue 1: other block kinds)")
        if config.kv_block_size > 0 and any(k != "attn" for k in cfg.layer_kinds):
            # so the reference's blocking fallback for chunked admission of
            # a paged stateful stack does not arise here
            raise NotImplementedError(f"{cfg.name}: {PAGED_STATEFUL_REASON}")
        reason = attn_kernel_reject_reason(cfg.head_dim, model.opts.attn_impl, self.device.type)
        if reason is not None:
            raise NotImplementedError(f"{cfg.name}: {reason}")
        if config.prefill_chunk_tokens < 0:
            raise ValueError(
                f"prefill_chunk_tokens={config.prefill_chunk_tokens} is negative; pass a "
                "per-round token budget or 0 for blocking admission")
        # every GEMM site this model executes must resolve 1:1 to a
        # simulator op: the accounting attributes energy by site
        _check_site_registry(cfg)
        self.model = model
        self.params = model.prepare(params)
        self.config = config
        self.chip = chip or AstraChipConfig()
        self.clock = resolve_clock(clock)
        self._fused = make_fused_decode(model)
        self._queue: deque[Request] = deque()
        self._slots: List[Optional[_Slot]] = [None] * config.max_slots
        self._outbox: List[RequestOutput] = []
        self._next_id = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)
        self._cur_tok = torch.zeros((config.max_slots, 1), dtype=torch.int32,
                                    device=self.device)
        # host-clock seconds and tokens of admission prefills (each chunk
        # dispatch under chunked prefill) and decode chunks; a phase that
        # brings tokens to the host ends with them there, so its device
        # work is inside the interval
        self.phase_stats = {"prefill_s": 0.0, "prefill_tokens": 0,
                            "decode_s": 0.0, "decode_tokens": 0}
        self._step_no = 0  # engine rounds run
        self._n_quarantined = 0  # slots ended by a fault
        self._n_shed = 0  # queue heads shed by the degraded ladder
        self._paged = config.kv_block_size > 0
        # the full-sequence prefill emits window-sized rings; where the
        # window exceeds max_len the slots' rings are smaller (init_cache
        # clamps them), so admission takes the masked scan
        self._force_scan = (any(k == "local" for k in cfg.layer_kinds)
                            and config.max_len < cfg.window)
        self._prefix: Optional[RadixPrefixTree] = None
        if self._paged:
            self._init_pool(model, config)
        else:
            self._states = model.init_decode_state(config.max_slots, config.max_len)
        # pool pressure is a paged-only condition: dense caches have no pool
        self._ladder: Optional[DegradedLadder] = (
            DegradedLadder() if self._paged and config.degraded_mode else None)
        self._prefix_admission = True  # ladder level 2 turns it off
        self._admit_progress = False  # a request left the queue this round
        self._admit_stalled = False  # a paged admission rolled back this round
        self._sched: Optional[TokenBudgetScheduler] = None
        if config.prefill_chunk_tokens > 0:
            self._sched = TokenBudgetScheduler(SchedulerConfig(config.prefill_chunk_tokens))
        self._prefilling: List[int] = []  # PREFILLING slot ids, admission order

    def _init_pool(self, model: Model, config: ServeConfig) -> None:
        """The paged layout: one block pool per layer, block tables, the
        allocator and (where KV is deterministic) the prefix tree."""
        bs = config.kv_block_size
        w = -(-config.max_len // bs)
        floor = 1 + config.max_slots * w
        n_blocks = config.kv_pool_blocks or (floor + 2 * w)
        if n_blocks < floor:
            raise ValueError(
                f"kv_pool_blocks={n_blocks} cannot back max_slots={config.max_slots} x "
                f"ceil(max_len {config.max_len} / kv_block_size {bs}) = {w} blocks "
                f"each (+1 scratch): need >= {floor}")
        self._block_size, self._table_width = bs, w
        self._pool = KVBlockPool(n_blocks, bs)
        self._slot_blocks: List[List[int]] = [[] for _ in range(config.max_slots)]
        self._tables_np = np.zeros((config.max_slots, w), np.int32)
        self._tables_dev = torch.as_tensor(self._tables_np, device=self.device)
        self._tables_dirty = False
        self._prefix_off_reason: Optional[str] = None
        if not config.prefix_cache:
            self._prefix_off_reason = "disabled by config (prefix_cache=False)"
        elif not _kv_deterministic(model):
            self._prefix_off_reason = (
                "non-deterministic KV: a quantized GEMM site runs with dynamic "
                "scales (run Model.calibrate for static scales)")
        else:
            self._prefix = RadixPrefixTree(bs)
        self._states = model.init_decode_state(config.max_slots, config.max_len,
                                               paged=(n_blocks, bs))
        # storage of one block over every layer's K and V pools, at the
        # pools' dtype (int8 under kv_quant); per-head scales are not per block
        self._pool.bytes_per_block = sum(
            t[0].numel() * t.element_size() for st in self._states["layers"]
            for t in (st.k, st.v))

    # ------------------------------------------------------------- intake
    def check_request(self, prompt, max_new_tokens: int) -> np.ndarray:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D tokens, got shape {prompt.shape}")
        if prompt.shape[-1] == 0:
            raise ValueError("empty prompt: a request needs at least one "
                             "prompt token (its logits seed sampling)")
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens={max_new_tokens} is negative")
        if prompt.shape[-1] + max_new_tokens > self.config.max_len:
            raise ValueError(f"prompt_len {prompt.shape[-1]} + max_new {max_new_tokens} "
                             f"exceeds max_len {self.config.max_len}")
        return prompt

    def submit(self, prompt, max_new_tokens: int, eos_id: Optional[int] = None) -> int:
        prompt = self.check_request(prompt, max_new_tokens)
        rid = self._next_id
        self._next_id += 1
        req = Request(rid, prompt, max_new_tokens, eos_id, t_submit=self.clock())
        if max_new_tokens == 0:
            now = self.clock()
            self._complete(req, [], t_admit=now, t_first=now, events=[])
        else:
            self._queue.append(req)
        return rid

    # ------------------------------------------------------------ engine
    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def run(self) -> List[RequestOutput]:
        """Drain queue and slots; every output completed since the last
        collection, in submission order (each handed over exactly once)."""
        outs = self._drain()
        while self.has_work():
            outs.extend(self.step())
        return sorted(outs, key=lambda o: o.request_id)

    def step(self) -> List[RequestOutput]:
        """Admit (+ blocking prefill), one chunked-prefill dispatch, one
        decode chunk, then the admission progress check; returns what
        finished."""
        self._step_no += 1
        self._admit()
        if self._sched is not None:
            self._prefill_chunk()
        self._decode_chunk()
        self._check_progress()
        return self._drain()

    def _drain(self) -> List[RequestOutput]:
        outs, self._outbox = self._outbox, []
        return outs

    def _check_progress(self):
        """React to a stalled paged admission round: walk the degraded
        ladder (one level up a stalled round, one down a round with
        admission progress), or without it raise when admission failed
        with every slot free, since no retirement can then release blocks."""
        if self._admit_stalled and self._ladder is not None:
            self._degrade()
        elif (self._admit_stalled and self._queue
                and not any(s is not None for s in self._slots)):
            raise RuntimeError(
                "serve engine wedged: paged admission failed with every slot "
                "free, so no retirement can ever release blocks "
                f"({len(self._queue)} request(s) queued, "
                f"{self._pool.n_free} pool blocks free)")
        elif self._admit_progress and self._ladder is not None:
            if self._ladder.relax(self._step_no) == DegradedLadder.NORMAL:
                self._prefix_admission = True
        self._admit_stalled = False
        self._admit_progress = False

    def _degrade(self):
        """One stalled round: escalate the ladder and act at its level."""
        level = self._ladder.escalate(self._step_no)
        if level >= DegradedLadder.FLUSH_PREFIX and self._prefix is not None:
            # every evictable interned block goes: hits become recomputes
            self._prefix.evict(self._pool.n_blocks, self._pool)
        if level >= DegradedLadder.NO_PREFIX_ADMISSION:
            self._prefix_admission = False
        if level >= DegradedLadder.SHED_LOAD and self._queue:
            # one queue head a stalled round ends as a pool_pressure output
            req = self._queue.popleft()
            now = self.clock()
            self._complete(req, [], t_admit=now, t_first=now, events=[],
                           fault_reason=FAULT_POOL_PRESSURE)
            self._n_shed += 1

    # ------------------------------------------------------------- admit
    def _admit(self):
        free = [i for i, s in enumerate(self._slots) if s is None]
        n = min(len(free), len(self._queue))
        if n == 0:
            return
        before = len(self._queue)
        if self._sched is not None:
            self._admit_chunked(free[:n])
        else:
            self._admit_blocking(free[:n])
        if len(self._queue) < before:
            self._admit_progress = True

    def _admit_blocking(self, slot_ids: List[int]):
        reqs = [self._queue.popleft() for _ in range(len(slot_ids))]
        t_admit = self.clock()
        if self._paged:
            slot_ids, reqs, last_logits, cached = self._prefill_paged(slot_ids, reqs)
            if not reqs:
                return
        else:
            last_logits = self._prefill_dense(slot_ids, reqs)
            cached = [0] * len(reqs)
        first = sample_next_token(last_logits, self.config.sampler, self._gen, self.model.cfg)
        self._cur_tok[torch.as_tensor(slot_ids, device=self.device)] = first
        first_np = first.cpu().numpy()
        t_first = self.clock()
        self.phase_stats["prefill_s"] += t_first - t_admit
        self.phase_stats["prefill_tokens"] += sum(r.prompt_len - c for r, c in zip(reqs, cached))
        for j, (i, req) in enumerate(zip(slot_ids, reqs)):
            tok0 = first_np[j]
            slot = _Slot(req, SlotState.DECODING, pos=req.prompt_len,
                         remaining=req.max_new_tokens - 1, filled=req.prompt_len,
                         generated=[tok0], cached=cached[j], t_admit=t_admit,
                         t_first=t_first, events=[(t_first, 1)])
            if self._hit_eos(req, tok0) or slot.remaining == 0:
                self._retire(slot)
                self._release_blocks(i)
            else:
                self._slots[i] = slot

    def _reserve_blocks(self, req: Request) -> Tuple[List[int], int]:
        """Match + incref prefix blocks and allocate the rest; atomic (every
        incref is rolled back if the allocation fails)."""
        bs = self._block_size
        total = -(-(req.prompt_len + req.max_new_tokens) // bs)
        matched: List[int] = []
        if self._prefix is not None and self._prefix_admission:
            # leave >= 1 suffix token: its logits seed the first sample
            matched = self._prefix.match(req.prompt,
                                         max_blocks=min((req.prompt_len - 1) // bs, total))
            for blk in matched:
                self._pool.incref(blk)
        need = total - len(matched)
        try:
            if need > self._pool.n_free and self._prefix is not None:
                self._prefix.evict(need - self._pool.n_free, self._pool)
            fresh = self._pool.alloc(need)
        except RuntimeError:
            for blk in matched:
                self._pool.decref(blk)
            raise
        return matched + fresh, len(matched)

    def _install_blocks(self, slot_i: int, blocks: List[int], into_table: bool) -> None:
        """Record a slot's blocks; its table row holds them only once the
        slot decodes (``into_table``): a PREFILLING slot's row stays at
        scratch, where its ride-along decode writes land."""
        self._slot_blocks[slot_i] = blocks
        self._tables_np[slot_i] = 0
        if into_table:
            self._tables_np[slot_i, : len(blocks)] = blocks
        self._tables_dirty = True

    def _prefill_dense(self, slot_ids: List[int], reqs: List[Request]) -> torch.Tensor:
        """One packed prefill of the admitted prompts (full-sequence or
        masked scan, ``packed_prefill``); each request's states replace its
        slot's rows."""
        tokens, lengths = pack_prompts([r.prompt for r in reqs], self.model.cfg,
                                       device=self.device)
        last_logits, small = packed_prefill(self.model, self.params, tokens, lengths,
                                            self.config.max_len, force_scan=self._force_scan)
        scatter_states(self._states, small, torch.as_tensor(slot_ids, device=self.device))
        return last_logits

    def _prefill_paged(self, slot_ids: List[int], reqs: List[Request]):
        """Reserve blocks (reusing interned prefix blocks), prefill the
        unmatched suffixes in one packed pass, intern new prompt blocks.
        A request whose blocks cannot be covered goes back to the queue
        front with every later one (FCFS), and the round counts as stalled."""
        bs = self._block_size
        starts: List[int] = []
        adm_slots: List[int] = []
        adm_reqs: List[Request] = []
        for k, (i, req) in enumerate(zip(slot_ids, reqs)):
            try:
                blocks, n_matched = self._reserve_blocks(req)
            except RuntimeError:
                for r in reversed(reqs[k:]):
                    self._queue.appendleft(r)
                self._admit_stalled = True
                break
            self._install_blocks(i, blocks, into_table=True)
            starts.append(n_matched * bs)
            adm_slots.append(i)
            adm_reqs.append(req)
        if not adm_reqs:
            return [], [], None, []
        rows = torch.as_tensor(self._tables_np[adm_slots], device=self.device)
        suffixes = [r.prompt[s:] for r, s in zip(adm_reqs, starts)]
        tokens, lengths = pack_prompts(suffixes, self.model.cfg, device=self.device)
        ctx = self._ctx_bucket(max(s + int(tokens.shape[-1]) for s in starts))
        last_logits, self._states = prefill_paged_suffix(
            self.model, self.params, tokens, lengths, self._states, rows,
            torch.as_tensor(starts, dtype=torch.int32, device=self.device), ctx)
        if self._prefix is not None:
            for i, req, start in zip(adm_slots, adm_reqs, starts):
                self._intern_prompt(i, req, start)
        return adm_slots, adm_reqs, last_logits, starts

    def _intern_prompt(self, slot_i: int, req: Request, start: int):
        if not self._prefix_admission:  # ladder level 2 and up: no new interning
            return
        bs = self._block_size
        nb_full = req.prompt_len // bs
        if nb_full > start // bs:
            self._prefix.insert(req.prompt[: nb_full * bs],
                                self._slot_blocks[slot_i][:nb_full], self._pool)

    def _ctx_bucket(self, max_pos: int) -> int:
        """Pow2 context-view width in blocks covering ``max_pos`` positions
        (the reference's bucketing, kept so both gather the same view)."""
        need = -(-max_pos // self._block_size)
        return max(pow2_bucket(need, self._table_width), 1)

    # -------------------------------------------------- chunked admission
    def _admit_chunked(self, slot_ids: List[int]):
        """Claim free slots for waiting requests as PREFILLING; the
        scheduler feeds their prompts.  On the paged layout the head's
        blocks are reserved first and a head that cannot fit stops the
        admission (FCFS; the round counts as stalled)."""
        t_admit = self.clock()
        new_dense: List[int] = []
        for i in slot_ids:
            if not self._queue:
                break
            req = self._queue[0]
            filled = 0
            if self._paged:
                try:
                    blocks, n_matched = self._reserve_blocks(req)
                except RuntimeError:
                    self._admit_stalled = True
                    break
                self._install_blocks(i, blocks, into_table=False)
                filled = n_matched * self._block_size
            self._queue.popleft()
            self._slots[i] = _Slot(req, SlotState.PREFILLING, filled=filled,
                                   cached=filled, t_admit=t_admit)
            self._prefilling.append(i)
            if not self._paged:
                new_dense.append(i)
        if new_dense:
            # a dense slot's state is built in place, chunk by chunk: its
            # previous occupant's (recurrent states especially) goes first
            zeros = self.model.init_decode_state(len(new_dense), self.config.max_len)
            scatter_states(self._states, zeros, torch.as_tensor(new_dense, device=self.device))

    def _prefill_chunk(self):
        """One bounded prefill dispatch: this round's FCFS chunk plan, then
        the DECODING transition of every prompt it completes.  Its host
        interval and the prompt tokens it fed count as prefill; a chunk
        that completes prompts ends with their first tokens on the host."""
        if not self._prefilling:
            return
        n_active = sum(1 for s in self._slots
                       if s is not None and s.state is SlotState.DECODING)
        needs = [(i, self._slots[i].req.prompt_len - self._slots[i].filled)
                 for i in self._prefilling]
        plan = self._sched.plan_chunks(needs, n_active)
        if not plan:
            return
        t0 = self.clock()
        if self._paged:
            last_logits = self._prefill_chunk_paged(plan)  # [n_planned, 1, V]
            row_of = {i: j for j, (i, _) in enumerate(plan)}
        else:
            last_logits = self._prefill_chunk_dense(plan)  # [max_slots, 1, V]
            row_of = {i: i for i, _ in plan}
        done: List[int] = []
        for i, take in plan:
            slot = self._slots[i]
            slot.filled += take
            if slot.filled == slot.req.prompt_len:
                done.append(i)
        if done:
            self._start_decoding(done, last_logits, [row_of[i] for i in done])
        self.phase_stats["prefill_s"] += self.clock() - t0
        self.phase_stats["prefill_tokens"] += sum(t for _, t in plan)

    def _chunk_tokens(self, plan: List[Tuple[int, int]], width: int,
                      rows: Optional[List[int]] = None) -> np.ndarray:
        """Each planned slot's next prompt slice in a ``[n, width]`` grid;
        ``rows`` maps plan entries to grid rows of a ``[max_slots, width]``
        grid (default: row j of ``[len(plan), width]``)."""
        n = len(plan) if rows is None else self.config.max_slots
        toks = np.zeros((n, width), np.int32)
        for j, (i, take) in enumerate(plan):
            slot = self._slots[i]
            toks[j if rows is None else rows[j], :take] = \
                slot.req.prompt[slot.filled:slot.filled + take]
        return toks

    def _prefill_chunk_paged(self, plan: List[Tuple[int, int]]) -> torch.Tensor:
        """Chunked suffix prefill against the pool: a slot's resident
        prefix is its prefix-cache hit plus its own earlier chunks, so its
        start may sit inside a block."""
        width = pow2_bucket(max(t for _, t in plan), self.config.prefill_chunk_tokens)
        tokens = torch.as_tensor(self._chunk_tokens(plan, width), device=self.device)
        starts = [self._slots[i].filled for i, _ in plan]
        lengths = torch.as_tensor([t for _, t in plan], dtype=torch.int32, device=self.device)
        rows = torch.as_tensor(np.stack([self._real_row(i) for i, _ in plan]),
                               device=self.device)
        ctx = self._ctx_bucket(max(s + width for s in starts))
        last_logits, self._states = prefill_paged_suffix(
            self.model, self.params, tokens, lengths, self._states, rows,
            torch.as_tensor(starts, dtype=torch.int32, device=self.device), ctx)
        return last_logits

    def _real_row(self, slot_i: int) -> np.ndarray:
        """A PREFILLING slot's block-table row (its device row is scratch)."""
        row = np.zeros(self._table_width, np.int32)
        blocks = self._slot_blocks[slot_i]
        row[: len(blocks)] = blocks
        return row

    def _prefill_chunk_dense(self, plan: List[Tuple[int, int]]) -> torch.Tensor:
        """Chunked dense prefill: one windowed masked scan over the whole
        engine state; the planned slots advance, every other row is gated."""
        width = pow2_bucket(max(t for _, t in plan), self.config.prefill_chunk_tokens)
        b = self.config.max_slots
        tokens = torch.as_tensor(self._chunk_tokens(plan, width, rows=[i for i, _ in plan]),
                                 device=self.device)
        starts = np.zeros(b, np.int64)
        lengths = np.zeros(b, np.int32)
        for i, take in plan:
            starts[i] = self._slots[i].filled
            lengths[i] = take
        last_logits, self._states = prefill_window(
            self.model, self.params, tokens, torch.as_tensor(starts, device=self.device),
            torch.as_tensor(lengths, device=self.device), self._states)
        return last_logits

    def _start_decoding(self, slot_ids: List[int], last_logits: torch.Tensor,
                        rows: List[int]):
        """PREFILLING -> DECODING: sample each completed prompt's first
        token, expose paged table rows, intern prefix blocks."""
        logits = last_logits[torch.as_tensor(rows, device=last_logits.device)]
        first = sample_next_token(logits, self.config.sampler, self._gen, self.model.cfg)
        self._cur_tok[torch.as_tensor(slot_ids, device=self.device)] = first
        first_np = first.cpu().numpy()
        t_first = self.clock()
        for j, i in enumerate(slot_ids):
            slot = self._slots[i]
            req = slot.req
            tok0 = first_np[j]
            slot.state = SlotState.DECODING
            slot.pos = req.prompt_len
            slot.remaining = req.max_new_tokens - 1
            slot.generated = [tok0]
            slot.t_first = t_first
            slot.events = [(t_first, 1)]
            self._prefilling.remove(i)
            if self._paged:
                self._install_blocks(i, self._slot_blocks[i], into_table=True)
                if self._prefix is not None:
                    self._intern_prompt(i, req, slot.cached)
            if self._hit_eos(req, tok0) or slot.remaining == 0:
                self._retire(slot)
                self._release_blocks(i)
                self._slots[i] = None

    # ------------------------------------------------------ paged helpers
    def _release_blocks(self, slot_i: int):
        if not self._paged or not self._slot_blocks[slot_i]:
            return
        for blk in self._slot_blocks[slot_i]:
            self._pool.decref(blk)
        self._slot_blocks[slot_i] = []
        # the retired row points back at scratch: its ride-along writes
        # must not reach a future owner of these blocks
        self._tables_np[slot_i] = 0
        self._tables_dirty = True

    def _block_tables(self) -> BlockTables:
        if self._tables_dirty:
            self._tables_dev = torch.as_tensor(self._tables_np, device=self.device)
            self._tables_dirty = False
        return BlockTables(self._tables_dev)

    # ------------------------------------------------------------- chunk
    def _decode_chunk(self):
        active = [i for i, s in enumerate(self._slots)
                  if s is not None and s.state is SlotState.DECODING]
        if not active:
            return
        steps = min(self.config.chunk_steps, min(self._slots[i].remaining for i in active))
        pos = np.zeros(self.config.max_slots, np.int64)
        for i in active:
            pos[i] = self._slots[i].pos
        mask = None
        if (self._sched is not None and not self._paged
                and len(active) < sum(s is not None for s in self._slots)):
            # dense caches with PREFILLING slots: gate every row but the
            # decoding ones, so half-prefilled states stay as they are
            m = np.zeros(self.config.max_slots, bool)
            m[active] = True
            mask = torch.as_tensor(m, device=self.device)
        t0 = self.clock()
        toks, finite, (next_tok, states, _, _) = self._fused(
            self.params, self._cur_tok, self._states, torch.as_tensor(pos, device=self.device),
            self._gen, steps=steps, sampler=self.config.sampler,
            tables=self._block_tables() if self._paged else None, active=mask)
        self._states = states
        self._cur_tok = next_tok
        toks_np = toks.cpu().numpy()  # [B, steps]
        finite_np = finite.cpu().numpy()  # [B], ANDed over the chunk
        bad = [i for i in active if not finite_np[i]]
        t_now = self.clock()
        self.phase_stats["decode_s"] += t_now - t0
        self.phase_stats["decode_tokens"] += steps * (len(active) - len(bad))
        for i in active:
            if i in bad:
                # sampled from non-finite logits: neither emitted nor
                # counted; the request ends at its pre-fault stream
                self._quarantine(i, FAULT_NONFINITE)
                continue
            slot = self._slots[i]
            slot.generated.append(toks_np[i])
            slot.events.append((t_now, steps))
            slot.pos += steps
            slot.remaining -= steps
            if slot.remaining == 0 or self._hit_eos(slot.req, toks_np[i]):
                self._retire(slot)
                self._release_blocks(i)
                self._slots[i] = None
        if bad:
            # every healthy slot is committed above; the fault names exactly
            # the bad ones, already retired
            raise NonFiniteLogitsError(f"non-finite logits at engine step {self._step_no} "
                                       f"for slot(s) {bad}", slots=tuple(bad))

    def _quarantine(self, slot_i: int, reason: str):
        """End the request in ``slot_i`` at the tokens it had before the
        fault (``fault_reason=reason``) and free the slot.  Its chunk
        advanced the slot's recurrent state and cache past that stream, so
        it cannot go on.  The blocks only it holds are zeroed first:
        attention masks scores, not values, so a NaN left there would reach
        their next owner.  A dense row needs no scrub: admission overwrites
        it whole."""
        slot = self._slots[slot_i]
        gen = np.concatenate(slot.generated, axis=-1) if slot.generated else []
        self._complete(slot.req, gen, slot.t_admit, slot.t_first, slot.events,
                       cached=slot.cached, fault_reason=reason)
        if self._paged:
            own = [b for b in self._slot_blocks[slot_i] if self._pool.ref(b) == 1]
            if own:
                idx = torch.as_tensor(own, device=self.device)
                for st in self._states["layers"]:
                    st.k[idx] = 0
                    st.v[idx] = 0
        self._release_blocks(slot_i)
        self._slots[slot_i] = None
        self._n_quarantined += 1

    # ------------------------------------------------------------ retire
    def _hit_eos(self, req: Request, toks: np.ndarray) -> bool:
        return req.eos_id is not None and bool(np.any(toks == req.eos_id))

    def _trim_eos(self, req: Request, toks: np.ndarray) -> np.ndarray:
        if req.eos_id is None:
            return toks
        hits = np.nonzero(toks == req.eos_id)[0]
        return toks[: hits[0] + 1] if hits.size else toks

    def _retire(self, slot: _Slot):
        gen = self._trim_eos(slot.req, np.concatenate(slot.generated, axis=-1))
        # EOS can cut a chunk short: the last arrival event counts only
        # the tokens actually delivered
        overshoot = sum(n for _, n in slot.events) - int(gen.shape[-1])
        if overshoot > 0 and slot.events:
            t_last, n_last = slot.events[-1]
            slot.events[-1] = (t_last, n_last - overshoot)
        self._complete(slot.req, gen, slot.t_admit, slot.t_first, slot.events,
                       cached=slot.cached)

    def _complete(self, req: Request, gen, t_admit: float, t_first: float,
                  events: List[Tuple[float, int]], cached: int = 0,
                  fault_reason: Optional[str] = None):
        gen = np.asarray(gen, np.int32).reshape(-1)
        hw = None
        if self.config.astra_accounting:
            hw = request_hardware_report(self.model.cfg, self.chip, req.prompt_len,
                                         int(gen.shape[-1]), cached_prompt_len=cached)
        timing = request_timing(req.t_submit, t_admit, t_first, events, self.clock())
        self._outbox.append(RequestOutput(req.id, req.prompt, gen, timing.wall_time_s,
                                          hw, timing, fault_reason))

    # ------------------------------------------------------------- stats
    @property
    def prefix_stats(self) -> Dict[str, int]:
        """Radix-tree/pool counters ({} when the prefix cache is off)."""
        if self._prefix is None:
            return {}
        t = self._prefix
        return {"hits": t.hits, "misses": t.misses, "hit_tokens": t.hit_tokens,
                "evictions": t.evictions, "interned_blocks": len(t),
                "free_blocks": self._pool.n_free}

    @property
    def kv_stats(self) -> Dict[str, object]:
        """Pool counters of the paged layout, with the degraded ladder's
        level and transitions; ``{}`` on the dense layout."""
        if not self._paged:
            return {}
        out: Dict[str, object] = {
            "kv_quant": self.model.opts.kv_quant,
            "block_size": self._block_size,
            "pool_blocks": self._pool.n_blocks,
            "live_blocks": self._pool.n_live,
            "free_blocks": self._pool.n_free,
            "bytes_per_block": self._pool.bytes_per_block,
            "pool_bytes": self._pool.total_bytes,
            "live_bytes": self._pool.live_bytes,
            "prefix_cache": self._prefix is not None,
        }
        if self._prefix is None and self._prefix_off_reason:
            out["prefix_cache_off_reason"] = self._prefix_off_reason
        if self._ladder is not None:
            out["degraded_level"] = self._ladder.level_name
            out["degraded_transitions"] = len(self._ladder.transitions)
            out["prefix_admission"] = self._prefix_admission
        return out

    @property
    def scheduler_stats(self) -> Dict[str, int]:
        """Chunked-prefill counters; ``{"active": False}`` under blocking
        admission."""
        if self._sched is None:
            return {"active": False}
        return {"active": True, **self._sched.stats}

    def stats(self) -> Dict[str, object]:
        """One-call serving snapshot: the fault and degraded-mode counters
        and the per-subsystem stat dicts."""
        return {
            "step": self._step_no,
            "queued": len(self._queue),
            "slots_live": sum(s is not None for s in self._slots),
            "n_quarantined": self._n_quarantined,
            "n_shed": self._n_shed,
            "degraded_level": (self._ladder.level_name if self._ladder is not None
                               else "normal"),
            "degraded_transitions": (list(self._ladder.transitions)
                                     if self._ladder is not None else []),
            "kv": self.kv_stats,
            "prefix": self.prefix_stats,
            "scheduler": self.scheduler_stats,
        }

    # -------------------------------------------------------- convenience
    def generate_batch(self, prompts: Sequence[np.ndarray], max_new_tokens: int,
                       eos_id: Optional[int] = None) -> List[RequestOutput]:
        """Submit a batch and drain — outputs in prompt order."""
        ids = [self.submit(p, max_new_tokens, eos_id) for p in prompts]
        by_id = {o.request_id: o for o in self.run()}
        return [by_id[rid] for rid in ids]
