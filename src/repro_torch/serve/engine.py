"""Continuous-batching serve engine over the paged KV pool.

Port of ``repro.serve.engine`` for this slice: blocking admission on the
paged layout with radix-tree prefix reuse, chunked decode, retirement and
the exactly-once outbox.  The engine owns ``max_slots`` decode slots and
one block pool per layer; requests flow

  queue -> [admit: claim a free slot, reserve blocks (reusing interned
            prefix blocks)] -> [suffix prefill of the unmatched prompt]
        -> [decode chunks of ``min(chunk_steps, min(remaining))`` steps]
        -> [retire: release blocks, timing, outbox]

Every decode step runs all ``max_slots`` rows, free ones included (at
position 0 with a stale token, their writes landing in scratch block 0),
exactly as the reference does: under a plan with dynamic int8 scales the
activation absmax spans every row, so the port must carry the same rows
to give the same tokens.  The dense layout, chunked prefill, KV
quantization, fault containment and the chip-model accounting come with
later slices (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.plan import model_sites
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import BlockTables
from repro_torch.models.model import Model
from repro_torch.serve.accounting import RequestTiming, request_timing
from repro_torch.serve.clock import resolve_clock
from repro_torch.serve.decode_loop import make_fused_decode
from repro_torch.serve.kv_pool import KVBlockPool
from repro_torch.serve.prefill import pack_prompts, prefill_paged_suffix
from repro_torch.serve.prefix_tree import RadixPrefixTree
from repro_torch.serve.sampling import GREEDY, SamplerConfig, sample_next_token
from repro_torch.serve.scheduler import pow2_bucket
from repro_torch.serve.slots import SlotState


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_slots: int = 8
    max_len: int = 256  # per-slot positions (prompt + generated)
    chunk_steps: int = 8  # decode steps per engine round
    sampler: SamplerConfig = GREEDY
    seed: int = 0
    kv_block_size: int = 16  # positions per pool block; must be > 0 in this slice
    kv_pool_blocks: int = 0  # physical blocks incl. scratch; 0 = slot floor + 2 slots
    prefix_cache: bool = True  # radix-tree prefix reuse
    attn_impl: Optional[str] = None  # None inherits the model's; "naive" | "flash"


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
    hardware: None = None  # modeled chip cost: arrives with the chip-model slice
    timing: Optional[RequestTiming] = None

    @property
    def gen_len(self) -> int:
        return int(self.tokens.shape[-1])


@dataclasses.dataclass
class _Slot:
    req: Request
    state: SlotState
    pos: int = 0  # absolute position of the next decode write
    remaining: int = 0  # tokens still to generate
    generated: List[np.ndarray] = dataclasses.field(default_factory=list)
    cached: int = 0  # prompt tokens served from the prefix cache
    t_admit: float = 0.0
    t_first: float = 0.0
    events: List[Tuple[float, int]] = dataclasses.field(default_factory=list)


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


class ServeEngine:
    def __init__(self, model: Model, params, config: Optional[ServeConfig] = None, *,
                 device: DeviceLike = None, clock: Optional[Callable[[], float]] = None):
        """``device=None`` means the card (raises without one); it must be
        the model's device.  ``clock`` replaces the wall clock for every
        timestamp (a replay harness passes a virtual one)."""
        config = ServeConfig() if config is None else config
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        if config.attn_impl is not None and config.attn_impl != model.opts.attn_impl:
            model = dataclasses.replace(
                model, opts=dataclasses.replace(model.opts, attn_impl=config.attn_impl))
        if config.kv_block_size <= 0:
            raise ValueError(
                f"kv_block_size={config.kv_block_size}: the dense per-slot KV layout "
                "is not ported yet (ROADMAP queue 1: dense layout); use a paged "
                "block size > 0")
        cfg = model.cfg
        if any(k != "attn" for k in cfg.layer_kinds):
            raise NotImplementedError(f"{cfg.name}: serving ports pure global-attention "
                                      "stacks only (ROADMAP queue 1: other block kinds)")
        self.model = model
        self.params = model.prepare(params)
        self.config = config
        self.clock = resolve_clock(clock)
        self._fused = make_fused_decode(model)
        self._queue: deque[Request] = deque()
        self._slots: List[Optional[_Slot]] = [None] * config.max_slots
        self._outbox: List[RequestOutput] = []
        self._next_id = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)
        # ----------------------------------------------------- KV layout
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
        self._prefix: Optional[RadixPrefixTree] = None
        self._prefix_off_reason: Optional[str] = None
        if not config.prefix_cache:
            self._prefix_off_reason = "disabled by config (prefix_cache=False)"
        elif not _kv_deterministic(model):
            self._prefix_off_reason = (
                "non-deterministic KV: a quantized GEMM site runs with dynamic "
                "scales (calibrated static scales arrive with the calibration slice)")
        else:
            self._prefix = RadixPrefixTree(bs)
        self._states = model.init_decode_state(config.max_slots, config.max_len,
                                               paged=(n_blocks, bs))
        self._pool.bytes_per_block = sum(
            t[0].numel() * t.element_size() for st in self._states["layers"] for t in st)
        self._cur_tok = torch.zeros((config.max_slots, 1), dtype=torch.int32,
                                    device=self.device)
        # host-clock seconds and tokens of admission prefills and decode
        # chunks; each phase ends with its tokens on the host, so the
        # device work is inside the interval
        self.phase_stats = {"prefill_s": 0.0, "prefill_tokens": 0,
                            "decode_s": 0.0, "decode_tokens": 0}

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
        """Admit + prefill, then one decode chunk; returns what finished."""
        self._admit()
        self._decode_chunk()
        return self._drain()

    def _drain(self) -> List[RequestOutput]:
        outs, self._outbox = self._outbox, []
        return outs

    # ------------------------------------------------------------- admit
    def _admit(self):
        free = [i for i, s in enumerate(self._slots) if s is None]
        n = min(len(free), len(self._queue))
        if n == 0:
            return
        slot_ids = free[:n]
        reqs = [self._queue.popleft() for _ in range(n)]
        t_admit = self.clock()
        slot_ids, reqs, last_logits, cached = self._prefill_paged(slot_ids, reqs)
        if not reqs:
            return
        first = sample_next_token(last_logits, self.config.sampler, self._gen, self.model.cfg)
        self._cur_tok[torch.as_tensor(slot_ids, device=self.device)] = first
        first_np = first.cpu().numpy()
        t_first = self.clock()
        self.phase_stats["prefill_s"] += t_first - t_admit
        self.phase_stats["prefill_tokens"] += sum(r.prompt_len - c for r, c in zip(reqs, cached))
        for j, (i, req) in enumerate(zip(slot_ids, reqs)):
            tok0 = first_np[j]
            slot = _Slot(req, SlotState.DECODING, pos=req.prompt_len,
                         remaining=req.max_new_tokens - 1, generated=[tok0],
                         cached=cached[j], t_admit=t_admit, t_first=t_first,
                         events=[(t_first, 1)])
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
        if self._prefix is not None:
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

    def _prefill_paged(self, slot_ids: List[int], reqs: List[Request]):
        """Reserve blocks (reusing interned prefix blocks), prefill the
        unmatched suffixes in one packed pass, intern new prompt blocks.
        A request whose blocks cannot be covered goes back to the queue
        front with every later one (FCFS)."""
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
                break
            self._slot_blocks[i] = blocks
            self._tables_np[i] = 0
            self._tables_np[i, : len(blocks)] = blocks
            self._tables_dirty = True
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

    def _release_blocks(self, slot_i: int):
        if not self._slot_blocks[slot_i]:
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
        t0 = self.clock()
        toks, finite, (next_tok, states, _, _) = self._fused(
            self.params, self._cur_tok, self._states, torch.as_tensor(pos, device=self.device),
            self._gen, steps=steps, sampler=self.config.sampler,
            tables=self._block_tables())
        self._states = states
        self._cur_tok = next_tok
        toks_np = toks.cpu().numpy()  # [B, steps]
        finite_np = finite.cpu().numpy()
        bad = [i for i in active if not finite_np[i]]
        if bad:
            raise FloatingPointError(f"non-finite logits for slot(s) {bad}; fault "
                                     "containment arrives with the faults slice")
        t_now = self.clock()
        self.phase_stats["decode_s"] += t_now - t0
        self.phase_stats["decode_tokens"] += steps * len(active)
        for i in active:
            slot = self._slots[i]
            slot.generated.append(toks_np[i])
            slot.events.append((t_now, steps))
            slot.pos += steps
            slot.remaining -= steps
            if slot.remaining == 0 or self._hit_eos(slot.req, toks_np[i]):
                self._retire(slot)
                self._release_blocks(i)
                self._slots[i] = None

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
        self._complete(slot.req, gen, slot.t_admit, slot.t_first, slot.events)

    def _complete(self, req: Request, gen, t_admit: float, t_first: float,
                  events: List[Tuple[float, int]]):
        gen = np.asarray(gen, np.int32).reshape(-1)
        timing = request_timing(req.t_submit, t_admit, t_first, events, self.clock())
        self._outbox.append(RequestOutput(req.id, req.prompt, gen, timing.wall_time_s,
                                          None, timing))

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
        return out

    # -------------------------------------------------------- convenience
    def generate_batch(self, prompts: Sequence[np.ndarray], max_new_tokens: int,
                       eos_id: Optional[int] = None) -> List[RequestOutput]:
        """Submit a batch and drain — outputs in prompt order."""
        ids = [self.submit(p, max_new_tokens, eos_id) for p in prompts]
        by_id = {o.request_id: o for o in self.run()}
        return [by_id[rid] for rid in ids]
