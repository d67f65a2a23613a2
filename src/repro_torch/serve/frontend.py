"""Open-loop serving front-end: admission control and per-token streaming
(port of ``repro.serve.frontend``).

:class:`ServeFrontend` wraps one engine with the policy an open-loop
server needs:

* **admission queue** — a bounded FCFS waiting line in front of the
  engine: ``max_queue_depth`` rejects arrivals to a full queue at once,
  ``queue_timeout_s`` rejects requests that wait too long, and
  ``max_concurrency`` caps the admitted requests in flight.  Every
  rejection is a terminal :class:`~repro_torch.serve.engine.RequestOutput`
  with ``reject_reason`` ("queue_full" | "queue_timeout") and
  queue-wait-only timing.
* **per-token streaming** — the engine's ``token_sink`` feeds each
  request's :class:`TokenStream` and ``on_tokens`` callback as each decode
  chunk completes, token-identical to ``run()``'s outputs; finished outputs
  still flow through ``drain()``/``run()`` exactly once.
* **injected clock** — every timestamp (arrival, queue waits, timeouts,
  deadlines, retry backoff) reads the engine's ``clock``, so a replay on a
  virtual clock is deterministic.
* **faults** — per-request deadlines (a waiting request expires, an
  in-flight one is cancelled mid-decode, its blocks freed), client
  :meth:`ServeFrontend.cancel`, and capped-exponential-backoff retry of
  the retryable fault classes (``serve/faults.py``): the faulted attempt's
  partial stream is withdrawn and the request waits again under its id and
  original arrival time.  Pass an
  :class:`~repro_torch.serve.supervisor.EngineSupervisor` to step the
  engine through the fault-containment layer.

The front-end is single-threaded and never sleeps: ``pump()`` advances one
engine round, and streams pump on demand.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.accounting import RequestTiming
from repro_torch.serve.engine import RequestOutput, ServeEngine
from repro_torch.serve.faults import CANCEL_CLASS, CANCELLED, DEADLINE_EXCEEDED, RETRYABLE_FAULTS
from repro_torch.serve.sampling import empty_tokens

REJECT_QUEUE_FULL = "queue_full"
REJECT_QUEUE_TIMEOUT = "queue_timeout"


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Admission + fault policy for :class:`ServeFrontend`.

    * ``max_queue_depth`` — most requests allowed to *wait* in front of
      the engine; ``0`` means no waiting room (admit-or-reject), ``None``
      means unbounded.
    * ``queue_timeout_s`` — a request waiting longer than this is
      rejected with ``reject_reason="queue_timeout"``; ``None`` waits
      forever.
    * ``max_concurrency`` — most admitted requests in flight inside the
      engine at once; ``None`` means the engine's ``max_slots``.  Must
      not exceed ``max_slots`` (the excess could only sit in the
      engine-internal queue, invisible to the timeout policy).
    * ``default_deadline_s`` — per-request end-to-end deadline measured
      from submission (``submit(deadline_s=...)`` overrides it): a
      waiting request past its deadline terminates immediately, an
      in-flight one is cancelled mid-decode (KV blocks freed), both as
      terminal ``fault_reason="deadline_exceeded"`` outputs.  ``None``
      disables deadlines.
    * ``max_retries`` — attempts *beyond the first* granted to requests
      that end in a retryable fault class (``serve/faults.py``:
      step_error / nonfinite_logits / pool_pressure).  0 disables retry.
    * ``retry_backoff_s`` — base backoff before re-admission; attempt
      ``k`` waits ``min(base * 2**(k-1), 8 * base)`` on the injected
      clock, never ambient time.
    """

    max_queue_depth: Optional[int] = None
    queue_timeout_s: Optional[float] = None
    max_concurrency: Optional[int] = None
    default_deadline_s: Optional[float] = None
    max_retries: int = 0
    retry_backoff_s: float = 0.5

    def __post_init__(self):
        if self.max_queue_depth is not None and self.max_queue_depth < 0:
            raise ValueError(
                f"max_queue_depth={self.max_queue_depth} is negative; pass "
                "a queue capacity >= 0 (0 = no waiting room) or None for "
                "unbounded"
            )
        if self.queue_timeout_s is not None and self.queue_timeout_s <= 0:
            raise ValueError(
                f"queue_timeout_s={self.queue_timeout_s} must be > 0 "
                "(None disables the timeout)"
            )
        if self.max_concurrency is not None and self.max_concurrency < 1:
            raise ValueError(
                f"max_concurrency={self.max_concurrency} must be >= 1 "
                "(None inherits the engine's max_slots)"
            )
        if self.default_deadline_s is not None and self.default_deadline_s <= 0:
            raise ValueError(
                f"default_deadline_s={self.default_deadline_s} must be > 0 "
                "(None disables deadlines)"
            )
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries={self.max_retries} is negative (0 disables "
                "retry)"
            )
        if self.retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s={self.retry_backoff_s} is negative"
            )


@dataclasses.dataclass
class _Pending:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    t_enqueue: float


class TokenStream:
    """Per-token iterator over one request's generated tokens.

    Iterating yields one token at a time (a scalar array, or ``[C]`` for
    multi-codebook models) as soon as the fused chunk that produced it
    completes; ``__next__`` pumps the front-end until a token is
    available or the request finishes.  After exhaustion (or an
    up-front rejection) ``output`` holds the terminal
    :class:`RequestOutput`.  The concatenation of the yielded tokens is
    exactly ``output.tokens``.

    Retry caveat: when a faulted attempt is retried, its not-yet-consumed
    buffered tokens are withdrawn and the stream restarts from the retry
    attempt's first token — tokens a caller already pulled out cannot be
    unseen, so consume streams only if retries are off or duplicates are
    acceptable (the replay harness uses the ``on_retry`` hook to keep its
    accounting exact)."""

    def __init__(self, frontend: "ServeFrontend", request_id: int):
        self._fe = frontend
        self.request_id = request_id
        self.output: Optional[RequestOutput] = None
        self._buf: Deque[np.ndarray] = deque()

    def _push(self, toks: np.ndarray) -> None:
        for j in range(toks.shape[-1]):
            self._buf.append(np.asarray(toks[..., j]))

    @property
    def finished(self) -> bool:
        return self.output is not None

    def __iter__(self) -> "TokenStream":
        return self

    def __next__(self) -> np.ndarray:
        while not self._buf:
            if self.output is not None:
                raise StopIteration
            if not self._fe.busy():
                raise RuntimeError(
                    f"token stream for request {self.request_id} stalled: "
                    "front-end is idle but the request never finished"
                )
            self._fe.pump()
        return self._buf.popleft()


class ServeFrontend:
    """Admission-controlled, streaming wrapper around one ``ServeEngine``.

    The front-end owns the engine's request-id space
    (``engine.allocate_request_id``) and its submission timestamps:
    ``Request.t_submit`` is stamped at *front-end* admission, so queue
    waits spent under backpressure — and the waits of requests that end
    up rejected — are visible in every ``RequestTiming``.

    ``supervisor`` (optional, must wrap this same engine) routes every
    engine round through the fault-containment layer
    (:class:`~repro_torch.serve.supervisor.EngineSupervisor`): injected faults
    fire, faulted slots quarantine, and the per-step audit runs.  Without
    one, engine faults propagate out of :meth:`pump` unhandled.
    """

    def __init__(self, engine: ServeEngine,
                 config: Optional[FrontendConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 supervisor=None):
        # None sentinel for the same reason as ServeEngine: never share a
        # module-level default instance across front-ends
        config = FrontendConfig() if config is None else config
        if config.max_concurrency is not None \
                and config.max_concurrency > engine.config.max_slots:
            raise ValueError(
                f"max_concurrency={config.max_concurrency} exceeds the "
                f"engine's max_slots={engine.config.max_slots}: the excess "
                "would wait in the engine-internal queue, outside the "
                "queue-timeout policy"
            )
        if supervisor is not None and supervisor.engine is not engine:
            raise ValueError(
                "supervisor wraps a different engine than this front-end; "
                "fault containment and admission must act on one engine"
            )
        self.engine = engine
        self.config = config
        self.clock = clock or engine.clock
        self.supervisor = supervisor
        self._stepper = engine.step if supervisor is None else supervisor.step
        self._max_inflight = config.max_concurrency or engine.config.max_slots
        self._waiting: Deque[_Pending] = deque()
        self._inflight: set = set()
        # full request records for everything forwarded (retry needs them)
        self._inflight_info: Dict[int, _Pending] = {}
        self._deadlines: Dict[int, float] = {}  # rid -> absolute deadline
        self._retry_wait: List[Tuple[float, _Pending]] = []  # (ready_at, p)
        self._attempts: Dict[int, int] = {}  # rid -> retries consumed
        self._outbox: List[RequestOutput] = []
        self._streams: Dict[int, TokenStream] = {}
        self._callbacks: Dict[int, Callable[[np.ndarray], None]] = {}
        # fired with the request id whenever a faulted attempt is retried
        # (the replay harness resets its per-request token accounting here)
        self.on_retry: Optional[Callable[[int], None]] = None
        # counters surfaced as `.stats`
        self._n_submitted = 0
        self._n_completed = 0
        self._n_rejected = {REJECT_QUEUE_FULL: 0, REJECT_QUEUE_TIMEOUT: 0}
        self._n_faulted = 0
        self._n_cancelled = 0
        self._n_retries = 0
        self._hw_queue_depth = 0  # high-water mark of the waiting line
        # incremental drain: route engine token chunks to streams/callbacks
        # (chain, so an externally installed sink keeps working)
        self._prev_sink = engine.token_sink
        engine.token_sink = self._route_tokens

    # ------------------------------------------------------------ intake
    def submit(self, prompt, max_new_tokens: int, eos_id: Optional[int] = None,
               on_tokens: Optional[Callable[[np.ndarray], None]] = None,
               deadline_s: Optional[float] = None) -> int:
        """Admit (or reject) one request; returns its request id.

        ``on_tokens`` (optional) is called with each freshly generated
        token chunk (``[k]`` or ``[C, k]``) as it completes — the callback
        flavour of :meth:`stream`.  ``deadline_s`` (optional) overrides
        ``config.default_deadline_s`` for this request.  Rejection is
        immediate only for a full queue; queue timeouts surface from a
        later ``pump()``.  Either way the terminal output arrives through
        ``drain()``/``run()``.
        """
        prompt = self.engine.check_request(prompt, max_new_tokens)
        rid = self.engine.allocate_request_id()
        if on_tokens is not None:
            self._callbacks[rid] = on_tokens
        self._admit(rid, prompt, max_new_tokens, eos_id, deadline_s)
        return rid

    def stream(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None) -> TokenStream:
        """Admit one request and return its per-token iterator.

        A request rejected at admission returns an already-finished
        stream (``output.reject_reason`` set, zero tokens)."""
        prompt = self.engine.check_request(prompt, max_new_tokens)
        rid = self.engine.allocate_request_id()
        # register before admitting: a gen_len==0 or instantly-rejected
        # request finishes inside _admit
        s = TokenStream(self, rid)
        self._streams[rid] = s
        self._admit(rid, prompt, max_new_tokens, eos_id, deadline_s)
        return s

    def _admit(self, rid: int, prompt: np.ndarray, max_new_tokens: int,
               eos_id: Optional[int],
               deadline_s: Optional[float] = None) -> None:
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s={deadline_s} must be > 0")
        now = self.clock()
        self._n_submitted += 1
        deadline = (deadline_s if deadline_s is not None
                    else self.config.default_deadline_s)
        if deadline is not None:
            self._deadlines[rid] = now + deadline
        self._expire(now)
        self._waiting.append(_Pending(rid, prompt, max_new_tokens, eos_id, now))
        self._forward(now)
        if (self.config.max_queue_depth is not None
                and len(self._waiting) > self.config.max_queue_depth):
            # the newest arrival is the overflow: everyone ahead was within
            # bound when they were admitted (invariant: depth <= max before
            # every append)
            p = self._waiting.pop()
            self._reject(p.rid, p.prompt, now, now, REJECT_QUEUE_FULL)
        else:
            self._hw_queue_depth = max(self._hw_queue_depth, len(self._waiting))

    # ------------------------------------------------------------- engine
    def busy(self) -> bool:
        return bool(self._waiting or self._inflight or self._retry_wait)

    def pump(self) -> None:
        """One scheduling round: expire timed-out waiters, enforce
        deadlines, re-admit retries whose backoff elapsed, forward into
        the engine up to ``max_concurrency``, run one engine round
        (through the supervisor when present), route finished outputs.
        Outputs accumulate for ``drain()``."""
        now = self.clock()
        self._expire(now)
        self._check_deadlines(now)
        now = self._revive_retries(now)
        self._forward(now)
        if self.engine.has_work() or self._inflight:
            for out in self._stepper():
                self._finish(out)

    def drain(self) -> List[RequestOutput]:
        """Hand over every output finished since the last collection —
        served and rejected alike — exactly once."""
        outs, self._outbox = self._outbox, []
        return outs

    def run(self) -> List[RequestOutput]:
        """Pump until idle; returns all pending outputs in id order."""
        outs = self.drain()
        while self.busy():
            self.pump()
            outs.extend(self.drain())
        return sorted(outs, key=lambda o: o.request_id)

    # -------------------------------------------------------------- faults
    def cancel(self, request_id: int) -> bool:
        """Client cancellation: terminate a waiting, backing-off, or
        in-flight request.  Mid-decode cancellation frees the request's
        KV blocks immediately (``engine.cancel`` → quarantine); the
        terminal ``fault_reason="cancelled"`` output arrives through
        ``drain()``.  Returns False for unknown/finished ids."""
        now = self.clock()
        for j, p in enumerate(self._waiting):
            if p.rid == request_id:
                del self._waiting[j]
                self._fault_terminal(p, CANCELLED, now)
                return True
        for j, (_t, p) in enumerate(self._retry_wait):
            if p.rid == request_id:
                del self._retry_wait[j]
                self._fault_terminal(p, CANCELLED, now)
                return True
        if request_id in self._inflight:
            # output flows back through the engine outbox on the next pump
            return self.engine.cancel(request_id, CANCELLED)
        return False

    def _check_deadlines(self, now: float) -> None:
        for rid, deadline in list(self._deadlines.items()):
            if now < deadline:
                continue
            handled = False
            for j, p in enumerate(self._waiting):
                if p.rid == rid:
                    del self._waiting[j]
                    self._fault_terminal(p, DEADLINE_EXCEEDED, now)
                    handled = True
                    break
            if not handled:
                for j, (_t, p) in enumerate(self._retry_wait):
                    if p.rid == rid:
                        del self._retry_wait[j]
                        self._fault_terminal(p, DEADLINE_EXCEEDED, now)
                        handled = True
                        break
            if not handled and rid in self._inflight:
                self.engine.cancel(rid, DEADLINE_EXCEEDED)
                self._deadlines.pop(rid, None)

    def _revive_retries(self, now: float) -> float:
        """Move retries whose backoff elapsed to the *front* of the
        waiting line (they already waited a full queue pass).  When
        future retries are the only remaining work, advance an
        advanceable (virtual) clock to the earliest ready time so
        ``run()`` terminates deterministically instead of spinning."""
        if not self._retry_wait:
            return now
        if (not self._waiting and not self._inflight
                and not self.engine.has_work()):
            t_next = min(t for t, _ in self._retry_wait)
            advance = getattr(self.clock, "advance", None)
            if t_next > now and advance is not None:
                advance(t_next - now)
                now = self.clock()
        ready = sorted([e for e in self._retry_wait if e[0] <= now],
                       key=lambda e: e[0], reverse=True)
        if ready:
            self._retry_wait = [e for e in self._retry_wait if e[0] > now]
            for _t, p in ready:
                self._waiting.appendleft(p)
        return now

    def _fault_terminal(self, p: _Pending, reason: str, now: float) -> None:
        """Terminal fault output for a request that never (re)reached the
        engine: queue-wait-only timing, like a rejection."""
        wait = max(now - p.t_enqueue, 0.0)
        timing = RequestTiming(queue_time_s=wait, ttft_s=0.0, wall_time_s=wait,
                               mean_itl_s=0.0, max_itl_s=0.0, n_token_events=0)
        out = RequestOutput(p.rid, p.prompt, empty_tokens(p.prompt),
                            wall_time_s=wait, hardware=None, timing=timing,
                            fault_reason=reason)
        self._finish(out)

    # ------------------------------------------------------------ internals
    def _expire(self, now: float) -> None:
        timeout = self.config.queue_timeout_s
        if timeout is None:
            return
        # t_enqueue is nondecreasing along the FCFS deque, so expired
        # requests are always a prefix... except revived retries, whose
        # enqueue times are older still — also a prefix, so still correct
        while self._waiting and now - self._waiting[0].t_enqueue >= timeout:
            p = self._waiting.popleft()
            self._reject(p.rid, p.prompt, p.t_enqueue, now, REJECT_QUEUE_TIMEOUT)

    def _forward(self, now: float) -> None:
        forwarded = False
        while self._waiting and len(self._inflight) < self._max_inflight:
            p = self._waiting.popleft()
            self._inflight.add(p.rid)
            self._inflight_info[p.rid] = p
            self.engine.submit(p.prompt, p.max_new_tokens, p.eos_id,
                               request_id=p.rid, t_submit=p.t_enqueue)
            forwarded = True
        if forwarded:
            # max_new_tokens==0 requests complete synchronously inside
            # engine.submit; collect them now so their streams finish at
            # admission rather than on the next pump
            for out in self.engine._drain():
                self._finish(out)

    def _route_tokens(self, rid: int, toks: np.ndarray) -> None:
        if self._prev_sink is not None:
            self._prev_sink(rid, toks)
        cb = self._callbacks.get(rid)
        if cb is not None:
            cb(toks)
        s = self._streams.get(rid)
        if s is not None:
            s._push(toks)

    def _finish(self, out: RequestOutput) -> None:
        rid = out.request_id
        p = self._inflight_info.pop(rid, None)
        self._inflight.discard(rid)
        if (out.fault_reason in RETRYABLE_FAULTS and p is not None
                and self._attempts.get(rid, 0) < self.config.max_retries):
            # retry instead of terminal delivery: same rid, original
            # submission time, capped exponential backoff on the injected
            # clock.  The faulted attempt's partial stream is withdrawn.
            attempt = self._attempts[rid] = self._attempts.get(rid, 0) + 1
            self._n_retries += 1
            base = self.config.retry_backoff_s
            delay = min(base * (2 ** (attempt - 1)), 8 * base)
            self._retry_wait.append((self.clock() + delay, p))
            s = self._streams.get(rid)
            if s is not None:
                s._buf.clear()
            if self.on_retry is not None:
                self.on_retry(rid)
            return
        self._deadlines.pop(rid, None)
        self._attempts.pop(rid, None)
        if out.reject_reason is not None:
            pass  # counted at the _reject site
        elif out.fault_reason is None:
            self._n_completed += 1
        elif out.fault_reason in CANCEL_CLASS:
            self._n_cancelled += 1
        else:
            self._n_faulted += 1
        self._outbox.append(out)
        self._callbacks.pop(rid, None)
        s = self._streams.pop(rid, None)
        if s is not None:
            s.output = out

    def _reject(self, rid: int, prompt: np.ndarray, t_submit: float,
                now: float, reason: str) -> None:
        wait = max(now - t_submit, 0.0)
        timing = RequestTiming(queue_time_s=wait, ttft_s=0.0, wall_time_s=wait,
                               mean_itl_s=0.0, max_itl_s=0.0, n_token_events=0)
        out = RequestOutput(rid, prompt, empty_tokens(prompt),
                            wall_time_s=wait, hardware=None, timing=timing,
                            reject_reason=reason)
        self._n_rejected[reason] += 1
        self._finish(out)

    # -------------------------------------------------------------- stats
    @property
    def stats(self) -> Dict[str, int]:
        """Admission and fault counters.  Conservation: ``submitted ==
        completed + rejected_* + faulted + cancelled + queue_depth +
        in_flight + retry_pending`` at every quiescent point."""
        return {
            "submitted": self._n_submitted,
            "completed": self._n_completed,
            "rejected_queue_full": self._n_rejected[REJECT_QUEUE_FULL],
            "rejected_queue_timeout": self._n_rejected[REJECT_QUEUE_TIMEOUT],
            "faulted": self._n_faulted,
            "cancelled": self._n_cancelled,
            "retries": self._n_retries,
            "retry_pending": len(self._retry_wait),
            "max_queue_depth": self._hw_queue_depth,
            "queue_depth": len(self._waiting),
            "in_flight": len(self._inflight),
        }
