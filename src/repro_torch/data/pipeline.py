"""Deterministic synthetic LM data pipeline with straggler mitigation.

Port of ``repro.data.pipeline``; the numpy draws are the reference's, so
``batch_at(step)`` gives the reference's batches bit for bit (tokens,
codebook grids, vision embeddings), as numpy arrays.  :func:`batch_to`
moves one onto a device.

* **Step-addressable determinism** — ``batch_at(step)`` is a pure function
  of ``(seed, step)``, so a restarted job resumes with exactly the batch
  sequence it would have seen, with no data-loader state to checkpoint.
* **Learnable structure** — tokens follow a seeded order-1 Markov chain
  with a skewed transition table plus periodic copy spans, so small models
  show a falling loss within a few steps.
* **Straggler mitigation** — :class:`Prefetcher` produces batches on a
  background thread with a bounded queue; if the producer misses the
  ``timeout_s`` deadline, the consumer substitutes the deterministic
  backup batch for that step and counts the substitution.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_codebooks: int = 0  # audio grids: tokens [B, C, S]
    vision_tokens: int = 0  # vlm: attach stub patch embeddings
    d_model: int = 0  # embedding dim for vision stub
    copy_period: int = 64  # every k-th position starts a copy span
    copy_len: int = 8
    menu_size: int = 8  # successors per state (smaller => more learnable)
    greedy_p: float = 0.9  # probability of taking a menu successor


class SyntheticLMDataset:
    """Order-1 Markov token stream, step-addressable."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # skewed per-state successor menu: each state transitions to one of
        # ``menu_size`` preferred successors with p=greedy_p, else uniform.
        # Small menu => low conditional entropy => learnable by tiny models
        # in a few steps.
        self._menu = rng.integers(0, v, size=(min(v, 4096), cfg.menu_size), dtype=np.int64)

    def batch_at(self, step: int) -> Dict[str, Any]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b = cfg.global_batch
        rows = b * max(cfg.n_codebooks, 1)
        s = cfg.seq_len
        v = cfg.vocab
        n_states = self._menu.shape[0]
        toks = np.empty((rows, s), dtype=np.int64)
        toks[:, 0] = rng.integers(0, v, size=rows)
        greedy = rng.random((rows, s)) < cfg.greedy_p
        choice = rng.integers(0, cfg.menu_size, size=(rows, s))
        uniform = rng.integers(0, v, size=(rows, s))
        for t in range(1, s):
            prev = toks[:, t - 1] % n_states
            toks[:, t] = np.where(greedy[:, t], self._menu[prev, choice[:, t]], uniform[:, t])
        # copy spans: repeat the previous ``copy_len`` tokens verbatim
        if cfg.copy_period and s > 2 * cfg.copy_len:
            for start in range(cfg.copy_period, s - cfg.copy_len, cfg.copy_period):
                toks[:, start : start + cfg.copy_len] = toks[:, start - cfg.copy_len : start]
        toks = toks.astype(np.int32)
        if cfg.n_codebooks:
            toks = toks.reshape(b, cfg.n_codebooks, s)
        batch: Dict[str, Any] = {"tokens": toks}
        if cfg.vision_tokens:
            emb = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
            batch["vision_embeds"] = emb
        return batch


class Prefetcher:
    """Bounded background prefetch with a straggler deadline.

    ``get(step)`` returns the batch for ``step``; if the producer thread has
    not delivered it within ``timeout_s`` the deterministic backup batch
    (computed synchronously) is substituted — the training loop never stalls
    on one slow input shard.
    """

    def __init__(self, dataset: SyntheticLMDataset, depth: int = 2,
                 timeout_s: float = 30.0, delay_injector=None):
        self.dataset = dataset
        self.timeout_s = timeout_s
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next_step = 0
        self._delay = delay_injector  # callable(step) -> seconds, for tests
        self.substituted_steps: list = []
        self._thread: Optional[threading.Thread] = None

    def start(self, first_step: int = 0):
        self._next_step = first_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        step = self._next_step
        while not self._stop.is_set():
            if self._delay is not None:
                d = self._delay(step)
                if d:
                    self._stop.wait(d)
            batch = self.dataset.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self, step: int) -> Dict[str, Any]:
        try:
            got_step, batch = self._q.get(timeout=self.timeout_s)
            if got_step == step:
                return batch
            # mismatch (e.g. a restart rewound the step counter): determinism
            # beats pipelining — recompute synchronously.
            return self.dataset.batch_at(step)
        except queue.Empty:
            self.substituted_steps.append(step)
            return self.dataset.batch_at(step)  # deterministic backup

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A ``batch_at`` batch as tensors on ``device`` (dtypes kept: int32
    tokens, float32 vision embeddings)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def make_batch_iterator(cfg: DataConfig, device=None,
                        first_step: int = 0) -> Iterator[Dict[str, Any]]:
    """Synchronous iterator from ``first_step``: numpy batches, or tensors
    on ``device`` when one is given."""
    ds = SyntheticLMDataset(cfg)
    step = first_step
    while True:
        batch = ds.batch_at(step)
        yield batch if device is None else batch_to(batch, device)
        step += 1
