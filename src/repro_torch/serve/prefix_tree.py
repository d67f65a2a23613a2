"""Radix-tree prefix cache over paged KV blocks.

Interns finished prompt prefixes at **block granularity**: each tree edge
is one block's worth of tokens (``block_size`` positions) keyed by the
raw token bytes, and each node owns exactly one physical block id whose
KV content is the deterministic function of the token path from the root.
A new request walks the tree with its prompt, reuses every matched
block's KV verbatim (zero recompute, zero modeled ASTRA energy), and
prefills only the unmatched suffix.

Block alignment is what makes sharing safe: a shared block is never
written (divergence inside a block means that block simply isn't matched,
so the diverging request gets a private block — copy-on-write without the
copy).  Only *fully prompt-covered* blocks are interned; the partial tail
block and generated tokens stay private to the slot.

Eviction is LRU over **leaves** whose block no live slot holds
(``pool.ref == 1`` — the tree's own reference): evicting inner nodes
first would orphan children whose KV is only valid under their full
prefix path.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.kv_pool import KVBlockPool


class _Node:
    __slots__ = ("children", "parent", "key", "block", "last_use")

    def __init__(self, parent: Optional["_Node"], key: bytes, block: int):
        self.children: Dict[bytes, _Node] = {}
        self.parent = parent
        self.key = key
        self.block = block
        self.last_use = 0


class RadixPrefixTree:
    def __init__(self, block_size: int):
        self.block_size = block_size
        self.root = _Node(None, b"", -1)
        self._clock = 0
        self.n_nodes = 0
        # counters surfaced by the engine / benchmarks
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0

    # ------------------------------------------------------------- keying
    def _chunks(self, tokens: np.ndarray, max_blocks: int) -> List[bytes]:
        """Token array ``[S]`` (or ``[C, S]`` multi-codebook) -> per-block
        byte keys for the first ``max_blocks`` fully covered blocks."""
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        s = tokens.shape[-1]
        n = min(s // self.block_size, max_blocks)
        return [
            np.ascontiguousarray(
                tokens[..., j * self.block_size:(j + 1) * self.block_size]
            ).tobytes()
            for j in range(n)
        ]

    # ------------------------------------------------------------ matching
    def match(self, tokens: np.ndarray, max_blocks: int) -> List[int]:
        """Longest interned block-aligned prefix of ``tokens``.

        Returns the matched physical block ids in order (possibly empty)
        and touches each node's LRU clock.  The caller must ``incref``
        every returned block before anything else can trigger eviction.
        """
        chunks = self._chunks(tokens, max_blocks)
        if not chunks:
            return []  # prompt too short to consult the tree: not a miss
        self._clock += 1
        node = self.root
        blocks: List[int] = []
        for key in chunks:
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = self._clock
            blocks.append(child.block)
            node = child
        if blocks:
            self.hits += 1
            self.hit_tokens += len(blocks) * self.block_size
        else:
            self.misses += 1
        return blocks

    # ------------------------------------------------------------- intern
    def insert(self, tokens: np.ndarray, blocks: List[int], pool: KVBlockPool) -> int:
        """Intern ``tokens``' fully covered prompt blocks, adopting ids
        from ``blocks`` (the owning slot's table, same order).

        Already-interned prefixes keep their existing block (the caller's
        duplicate stays slot-owned and is freed at retire); each newly
        adopted block gets one tree-held reference.  Returns the number of
        blocks adopted.
        """
        self._clock += 1
        node = self.root
        adopted = 0
        for key, block in zip(self._chunks(tokens, len(blocks)), blocks):
            child = node.children.get(key)
            if child is None:
                if block == 0:
                    break  # never intern the scratch sink
                child = _Node(node, key, block)
                node.children[key] = child
                pool.incref(block)
                self.n_nodes += 1
                adopted += 1
            child.last_use = self._clock
            node = child
        return adopted

    # ------------------------------------------------------------ eviction
    def _evictable_leaves(self, pool: KVBlockPool) -> List[_Node]:
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and not n.children and pool.ref(n.block) == 1:
                out.append(n)
        return out

    def evict(self, n_needed: int, pool: KVBlockPool) -> int:
        """Free at least ``n_needed`` blocks by dropping LRU unreferenced
        leaves.  One tree scan seeds the candidate heap; a parent joins it
        when its last child is evicted (pool refs only change through our
        own decrefs here, so incremental maintenance is exact).  Returns
        how many blocks were actually freed."""
        heap = [(n.last_use, i, n) for i, n in enumerate(self._evictable_leaves(pool))]
        heapq.heapify(heap)
        tiebreak = len(heap)
        freed = 0
        while freed < n_needed and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            del parent.children[victim.key]
            pool.decref(victim.block)  # tree-held ref -> 0 -> free list
            self.n_nodes -= 1
            self.evictions += 1
            freed += 1
            if (parent is not self.root and not parent.children
                    and pool.ref(parent.block) == 1):
                heapq.heappush(heap, (parent.last_use, tiebreak, parent))
                tiebreak += 1
        return freed

    def interned_blocks(self) -> List[int]:
        """Every block id the tree currently holds a reference on.

        One entry per node (the tree holds exactly one ref per interned
        block) — this is the tree's leg of ``ServeEngine.audit()``'s
        refcount cross-check.
        """
        out: List[int] = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root:
                out.append(n.block)
        return out

    def __len__(self) -> int:
        return self.n_nodes
