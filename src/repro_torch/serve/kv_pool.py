"""Host-side block allocator for the paged KV cache.

The serve engine's paged mode stores attention KV in fixed-size *blocks*
(``block_size`` token positions each) drawn from one global pool per
attention layer.  All layers share a single **block-id space**: a slot's
block table (``[W]`` physical ids, ``W = ceil(max_len / block_size)``)
indexes every layer's pool tensor at once, vLLM-style.  This module is
the host-side bookkeeping only — the device tensors live inside the
engine's state pytree (:class:`repro_torch.models.attention.PagedKVCache`).

Invariants (docs/SERVING.md has the full memory model):

* **Block 0 is the scratch sink.**  It is never allocated, never
  interned, and never read at a maskable position — table entries beyond
  a slot's allocated region point at it, so padded/overrun writes from
  packed prefill land somewhere harmless instead of corrupting a
  neighbour's blocks.
* **Ref-counted sharing.**  A block's refcount is (#slots holding it in
  their table) + (1 if the radix prefix tree has interned it).  Blocks
  return to the free list only at refcount zero; double-free raises.
* **Immutable when shared.**  The engine only ever writes a block it
  allocated for the writing slot (prefix matching is block-aligned, so
  the diverging block is always private) — copy-on-write reduces to
  "divergence allocates, never mutates".
"""
from __future__ import annotations

from typing import List


class KVBlockPool:
    """Free-list + refcount allocator over ``n_blocks`` physical blocks."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(f"pool needs >= 2 blocks (1 scratch + 1 usable), got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # storage bytes per physical block summed across every layer's K+V
        # pool tensors, at their actual dtype (int8 under kv_quant).  The
        # engine stamps this after building the device pools; it is the
        # unit of all serve-side KV byte accounting (docs/SERVING.md §KV
        # quantization).
        self.bytes_per_block = 0
        # block 0 reserved as the scratch sink; pop() hands out low ids first
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._ref = [0] * n_blocks

    # ------------------------------------------------------------- queries
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        """Blocks currently held (excludes scratch and the free list)."""
        return self.n_blocks - 1 - len(self._free)

    def ref(self, block: int) -> int:
        return self._ref[block]

    @property
    def total_bytes(self) -> int:
        """Allocatable pool storage (scratch block 0 excluded)."""
        return (self.n_blocks - 1) * self.bytes_per_block

    @property
    def live_bytes(self) -> int:
        """Storage held by live blocks (refcount > 0)."""
        return self.n_live * self.bytes_per_block

    # ------------------------------------------------------------ lifetime
    def alloc(self, n: int) -> List[int]:
        """Hand out ``n`` fresh blocks at refcount 1.

        Raises ``RuntimeError`` on exhaustion — the engine sizes the pool
        so that (after evicting every tree-only block) admission can never
        hit this; see ``ServeEngine``'s construction-time assertion.
        """
        if n > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: need {n} blocks, {len(self._free)} free "
                f"of {self.n_blocks - 1} allocatable"
            )
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, block: int) -> None:
        if block == 0:
            raise ValueError("scratch block 0 is not ref-counted")
        if self._ref[block] <= 0:
            raise ValueError(f"incref on free block {block}")
        self._ref[block] += 1

    def decref(self, block: int) -> None:
        """Drop one reference; a block at zero returns to the free list."""
        if block == 0:
            raise ValueError("scratch block 0 is not ref-counted")
        if self._ref[block] <= 0:
            raise ValueError(f"double free of block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)

    # --------------------------------------------------------------- audit
    def check_consistent(self) -> None:
        """Free-list/refcount cross-check (``ServeEngine.audit()`` leg).

        The free list must be duplicate-free, scratch-free, and must
        contain *exactly* the zero-refcount non-scratch blocks — a block
        in both worlds (free yet referenced) or in neither (leaked) is a
        bug in release/quarantine bookkeeping.  Raises ``RuntimeError``.
        """
        free = set(self._free)
        if len(free) != len(self._free):
            raise RuntimeError("KV pool corrupt: duplicate blocks in free list")
        if 0 in free:
            raise RuntimeError("KV pool corrupt: scratch block 0 on free list")
        zero_ref = {b for b in range(1, self.n_blocks) if self._ref[b] == 0}
        if free != zero_ref:
            leaked = sorted(zero_ref - free)
            phantom = sorted(free - zero_ref)
            raise RuntimeError(
                "KV pool corrupt: free list != zero-ref blocks "
                f"(leaked={leaked[:8]}, free-but-referenced={phantom[:8]})"
            )
