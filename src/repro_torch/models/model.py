"""Model facade (port of ``repro.models.model``): config + options + device."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import (
    ModelOptions, decode_step, forward, init_decode_state, init_params, prepare_params,
    suffix_forward,
)


@dataclasses.dataclass(frozen=True)
class Model:
    """``device=None`` means the card (raises without one); pass
    ``device="cpu"`` to run the plain PyTorch paths on the CPU."""

    cfg: ArchConfig
    opts: ModelOptions = ModelOptions()
    device: DeviceLike = None

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def plan(self) -> ExecutionPlan:
        return self.opts.plan

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0) -> Dict[str, Any]:
        return init_params(self.cfg, seed, self.device)

    def prepare(self, params) -> Dict[str, Any]:
        """Params with this plan's per-weight caches (int8 codes, cast copies)."""
        return prepare_params(params, self.cfg, self.plan)

    # ------------------------------------------------------------- serve
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Full-sequence pass; returns (logits, dense per-layer KV caches
        padded to ``max_len``)."""
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return forward(params, tokens, self.cfg, self.opts, return_states=True,
                       max_len=max_len)

    def decode(self, params, token, states, pos, block_tables=None):
        return decode_step(params, token, states, pos, self.cfg, self.opts,
                           block_tables=block_tables)

    def prefill_suffix(self, params, tokens, states, table, start, ctx_blocks: int):
        return suffix_forward(params, tokens, self.cfg, self.opts, states, table, start,
                              ctx_blocks)

    def init_decode_state(self, batch: int, max_len: int, paged=None):
        return init_decode_state(self.cfg, batch, max_len, paged, device=self.device)
