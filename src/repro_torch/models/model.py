"""Model facade (port of ``repro.models.model``): config + options + device."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.plan import ExecutionPlan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import (
    ModelOptions, decode_step, forward, forward_aux, init_decode_state, init_params,
    prepare_params, suffix_forward,
)

# the per-weight caches ``prepare`` adds; stale after the first update
PREPARED_KEYS = frozenset({"wc", "wq_t", "wsc_t", "head_wc", "head_wq_t", "head_wsc_t",
                           "caches"})


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 0.0, dp=None) -> torch.Tensor:
    """Mean token cross entropy of float32 ``logits [..., V]`` against
    ``labels [...]`` (label -1 masked), plus ``z_loss`` times the mean
    squared log-partition over the same tokens.  With ``dp`` (a
    ``parallel.dp.DataParallel``) the sums and the count run over every
    data-parallel rank's tokens: the value is the global mean, the
    gradient this rank's part of it."""
    valid = (labels >= 0).to(torch.float32)
    labels = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0] - logz
    count = valid.sum() if dp is None else dp.sum(valid.sum())
    count = count.clamp_min(1.0)
    loss = -(ll * valid).sum() / count
    if z_loss:
        loss = loss + z_loss * ((logz ** 2) * valid).sum() / count
    if dp is not None:
        loss = dp.global_value(loss, dp.sum(loss))
    return loss


def _prepared_keys(tree, path="params"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in PREPARED_KEYS:
                yield f"{path}.{k}"
            else:
                yield from _prepared_keys(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _prepared_keys(v, f"{path}.{i}")


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

    def with_plan(self, plan) -> "Model":
        """The same model under another plan (any ``from_spec`` form)."""
        return dataclasses.replace(
            self, opts=dataclasses.replace(self.opts, plan=ExecutionPlan.from_spec(plan)))

    def calibrate(self, params, batch) -> "Model":
        """PTQ calibration: one exact forward over ``batch`` (``{"tokens"[,
        "vision_embeds"]}``) with per-site observers; returns the model with
        static activation and KV scales baked into its plan."""
        return self.with_plan(self.plan.calibrate(self, params, batch))

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0) -> Dict[str, Any]:
        return init_params(self.cfg, seed, self.device)

    def param_shapes(self) -> Dict[str, Any]:
        """The params' tree of shapes and dtypes on the meta device
        (nothing drawn, nothing allocated)."""
        return init_params(self.cfg, 0, "meta")

    def prepare(self, params) -> Dict[str, Any]:
        """Params with this plan's per-weight caches (int8 codes, cast copies)."""
        return prepare_params(params, self.cfg, self.plan)

    # ------------------------------------------------------------- train
    def loss(self, params, batch, dp=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token loss of ``batch`` (``{"tokens" [B, S] or [B, C, S],
        ["vision_embeds" [B, T, D]]}``, tensors on the model's device):
        cross entropy with ``opts.z_loss`` over positions shifted by one
        (along S for every codebook), plus the MoE load-balance loss.
        Returns (loss, {"loss", "aux"}).  ``params`` are the raw float32
        masters: a dict carrying ``prepare``'s caches is refused, since
        they would not follow an update.  ``dp`` (a
        ``parallel.dp.DataParallel``; None on one process): ``batch`` is
        this rank's rows, and the loss and aux are those of the global
        batch, their gradients this rank's part (summed over the
        data-parallel ranks, the one-process gradients)."""
        stale = next(_prepared_keys(params), None)
        if stale is not None:
            raise ValueError(f"Model.loss takes raw params, not prepared ones ({stale} is a "
                             "weight cache that would go stale after the first update)")
        tokens = batch["tokens"]
        logits, aux, _ = forward_aux(params, tokens, self.cfg, self.opts,
                                     vision_embeds=batch.get("vision_embeds"), dp=dp)
        if self.cfg.n_codebooks:  # tokens [B, C, S], logits [B, S, C, V]
            labels = tokens[:, :, 1:].transpose(1, 2)  # [B, S-1, C]
        else:
            labels = tokens[:, 1:]
        loss = cross_entropy(logits[:, :-1], labels, self.opts.z_loss, dp) + aux
        return loss, {"loss": loss, "aux": aux}

    # ------------------------------------------------------------- serve
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Full-sequence pass over ``batch`` (``{"tokens"[,
        "vision_embeds"]}`` or the tokens); returns (logits, per-layer
        serving states: dense KV caches padded to ``max_len``, local rings,
        the cross caches of the vision embeddings, recurrent states)."""
        tokens, vis = batch, None
        if isinstance(batch, dict):
            tokens, vis = batch["tokens"], batch.get("vision_embeds")
        return forward(params, tokens, self.cfg, self.opts, return_states=True,
                       max_len=max_len, vision_embeds=vis)

    def decode(self, params, token, states, pos, block_tables=None, write=None):
        """One step; ``write [B]`` gates each slot's dense cache write."""
        return decode_step(params, token, states, pos, self.cfg, self.opts,
                           block_tables=block_tables, write=write)

    def prefill_suffix(self, params, tokens, states, table, start, ctx_blocks: int):
        return suffix_forward(params, tokens, self.cfg, self.opts, states, table, start,
                              ctx_blocks)

    def init_decode_state(self, batch: int, max_len: int, paged=None):
        """Dense per-slot states (caches ``[batch, n_kv, max_len, hd]``,
        local rings, recurrent states), or with
        ``paged=(n_blocks, block_size)`` block pools; with
        ``opts.kv_quant="int8"`` the pools are int8 with the plan's
        calibrated per-KV-head scales (dense caches refuse it)."""
        return init_decode_state(self.cfg, batch, max_len, paged, device=self.device,
                                 kv_quant=self.opts.kv_quant, plan=self.plan)


# ---------------------------------------------------------------- specs
def _tok_spec(cfg: ArchConfig, batch: int, seq: int) -> torch.Tensor:
    shape = (batch, cfg.n_codebooks, seq) if cfg.n_codebooks else (batch, seq)
    return torch.empty(shape, dtype=torch.int32, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input of one shape cell, as
    the reference's ``input_specs`` gives them: train/prefill ``{"tokens"
    int32, ["vision_embeds" in dtype]}``; decode ``{"token" (one step),
    "states" (the dense serving state of seq_len), "pos" int32 scalar}``."""
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {"tokens": _tok_spec(cfg, shape.global_batch, shape.seq_len)}
        if cfg.vision_tokens:
            specs["vision_embeds"] = torch.empty(
                (shape.global_batch, cfg.vision_tokens, cfg.d_model), dtype=dtype,
                device="meta")
        return specs
    return {"token": _tok_spec(cfg, shape.global_batch, 1),
            "states": init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                        device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}
