"""Elastic scaling: resume a checkpoint on a different mesh.

Port of ``repro.runtime.elastic``.  Checkpoints hold full logical arrays
(a sharded state is gathered and written by rank 0,
:class:`ShardedCheckpoints`), so scaling is re-sharding, not re-assembly:
build the new mesh, resolve the rule table on it and cut each leaf to the
rank's block.  Param and optimizer leaves keep their logical shapes, so
any (data, model) factorization is legal; the global batch is preserved
(each rank takes more rows), and the data stays aligned because the
pipeline is step-addressable.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpoint import restore_checkpoint
from repro_torch.parallel.sharding import Spec, distribute_tree, param_specs


def train_state_specs(strategy: str = "tp_fsdp"):
    """A ``spec_fn`` for a whole train state ``{"params", "opt": {"m",
    "v", "step"}}``: params, ``m`` and ``v`` by the rule table, ``step``
    replicated."""

    def fn(state, mesh):
        opt = state["opt"]
        return {"params": param_specs(state["params"], mesh, strategy),
                "opt": {"m": param_specs(opt["m"], mesh, strategy),
                        "v": param_specs(opt["v"], mesh, strategy), "step": Spec()}}

    return fn


def elastic_restore(ckpt_manager: CheckpointManager, step: int, template: Any, new_mesh,
                    spec_fn=param_specs) -> Tuple[Any, dict]:
    """Restore checkpoint ``step`` re-sharded for ``new_mesh`` (a
    ``DeviceMesh``): (a DTensor tree, the checkpoint's metadata).
    ``template`` gives the structure and shapes (meta tensors will do);
    ``spec_fn(template, mesh)`` resolves the specs (the parameter rule
    table by default; :func:`train_state_specs` for a train state)."""
    full, metadata = ckpt_manager.restore(step, template)
    return distribute_tree(full, spec_fn(template, new_mesh), new_mesh), metadata


class ShardedCheckpoints:
    """A ``CheckpointManager`` seen from every rank of a sharded run
    (``run_with_restarts``' ``ckpt_manager``): ``save`` gathers the full
    arrays (a collective) and rank 0 writes them synchronously, then every
    rank waits for the write; ``restore`` reads the full arrays and cuts
    each rank's blocks.  The files are those of a one-process run."""

    def __init__(self, manager: CheckpointManager, step_obj, template: Dict[str, Any]):
        self.manager, self.step_obj, self.template = manager, step_obj, template

    def save(self, step: int, state, metadata: Optional[Dict] = None) -> None:
        import torch.distributed as dist

        full = self.step_obj.full_state(state)
        if dist.get_rank() == 0:
            self.manager.save(step, full, metadata)
            self.manager.wait()
        dist.barrier()

    def wait(self) -> None:
        self.manager.wait()

    def latest_step(self) -> Optional[int]:
        return self.manager.latest_step()

    def restore(self, step: int, _template=None):
        full, metadata = restore_checkpoint(self.manager.ckpt_dir, step, self.template)
        return self.step_obj.shard_state(full), metadata
