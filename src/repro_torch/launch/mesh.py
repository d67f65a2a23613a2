"""Production mesh construction.

Port of ``repro.launch.mesh``.  Single pod: 16 x 16 = 256 ranks over
``("data", "model")``; multi-pod: 2 x 16 x 16 = 512 over ``("pod",
"data", "model")``, the leading ``pod`` axis the one only pure-DP
collectives (the gradient all-reduce) should cross.  :func:`mesh_shape`
gives a mesh's shape and axis names with no process group (the dry run
resolves the rules on it); :func:`make_production_mesh` and
:func:`make_host_mesh` build a ``DeviceMesh`` through
``init_device_mesh`` over the already initialised default group, and
raise, naming both sizes, when the world is not the mesh's size.
Importing this module starts no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's shape and axis names (``DeviceMesh``'s ``shape`` and
    ``mesh_dim_names``), with no devices behind it."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.mesh_dim_names, self.shape))

    @property
    def label(self) -> str:
        return "x".join(str(s) for s in self.shape)


def mesh_shape(multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


HOST_MESH = MeshShape((1, 1), ("data", "model"))


def make_mesh(spec: MeshShape, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``spec`` over the default process group, which
    must hold exactly ``spec.size`` ranks (a one-rank mesh with no group
    makes one, in memory).  ``device_type`` defaults to the card (raises
    when none is visible); pass ``"cpu"`` for the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != spec.size:
        raise ValueError(f"mesh {spec.label} over {spec.mesh_dim_names} needs {spec.size} "
                         f"ranks; the world has {world}")
    device_type = resolve_device(device_type).type
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, spec.shape, mesh_dim_names=spec.mesh_dim_names)


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    return make_mesh(mesh_shape(multi_pod), device_type)


def make_host_mesh(device_type: Optional[str] = None):
    """Degenerate 1 x 1 mesh (one rank) for smoke tests."""
    return make_mesh(HOST_MESH, device_type)
