"""Run a function on every rank of a fresh gloo group of local processes.

``spawn(fn, world, *args)`` starts ``world`` processes (the ``spawn``
start method), joins each to a gloo group over a ``FileStore`` in a
fresh directory (no port, no network), calls ``fn(rank, world,
*args)`` and tears the group down; a rank that raises makes ``spawn``
raise.  On the card every rank shares ``cuda:0`` (gloo takes CUDA
tensors; NCCL refuses two ranks on one device).  ``fn`` must be
importable by name (a module-level function).
"""
from __future__ import annotations

import os
import shutil
import tempfile


def _entry(rank: int, fn, world: int, store_path: str, threads: int, args) -> None:
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, threads: int = 0, store_dir=None) -> None:
    """``fn(rank, world, *args)`` on ``world`` ranks; ``threads`` caps each
    rank's intra-op CPU threads (0 leaves PyTorch's default); the store's
    file lives in a fresh directory under ``store_dir`` (the system's
    temporary directory by default), removed after."""
    import torch.multiprocessing as mp

    root = tempfile.mkdtemp(prefix="gloo_store_", dir=store_dir)
    try:
        mp.spawn(_entry, args=(fn, world, os.path.join(root, "store"), threads, args),
                 nprocs=world, join=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
