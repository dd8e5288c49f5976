"""Data parallelism for U-Net training: torch.distributed in place of the
JAX package's device mesh (port of pixie_tpu/parallel/mesh.py).

The reference trains with single-node DDP over local GPUs
(pixie/training_utils.py:50-55 ``ddp_setup``: NCCL, DistributedSampler, the
gradient allreduce inside DDP).  The JAX package replaces that with one
mesh, the global batch sharded over its ``dp`` axis.  Here it is DDP again,
one process a card:

  * ``initialize_distributed`` joins the process group that torchrun (or an
    explicit ``init_method``) describes.  It stands for both
    ``initialize_distributed`` and ``get_pod_mesh`` of the JAX package:
    torchrun starts one process a card on every node, so multi-node needs
    nothing more, and ``host_local_to_global`` has nothing left to do;
  * ``rank_rows`` / ``local_batch`` give each rank its contiguous block of
    the global batch, padded to a multiple of the world size with zero
    sample weights as the JAX trainer pads for its mesh
    (pixie_tpu/train/trainer.py:223-233), not by repeating samples at full
    weight as ``DistributedSampler`` does;
  * ``all_sum`` adds a value over the ranks (the global denominators of the
    masked losses; the metrics).

The JAX trainer can also shard the voxel grid's z axis over an ``sp`` mesh
axis (GSPMD halo convolutions, trainer.py:209-221).  One H100 holds a
batch-4 step at 64^3, so that waits for the multi-device work (ROADMAP.md
§1 item 5).
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def initialize_distributed(device: str | torch.device = "cuda", init_method: str | None = None,
                           world: int | None = None, rank_id: int | None = None,
                           timeout_s: float = 1800.0) -> int:
    """Join the process group and return the world size.

    ``world`` and ``rank_id`` default to torchrun's ``WORLD_SIZE`` and
    ``RANK``; ``init_method`` to ``env://`` (``MASTER_ADDR`` /
    ``MASTER_PORT``).  NCCL on a CUDA device, gloo on the CPU.  A no-op for
    a single process or when the group is already up."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", 1) if world is None else world)
    if world <= 1:
        return 1
    rank_id = int(os.environ.get("RANK", 0) if rank_id is None else rank_id)
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world,
                            rank=rank_id, timeout=datetime.timedelta(seconds=timeout_s))
    logging.info("distributed: rank %d of %d (%s)", rank_id, world, backend)
    return world


def local_device(device: str | torch.device) -> torch.device:
    """``cuda`` without an index -> this process's card (torchrun's
    ``LOCAL_RANK``) when the group spans several processes."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and world_size() > 1:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def rank_rows(n: int, world: int, rank_id: int) -> tuple[list[int], np.ndarray]:
    """Rows of a global batch of ``n`` that rank ``rank_id`` of ``world``
    takes, and their sample weights: the batch is padded to a multiple of
    ``world`` with copies of its last row at weight 0, then cut into
    ``world`` contiguous blocks."""
    pad = (-n) % world
    rows = list(range(n)) + [n - 1] * pad
    w = np.ones(n + pad, np.float32)
    w[n:] = 0.0
    per = (n + pad) // world
    sl = slice(rank_id * per, (rank_id + 1) * per)
    return rows[sl], w[sl]


def local_batch(batch, world: int, rank_id: int):
    """Rank ``rank_id``'s rows of a global batch (a tuple of arrays with a
    leading batch dim) and their sample weights (see ``rank_rows``)."""
    rows, w = rank_rows(len(batch[0]), world, rank_id)
    if rows == list(range(rows[0], rows[0] + len(rows))):  # no pad row: a view
        return tuple(np.asarray(x)[rows[0]:rows[0] + len(rows)] for x in batch), w
    return tuple(np.asarray(x)[rows] for x in batch), w


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, without gradient (``t`` itself when
    there is one process)."""
    t = t.detach()
    if world_size() > 1:
        t = t.clone()
        dist.all_reduce(t)
    return t
