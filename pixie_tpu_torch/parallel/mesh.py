"""Parallelism over several processes: torch.distributed in place of the
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
    masked losses; the metrics);
  * ``get_mesh(dp, sp)`` lays the ranks out as a (dp, sp) grid, rank-major
    as JAX's ``reshape(dp, sp)`` (pixie_tpu/parallel/mesh.py:26-34), with a
    process group along each axis.  The U-Net trainer splits each sample's
    voxel z axis over the ``sp`` group (``models/unet3d.SpatialShard``) and
    the batch over ``dp``; the sharded MPM frame (``sim/solver_dist.py``)
    shards particles over the whole world;
  * ``exchange`` posts point-to-point sends and receives together (the
    halo planes of both), ``all_reduce_grad`` / ``all_gather_grad`` are
    collectives that carry gradients.
"""

from __future__ import annotations

import dataclasses
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
    """Rank ``rank_id``'s rows of a global batch (a tuple of arrays or
    tensors with a leading batch dim) and their sample weights (see
    ``rank_rows``)."""
    rows, w = rank_rows(len(batch[0]), world, rank_id)
    if rows == list(range(rows[0], rows[0] + len(rows))):  # no pad row: a view
        return tuple(x[rows[0]:rows[0] + len(rows)] for x in batch), w
    return tuple(x[rows] for x in batch), w


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, without gradient (``t`` itself when
    there is one process)."""
    t = t.detach()
    if world_size() > 1:
        t = t.clone()
        dist.all_reduce(t)
    return t


# -- the (dp, sp) grid -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, sp) grid of ranks: rank r sits at
    (r // sp, r % sp), as JAX lays a device list out with ``reshape(dp,
    sp)``.  ``dp_group`` holds the ranks of this rank's sp column (the same
    spatial slab of different batch rows), ``sp_group`` those of its dp row
    (the slabs of the same rows); both are None for one process."""

    dp: int
    sp: int
    rank: int = 0
    dp_group: object = None
    sp_group: object = None

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}

    @property
    def dp_rank(self) -> int:
        return self.rank // self.sp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp

    @property
    def sp_ranks(self) -> list[int]:
        """The global ranks of this rank's sp group, in slab order."""
        return [self.dp_rank * self.sp + j for j in range(self.sp)]


def get_mesh(dp: int | None = None, sp: int = 1) -> Mesh:
    """A (dp, sp) grid over the process group's ranks (all of them on dp by
    default).  Every rank must call it, in the same order as its other
    group creations: ``dist.new_group`` is collective."""
    world = world_size()
    if dp is None:
        dp = world // sp
    if dp < 1 or sp < 1 or dp * sp != world:
        raise ValueError(f"dp({dp}) * sp({sp}) != world size ({world})")
    if world == 1:
        return Mesh(dp, sp)
    me = rank()
    dp_group = sp_group = None
    for j in range(sp):
        g = dist.new_group([i * sp + j for i in range(dp)])
        if me % sp == j:
            dp_group = g
    for i in range(dp):
        g = dist.new_group([i * sp + j for j in range(sp)])
        if me // sp == i:
            sp_group = g
    return Mesh(dp, sp, me, dp_group, sp_group)


# -- communication ---------------------------------------------------------------------

def host_staged(group=None) -> bool:
    """Whether CUDA tensors travel through host memory on ``group``: gloo
    has CUDA all_reduce and broadcast but no CUDA send or recv (two ranks
    sharing one card must use gloo: NCCL refuses them)."""
    return dist.get_backend(group) == "gloo"


def exchange(sends: list, recvs: list, group=None) -> None:
    """Post every send ``(tensor, peer)`` and receive ``(tensor, peer)``
    together and wait for all of them; peers are global ranks, received
    tensors are written in place.  On a gloo group CUDA tensors are staged
    through host memory (see ``host_staged``)."""
    staged = host_staged(group)
    ops, back = [], []
    for t, peer in sends:
        buf = t.cpu() if staged and t.is_cuda else t.contiguous()
        ops.append(dist.P2POp(dist.isend, buf, peer, group))
    for t, peer in recvs:
        buf = t
        if (staged and t.is_cuda) or not t.is_contiguous():
            buf = torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged else t.device)
            back.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for t, buf in back:
        t.copy_(buf)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group`` on every rank; its gradient is the sum of the
    ranks' gradients (every rank's output reads every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def all_gather_grad(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in group
    rank order, differentiable.  Written as the all_reduce of a zero buffer
    that each rank fills at its block: gloo has no reduce_scatter for
    all_gather's backward, and the all_reduce's backward (the ranks'
    gradients summed, then each rank's block) is that reduce_scatter."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    parts = [torch.zeros_like(x)] * n
    parts[r] = x
    return all_reduce_grad(torch.cat(parts, dim), group)
