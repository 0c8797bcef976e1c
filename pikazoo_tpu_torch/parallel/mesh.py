"""Data parallelism over the environment batch, on ``torch.distributed``.

Counterpart of ``pikazoo_tpu.parallel.mesh``.  The env step is
embarrassingly parallel over matches, so the scaling design is one axis,
``env``: rank i of a world of n holds rows ``[i*b, (i+1)*b)`` of every
batch-leading leaf (``b = B / n``), the parameters are replicated, and the
only collectives are the learner's sums (``train/ppo.py``).  A process
group is the mesh; :class:`EnvMesh` names this rank's place in it.  Without
a process group it is the one-rank mesh, on which every function here is
the identity and calls no collective.

The backend follows the topology, never a failure: ``nccl`` for CUDA
devices, ``gloo`` for the CPU (or as the caller names it).  Gloo's
collectives take host tensors here, so a CUDA tensor goes through the host
(two ranks sharing one card use gloo, since NCCL refuses two ranks on one
device).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from pikazoo_tpu_torch.utils.profiling import trace_annotation

ENV_AXIS = "env"


def init_distributed(backend: Optional[str] = None, device=None, **kwargs) -> None:
    """Join the process group, once, on every rank.

    The rendezvous comes from ``kwargs`` (``init_method`` or ``store``,
    ``rank``, ``world_size``, ``timeout``, as
    ``torch.distributed.init_process_group`` takes them) or from the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  A no-op when the group exists already, or when neither
    gives a rendezvous (one process).  ``backend``: ``nccl`` when CUDA is
    available, else ``gloo``, unless named.  ``device``, this rank's card
    under nccl, becomes the process's current card and the group's
    ``device_id``, so that the communicator, ``barrier`` and any call on the
    default card land on it.  A failed init raises."""
    if dist.is_initialized():
        return
    env_given = all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                               "MASTER_PORT"))
    if not kwargs and not env_given:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if device is not None and backend == "nccl":
        device = torch.device(device)
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend=backend, **kwargs)


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """This rank's place on the ``env`` axis: rows ``[rank*b, (rank+1)*b)``
    of a batch of ``b * world_size``, tensors on ``device``, collectives in
    ``group`` (None: the one-rank mesh)."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None
    axis_name: str = ENV_AXIS

    @property
    def distributed(self) -> bool:
        """More than one rank: the trainer's collectives run."""
        return self.world_size > 1

    @property
    def through_host(self) -> bool:
        """Gloo's collectives take host tensors: stage device tensors."""
        return self.distributed and dist.get_backend(self.group) == "gloo" and \
            self.device.type != "cpu"


def make_env_mesh(device="cuda") -> EnvMesh:
    """The mesh of the process group (the one-rank mesh without one), its
    tensors on ``device``.  The caller picks the device: ``torchrun`` puts a
    rank a card at ``cuda:{LOCAL_RANK}``, while two ranks may share one card
    over gloo."""
    device = torch.device(device)
    if not dist.is_initialized():
        return EnvMesh(0, 1, device)
    return EnvMesh(dist.get_rank(), dist.get_world_size(), device, dist.group.WORLD)


def _map(fn, tree):
    """``fn`` over the tensor leaves of nested (Named)tuples and dicts."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        leaves = [_map(fn, v) for v in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return tree


def local_rows(rows: int, mesh: EnvMesh) -> slice:
    """This rank's rows of a batch of ``rows``; raises unless the world
    divides it."""
    if rows % mesh.world_size:
        raise ValueError(f"a batch of {rows} rows does not split over {mesh.world_size} ranks")
    b = rows // mesh.world_size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(tree, mesh: EnvMesh):
    """This rank's rows ``[rank*b, (rank+1)*b)`` of every leaf of a
    batch-leading tree (the global one, alike on every rank), contiguous."""
    if not mesh.distributed:
        return tree
    return _map(lambda t: t[local_rows(t.shape[0], mesh)].contiguous(), tree)


def _staged(t: torch.Tensor, mesh: EnvMesh) -> torch.Tensor:
    return t.cpu() if mesh.through_host else t


def gather_batch(tree, mesh: EnvMesh):
    """The inverse of :func:`shard_batch`: every leaf's shards joined in rank
    order, on every rank (an ``all_gather`` a leaf)."""
    if not mesh.distributed:
        return tree

    def gather(t: torch.Tensor) -> torch.Tensor:
        local = _staged(t.contiguous(), mesh)
        parts = [torch.empty_like(local) for _ in range(mesh.world_size)]
        dist.all_gather(parts, local, group=mesh.group)
        gather_batch.calls += 1
        return torch.cat(parts).to(t.device)

    return _map(gather, tree)


def replicated(tree, mesh: EnvMesh):
    """Every leaf as rank 0 holds it, on every rank (a ``broadcast`` a
    leaf)."""
    if not mesh.distributed:
        return tree

    def broadcast(t: torch.Tensor) -> torch.Tensor:
        buf = _staged(t.contiguous(), mesh).clone()
        dist.broadcast(buf, src=0, group=mesh.group)
        replicated.calls += 1
        return buf.to(t.device)

    return _map(broadcast, tree)


def barrier(mesh: EnvMesh) -> None:
    """Return on every rank once every rank has called it (an ``all_reduce``
    of one element, on the mesh's device or the host for gloo; not counted)."""
    if mesh.distributed:
        dist.all_reduce(torch.zeros(1, device="cpu" if mesh.through_host else mesh.device),
                        group=mesh.group)


def all_reduce_sum(flat: torch.Tensor, mesh: EnvMesh) -> torch.Tensor:
    """The sum over ranks of a tensor, the same bits on every rank (one
    ``all_reduce``; each call adds one to ``all_reduce_sum.calls`` and the
    tensor's bytes to ``all_reduce_sum.bytes``).  The input is left as it
    is."""
    if not mesh.distributed:
        return flat
    with trace_annotation("mesh.all_reduce"):
        buf = _staged(flat.contiguous(), mesh).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        all_reduce_sum.calls += 1
        all_reduce_sum.bytes += buf.numel() * buf.element_size()
        return buf.to(flat.device)


def zero_counts() -> None:
    """Set the collectives' call counts, and ``all_reduce_sum.bytes``, to 0."""
    all_reduce_sum.calls = 0
    all_reduce_sum.bytes = 0
    gather_batch.calls = 0
    replicated.calls = 0


zero_counts()
