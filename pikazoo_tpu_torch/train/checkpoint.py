"""Checkpoint and resume of the whole training state.

Counterpart of ``pikazoo_tpu.train.checkpoint`` (which writes orbax): one
``torch.save`` file of the ``PPORunnerState`` — params, the Adam state, the
env batch, the last observations, the update index and the rollout
generator's state — as nested dicts of tensors, read back with
``torch.load(weights_only=True)``.  A resumed run equals an uninterrupted one
bit for bit: the env step is pure, and the generator's state carries the
rollout's draws.

The swap is crash-safe as the JAX package's is.  ``save`` writes
``path.new`` in full (through a staging file renamed into place, so a
``.new`` that exists is complete), moves ``path`` to ``path.old``, renames
``path.new`` to ``path`` and drops ``.old``: at every instant a complete
checkpoint is at ``path``, ``path.new`` or ``path.old``.  A ``.new`` left by
a crash inside that window is the newest and is promoted, never deleted.

On a mesh (``parallel.EnvMesh``) the file still holds the global runner, so
it restores on any world, as the JAX package's ``restore(like)`` does across
topologies: ``save`` gathers the env shards (the batch fields,
:data:`BATCH_FIELDS`) and rank 0 writes; ``restore`` loads on every rank and
keeps the rank's rows.  A checkpoint written by two ranks resumes on one,
and one written by one rank resumes on two.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from pikazoo_tpu_torch.parallel.mesh import barrier, gather_batch, shard_batch

_GENERATOR = "__generator_state__"
# The runner's fields whose leaves lead with the env batch: sharded on a mesh.
BATCH_FIELDS = ("env_state", "last_obs")


def _encode(tree: Any) -> Any:
    """Tensors, ints and generator states in nested dicts."""
    if isinstance(tree, torch.Generator):
        return {_GENERATOR: tree.get_state()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _encode(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: _encode(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach()
    return tree


def _decode(like: Any, data: Any, where: str) -> Any:
    """``data`` rebuilt in ``like``'s structure, each tensor on the device of
    ``like``'s leaf; a leaf of another shape or dtype raises."""
    if isinstance(like, torch.Generator):
        gen = torch.Generator(device=like.device)
        gen.set_state(data[_GENERATOR])
        return gen
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_decode(getattr(like, f), data[f], f"{where}.{f}")
                            for f in like._fields])
    if isinstance(like, dict):
        if set(like) != set(data):
            raise ValueError(f"{where}: checkpoint keys {sorted(data)}, want {sorted(like)}")
        return {k: _decode(v, data[k], f"{where}.{k}") for k, v in like.items()}
    if torch.is_tensor(like):
        if data.shape != like.shape or data.dtype != like.dtype:
            raise ValueError(f"{where}: checkpoint has {data.dtype}{tuple(data.shape)}, "
                             f"want {like.dtype}{tuple(like.shape)}")
        return data.to(like.device)
    return type(like)(data)


def _fsync_dir(path: str) -> None:
    fd = os.open(os.path.dirname(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _recover_swap(path: str) -> None:
    """Promote a complete ``path.new`` stranded by a crash inside
    :func:`save`'s swap: it was written after whatever sits at ``path``."""
    tmp, old = path + ".new", path + ".old"
    if not os.path.isfile(tmp):
        return
    if os.path.exists(path):
        if os.path.exists(old):
            os.remove(old)
        os.rename(path, old)
    os.rename(tmp, path)
    _fsync_dir(path)


def save(path: str, state: Any, mesh=None) -> None:
    """Write ``state`` (a ``PPORunnerState``) to ``path``, crash-safe (see
    the module docstring).  A complete stale ``path.new`` is promoted first,
    never deleted.  On a mesh every rank calls it: the batch fields are
    gathered, rank 0 writes, and every rank returns once the file is in
    place."""
    if mesh is not None and mesh.distributed:
        state = state._replace(**{f: gather_batch(getattr(state, f), mesh)
                                  for f in BATCH_FIELDS})
        if mesh.rank == 0:
            _write(path, state)
        barrier(mesh)
        return
    _write(path, state)


def _write(path: str, state: Any) -> None:
    path = os.path.abspath(path)
    tmp, old = path + ".new", path + ".old"
    _recover_swap(path)
    staging = tmp + ".partial"
    with open(staging, "wb") as f:
        torch.save(_encode(state), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(staging, tmp)
    if os.path.exists(old):
        os.remove(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    _fsync_dir(path)
    if os.path.exists(old):
        os.remove(old)


def latest_restorable(path: str) -> str | None:
    """The complete checkpoint to restore from: a promoted ``path.new``
    (crash inside :func:`save`'s swap), ``path``, or ``path.old``."""
    path = os.path.abspath(path)
    try:
        _recover_swap(path)
    except OSError:
        pass  # read-only filesystem etc.: fall through to what exists
    for candidate in (path, path + ".old"):
        if os.path.isfile(candidate):
            return candidate
    return None


def restore(path: str, like: Any, mesh=None) -> Any:
    """The checkpoint at ``path`` in the structure of ``like`` (e.g.
    ``init_fn(seed)``'s runner), every tensor on the device of ``like``'s
    leaf: a run saved on the card resumes on the card, one saved on the CPU
    on the CPU, whichever wrote it.  On a mesh each rank keeps its rows of
    the batch fields (``like`` holds this rank's)."""
    data = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if mesh is not None and mesh.distributed:
        data = dict(data, **{f: shard_batch(data[f], mesh) for f in BATCH_FIELDS})
    return _decode(like, data, "state")
