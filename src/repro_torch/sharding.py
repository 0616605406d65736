"""Logical sharding axes and their resolution on a mesh: the reference's
``sharding.py`` without its jax half.

A logical axis is an entry of a leaf's axes tuple: ``None``, a mesh axis
name, or a tuple of candidate names used jointly (``BATCH`` =
``("pod", "data")``).  ``resolve_pspec`` picks, per dimension, the
candidates that exist in the mesh and divide the dimension, so one model
resolves on one device, a 16 x 16 pod or a 2 x 16 x 16 multi-pod mesh
alike (SmolLM's 9 heads fall back to replication on ``model = 16``).

The reference's ``shard_hint`` (``with_sharding_constraint`` under an
active mesh) has no counterpart yet: in one process it can only be the
identity, and the multi-process execution that would give it meaning is
ROADMAP Queue A item 3(b).
"""
from __future__ import annotations

import math

__all__ = ["BATCH", "MODEL", "WORKERS", "PartitionSpec", "resolve_pspec",
           "worker_devices"]

# canonical logical axes
BATCH = ("pod", "data")  # batch (or sequence for long context) shards here
MODEL = "model"
WORKERS = "workers"  # the coded cluster's n-worker axis (1-D worker mesh)


class PartitionSpec(tuple):
    """One leaf's placement on a mesh, dimension by dimension: ``None``
    (replicated), a mesh axis name, or a tuple of names sharded jointly.
    An immutable tuple of those entries (the reference's
    ``jax.sharding.PartitionSpec`` compares equal to the same tuple)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def worker_devices(mesh, n: int) -> list:
    """The n coded workers' devices, read off a worker mesh
    (``launch.mesh.make_worker_mesh``): worker ``i`` runs on device
    ``i % mesh size``.  With fewer devices than workers the round-robin
    oversubscribes evenly (one device holds every worker); with at least
    ``n`` devices each worker owns its device."""
    devs = list(mesh.devices.flat)
    if not devs:
        raise ValueError("empty mesh")
    return [devs[i % len(devs)] for i in range(n)]


def _resolve_dim(dim: int, cand, mesh_shape) -> tuple[str, ...] | None:
    if cand is None:
        return None
    if isinstance(cand, str):
        cand = (cand,)
    chosen = tuple(a for a in cand if a in mesh_shape)
    if not chosen:
        return None
    total = math.prod(mesh_shape[a] for a in chosen)
    if total and dim % total == 0:
        return chosen
    # else the single axis that divides, first come
    for a in chosen:
        if dim % mesh_shape[a] == 0:
            return (a,)
    return None


def resolve_pspec(shape, axes, mesh_shape) -> PartitionSpec:
    """The ``PartitionSpec`` of a leaf of ``shape`` whose dimensions take
    the logical ``axes`` on a mesh of ``mesh_shape`` (axis name -> size):
    each dimension takes the candidates that exist and divide it, and no
    mesh axis is used twice."""
    out = []
    used: set[str] = set()
    for dim, cand in zip(shape, axes):
        r = _resolve_dim(dim, cand, mesh_shape)
        if r is None or any(a in used for a in r):
            out.append(None)
        else:
            used.update(r)
            out.append(r if len(r) > 1 else r[0])
    return PartitionSpec(*out)
