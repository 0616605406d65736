"""Meshes in one process: the reference's ``launch/mesh.py`` without jax.

A ``Mesh`` names the axes of a grid of devices.  The port's meshes are
those one process can hold: the host mesh (one device) and the coded
cluster's worker mesh (the devices its workers run on).  The production
meshes, single pod ``(data 16, model 16)`` and multi-pod ``(pod 2, data
16, model 16)``, carry their axis sizes only: the sharding specs resolve
against them (``sharding.resolve_pspec``, ``models.common.spec_to_pspec``),
and no one process holds 256 devices.  A mesh over processes
(``torch.distributed.DeviceMesh``) comes with the multi-process execution,
ROADMAP Queue A item 3(b).
"""
from __future__ import annotations

import numpy as np
import torch

from ..devices import canonical_device, resolve_device

__all__ = ["Mesh", "make_host_mesh", "make_worker_mesh", "make_production_mesh"]


class Mesh:
    """Axis names, their sizes and, where one process holds them, the
    devices: an object array of ``torch.device`` shaped by the sizes."""

    def __init__(self, axis_names, axis_sizes, devices=None):
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.axis_sizes}")
        if devices is not None:
            arr = np.empty(len(devices), dtype=object)
            arr[:] = list(devices)
            devices = arr.reshape(self.axis_sizes)
        self.devices = devices

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16 x 16 = 256 devices, axes (data, model).  Multi-pod:
    2 x 16 x 16 = 512, axes (pod, data, model), the pod axis carrying data
    parallelism across the pods.  Sizes only, no devices."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(device: str | torch.device = "cuda") -> Mesh:
    """The 1 x 1 (data, model) mesh on ``device``."""
    return Mesh(("data", "model"), (1, 1), [resolve_device(device)])


def make_worker_mesh(n: int, devices=None) -> Mesh:
    """The 1-D ``("workers",)`` mesh of the coded cluster's device pool:
    ``devices`` when given (a ``torch.device``, a name or a CUDA index
    each), else every visible CUDA device, capped at ``n`` (a 6-worker
    cluster on an 8-card host leaves 2 cards free).  Fewer devices than
    workers is fine: the pool round-robins the workers over the mesh
    (``sharding.worker_devices``)."""
    if n < 1:
        raise ValueError(f"need n >= 1 workers, got {n}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device visible; pass devices= or "
                               "device='cpu'")
        devices = range(torch.cuda.device_count())
    devs = [canonical_device(resolve_device(
        torch.device("cuda", d) if isinstance(d, int) else d))
        for d in list(devices)[:n]]
    if not devs:
        raise ValueError("empty device list")
    return Mesh(("workers",), (len(devs),), devs)
