"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import contextlib

import torch

__all__ = ["canonical_device", "fp32_products", "resolve_device",
           "worker_devices"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA request on a machine without
    CUDA raises — the port never drops to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def canonical_device(dev: torch.device) -> torch.device:
    """A CUDA device with its index spelled out (``cuda`` is the current
    one), so two spellings of one card compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def worker_devices(n: int, devices=None) -> list[torch.device]:
    """The device of each of ``n`` coded workers: the given ``devices``, or
    else every visible CUDA device, capped at ``n``; worker ``i`` runs on
    ``devs[i % len(devs)]`` (round-robin when there are fewer devices than
    workers).  The worker mesh's round-robin
    (``sharding.worker_devices(launch.mesh.make_worker_mesh(n, devices),
    n)``), which is its one definition."""
    from .launch.mesh import make_worker_mesh
    from .sharding import worker_devices as mesh_workers

    return mesh_workers(make_worker_mesh(n, devices), n)


@contextlib.contextmanager
def fp32_products():
    """TF32 off for every product inside (matmuls and cuDNN convolutions),
    the process's flags restored after."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was
