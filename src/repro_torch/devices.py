"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch

__all__ = ["canonical_device", "resolve_device", "worker_devices"]


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
    workers).  The counterpart of the reference's 1-D worker mesh, which
    the port needs only as this list."""
    if n < 1:
        raise ValueError(f"need n >= 1 workers, got {n}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device visible; pass devices= or "
                               "device='cpu'")
        devices = range(min(torch.cuda.device_count(), n))
    devs = [canonical_device(resolve_device(d if not isinstance(d, int)
                                    else torch.device("cuda", d)))
            for d in devices]
    if not devs:
        raise ValueError("empty device list")
    return [devs[i % len(devs)] for i in range(n)]
