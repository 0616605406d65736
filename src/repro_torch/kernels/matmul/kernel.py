"""K2: the fp32 GEMM with a ReLU epilogue (``csrc/matmul.cu``) and its
plain PyTorch version.

Counterpart of the TPU kernel ``matmul_pallas``
(``src/repro/kernels/matmul/kernel.py:111``).  ``matmul`` launches the
CUDA kernel for CUDA tensors and runs ``matmul_plain`` only for tensors
that lie on the CPU; there is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from ..native import LaunchCounter, check_launch, launch_stream, load_library

__all__ = ["matmul", "matmul_plain", "launches"]

launches = LaunchCounter("matmul")

_MAX_ROW_BLOCKS = 65535  # grid.y limit; the kernel takes 16 rows a block


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 relu: bool = False) -> torch.Tensor:
    """``a @ b`` then ``clamp_min(0)`` when ``relu`` — what K2 computes."""
    y = a @ b
    return y.clamp_min(0) if relu else y


def matmul(a: torch.Tensor, b: torch.Tensor, *, relu: bool = False) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` in IEEE fp32, ReLU fused into the store when
    ``relu``.  CUDA tensors launch K2; CPU tensors take ``matmul_plain``."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return matmul_plain(a, b, relu=relu)
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu, got {a.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"K2 takes float32 only, got {a.dtype} @ {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("K2 takes contiguous row-major operands")
    m, k = a.shape
    n = b.shape[1]
    if -(-m // 16) > _MAX_ROW_BLOCKS:
        raise ValueError(f"M={m} exceeds the kernel's row-block grid")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(a.device):
        rc = load_library().matmul_f32(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, int(relu),
            launch_stream(a))
    check_launch("matmul_f32", rc)
    launches.add()
    return out
