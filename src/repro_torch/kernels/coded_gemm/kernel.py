"""K3: the CRME coded GEMM (``csrc/coded_gemm.cu``) and its plain PyTorch
version.

Counterpart of the TPU kernels ``coded_gemm_pallas_legacy``
(``src/repro/kernels/coded_gemm/kernel.py:57``) and ``coded_gemm_pallas``
(``:27``), which the reference proves bit-equal.  ``coded_gemm`` launches
the CUDA kernel for CUDA tensors and runs ``coded_gemm_plain`` only for
tensors that lie on the CPU; there is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from ..native import LaunchCounter, check_launch, launch_stream, load_library

__all__ = ["coded_gemm", "coded_gemm_plain", "launches", "R_MAX"]

launches = LaunchCounter("coded_gemm")

R_MAX = 16  # the kernel keeps the whole code matrix in shared memory


def coded_gemm_plain(code: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """``code (R_out, R_in) @ feats (R_in, F)`` — what K3 computes."""
    return code @ feats


def coded_gemm(code: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """``code (R_out, R_in) @ feats (R_in, F)`` in IEEE fp32 (no TF32), for
    code dimensions up to ``R_MAX``.  CUDA tensors launch K3; CPU tensors
    take ``coded_gemm_plain``."""
    if code.ndim != 2 or feats.ndim != 2 or code.shape[1] != feats.shape[0]:
        raise ValueError(f"coded_gemm shapes {tuple(code.shape)} @ "
                         f"{tuple(feats.shape)}")
    r_out, r_in = code.shape
    if not (1 <= r_out <= R_MAX and 1 <= r_in <= R_MAX):
        raise ValueError(f"code matrix {r_out}x{r_in}: K3 takes code "
                         f"dimensions 1..{R_MAX}")
    if code.device != feats.device:
        raise ValueError(f"operands on {code.device} and {feats.device}")
    if code.device.type == "cpu":
        return coded_gemm_plain(code, feats)
    if code.device.type != "cuda":
        raise ValueError(f"coded_gemm runs on cuda or cpu, got {code.device}")
    if code.dtype != torch.float32 or feats.dtype != torch.float32:
        raise TypeError(f"K3 takes float32 only, got {code.dtype} @ {feats.dtype}")
    if not (code.is_contiguous() and feats.is_contiguous()):
        raise ValueError("K3 takes contiguous row-major operands")
    f = feats.shape[1]
    out = torch.empty((r_out, f), dtype=torch.float32, device=code.device)
    if f == 0:
        return out
    with torch.cuda.device(code.device):
        rc = load_library().coded_gemm_f32(
            code.data_ptr(), feats.data_ptr(), out.data_ptr(), r_out, r_in, f,
            launch_stream(code))
    check_launch("coded_gemm_f32", rc)
    launches.add()
    return out
