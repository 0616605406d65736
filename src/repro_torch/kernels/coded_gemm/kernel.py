"""K3: the CRME coded GEMM (``csrc/coded_gemm.cu``) and its plain PyTorch
version.

Counterpart of the TPU kernels ``coded_gemm_pallas_legacy``
(``src/repro/kernels/coded_gemm/kernel.py:57``) and ``coded_gemm_pallas``
(``:27``), which the reference proves bit-equal.  The code matrix is born
on the host and stays there: K3 takes it by value, as a kernel parameter,
so a CUDA ``feats`` pairs with a CPU fp32 tensor or numpy array for the
code, and a code matrix on the card is refused (reading it back would
synchronise the stream).  ``coded_gemm`` launches the CUDA kernel for
CUDA ``feats`` and runs ``coded_gemm_plain`` only for ``feats`` that lie
on the CPU; there is no fallback from one to the other.
``coded_gemm_plan`` chooses the launch shape.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..native import NUM_SMS, LaunchCounter, launch_on, load_library

__all__ = ["coded_gemm", "coded_gemm_plain", "coded_gemm_plan", "CodedGemmPlan",
           "launches", "R_MAX"]

launches = LaunchCounter("coded_gemm")

R_MAX = 16  # the kernel takes the code matrix as a parameter of up to 16 x 16
THREAD_CHOICES = (256, 128, 64, 32)  # threads a block, most first
VEC4_MIN_COLUMNS = 128 * NUM_SMS  # float4 columns that fill every SM


class CodedGemmPlan(NamedTuple):
    """How K3 launches one ``(R_out, R_in) @ (R_in, F)``: ``vec`` feature
    columns a thread (4: one float4 a row), ``threads`` a block and
    ``blocks`` in the launch."""
    vec: int
    threads: int
    blocks: int


@functools.lru_cache(maxsize=None)  # a decode step asks for 4 shapes, 30 times
def coded_gemm_plan(r_out: int, r_in: int, f: int,
                    aligned: bool = True) -> CodedGemmPlan:
    """The launch K3 uses for ``(r_out, r_in) @ (r_in, f)``.

    At build-time widths (F in the hundreds of thousands) a thread streams
    float4 columns, which needs ``f % 4 == 0`` and 16-byte aligned
    operands (``aligned``); at decode widths (F = 576-3072) a thread
    takes one column, so the launch spreads over more threads.  The block
    is the largest of 256, 128, 64 and 32 threads that still gives every
    SM a block, else 32 (as many blocks as the columns allow).  The code
    dimensions change nothing: every thread
    loads all ``r_in`` rows of its columns and writes all ``r_out``."""
    del r_out, r_in  # the launch shape depends on F alone
    vec = 4 if aligned and f % 4 == 0 and f // 4 >= VEC4_MIN_COLUMNS else 1
    cols = -(-f // vec)
    threads = next((t for t in THREAD_CHOICES if -(-cols // t) >= NUM_SMS),
                   THREAD_CHOICES[-1])
    blocks = -(-cols // threads)
    return CodedGemmPlan(vec, threads, blocks)


def coded_gemm_plain(code, feats: torch.Tensor) -> torch.Tensor:
    """``code (R_out, R_in) @ feats (R_in, F)`` — what K3 computes; the
    code matrix (a tensor or numpy array) is moved to ``feats``' device."""
    return torch.as_tensor(code, device=feats.device) @ feats


def coded_gemm(code, feats: torch.Tensor) -> torch.Tensor:
    """``code (R_out, R_in) @ feats (R_in, F)`` in IEEE fp32 (no TF32), for
    code dimensions up to ``R_MAX``.  ``code`` is a CPU tensor or a numpy
    array; CUDA ``feats`` launch K3 as ``coded_gemm_plan`` says, with the
    code fp32 and both operands contiguous; CPU ``feats`` take
    ``coded_gemm_plain``."""
    if isinstance(code, np.ndarray):
        code = torch.from_numpy(code)
    if code.ndim != 2 or feats.ndim != 2 or code.shape[1] != feats.shape[0]:
        raise ValueError(f"coded_gemm shapes {tuple(code.shape)} @ "
                         f"{tuple(feats.shape)}")
    r_out, r_in = code.shape
    if not (1 <= r_out <= R_MAX and 1 <= r_in <= R_MAX):
        raise ValueError(f"code matrix {r_out}x{r_in}: K3 takes code "
                         f"dimensions 1..{R_MAX}")
    if not code.is_cpu:
        raise ValueError(f"K3 takes the code matrix on the host (a CPU tensor "
                         f"or numpy array), got one on {code.device}: it goes "
                         f"to the kernel by value, and reading it back from "
                         f"the card would synchronise the stream")
    if not feats.is_cuda:
        if feats.device.type != "cpu":
            raise ValueError(f"coded_gemm runs on cuda or cpu, got {feats.device}")
        return coded_gemm_plain(code, feats)
    if code.dtype != torch.float32 or feats.dtype != torch.float32:
        raise TypeError(f"K3 takes float32 only, got {code.dtype} @ {feats.dtype}")
    if not (code.is_contiguous() and feats.is_contiguous()):
        raise ValueError("K3 takes contiguous row-major operands")
    f = feats.shape[1]
    out = feats.new_empty((r_out, f))
    if f == 0:
        return out
    plan = coded_gemm_plan(r_out, r_in, f, feats.data_ptr() % 16 == 0)
    launch_on("coded_gemm_f32", feats, load_library().coded_gemm_f32,
              code.data_ptr(), feats.data_ptr(), out.data_ptr(), r_out, r_in,
              f, plan.vec, plan.threads)
    launches.add()
    return out
