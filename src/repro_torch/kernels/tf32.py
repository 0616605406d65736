"""The 3xTF32 kernels' operand split in torch ops (``split_tf32``), shared
by K1 (``conv2d``) and K4 (``flash_attn``) as ``csrc/hopper.cuh`` shares
the device side (``cvt_tf32``, ``split``), for holding their precision on
the CPU."""
from __future__ import annotations

import torch

__all__ = ["split_tf32"]

_TF32_DROP = 0x1FFF  # the 13 low mantissa bits TF32 does not keep
_TF32_MAX_BITS = 0x7F7FE000  # the largest finite TF32 value


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``t = hi + lo`` as the tensor-core kernels split their fp32 operands:
    ``hi`` is ``t`` rounded to TF32 (10 mantissa bits, nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``; a finite value that would
    round past the largest TF32 number saturates there), ``lo`` is ``t -
    hi`` (exact in fp32) rounded the same way.  NaN and inf pass through
    into ``hi`` with ``lo = 0``.  ``hi + lo`` is within 2^-22 of ``|t|``
    (plus half the TF32 subnormal spacing, 2^-137)."""
    if t.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {t.dtype}")
    hi = _round_tf32(t)
    finite = torch.isfinite(hi)
    lo = torch.where(finite, _round_tf32(torch.where(finite, t - hi, 0.0)),
                     0.0)
    return hi, lo


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    sign = bits & ~0x7FFFFFFF
    finite = mag < 0x7F800000
    # round the magnitude half away from zero at bit 13, then drop 13 bits
    rounded = ((mag + 0x1000) & ~_TF32_DROP).clamp_max(_TF32_MAX_BITS)
    return torch.where(finite, sign | rounded, bits).view(torch.float32)
