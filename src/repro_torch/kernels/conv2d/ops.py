"""Public conv ops used by ``CodedConv2d``'s ``backend="kernel"`` path."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..matmul.kernel import matmul
from .kernel import coded_worker

__all__ = ["conv2d_im2col", "coded_worker", "coded_transition",
           "transition_gemms"]


def conv2d_im2col(x: torch.Tensor, k: torch.Tensor, stride: int = 1,
                  padding: int = 0) -> torch.Tensor:
    """``x``: (C, H, W); ``k``: (N, C, KH, KW) -> (N, H', W').

    The one-share/one-group/one-image case of the worker kernel (the
    counterpart of ``conv2d_im2col_pallas``, which delegates the same way):
    the paper-literal unfused worker loop runs through it."""
    if padding:
        x = F.pad(x, (padding,) * 4)
    return coded_worker(x[None].contiguous(), k[None].contiguous(), stride)[0]


def coded_transition(outs: torch.Tensor, d: torch.Tensor, m_next: torch.Tensor,
                     assemble) -> torch.Tensor:
    """One partition-resident layer transition: decode GEMM with the ReLU
    fused into its store -> partition-space pool/halo re-slice ->
    re-encode GEMM (counterpart of ``coded_transition_pallas``).

    ``outs``: fastest-delta worker outputs ``(delta, ell2, *block)``;
    ``d``: the ``(Q, Q)`` decode inverse; ``m_next``: the next layer's
    A-code encode columns ``(k_a', L)``; ``assemble``: the
    geometry-specialised ``partition_transition`` (torch slicing and max).
    Returns the coded next-layer input shares ``(L, *part)``.  The two K2
    launches' shapes are ``transition_gemms``'."""
    q = d.shape[0]
    rows = outs.reshape(outs.shape[0] * outs.shape[1], -1)
    decoded = matmul(d.to(rows.dtype).contiguous(), rows, relu=True)
    parts = assemble(decoded.reshape((q,) + tuple(outs.shape[2:])))
    k2 = parts.shape[0]
    cols_t = m_next.to(parts.dtype).t().contiguous()  # (L, k_a')
    coded = matmul(cols_t, parts.reshape(k2, -1))
    return coded.reshape((cols_t.shape[0],) + tuple(parts.shape[1:]))


def transition_gemms(outs_shape, q: int, widths, assemble) -> list[tuple]:
    """``(m, k, n, relu)`` of each K2 launch of ``coded_transition`` for
    worker outputs of ``outs_shape`` and a ``(q, q)`` decode inverse: the
    decode GEMM, then the re-encode GEMM at each of ``widths`` encode
    columns.  The parts' shape is ``assemble``'s on a meta tensor, so
    nothing runs."""
    rows = outs_shape[0] * outs_shape[1]
    parts = assemble(torch.empty((q,) + tuple(outs_shape[2:]), device="meta"))
    k2, fp = parts.shape[0], math.prod(parts.shape[1:])
    return ([(q, rows, math.prod(outs_shape[2:]), True)]
            + [(w, k2, fp, False) for w in widths])
