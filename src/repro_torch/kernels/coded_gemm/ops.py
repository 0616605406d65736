"""CRME encode/decode on the coded-GEMM kernel (K3).

Mirrors ``src/repro/kernels/coded_gemm/ops.py:31-46``: both NSCTC phases
are ``small code matrix @ wide feature matrix``, with the blocks flattened
into the feature axis.  The reference's autotune-ledger lookup has no
counterpart: K3 plans its own launch (``coded_gemm_plan``).  Code matrices
stay on the host, in the operands' dtype: K3 takes them by value.
"""
from __future__ import annotations

import torch

from .kernel import coded_gemm

__all__ = ["crme_encode", "crme_decode"]


def crme_encode(parts: torch.Tensor, matrix) -> torch.Tensor:
    """``parts`` (k, *block), ``matrix`` (k, ell*n) -> (ell*n, *block):
    ``out[c] = sum_k matrix[k, c] * parts[k]``."""
    k = parts.shape[0]
    rows = parts.reshape(k, -1)
    m = torch.as_tensor(matrix, dtype=parts.dtype)
    out = coded_gemm(m.t().contiguous(), rows.contiguous())
    return out.reshape((m.shape[1],) + tuple(parts.shape[1:]))


def crme_decode(decode_matrix, coded: torch.Tensor) -> torch.Tensor:
    """``decode_matrix`` (Q, Q) = inv(E^T), on the host; ``coded`` (Q,
    *block)."""
    q = coded.shape[0]
    rows = coded.reshape(q, -1)
    d = torch.as_tensor(decode_matrix, dtype=coded.dtype)
    return coded_gemm(d.contiguous(), rows.contiguous()).reshape(coded.shape)
