"""Numerically Stable Coded Tensor Convolution (Sec. III).

Tensor-list x matrix encoding (eq. 18), the per-worker grouping, and
decode-from-any-delta-workers (eq. 23/45).  The recovery matrix is built and
inverted in float64 on the host; only its fp32 cast reaches the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .crme import recovery_matrix

__all__ = [
    "encode_tensor_list",
    "group_by_worker",
    "worker_outputs_to_matrix",
    "decode_solve",
    "decode_blocks",
]


def encode_tensor_list(parts: torch.Tensor, matrix) -> torch.Tensor:
    """``parts``: ``(k, *block)``; ``matrix``: ``(k, L)`` (numpy or tensor).

    Returns the coded tensor list ``(L, *block)`` — the tensor-list x matrix
    product of eq. (18): ``out[c] = sum_k matrix[k, c] * parts[k]``.
    """
    k = parts.shape[0]
    assert matrix.shape[0] == k, (parts.shape, matrix.shape)
    m = torch.as_tensor(matrix, dtype=parts.dtype, device=parts.device)
    return torch.tensordot(m, parts, dims=([0], [0]))


def group_by_worker(coded: torch.Tensor, ell: int) -> torch.Tensor:
    """``(ell*n, *block)`` -> ``(n, ell, *block)``."""
    total = coded.shape[0]
    assert total % ell == 0
    return coded.reshape((total // ell, ell) + tuple(coded.shape[1:]))


def worker_outputs_to_matrix(outputs: torch.Tensor) -> torch.Tensor:
    """``(delta, ell2, *block)`` -> ``(delta*ell2, F)`` flattened rows."""
    d, e2 = outputs.shape[:2]
    return outputs.reshape(d * e2, -1)


def decode_solve(e: np.ndarray, coded_rows: torch.Tensor) -> torch.Tensor:
    """Solve ``E^T @ Y_true = Y_coded``: the inverse is taken in float64 on
    the host and applied as one GEMM in the rows' dtype."""
    d = np.linalg.inv(e.T)
    dm = torch.as_tensor(d, dtype=coded_rows.dtype, device=coded_rows.device)
    return dm @ coded_rows


def decode_blocks(a_code, b_code, worker_ids, outputs: torch.Tensor,
                  block_shape: tuple[int, ...]) -> torch.Tensor:
    """Coded worker outputs ``(delta, ell_a*ell_b, *block_shape)`` (stacked
    in ``worker_ids`` order) -> true blocks ``(k_a*k_b, *block_shape)``
    ordered A-major (``a * k_b + b``)."""
    e = recovery_matrix(a_code, b_code, worker_ids)
    true_rows = decode_solve(e, worker_outputs_to_matrix(outputs))
    q = a_code.k * b_code.k
    return true_rows.reshape((q,) + tuple(block_shape))
