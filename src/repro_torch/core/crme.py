"""Circulant & Rotation Matrix Embedding (CRME) code construction.

Implements the encoding-matrix algebra of the paper (Sec. III): rotation
blocks ``R_theta^k`` with ``theta = 2*pi/q``, ``q = NextOdd(n)`` odd and
``q >= n``.  The coded evaluation points are effectively the complex roots of
unity ``exp(i * 2*pi*j/q)`` embedded in 2x2 real rotation blocks, which keeps
the recovery (generalized Vandermonde) matrix polynomially conditioned —
``kappa = O(n^{gamma+5.5})`` — versus the exponential blowup of real
Vandermonde codes.

All matrices here are small (``k x ell*n``) and built eagerly in float64
NumPy; they are constants of the distributed program, never traced.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

__all__ = [
    "next_odd",
    "rotation_matrix",
    "CrmeAxisCode",
    "make_axis_codes",
    "joint_columns",
    "recovery_matrix",
    "condition_number",
]


def next_odd(n: int) -> int:
    """Smallest odd integer ``q >= n`` (Algorithm 1's ``Nextodd``)."""
    return n if n % 2 == 1 else n + 1


def rotation_matrix(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class CrmeAxisCode:
    """CRME code along one partition axis.

    ``matrix`` has shape ``(k, ell * n)``: column block ``j`` holds the
    ``ell`` coded combinations sent to worker ``j``.

    ``ell == 2`` for genuine CRME coding (k even, k >= 2); the degenerate
    ``k == 1`` axis uses ``ell == 1`` with an all-ones matrix, i.e. the
    uncoded replication limit in which FCDCC collapses to plain spatial or
    channel partitioning (Table II).
    """

    k: int
    n: int
    q: int
    ell: int
    base: int  # exponent multiplier: A uses 1, B uses k_A/2 (eq. 16)
    matrix: np.ndarray  # (k, ell*n), float64

    def worker_columns(self, i: int) -> np.ndarray:
        """The ``(k, ell)`` columns assigned to worker ``i``."""
        return self.matrix[:, self.ell * i : self.ell * (i + 1)]


def _crme_matrix(k: int, n: int, q: int, base: int) -> np.ndarray:
    """Eq. (17): block (a, j) of the (k x 2n) matrix is R_theta^{base*j*a}."""
    theta = 2.0 * np.pi / q
    m = np.zeros((k, 2 * n), dtype=np.float64)
    for a in range(k // 2):
        for j in range(n):
            blk = rotation_matrix(theta * base * j * a)
            m[2 * a : 2 * a + 2, 2 * j : 2 * j + 2] = blk
    return m


@lru_cache(maxsize=None)
def make_axis_codes(k_a: int, k_b: int, n: int, q: int | None = None):
    """Build the (A, B) axis codes for an FCDCC plan.

    ``A`` codes the ``k_a`` input partitions with exponent base 1; ``B``
    codes the ``k_b`` filter partitions with exponent base ``k_a/2`` so the
    Kronecker product spans distinct "degrees" ``a + b*k_a/2`` (eq. 16) —
    exactly the polynomial-code degree layout, evaluated on the unit circle.
    """
    if k_a < 1 or k_b < 1:
        raise ValueError("k_a and k_b must be >= 1")
    for name, k in (("k_a", k_a), ("k_b", k_b)):
        if k != 1 and k % 2 != 0:
            raise ValueError(f"{name} must be 1 or even for CRME (got {k})")
    q = next_odd(n) if q is None else q
    if q < n or q % 2 == 0:
        raise ValueError(f"q must be odd and >= n (got q={q}, n={n})")

    ell_a = 1 if k_a == 1 else 2
    ell_b = 1 if k_b == 1 else 2
    delta = (k_a * k_b) // (ell_a * ell_b)
    if delta > n:
        raise ValueError(
            f"recovery threshold delta={delta} exceeds n={n}; "
            f"need k_a*k_b/(ell_a*ell_b) <= n"
        )

    if ell_a == 1:
        a_mat = np.ones((1, n), dtype=np.float64)
    else:
        a_mat = _crme_matrix(k_a, n, q, base=1)

    b_base = max(k_a // 2, 1)
    if ell_b == 1:
        b_mat = np.ones((1, n), dtype=np.float64)
    else:
        b_mat = _crme_matrix(k_b, n, q, base=b_base)

    a = CrmeAxisCode(k=k_a, n=n, q=q, ell=ell_a, base=1, matrix=a_mat)
    b = CrmeAxisCode(k=k_b, n=n, q=q, ell=ell_b, base=b_base, matrix=b_mat)
    return a, b


def joint_columns(a: CrmeAxisCode, b: CrmeAxisCode, worker: int) -> np.ndarray:
    """All ``ell_a*ell_b`` joint (Kronecker) columns of worker ``i``.

    Returns ``(k_a*k_b, ell_a*ell_b)``; output slot ``beta3 = ell_b*b1 + b2``
    corresponds to coded conv ``X~_{i,b1} * K~_{i,b2}`` and to column
    ``kron(A[:, ell_a*i+b1], B[:, ell_b*i+b2])`` (eq. 20/21, with the
    ordering fixed as documented in DESIGN.md §7).
    """
    a_cols = a.worker_columns(worker)  # (k_a, ell_a)
    b_cols = b.worker_columns(worker)  # (k_b, ell_b)
    cols = []
    for b1 in range(a.ell):
        for b2 in range(b.ell):
            cols.append(np.kron(a_cols[:, b1], b_cols[:, b2]))
    return np.stack(cols, axis=1)  # (k_a*k_b, ell_a*ell_b)


def recovery_matrix(a: CrmeAxisCode, b: CrmeAxisCode, workers) -> np.ndarray:
    """Recovery matrix E (eq. 42) from the given finished-worker indices.

    ``E`` is ``(Q, ell_a*ell_b*delta) = (Q, Q)``; decoding solves
    ``Y_coded = E^T @ Y_true`` for the true output blocks.
    """
    q_total = a.k * b.k
    need = q_total // (a.ell * b.ell)
    workers = list(workers)
    if len(workers) != need:
        raise ValueError(f"need exactly delta={need} workers, got {len(workers)}")
    e = np.concatenate([joint_columns(a, b, i) for i in workers], axis=1)
    assert e.shape == (q_total, q_total)
    return e


def condition_number(e: np.ndarray) -> float:
    return float(np.linalg.cond(e))
