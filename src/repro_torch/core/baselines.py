"""Baseline coded / uncoded schemes the paper compares against.

* ``PolyAxisCode`` — classical real polynomial codes [Yu et al. '17]:
  evaluation points on the real line; condition number grows exponentially
  in n (the instability the paper demonstrates in Fig. 3/4).
* ``chebyshev_points`` variant — Fahim–Cadambe-style numerically-stable
  polynomial coding via Chebyshev evaluation points (better than raw real
  points, still exponential asymptotically, per Fig. 4).
* Uncoded model-parallel splits of Table II (spatial / out-channel /
  in-channel partitioning) with no straggler resilience.

The polynomial codes reuse the NSCTC encode/decode machinery via the
AxisCode protocol (ell = 1: one coded X and one coded K per worker, a single
conv per worker, recovery threshold delta = k_a * k_b).  Their matrices are
float64 numpy, like the CRME codes; the splits take torch tensors and
convolve in IEEE fp32 (TF32 off).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .partition import ConvGeometry, apcp_partition

__all__ = [
    "PolyAxisCode",
    "real_points",
    "chebyshev_points",
    "make_poly_codes",
    "poly_recovery_matrix",
    "uncoded_spatial",
    "uncoded_out_channel",
    "uncoded_in_channel",
]


@dataclasses.dataclass(frozen=True)
class PolyAxisCode:
    """Polynomial (Vandermonde) code along one axis. ell == 1."""

    k: int
    n: int
    ell: int
    base: int
    matrix: np.ndarray  # (k, n)

    def worker_columns(self, i: int) -> np.ndarray:
        return self.matrix[:, i:i + 1]


def real_points(n: int) -> np.ndarray:
    """Evaluation points used by the classical real polynomial code."""
    return np.linspace(-1.0, 1.0, n)


def chebyshev_points(n: int) -> np.ndarray:
    """Fahim–Cadambe-style Chebyshev points cos((2j+1)pi/2n)."""
    j = np.arange(n)
    return np.cos((2 * j + 1) * np.pi / (2 * n))


def make_poly_codes(k_a: int, k_b: int, n: int, points: np.ndarray):
    """A[a, j] = x_j^a ; B[b, j] = x_j^{b*k_a} — distinct joint degrees."""
    a = np.stack([points**d for d in range(k_a)], axis=0)
    b = np.stack([points ** (d * k_a) for d in range(k_b)], axis=0)
    return (
        PolyAxisCode(k=k_a, n=n, ell=1, base=1, matrix=a),
        PolyAxisCode(k=k_b, n=n, ell=1, base=k_a, matrix=b),
    )


def poly_recovery_matrix(a: PolyAxisCode, b: PolyAxisCode, workers) -> np.ndarray:
    cols = [np.kron(a.matrix[:, i], b.matrix[:, i]) for i in workers]
    e = np.stack(cols, axis=1)
    assert e.shape == (a.k * b.k, a.k * b.k), e.shape
    return e


# ---------------------------------------------------------------------------
# Uncoded model-parallel baselines (Table II) — no straggler resilience.
# ---------------------------------------------------------------------------


def _conv(x: torch.Tensor, k: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """One (C, H, W) * (N, C, KH, KW) conv in IEEE fp32."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return F.conv2d(x[None], k, stride=stride, padding=padding)[0]


def uncoded_spatial(x: torch.Tensor, k: torch.Tensor, stride: int, padding: int,
                    k_a: int) -> torch.Tensor:
    """Spatial partitioning [42]: k_a workers, concat along H'."""
    geo = ConvGeometry(
        in_channels=x.shape[0], out_channels=k.shape[0], height=x.shape[1],
        width=x.shape[2], kernel_h=k.shape[2], kernel_w=k.shape[3],
        stride=stride, padding=padding, k_a=k_a, k_b=1,
    )
    parts = apcp_partition(x, geo)  # (k_a, C, h_hat, Wp)
    y = torch.cat([_conv(parts[i], k, stride, 0) for i in range(k_a)], dim=1)
    return y[:, :geo.out_h, :]


def uncoded_out_channel(x: torch.Tensor, k: torch.Tensor, stride: int,
                        padding: int, k_b: int) -> torch.Tensor:
    """Output-channel partitioning [43]: k_b workers, concat along N."""
    n = k.shape[0]
    assert n % k_b == 0
    parts = k.reshape((k_b, n // k_b) + tuple(k.shape[1:]))
    return torch.cat([_conv(x, parts[i], stride, padding) for i in range(k_b)],
                     dim=0)


def uncoded_in_channel(x: torch.Tensor, k: torch.Tensor, stride: int,
                       padding: int, k_c: int) -> torch.Tensor:
    """Input-channel partitioning [44]: k_c workers, SUM merge."""
    c = x.shape[0]
    assert c % k_c == 0
    xs = x.reshape((k_c, c // k_c) + tuple(x.shape[1:]))
    ks = k.reshape((k.shape[0], k_c, c // k_c) + tuple(k.shape[2:])).transpose(0, 1)
    outs = torch.stack([_conv(xs[i], ks[i], stride, padding) for i in range(k_c)])
    return outs.sum(dim=0)
