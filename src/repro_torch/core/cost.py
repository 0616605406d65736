"""FCDCC cost model and optimal (k_A, k_B) selection (Sec. IV-E, Thm. 1).

All volumes are tensor-entry / MAC counts (eqs. 50-55); costs weight them by
(lambda_comm, lambda_comp, lambda_store).
"""
from __future__ import annotations

import dataclasses
import math

from .partition import ConvGeometry

__all__ = ["CostWeights", "CostBreakdown", "cost_breakdown", "optimal_partition",
           "continuous_optimum"]


@dataclasses.dataclass(frozen=True)
class CostWeights:
    comm: float = 0.09  # AWS S3 egress $/GB ratio used by the paper (Exp. 5)
    store: float = 0.023
    comp: float = 0.0


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    v_comm_up: float
    v_comm_down: float
    m_comp: float
    v_store: float
    c_comm: float
    c_comp: float
    c_store: float

    @property
    def total(self) -> float:
        return self.c_comm + self.c_comp + self.c_store


def cost_breakdown(geo: ConvGeometry, k_a: int, k_b: int, w: CostWeights) -> CostBreakdown:
    """Per-node volumes & costs for a (k_a, k_b) split (eqs. 50-55), with
    the paper's constants (4 = ell_a*ell_b coded copies, 2 = ell_b coded
    filter partitions) kept so Table IV reproduces exactly."""
    q = k_a * k_b
    c, n_out = geo.in_channels, geo.out_channels
    hp, wp = geo.padded_h, geo.padded_w
    ho, wo = geo.out_h, geo.out_w

    v_up = 4 * c * hp * wp / k_a
    v_down = 4 * n_out * ho * wo / q
    m_comp = (
        4 * c * n_out * geo.height * geo.width * geo.kernel_h * geo.kernel_w
        / (geo.stride**2 * q)
    )
    v_store = 2 * n_out * c * geo.kernel_h * geo.kernel_w / k_b

    return CostBreakdown(
        v_comm_up=v_up,
        v_comm_down=v_down,
        m_comp=m_comp,
        v_store=v_store,
        c_comm=w.comm * (v_up + v_down),
        c_comp=w.comp * m_comp,
        c_store=w.store * v_store,
    )


def _feasible_factors(q: int) -> list[tuple[int, int]]:
    """(k_a, k_b) with k_a*k_b = Q and each in S = {1} U 2Z+."""
    def ok(k):
        return k == 1 or k % 2 == 0

    return [(k_a, q // k_a) for k_a in range(1, q + 1)
            if q % k_a == 0 and ok(k_a) and ok(q // k_a)]


def optimal_partition(
    geo: ConvGeometry, q: int, w: CostWeights = CostWeights()
) -> tuple[tuple[int, int], float, dict[tuple[int, int], float]]:
    """Exact discrete optimum over S x S with k_a*k_b = Q.

    Returns ``((k_a*, k_b*), U*, {feasible -> U})``.
    """
    landscape = {
        kk: cost_breakdown(geo, kk[0], kk[1], w).total for kk in _feasible_factors(q)
    }
    best = min(landscape, key=landscape.get)
    return best, landscape[best], landscape


def continuous_optimum(geo: ConvGeometry, q: int, w: CostWeights = CostWeights()) -> float:
    """Theorem 1's closed form k_A* = sqrt(a2/a1)."""
    a1 = w.store * 2 * geo.out_channels * geo.in_channels * geo.kernel_h * geo.kernel_w / q
    a2 = w.comm * 4 * geo.in_channels * geo.padded_h * geo.padded_w
    return math.sqrt(a2 / a1) if a1 > 0 else float("inf")
