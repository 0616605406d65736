"""K1: one worker's coded subtask as one implicit-GEMM convolution
(``csrc/coded_worker.cu``) and its plain PyTorch version.

Counterpart of the TPU kernel ``coded_worker_pallas``
(``src/repro/kernels/conv2d/kernel.py:291``).  The ``ell_a`` coded input
shares (times the request batch) ride the GEMM's M dimension and the
``ell_b`` coded filter groups its N dimension, so one launch computes the
paper's ``ell_a * ell_b`` pairwise convolutions of one worker.
``coded_worker`` launches the CUDA kernel for CUDA tensors and runs
``coded_worker_plain`` only for tensors that lie on the CPU.
``worker_plan`` chooses the kernel's N-tile and K split per layer, unless
the autotune ledger holds a plan for the cell (``choose_worker_plan``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from typing import NamedTuple

from .. import autotune
from ..native import NUM_SMS, LaunchCounter, launch_on, load_library

__all__ = ["coded_worker", "coded_worker_plain", "worker_plan", "WorkerPlan",
           "gemm_shape", "worker_plan_of", "choose_worker_plan",
           "launch_worker", "launches"]

launches = LaunchCounter("coded_worker")

TILE_M = 128  # output rows (pixels) a block owns
TILE_K = 16  # depth of one copy stage
MAX_K = 16384  # the kernel's k -> offset table
MIN_SPLIT_CHUNKS = 8  # stages a K slice keeps at least
SPLIT_CHOICES = (1, 2, 4, 8)  # K slices per tile: one thread-block cluster
BN_CHOICES = (32, 64, 128)  # the kernel's N-tiles
_MAX_COL_BLOCKS = 65535  # grid.y limit


class WorkerPlan(NamedTuple):
    """How K1 launches one worker GEMM of ``M`` pixels x ``N`` filters x
    ``K`` taps: ``128 x bn`` output tiles, K cut into ``splits`` slices of
    ``k_slice`` taps (a whole number of 16-deep stages; one thread-block
    cluster per tile; the kernel computes the same slices), ``blocks``
    blocks in all."""
    bn: int
    splits: int
    k_slice: int
    tiles: int
    blocks: int


def worker_plan(m: int, n: int, k: int) -> WorkerPlan:
    """The launch K1 uses for a worker GEMM of shape ``(m, n, k)``.

    The N-tile follows the layer's N: 32 up to N = 32 (VGG-16's first
    layers would leave half of a wider tile idle), 64 up to N = 128 (two
    64-column tiles double the blocks of a 128-column layer, with the
    same 8x8 micro-tile a thread), else 128 (enough blocks, and a wider
    tile reads each patch element for twice the columns).  Where the
    ``ceil(m/128) * ceil(n/bn)`` tiles are fewer than the SMs, K is cut
    into the fewest slices (2, 4 or 8) that give at least one block a SM,
    keeping every slice at least ``MIN_SPLIT_CHUNKS`` stages deep."""
    bn = 32 if n <= 32 else 64 if n <= 128 else 128
    tiles = -(-m // TILE_M) * -(-n // bn)
    chunks = -(-k // TILE_K)
    splits = 1
    if tiles < NUM_SMS:
        for s in SPLIT_CHOICES[1:]:
            if chunks < s * MIN_SPLIT_CHUNKS:
                break
            splits = s
            if tiles * s >= NUM_SMS:
                break
    return _plan(bn, splits, m, n, k)


def _plan(bn: int, splits: int, m: int, n: int, k: int) -> WorkerPlan:
    tiles = -(-m // TILE_M) * -(-n // bn)
    chunks = -(-k // TILE_K)
    return WorkerPlan(bn, splits, -(-chunks // splits) * TILE_K, tiles,
                      tiles * splits)


def worker_plan_of(params: dict, m: int, n: int, k: int) -> WorkerPlan:
    """The plan a ledger entry's ``{"bn", "splits"}`` names for a worker
    GEMM of shape ``(m, n, k)``.  Raises ``ValueError`` where K1 cannot
    launch it: an N-tile or split it lacks, or a K slice shallower than
    ``MIN_SPLIT_CHUNKS`` stages."""
    if not isinstance(params, dict) or set(params) != {"bn", "splits"}:
        raise ValueError(f"K1 plan {params!r}: want {{'bn', 'splits'}}")
    bn, splits = params["bn"], params["splits"]
    chunks = -(-k // TILE_K)
    if (type(bn) is not int or type(splits) is not int
            or bn not in BN_CHOICES or splits not in SPLIT_CHOICES
            or (splits > 1 and chunks < splits * MIN_SPLIT_CHUNKS)):
        raise ValueError(f"K1 plan {params!r} does not launch for K = {k}: "
                         f"bn in {BN_CHOICES}, splits in {SPLIT_CHOICES} with "
                         f"at least {MIN_SPLIT_CHUNKS} stages a slice")
    return _plan(bn, splits, m, n, k)


def choose_worker_plan(xe_shape, ke_shape, stride: int,
                       device=None) -> WorkerPlan:
    """The plan K1 launches for a worker cell on ``device``: the autotune
    ledger's where it records one (``autotune.worker_params``; never a
    sweep), else ``worker_plan``'s."""
    m, n, k = gemm_shape(xe_shape, ke_shape, stride)
    params = autotune.worker_params(tuple(xe_shape), tuple(ke_shape), stride,
                                    device=device)
    return worker_plan(m, n, k) if params is None else worker_plan_of(
        params, m, n, k)


def gemm_shape(xe_shape, ke_shape, stride: int) -> tuple[int, int, int]:
    """``(M, N, K)`` of the worker GEMM: pixels, filters, taps."""
    _, ea, b, c, _, _, eb, nb, kh, kw, ho, wo = _geometry(xe_shape, ke_shape,
                                                         stride)
    return ea * b * ho * wo, eb * nb, c * kh * kw


def _geometry(xe_shape, ke_shape, stride: int):
    xe_shape, ke_shape = tuple(xe_shape), tuple(ke_shape)
    if len(xe_shape) not in (4, 5) or len(ke_shape) != 5:
        raise ValueError(f"coded shares {xe_shape} / filters {ke_shape}: "
                         f"want (ell_a, [B,] C, H, W) and "
                         f"(ell_b, N/k_b, C, KH, KW)")
    batched = len(xe_shape) == 5
    ea = xe_shape[0]
    b = xe_shape[1] if batched else 1
    c, hh, wp = xe_shape[-3:]
    eb, nb, c2, kh, kw = ke_shape
    if c != c2:
        raise ValueError(f"channel mismatch: shares {c}, filters {c2}")
    if stride < 1 or hh < kh or wp < kw:
        raise ValueError(f"VALID conv of {hh}x{wp} by {kh}x{kw}, stride {stride}")
    ho = (hh - kh) // stride + 1
    wo = (wp - kw) // stride + 1
    return batched, ea, b, c, hh, wp, eb, nb, kh, kw, ho, wo


def coded_worker_plain(xe: torch.Tensor, ke: torch.Tensor,
                       stride: int = 1) -> torch.Tensor:
    """``unfold`` + matmul: the same function as K1, for the CPU and for
    holding the kernel against on the card."""
    batched, ea, b, c, hh, wp, eb, nb, kh, kw, ho, wo = _geometry(
        xe.shape, ke.shape, stride)
    cols = F.unfold(xe.reshape(ea * b, c, hh, wp), (kh, kw), stride=stride)
    y = torch.matmul(ke.reshape(eb * nb, c * kh * kw), cols)  # (G, N, H'W')
    y = y.reshape(ea, b, eb, nb, ho, wo).permute(0, 2, 1, 3, 4, 5)
    y = y.reshape(ea * eb, b, nb, ho, wo)
    return y if batched else y[:, 0]


def coded_worker(xe: torch.Tensor, ke: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """One worker's fused coded subtask.

    ``xe``: coded input shares ``(ell_a, [B,] C, h_hat, Wp)``, already
    conv-padded by APCP (the convolution is VALID).  ``ke``: coded filter
    groups ``(ell_b, N/k_b, C, KH, KW)``.  Returns
    ``(ell_a*ell_b, [B,] N/k_b, H'/k_a, W')``, slot ``ell_b * b1 + b2``.
    """
    batched = _geometry(xe.shape, ke.shape, stride)[0]
    if xe.device != ke.device:
        raise ValueError(f"shares on {xe.device}, filters on {ke.device}")
    if xe.device.type == "cpu":
        return coded_worker_plain(xe, ke, stride)
    if xe.device.type != "cuda":
        raise ValueError(f"coded_worker runs on cuda or cpu, got {xe.device}")
    if xe.dtype != torch.float32 or ke.dtype != torch.float32:
        raise TypeError(f"K1 takes float32 only, got {xe.dtype} / {ke.dtype}")
    if not (xe.is_contiguous() and ke.is_contiguous()):
        raise ValueError("K1 takes contiguous shares and filters")
    plan = choose_worker_plan(xe.shape, ke.shape, stride, xe.device)
    out = launch_worker(plan, xe, ke, stride)
    launches.add()
    return out if batched else out[:, 0]


def launch_worker(plan: WorkerPlan, xe: torch.Tensor, ke: torch.Tensor,
                  stride: int) -> torch.Tensor:
    """Launch K1 on CUDA operands that ``coded_worker`` has checked, as
    ``plan`` says; the output ``(ell_a*ell_b, B, N/k_b, H', W')``.  Counts
    no launch: the wrapper does (an autotune sweep launches here too)."""
    _, ea, b, c, hh, wp, eb, nb, kh, kw, ho, wo = _geometry(xe.shape, ke.shape,
                                                           stride)
    if -(-(eb * nb) // plan.bn) > _MAX_COL_BLOCKS:
        raise ValueError(f"N={eb * nb} exceeds the kernel's column-block grid")
    if c * kh * kw > MAX_K or c * hh * wp >= 2 ** 31:
        raise ValueError(f"K={c * kh * kw} or C*H*W={c * hh * wp} exceeds "
                         f"the kernel's offset table")
    out = torch.empty((ea * eb, b, nb, ho, wo), dtype=torch.float32,
                      device=xe.device)
    launch_on("coded_worker_f32", xe, load_library().coded_worker_f32,
              xe.data_ptr(), ke.data_ptr(), out.data_ptr(), c, hh, wp, kh, kw,
              stride, ea * b, b, eb, nb, plan.bn, plan.splits)
    return out
