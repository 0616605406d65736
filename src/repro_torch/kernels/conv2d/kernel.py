"""K1: one worker's coded subtask as one implicit-GEMM convolution
(``csrc/coded_worker.cu``) and its plain PyTorch version.

Counterpart of the TPU kernel ``coded_worker_pallas``
(``src/repro/kernels/conv2d/kernel.py:291``).  The ``ell_a`` coded input
shares (times the request batch) ride the GEMM's M dimension and the
``ell_b`` coded filter groups its N dimension, so one launch computes the
paper's ``ell_a * ell_b`` pairwise convolutions of one worker.
``coded_worker`` launches a CUDA kernel for CUDA tensors and runs
``coded_worker_plain`` only for tensors that lie on the CPU.  The source
holds two kernels: the tensor-core kernel (route ``"tc"``: 3xTF32 on
``wgmma``, each fp32 operand split into a TF32 high and low part) and the
FFMA kernel (route ``"ffma"``: IEEE fp32 outside the tensor cores).
``worker_plan`` chooses the route, N-tile and K split per layer, unless
the autotune ledger holds a plan for the cell (``choose_worker_plan``).
``split_tf32`` (``kernels/tf32.py``, shared with K4) and
``coded_worker_3xtf32_plain`` are the tensor-core kernel's arithmetic in
torch ops, for holding its precision on the CPU; no path of the port runs
them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from typing import NamedTuple

from .. import autotune
from ..native import NUM_SMS, LaunchCounter, launch_on, load_library
from ..tf32 import split_tf32

__all__ = ["coded_worker", "coded_worker_plain", "worker_plan", "WorkerPlan",
           "gemm_shape", "worker_plan_of", "choose_worker_plan",
           "launch_worker", "launches", "split_tf32",
           "coded_worker_3xtf32_plain", "ROUTES", "plan_params",
           "route_plan", "route_launches"]

launches = LaunchCounter("coded_worker")

TILE_M = 128  # output rows (pixels) a block owns, both routes
ROUTES = ("tc", "ffma")  # the tensor-core kernel, the FFMA kernel
# each route's kernel launches; together they are ``launches``
route_launches = {r: LaunchCounter(f"coded_worker.{r}") for r in ROUTES}
# depth of one copy stage; the fewest stages a K slice keeps
TILE_K = {"tc": 32, "ffma": 16}
MIN_SPLIT_CHUNKS = {"tc": 4, "ffma": 8}
MAX_K = 16384  # the FFMA kernel's k -> offset table
SPLIT_CHOICES = (1, 2, 4, 8)  # K slices per tile: one thread-block cluster
BN_CHOICES = (32, 64, 128)  # the N-tiles, both routes
# blocks of the tensor-core kernel an SM holds, by N-tile (its shared
# memory: four stages of patches and filter halves)
TC_BLOCKS_PER_SM = {32: 2, 64: 1, 128: 1}
_MAX_COL_BLOCKS = 65535  # grid.y limit


class WorkerPlan(NamedTuple):
    """How K1 launches one worker GEMM of ``M`` pixels x ``N`` filters x
    ``K`` taps: on ``route`` (``"tc"``, the tensor-core kernel, or
    ``"ffma"``), ``128 x bn`` output tiles, K cut into ``splits`` slices
    of ``k_slice`` taps (a whole number of the route's ``TILE_K``-deep
    stages; one thread-block cluster per tile; the kernel computes the
    same slices), ``blocks`` blocks in all."""
    route: str
    bn: int
    splits: int
    k_slice: int
    tiles: int
    blocks: int


def worker_plan(m: int, n: int, k: int) -> WorkerPlan:
    """The launch K1 uses for a worker GEMM of shape ``(m, n, k)``, at
    ``route_plan``'s tiles.  The tensor-core kernel, except where K fits
    in one of its 32-deep stages: there its pipeline has nothing to
    overlap, and the FFMA kernel was faster on an H100 (VGG-16's first
    layer, K 27: 0.0672 against 0.0952 device ms, ``scripts/
    torch_k1_sweep.py``)."""
    return route_plan("ffma" if k <= TILE_K["tc"] else "tc", m, n, k)


def route_plan(route: str, m: int, n: int, k: int) -> WorkerPlan:
    """The design's launch of ``route``'s kernel for a worker GEMM of shape
    ``(m, n, k)``.

    The N-tile follows the layer's N: 32 up to N = 32 (VGG-16's first
    layers would leave half of a wider tile idle), then on the tensor-core
    route 64 up to N = 64, else 128 (a 256-wide tile with its filters'
    high and low blocks leaves room for two stages only); on the FFMA
    route 64 up to N = 128 (two 64-column tiles double the blocks of a
    128-column layer, with the same 8x8 micro-tile a thread), else 128.

    K splits keep every slice at least ``MIN_SPLIT_CHUNKS[route]``
    stages deep.  On the tensor-core route K is cut into the fewest
    slices (1, 2, 4 or 8) whose last wave of blocks fills at least half
    of the ``slots`` the card holds at once (the ``ceil(m/128) *
    ceil(n/bn)`` tiles times the slices); where none does, into the
    slices that fill it most.  Measured on an H100 at VGG-16's shapes,
    the kernel runs as fast on 98 of 132 SMs as on all of them (its
    patch gather shares the L2 among the SMs), so a wave half full costs
    little and a split costs its cluster reduction.  On the FFMA route,
    where the tiles are fewer than the SMs, K is cut into the fewest
    slices that give at least one block a SM."""
    if route not in ROUTES:
        raise ValueError(f"K1 route {route!r}: one of {ROUTES}")
    wide = 64 if route == "tc" else 128
    bn = 32 if n <= 32 else 64 if n <= wide else 128
    tiles = -(-m // TILE_M) * -(-n // bn)
    chunks = -(-k // TILE_K[route])
    least = MIN_SPLIT_CHUNKS[route]
    splits = 1
    if route == "tc":
        slots = NUM_SMS * TC_BLOCKS_PER_SM[bn]
        cands = [s for s in SPLIT_CHOICES if s == 1 or chunks >= s * least]

        def last(s):  # blocks in the last wave
            return (tiles * s - 1) % slots + 1

        half = [s for s in cands if 2 * last(s) >= slots]
        splits = half[0] if half else max(cands, key=last)
    elif tiles < NUM_SMS:
        for s in SPLIT_CHOICES[1:]:
            if chunks < s * least:
                break
            splits = s
            if tiles * s >= NUM_SMS:
                break
    return _plan(route, bn, splits, m, n, k)


def _plan(route: str, bn: int, splits: int, m: int, n: int,
          k: int) -> WorkerPlan:
    tiles = -(-m // TILE_M) * -(-n // bn)
    chunks = -(-k // TILE_K[route])
    return WorkerPlan(route, bn, splits,
                      -(-chunks // splits) * TILE_K[route], tiles,
                      tiles * splits)


def plan_params(plan: WorkerPlan) -> dict:
    """The ledger's record of ``plan``: ``{"route", "bn", "splits"}``."""
    return {"route": plan.route, "bn": plan.bn, "splits": plan.splits}


def worker_plan_of(params: dict, m: int, n: int, k: int) -> WorkerPlan:
    """The plan a ledger entry's ``{"route", "bn", "splits"}`` names for a
    worker GEMM of shape ``(m, n, k)``.  Raises ``ValueError`` where K1
    cannot launch it: a route, N-tile or split it lacks, a K slice
    shallower than the route's ``MIN_SPLIT_CHUNKS`` stages, or an entry
    without a route (recorded before the tensor-core kernel, for the FFMA
    kernel alone: it is never applied to either kernel)."""
    if not isinstance(params, dict) or set(params) != {"route", "bn",
                                                       "splits"}:
        raise ValueError(f"K1 plan {params!r}: want {{'route', 'bn', "
                         f"'splits'}} (an entry without a route predates "
                         f"the tensor-core kernel: sweep the cell again)")
    route, bn, splits = params["route"], params["bn"], params["splits"]
    if route not in ROUTES:
        raise ValueError(f"K1 plan {params!r}: route in {ROUTES}")
    chunks = -(-k // TILE_K[route])
    least = MIN_SPLIT_CHUNKS[route]
    if (type(bn) is not int or type(splits) is not int
            or bn not in BN_CHOICES or splits not in SPLIT_CHOICES
            or (splits > 1 and chunks < splits * least)):
        raise ValueError(f"K1 plan {params!r} does not launch for K = {k}: "
                         f"bn in {BN_CHOICES}, splits in {SPLIT_CHOICES} with "
                         f"at least {least} stages a slice")
    if route == "ffma" and k > MAX_K:
        raise ValueError(f"K1 plan {params!r}: the FFMA kernel takes K up "
                         f"to {MAX_K}, not {k}")
    return _plan(route, bn, splits, m, n, k)


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


def coded_worker_3xtf32_plain(xe: torch.Tensor, ke: torch.Tensor,
                              stride: int = 1) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in torch ops: patches and
    filters split by ``split_tf32``, then ``lo*hi + hi*lo + hi*hi``, each
    product of two TF32 values exact in fp32 and summed in fp32.  The same
    function and layout as ``coded_worker_plain``; float32 only."""
    batched, ea, b, c, hh, wp, eb, nb, kh, kw, ho, wo = _geometry(
        xe.shape, ke.shape, stride)
    cols = F.unfold(xe.reshape(ea * b, c, hh, wp), (kh, kw), stride=stride)
    w_hi, w_lo = split_tf32(ke.reshape(eb * nb, c * kh * kw))
    c_hi, c_lo = split_tf32(cols)
    y = (torch.matmul(w_hi, c_lo) + torch.matmul(w_lo, c_hi)) + torch.matmul(
        w_hi, c_hi)
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
    route_launches[plan.route].add()
    return out if batched else out[:, 0]


def launch_worker(plan: WorkerPlan, xe: torch.Tensor, ke: torch.Tensor,
                  stride: int) -> torch.Tensor:
    """Launch K1 on CUDA operands that ``coded_worker`` has checked, as
    ``plan`` says; the output ``(ell_a*ell_b, B, N/k_b, H', W')``.  Counts
    no launch: the wrapper does (an autotune sweep launches here too)."""
    _, ea, b, c, hh, wp, eb, nb, kh, kw, ho, wo = _geometry(xe.shape, ke.shape,
                                                           stride)
    n, k = eb * nb, c * kh * kw
    if -(-n // plan.bn) > _MAX_COL_BLOCKS:
        raise ValueError(f"N={n} exceeds the kernel's column-block grid")
    if c * hh * wp >= 2 ** 31 or (plan.route == "ffma" and k > MAX_K):
        raise ValueError(f"K={k} or C*H*W={c * hh * wp} exceeds the "
                         f"{plan.route} kernel's offsets")
    out = torch.empty((ea * eb, b, nb, ho, wo), dtype=torch.float32,
                      device=xe.device)
    lib = load_library()
    if plan.route == "tc":
        # the filters' hi and lo blocks in the kernel's tile order
        tk = TILE_K["tc"]
        ws = torch.empty(-(-n // plan.bn) * -(-k // tk) * 2 * plan.bn * tk,
                         dtype=torch.float32, device=xe.device)
        launch_on("coded_worker_tc_f32", xe, lib.coded_worker_tc_f32,
                  xe.data_ptr(), ke.data_ptr(), ws.data_ptr(), out.data_ptr(),
                  c, hh, wp, kh, kw, stride, ea * b, b, eb, nb, plan.bn,
                  plan.splits)
    else:
        launch_on("coded_worker_f32", xe, lib.coded_worker_f32,
                  xe.data_ptr(), ke.data_ptr(), out.data_ptr(), c, hh, wp, kh,
                  kw, stride, ea * b, b, eb, nb, plan.bn, plan.splits)
    return out
