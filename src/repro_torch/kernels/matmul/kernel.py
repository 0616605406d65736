"""K2: the fp32 GEMM with a ReLU epilogue (``csrc/matmul.cu``) and its
plain PyTorch version.

Counterpart of the TPU kernel ``matmul_pallas``
(``src/repro/kernels/matmul/kernel.py:111``).  ``matmul`` launches the
CUDA kernel for CUDA tensors and runs ``matmul_plain`` only for tensors
that lie on the CPU; there is no fallback from one to the other.
``matmul_plan`` chooses between the kernel's two launch shapes, unless the
autotune ledger holds a plan for the cell (``choose_matmul_plan``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import autotune
from ..native import NUM_SMS, LaunchCounter, launch_on, load_library

__all__ = ["matmul", "matmul_plain", "matmul_plan", "MatmulPlan",
           "plan_params", "matmul_plan_of", "choose_matmul_plan",
           "launch_plan", "launches"]

launches = LaunchCounter("matmul")

_MAX_ROW_BLOCKS = 65535  # column kernel: grid.y limit, 16 rows a block
COLUMN_THREADS = 256  # column kernel: one thread per output column
SPLIT_STRIP = 16  # split kernel: columns a block owns
SPLIT_MAX_M = 16
SPLIT_MIN_K = 64  # below this a K slice is too thin to be worth a cluster
SPLIT_CHUNK = 1024  # rows of a K slice one block stages at a time
SPLIT_CHOICES = (1, 2, 4, 8)  # K slices per strip: one thread-block cluster


class MatmulPlan(NamedTuple):
    """How K2 launches one ``(M, K) @ (K, N)``: the ``column`` kernel, or
    the ``split`` kernel with ``splits`` K slices of ``k_slice`` rows per
    16-column strip (one thread-block cluster each; the kernel computes
    the same slices).  ``blocks`` is the launch's block count."""
    kernel: str
    splits: int
    k_slice: int
    blocks: int


def matmul_plan(m: int, n: int, k: int) -> MatmulPlan:
    """The launch K2 uses for an ``(m, k) @ (k, n)`` product.

    The column kernel (one thread per output column, K walked in the
    thread) suits the wide transition GEMMs: it fills the card once
    ``ceil(n/256) * ceil(m/bm)`` reaches the SM count, and K is 2-16
    there.  When it would not fill the card, M is small and K is deep
    enough to split, the split kernel takes 16-column strips and cuts K
    into the fewest slices (1, 2, 4 or 8) of at most ``SPLIT_CHUNK`` rows
    (one staging chunk of ``a``) that give two blocks a SM, as many as 8
    allow.  Past ``8 * SPLIT_CHUNK`` rows of K it takes 8 slices, each
    staged chunk by chunk: at Qwen3-4B's down projection (K 9,728 over N
    1,280) 80 strips of 8 slices of 1,216 rows, 640 blocks (on an H100,
    0.0329 device ms against 0.0357 with 4 slices and 0.0442 for
    ``torch.matmul``: ``scripts/torch_route_sweep.py``)."""
    bm = 8 if m <= 8 else 16
    column_blocks = -(-n // COLUMN_THREADS) * -(-m // bm)
    column = MatmulPlan("column", 0, k, column_blocks)
    if column_blocks >= NUM_SMS or m > SPLIT_MAX_M or k < SPLIT_MIN_K:
        return column
    strips = -(-n // SPLIT_STRIP)
    fits = ([s for s in SPLIT_CHOICES if -(-k // s) <= SPLIT_CHUNK]
            or [max(SPLIT_CHOICES)])
    splits = next((s for s in fits if strips * s >= 2 * NUM_SMS), fits[-1])
    return MatmulPlan("split", splits, -(-k // splits), strips * splits)


def plan_params(plan: MatmulPlan) -> dict:
    """A plan as the autotune ledger records it."""
    if plan.kernel == "column":
        return {"kernel": "column"}
    return {"kernel": "split", "splits": plan.splits}


def matmul_plan_of(params: dict, m: int, n: int, k: int) -> MatmulPlan:
    """The plan a ledger entry (``plan_params``'s form) names for an
    ``(m, k) @ (k, n)`` product.  Raises ``ValueError`` where K2 cannot
    launch it: the split kernel past ``SPLIT_MAX_M`` rows or with a split
    count it lacks, the column kernel past its row-block grid."""
    kind = params.get("kernel") if isinstance(params, dict) else None
    if kind == "column" and set(params) == {"kernel"}:
        if -(-m // 16) > _MAX_ROW_BLOCKS:
            raise ValueError(f"M={m} exceeds the column kernel's row-block "
                             f"grid")
        bm = 8 if m <= 8 else 16
        return MatmulPlan("column", 0, k,
                          -(-n // COLUMN_THREADS) * -(-m // bm))
    if kind == "split" and set(params) == {"kernel", "splits"}:
        s = params["splits"]
        if type(s) is not int or s not in SPLIT_CHOICES or m > SPLIT_MAX_M:
            raise ValueError(f"K2 plan {params!r} does not launch for M = "
                             f"{m}: splits in {SPLIT_CHOICES}, M at most "
                             f"{SPLIT_MAX_M}")
        return MatmulPlan("split", s, -(-k // s), -(-n // SPLIT_STRIP) * s)
    raise ValueError(f"K2 plan {params!r}: want {{'kernel': 'column'}} or "
                     f"{{'kernel': 'split', 'splits': s}}")


def choose_matmul_plan(m: int, n: int, k: int, *, relu: bool = False,
                       device=None) -> MatmulPlan:
    """The plan K2 launches for an ``(m, k) @ (k, n)`` cell on ``device``:
    the autotune ledger's where it records one (``autotune.matmul_params``;
    never a sweep), else ``matmul_plan``'s."""
    params = autotune.matmul_params(m, k, n, relu=relu, device=device)
    return (matmul_plan(m, n, k) if params is None
            else matmul_plan_of(params, m, n, k))


def matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                 relu: bool = False) -> torch.Tensor:
    """``a @ b`` then ``clamp_min(0)`` when ``relu`` — what K2 computes."""
    y = a @ b
    return y.clamp_min(0) if relu else y


def matmul(a: torch.Tensor, b: torch.Tensor, *, relu: bool = False) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` in IEEE fp32, ReLU fused into the store when
    ``relu``.  CUDA tensors launch K2 as ``choose_matmul_plan`` says; CPU
    tensors take ``matmul_plain``."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return matmul_plain(a, b, relu=relu)
    if a.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu, got {a.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"K2 takes float32 only, got {a.dtype} @ {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("K2 takes contiguous row-major operands")
    m, k = a.shape
    n = b.shape[1]
    plan = choose_matmul_plan(m, n, k, relu=relu, device=a.device)
    if plan.kernel == "column" and -(-m // 16) > _MAX_ROW_BLOCKS:
        raise ValueError(f"M={m} exceeds the kernel's row-block grid")
    out = launch_plan(plan, a, b, relu=relu)
    launches.add()
    return out


def launch_plan(plan: MatmulPlan, a: torch.Tensor, b: torch.Tensor, *,
                relu: bool = False) -> torch.Tensor:
    """Launch K2 on CUDA operands that ``matmul`` has checked, as ``plan``
    says (``matmul``'s plan, or another split count for a comparison:
    ``scripts/torch_route_sweep.py``).  Counts no launch: the wrapper
    does."""
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    launch_on("matmul_f32", a, load_library().matmul_f32,
              a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, int(relu),
              plan.splits)
    return out
