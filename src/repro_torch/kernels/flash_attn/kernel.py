"""K4: attention with an online softmax (``csrc/flash_attn.cu``) and its
plain PyTorch version, for fp32 and bf16 operands.

Counterpart of the TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attn/kernel.py:69``), with the TPU signature
``q (BH, Sq, D), k/v (BH, Sk, D)`` plus ``rep``: with ``rep > 1`` the K/V
rows are per KV head, ``k/v (BH / rep, Sk, D)``, and query row ``bh``
reads K/V row ``bh // rep`` (heads ordered ``h = g * rep + r``).  bf16
operands follow the TPU kernel: scores, softmax state and sums in fp32,
``p`` rounded to bf16 before P.V, a bf16 output.  ``flash_attention``
launches the CUDA kernel for CUDA tensors and runs
``flash_attention_plain`` only for tensors that lie on the CPU;
``flash_plan`` chooses the route (the ``rows`` kernel for short prompts,
the ``tiled`` kernels for long sequences or many keys; all in
``csrc/flash_attn.cu``) and its launch shape; ``flash_attention_tiled_plain``
computes the same function in a tiled bf16 kernel's order of rounding, for
a bit-level check of that route in bf16; ``flash_attention_3xtf32_plain``
is the fp32 wgmma kernel's arithmetic (three TF32 products a multiply-add)
and ``split_kv_plain`` the layout its pre-pass writes K and V in, for the
precision argument on the CPU.  The kernel has no backward (nor
has the TPU kernel): on the card it refuses an operand that requires grad
while grad mode is on, where the output would silently cut the gradient.
Meta operands (the dry run, ``launch.dryrun``) launch nothing: after the
card's checks they give an empty meta output and charge the work of the
launch, ``flash_cost``, to the active cost counter
(``native.record_kernel``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..native import (NUM_SMS, LaunchCounter, LaunchTotal, launch_on,
                      load_library, record_kernel)
from ..tf32 import split_tf32

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_tiled_plain", "flash_attention_3xtf32_plain",
           "split_kv_plain", "flash_plan", "FlashPlan", "flash_cost",
           "launches", "kernel_launches", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128)  # the kernels' template instances
DTYPES = (torch.float32, torch.bfloat16)
# the rows route
MAX_WARPS = 16  # warps a block
PAIRS_A_WARP = 4  # (query head, query row) pairs one warp takes in turn
ROW_CHOICES = (64, 32, 16, 8, 4, 2, 1)  # query rows a block, most first
MAX_GRID_Y = 65535  # one row of blocks per (KV head, head group)
# the tiled route: each kernel's launch shape, (query rows a block, keys a
# tile, warps a block); csrc/flash_attn.cu's flash_attn_tiled takes these
# and no other
TILED_KERNELS = {"ffma": (64, 64, 8),      # fp32, FFMA
                 "mma": (64, 64, 4),       # bf16 on mma.sync, every head dim
                 "wgmma": (128, 128, 12),  # bf16 on wgmma: 2 + 1 warpgroups
                 "tf32x3": (128, 64, 12)}  # fp32 as 3xTF32 on wgmma: 2 + 1
WGMMA_HEAD_DIMS = (64, 128)  # the wgmma kernels' instances (bf16 and fp32)
WGMMA_MIN_ROWS = 9216  # query rows over all heads from which bf16 takes it
WGMMA_MIN_SK = 256  # unmasked keys from which bf16 takes it whatever the rows
TF32X3_MIN_ROWS = 9216  # query rows over all heads from which fp32 takes it
SPLIT_KEYS = TILED_KERNELS["tf32x3"][1]  # keys a tile of the split K/V scratch
MAX_TILED_BLOCKS = 2 ** 31 - 1  # a flat grid of (query head, row tile)
# launches of each kernel (rows, and the three tiled ones), and of them all;
# each is named after K4, so a CUDA graph's tally counts them as K4's
kernel_launches = {k: LaunchCounter("flash_attention")
                   for k in ("rows", *TILED_KERNELS)}
launches = LaunchTotal("flash_attention", kernel_launches.values())


def max_pairs(d: int) -> int:
    """(query head, query row) pairs one block serves at head_dim ``d``:
    their q rows are staged beside a 32-key K and V chunk within 48 KB of
    shared memory."""
    return min(64, 2048 // d)


class FlashPlan(NamedTuple):
    """How K4 launches: on ``route`` (``"rows"`` or ``"tiled"``) by
    ``kernel`` (``"rows"``, or a key of ``TILED_KERNELS``), each block
    serves ``heads`` query heads of one KV head and ``rows`` query rows of
    each, with ``warps`` warps (a tiled kernel walking ``keys`` keys at a
    time); ``groups``
    blocks cover a KV head's ``rep`` query heads, ``BH / rep * groups *
    ceil(Sq / rows)`` = ``blocks`` in all (for the ``wgmma`` kernel, query
    tiles: a persistent grid of one block an SM walks them)."""
    route: str
    heads: int
    rows: int
    warps: int
    groups: int
    blocks: int
    kernel: str

    @property
    def keys(self) -> int | None:
        """Keys a tile of the tiled kernel (``TILED_KERNELS``), which the
        bit check walks at; None on the rows route."""
        return TILED_KERNELS[self.kernel][1] if self.route == "tiled" else None


@functools.lru_cache(maxsize=None)
def flash_plan(bh: int, sq: int, sk: int, d: int, rep: int,
               bf16: bool = False, causal: bool = True) -> FlashPlan:
    """The launch K4 uses for ``q (bh, sq, d)`` over ``k/v (bh / rep, sk,
    d)`` (``bf16`` operands, else fp32; ``causal`` or no mask):
    ``tiled_plan`` where ``tiled_route`` says, else ``rows_plan``.  Only
    unmasked calls read ``sk``: the route sweep's cross-attention cells
    are Whisper's, unmasked, and a causal query row reads at most ``sq``
    keys."""
    cross = 0 if causal else sk
    if tiled_route(sq, cross, rep, bf16):
        return tiled_plan(bh, sq, d, rep, bf16, cross=cross)
    return rows_plan(bh, sq, d, rep)


def tiled_route(sq: int, cross: int, rep: int, bf16: bool) -> bool:
    """Whether K4 takes the tiled route for ``sq`` query rows a head,
    ``rep`` query heads a KV head, over ``cross`` keys without the mask (0
    for a causal call).  The rows route serves short prompts; a rows-route
    block re-reads its KV head's keys for every 16 (head, row) pairs it
    serves, so many pairs (``sq * rep``) or many unmasked keys
    (cross-attention) go to the tiled route.

    The crossovers, timed by ``scripts/torch_route_sweep.py`` on an NVIDIA
    H100 80GB HBM3 at 700 W (device ms): at the zoo's prefill heads
    (SmolLM-135M, Qwen3-4B, Hymba-1.5B, Whisper-medium's decoder; 4
    prompts, causal, Sk = Sq) and, without a mask, 16 and 32 queries over
    256-4,096 keys at Whisper-medium's decoder heads (its
    cross-attention).  bf16: the rows route is the faster at 16 rows over
    16 keys in all 4 prefill cells (0.0060 against the mma.sync kernel's
    0.0070 at Qwen3-4B's heads), a tiled kernel from 32 rows in all 4
    (0.0073 against 0.0117) and from 256 keys in all 8 cross cells (0.0081
    against 0.0180 at 16 x 256).  fp32: the rows route at 16 rows in all 4
    prefill cells and at 32 in 3 of 4; Hymba's 25 heads over 5 (160
    pairs) take the FFMA kernel from 32 rows (0.0087 against 0.0097); over
    cross keys the rows route up to 512 (0.0423 against 0.0453 at 32 x
    512), the FFMA kernel from 1,500 (0.1302 against 0.1419 at 32 x
    1,500)."""
    if bf16:
        return sq >= 32 or cross >= WGMMA_MIN_SK
    return sq >= 48 or sq * rep >= 160 or cross >= 1024


def tiled_kernel(bh: int, sq: int, d: int, bf16: bool, cross: int = 0) -> str:
    """The tiled route's kernel for ``q (bh, sq, d)`` over ``cross`` keys
    without the mask (0 for a causal call): at D 64 and 128
    (``WGMMA_HEAD_DIMS``) from ``WGMMA_MIN_ROWS`` (bf16) or
    ``TF32X3_MIN_ROWS`` (fp32) query rows over all heads on, a wgmma
    kernel (bf16, or fp32 as 3xTF32), and in bf16 also from
    ``WGMMA_MIN_SK`` cross keys whatever the rows; else the mma.sync
    kernel (bf16) or the FFMA one (fp32), whose 64-row blocks fill the
    card sooner.

    Timed by ``scripts/torch_route_sweep.py`` (H100 80GB HBM3, 700 W,
    device ms; the cells of ``tiled_route``).  bf16: the mma.sync kernel
    is the faster up to 8,192 query rows over all heads in all 4 prefill
    cells (at Qwen3-4B's 128 heads x 64 rows 0.0078 against the wgmma
    kernel's 0.0093), the wgmma one from 9,216 in all 4 (128 x 96: 0.0094
    against 0.0113; at the Qwen3-4B prefill of 64 heads x 2,048 rows
    0.1573 against 0.3394) and over cross keys in all 8 cells (0.0081
    against 0.0082 at 16 x 256, 0.0223 against 0.0297 at 16 x 1,500).
    fp32: the FFMA kernel up to 8,192 rows over all heads (at 64 heads x
    128 rows 0.0145 against the 3xTF32 kernel's 0.0157) and over cross
    keys (0.1301 against 0.1410 at 16 x 1,500), the 3xTF32 one from 9,216
    (36 x 256: 0.0219 against 0.0290)."""
    wide = d in WGMMA_HEAD_DIMS
    if not bf16:
        return "tf32x3" if wide and bh * sq >= TF32X3_MIN_ROWS else "ffma"
    return ("wgmma" if wide and (bh * sq >= WGMMA_MIN_ROWS
                                 or cross >= WGMMA_MIN_SK) else "mma")


def tiled_plan(bh: int, sq: int, d: int, rep: int, bf16: bool = False,
               kernel: str | None = None, cross: int = 0) -> FlashPlan:
    """The tiled route on ``kernel`` (``tiled_kernel``'s by default; a
    kernel of the type can be named to time two side by side): one block
    per (query head, its rows), walking its key tiles, as ``TILED_KERNELS``
    says."""
    kernel = kernel or tiled_kernel(bh, sq, d, bf16, cross)
    rows, _, warps = TILED_KERNELS[kernel]
    return FlashPlan("tiled", 1, rows, warps, rep, bh * -(-sq // rows), kernel)


def rows_plan(bh: int, sq: int, d: int, rep: int) -> FlashPlan:
    """The rows route, built for the latency of short prompts.  A block
    stages its KV head's keys once for every query head it serves, so it
    takes all ``rep`` heads when ``max_pairs(d)`` allows (else groups of
    as many as fit).  Its query rows are the largest power of two (no
    larger than the sequence needs) that still gives every SM a block,
    else 1, the most blocks there can be: at the SmolLM-135M prefill (36
    query heads over 12 KV heads, S = 16) that is 192 blocks of 3 warps.
    One warp a (head, row) pair, up to 16 warps; each warp takes at most 4
    pairs in turn, over 32-key chunks."""
    cap = max_pairs(d)
    heads = min(rep, cap)
    groups = -(-rep // heads)
    column = (bh // rep) * groups
    fits = [r for r in ROW_CHOICES if r * heads <= cap and (r == 1 or r < 2 * sq)]
    rows = next((r for r in fits if column * -(-sq // r) >= NUM_SMS), fits[-1])
    warps = min(MAX_WARPS, heads * rows)
    return FlashPlan("rows", heads, rows, warps, groups, column * -(-sq // rows),
                     "rows")


def flash_cost(bh: int, bhkv: int, sq: int, sk: int, d: int,
               width: int = 4, causal: bool = True) -> tuple[float, float]:
    """``(flops, bytes)`` of one launch over ``q (bh, sq, d)`` and ``k/v
    (bhkv, sk, d)``, the least work of the function: causal, query row i
    scores and weighs ``min(i + 1, sk)`` keys (else all ``sk``), 2·d
    FLOPs each way; each input read once and the output written once,
    ``width`` bytes an element."""
    m = min(sq, sk)
    keys = m * (m + 1) // 2 + (sq - m) * sk if causal else sq * sk
    return 4.0 * d * keys * bh, float(width * (2 * bh * sq * d + 2 * bhkv * sk * d))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rep: int) -> None:
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want "
                         f"(BH, Sq, D) and (BH / rep, Sk, D)")
    if rep < 1 or q.shape[0] != k.shape[0] * rep or q.shape[2] != k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"pair with rep={rep}")
    if k.shape[1] < 1:
        raise ValueError("attention over zero keys")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          scale: float | None = None, causal: bool = True,
                          rep: int = 1) -> torch.Tensor:
    """Scores, index-causal mask, fp32 softmax, weighted sum — the function
    of K4 (mirrors ``flash_attn/ref.py``).  Every key index is below Sk
    here, so the kernel's padded-key mask has nothing to hide.  bf16
    operands take the TPU kernel's arithmetic: fp32 scores (the products of
    bf16 values are exact in fp32), ``e = exp(s - max)`` and its fp32 sum
    ``l``, ``e`` rounded to bf16 for P.V with an fp32 sum, then
    ``acc / max(l, 1e-30)`` rounded to bf16.  float64 operands compute in
    float64 throughout."""
    _check(q, k, v, rep)
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if rep > 1:
        k = k.repeat_interleave(rep, dim=0)
        v = v.repeat_interleave(rep, dim=0)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    else:  # fp32, or float64 kept whole (the precision checks' reference)
        s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        ok = (torch.arange(sk, device=q.device)[None, :]
              <= torch.arange(sq, device=q.device)[:, None])
        s = s.masked_fill(~ok[None], -1e30)
    if bf16:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        acc = torch.einsum("bqk,bkd->bqd", e.to(v.dtype).float(), v.float())
        return (acc / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)


def flash_attention_tiled_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, scale: float | None = None,
                                causal: bool = True, rep: int = 1,
                                tile: int | None = None) -> torch.Tensor:
    """The function of ``flash_attention_plain`` in a tiled bf16 kernel's
    order of rounding: the keys walked in tiles of ``tile`` (by default
    the key tile of the kernel ``tiled_plan`` picks for bf16 operands of
    this shape) with
    the online softmax of ``flash_attention_pallas``, scores in units of
    log2 (``scale * log2(e)`` in fp32), ``p = exp2(x - m)`` against the
    running max ``m``, ``l`` and ``acc`` rescaled by ``exp2(m_old -
    m_new)``, ``p`` rounded to ``v``'s type for P.V (bf16; fp32 operands
    keep it whole), ``acc / max(l, 1e-30)`` rounded once.  Where the
    kernel and this walk round ``p`` against the same ``m``, their outputs
    differ only where an fp32 sum in another order flips a rounding: the
    reference of the card's bit-level check of that route."""
    _check(q, k, v, rep)
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if tile is None:
        cross = 0 if causal else k.shape[1]
        tile = TILED_KERNELS[tiled_kernel(q.shape[0], q.shape[1], d, True,
                                          cross)][1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=0)
        v = v.repeat_interleave(rep, dim=0)
    sc = float(torch.tensor(scale, dtype=torch.float32)
               * torch.tensor(1.4426950408889634, dtype=torch.float32))
    bh, sq, _ = q.shape
    sk = k.shape[1]
    rows = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bh, sq, 1), float("-inf"), device=q.device)
    l = torch.zeros((bh, sq, 1), device=q.device)
    acc = torch.zeros((bh, sq, d), device=q.device)
    for k0 in range(0, sk, tile):
        kt, vt = k[:, k0:k0 + tile].float(), v[:, k0:k0 + tile]
        x = torch.einsum("bqd,bkd->bqk", q.float(), kt) * sc
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None, :]
            x = x.masked_fill((keys > rows)[None], float("-inf"))
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(),
                                        vt.float())
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def split_kv_numel(bhkv: int, sk: int, d: int) -> int:
    """Floats of the 3xTF32 kernel's split K/V scratch (``split_kv_plain``)."""
    return bhkv * -(-sk // SPLIT_KEYS) * 4 * SPLIT_KEYS * d


def _swizzled(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Offset of element (row, col) of a [rows][32 floats] block with the
    128-byte swizzle: 16-byte chunk q of a row lies at q ^ (row % 8)."""
    return rows * 32 + (((cols // 4) ^ (rows % 8)) * 4) + cols % 4


@functools.lru_cache(maxsize=None)
def _split_kv_offsets(d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Where each element of a key tile lands in its part of the scratch:
    ``(k_off, v_off)``, each (SPLIT_KEYS, d) int64 offsets into ``SPLIT_KEYS
    * d`` floats.  K's part is ``d / 32`` blocks of [keys][32 floats], key
    j at row j; V^T's part is ``SPLIT_KEYS / 32`` blocks of [d][32 keys],
    with the keys of each 8-key group placed so that slot s holds key 2s
    (s < 4) or 2(s - 4) + 1: the layout of P.V's B in which a thread's
    score accumulators (keys 2t and 2t + 1 of each group) are P's tf32 A
    fragments (k-slots t and t + 4) as they lie."""
    keys = torch.arange(SPLIT_KEYS)[:, None]
    cols = torch.arange(d)[None, :]
    k_off = (cols // 32) * (SPLIT_KEYS * 32) + _swizzled(keys, cols % 32)
    w = keys % 8
    slot = (keys % 32 // 8) * 8 + (w >> 1) + 4 * (w & 1)
    v_off = (keys // 32) * (d * 32) + _swizzled(cols, slot)
    return k_off, v_off


def split_kv_plain(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 kernel's pre-pass (``flash_tiled_split_kv``) in torch
    ops: ``k/v (BHkv, Sk, D)`` fp32 split by ``split_tf32``, written key
    tile by key tile (``SPLIT_KEYS`` keys, zero past Sk) as four parts, K
    hi, K lo, V^T hi, V^T lo, each laid out as ``_split_kv_offsets`` says.
    Returns the scratch as ``(BHkv, tiles, 4, SPLIT_KEYS * D)``."""
    bhkv, sk, d = k.shape
    nt = -(-sk // SPLIT_KEYS)
    pad = nt * SPLIT_KEYS - sk
    out = torch.empty((bhkv, nt, 4, SPLIT_KEYS * d), dtype=torch.float32,
                      device=k.device)
    for part, (t, off) in enumerate(zip((k, v), _split_kv_offsets(d))):
        t = torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(
            bhkv, nt, SPLIT_KEYS * d)
        off = off.to(k.device).reshape(-1).expand(bhkv, nt, -1)
        for half, x in enumerate(split_tf32(t)):
            out[:, :, 2 * part + half].scatter_(-1, off, x)
    return out


def flash_attention_3xtf32_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, scale: float | None = None,
                                 causal: bool = True, rep: int = 1,
                                 tile: int = SPLIT_KEYS) -> torch.Tensor:
    """The 3xTF32 kernel's arithmetic in torch ops, fp32 only: q, k, v and
    each tile's p split by ``split_tf32``, every product as ``lo*hi +
    hi*lo + hi*hi`` (products of TF32 values are exact in fp32) summed in
    fp32, the keys walked in tiles of ``tile`` with the fp32 online softmax
    of the FFMA kernel (``p = exp(s * scale - m)``), and each tile's P.V
    summed on its own before ``acc = acc * corr + part`` (the kernel's
    promotion: no tensor-core accumulation chain spans two tiles)."""
    _check(q, k, v, rep)
    if q.dtype != torch.float32 or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"3xTF32 takes float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if rep > 1:
        k = k.repeat_interleave(rep, dim=0)
        v = v.repeat_interleave(rep, dim=0)

    def mm3(a, b):  # a (.., m, n) . b (.., n, p) as three TF32 products
        (ah, al), (bh_, bl) = split_tf32(a), split_tf32(b)
        return (al @ bh_ + ah @ bl) + ah @ bh_

    bh, sq, _ = q.shape
    sk = k.shape[1]
    rows = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bh, sq, 1), float("-inf"), device=q.device)
    l = torch.zeros((bh, sq, 1), device=q.device)
    acc = torch.zeros((bh, sq, d), device=q.device)
    for k0 in range(0, sk, tile):
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        x = mm3(q, kt.transpose(1, 2)) * scale
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None, :]
            x = x.masked_fill((keys > rows)[None], float("-inf"))
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(x - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + mm3(p, vt)
        m = m_new
    return acc / l.clamp_min(1e-30)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, causal: bool = True,
                    rep: int = 1) -> torch.Tensor:
    """``q (BH, Sq, D)``, ``k/v (BH / rep, Sk, D)`` -> ``(BH, Sq, D)``;
    key ``j`` is masked for query ``i`` when ``causal`` and ``j > i``.
    fp32 or bf16 (all three alike), ``D`` in ``HEAD_DIMS``.  CUDA tensors
    launch K4 on the route and shape ``flash_plan`` says; CPU tensors take
    ``flash_attention_plain``; meta tensors launch nothing and charge
    ``flash_cost`` to the active cost counter.  On CUDA and meta, an
    operand that requires grad under grad mode raises: K4 has no
    backward."""
    _check(q, k, v, rep)
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal, rep=rep)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, got "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "K4 has no backward: its output would cut the gradient of q, k "
            "and v.  Train through the transformer's autograd route "
            "(lm_loss, forward(autograd=True)), or call under torch.no_grad()")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"K4 takes float32 or bfloat16 operands of one type, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("K4 takes contiguous (BH, S, D) operands")
    bh, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: K4 is built for {HEAD_DIMS}")
    sk = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    plan = flash_plan(bh, sq, sk, d, rep, bf16, causal)
    if (plan.route == "rows" and bh // rep * plan.groups > MAX_GRID_Y
            or plan.route == "tiled" and plan.blocks > MAX_TILED_BLOCKS):
        raise ValueError(f"BH={bh}, Sq={sq} exceed the {plan.route} kernel's grid")
    if q.device.type == "meta":  # nothing to launch: charge its work
        record_kernel("flash_attention", *flash_cost(
            bh, bh // rep, sq, sk, d, q.element_size(), causal))
        return torch.empty_like(q)
    out = launch_plan(plan, q, k, v, scale=scale, causal=causal, rep=rep)
    kernel_launches[plan.kernel].add()
    return out


def launch_plan(plan: FlashPlan, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, *, scale: float | None, causal: bool,
                rep: int) -> torch.Tensor:
    """Launch K4 on CUDA operands that ``flash_attention`` has checked, as
    ``plan`` says (``flash_attention``'s plan, or either route's for a
    comparison of the two: ``scripts/torch_route_sweep.py``).  Counts no
    launch: the wrapper does."""
    bh, sq, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    # the kernel loads 16 bytes at a time; a view that starts off a 16-byte
    # boundary is copied to fresh (aligned) storage
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    lib = load_library()
    args = (bh, sq, k.shape[1], d, rep, float(scale), int(causal),
            int(q.dtype == torch.bfloat16), plan.heads, plan.rows, plan.warps)
    if plan.route == "rows":
        launch_on("flash_attn", q, lib.flash_attn, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), *args)
        return out
    # the 3xTF32 kernel's K and V, split once a launch (split_kv_plain's
    # layout); the other tiled kernels read none
    kv = (torch.empty(split_kv_numel(k.shape[0], k.shape[1], d),
                      dtype=torch.float32, device=q.device)
          if plan.kernel == "tf32x3" else None)
    launch_on("flash_attn_tiled", q, lib.flash_attn_tiled, q.data_ptr(),
              k.data_ptr(), v.data_ptr(), out.data_ptr(),
              None if kv is None else kv.data_ptr(), *args)
    return out
