"""K4: attention with an online softmax (``csrc/flash_attn.cu``) and its
plain PyTorch version.

Counterpart of the TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attn/kernel.py:69``), with the TPU signature
``q (BH, Sq, D), k/v (BH, Sk, D)`` plus ``rep``: with ``rep > 1`` the K/V
rows are per KV head, ``k/v (BH / rep, Sk, D)``, and query row ``bh``
reads K/V row ``bh // rep`` (heads ordered ``h = g * rep + r``).
``flash_attention`` launches the CUDA kernel for CUDA tensors and runs
``flash_attention_plain`` only for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

from ..native import LaunchCounter, check_launch, launch_stream, load_library

__all__ = ["flash_attention", "flash_attention_plain", "launches", "HEAD_DIMS"]

launches = LaunchCounter("flash_attention")

HEAD_DIMS = (16, 32, 64, 128)  # the kernel's template instances
_MAX_ROWS = 65535  # grid.y limit: one row of blocks per bh


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
    here, so the kernel's padded-key mask has nothing to hide."""
    _check(q, k, v, rep)
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if rep > 1:
        k = k.repeat_interleave(rep, dim=0)
        v = v.repeat_interleave(rep, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        ok = (torch.arange(sk, device=q.device)[None, :]
              <= torch.arange(sq, device=q.device)[:, None])
        s = s.masked_fill(~ok[None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float | None = None, causal: bool = True,
                    rep: int = 1) -> torch.Tensor:
    """``q (BH, Sq, D)``, ``k/v (BH / rep, Sk, D)`` -> ``(BH, Sq, D)``;
    key ``j`` is masked for query ``i`` when ``causal`` and ``j > i``.
    fp32, ``D`` in ``HEAD_DIMS``.  CUDA tensors launch K4; CPU tensors
    take ``flash_attention_plain``."""
    _check(q, k, v, rep)
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal, rep=rep)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    if not all(t.dtype == torch.float32 for t in (q, k, v)):
        raise TypeError(f"K4 takes float32 only, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("K4 takes contiguous (BH, S, D) operands")
    bh, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: K4 is built for {HEAD_DIMS}")
    if bh > _MAX_ROWS:
        raise ValueError(f"BH={bh} exceeds the kernel's grid")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if bh == 0 or sq == 0:
        return out
    with torch.cuda.device(q.device):
        rc = load_library().flash_attn_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            k.shape[1], d, rep, float(scale), int(causal), launch_stream(q))
    check_launch("flash_attn_f32", rc)
    launches.add()
    return out
