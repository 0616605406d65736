"""Shared transformer building blocks: RMS norm, softcap, RoPE, the
causal/sliding-window mask and GQA attention.

Counterparts of the numerics in the JAX package's ``models/common.py``,
with the same layouts: activations ``(B, S, H, D)``, GQA by head
repetition with query head ``h = g * rep + r`` reading KV head ``g``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["rms_norm", "softcap", "rope_inv_freq", "apply_rope",
           "make_attn_mask", "attention", "NEG_INF"]

NEG_INF = -1e30  # additive mask value (finite, as in the reference)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + gamma)`` in fp32, cast back."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + gamma.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def rope_inv_freq(head_dim: int, base: float = 10000.0,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """``base ** (-j / half)``, computed on ``device`` with ``base`` a
    scalar operand: no host tensor is copied there, so the decode glue can
    compute it per call inside a CUDA-graph capture."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(float(base), exps)


def apply_rope(x: torch.Tensor, inv_freq: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Half-split rotation.  ``x`` (B, S, H, D); ``positions`` (B, S)."""
    ang = positions.float()[:, :, None] * inv_freq  # (B, S, D/2)
    c = torch.cos(ang)[:, :, None, :]
    s = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def make_attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                   window: int | None = None) -> torch.Tensor:
    """Causal (+ optional sliding window) additive mask: ``q_pos`` (B, Sq),
    ``k_pos`` (B, Sk) -> (B, 1, Sq, Sk) float32 of {0, NEG_INF}."""
    ok = k_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        ok &= k_pos[:, None, :] > q_pos[:, :, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))[:, None]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, *, scale: float | None = None,
              attn_softcap: float | None = None) -> torch.Tensor:
    """``q`` (B, Sq, H, D), ``k``/``v`` (B, Sk, Hkv, D[v]); GQA by head
    repetition.  Softmax in fp32; returns (B, Sq, H, Dv)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = h // hkv
    qg = q.reshape(b, sq, hkv, rep, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() * scale
    if attn_softcap is not None:
        logits = softcap(logits, attn_softcap)
    logits = logits + mask[:, :, None, :, :]  # (B,1,Sq,Sk) -> (B,1,1,Sq,Sk)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])
