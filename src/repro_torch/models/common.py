"""Shared model building blocks: the params drawn from a shapes tree or
carried across from numpy, RMS norm, softcap, RoPE, the
causal/sliding-window mask, GQA attention and the next-token loss.

Counterparts of the numerics in the JAX package's ``models/common.py``,
with the same layouts: activations ``(B, S, H, D)``, GQA by head
repetition with query head ``h = g * rep + r`` reading KV head ``g``.
A family's shapes tree is the reference's schema without its sharding
axes: the same nested dict, with ``(shape, init scale)`` leaves (scale
None = fan-in, 0.0 = zeros).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..devices import resolve_device
from ..tree import tree_map

__all__ = ["draw_params", "params_from_numpy", "stacked_shapes", "at_least_fp32",
           "rms_norm",
           "softcap", "rope_inv_freq", "apply_rope", "make_attn_mask",
           "attention", "next_token_nll", "position_index", "checkpointed", "NEG_INF"]

NEG_INF = -1e30  # additive mask value (finite, as in the reference)


def stacked_shapes(shapes: dict, n: int) -> dict:
    """A layer's shapes tree with a leading axis of ``n`` layers on every
    leaf (the reference's stacked schema)."""
    return {k: stacked_shapes(v, n) if isinstance(v, dict) else ((n,) + v[0], v[1])
            for k, v in shapes.items()}


def draw_params(shapes: dict, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32) -> dict:
    """Random params of a shapes tree: fan-in-scaled normals (the fan-in is
    the second-last axis, else the last), the leaf's own scale where it
    has one, zeros where it is 0.0.  Leaf by leaf in sorted-key order, each
    leaf is drawn from ``generator`` on the generator's own device and
    moved to ``device`` before the next is drawn, so a CUDA generator draws
    on the card and the host never holds the tree.  The reference draws
    with a jax PRNG, which is not re-implemented: the same seed gives other
    weights there."""
    dev = resolve_device(device)

    def leaf(shape, scale):
        if scale == 0.0:
            return torch.zeros(shape, dtype=dtype, device=dev)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        t = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device)
        return t.mul_(std).to(dev)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        return leaf(*node)

    return draw(shapes)


def _leaf_from_numpy(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, as jax hands it over
        return torch.tensor(a.view(np.int16), device=dev).view(torch.bfloat16)
    return torch.tensor(a, device=dev)


def params_from_numpy(tree: dict, device: str | torch.device = "cuda") -> dict:
    """Carry a tree made elsewhere across unchanged: same tree, same
    layouts, same values and dtypes (bf16 included).  Any family's params
    from the JAX package's ``bundle.init`` / ``schema_init``, or its AdamW
    state ``{"m", "v", "step"}``, as nested dicts of numpy arrays."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, dev), tree)


def checkpointed(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    backward recomputes it, saving only its inputs (the reference's
    ``jax.checkpoint``).  No model draws random numbers, so no RNG state
    is saved; reading the card's would fail inside a CUDA-graph capture
    of a train step."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def next_token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``targets`` (B, S) under ``logits``
    (B, S, V): the reference's ``lm_loss`` tail."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0].mean()


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or as it is in float64: the dtype the norms, the
    gates and the scan compute in, so that a float64 model stays float64
    throughout."""
    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + gamma)`` in fp32 (float64 for
    float64), cast back."""
    dt = x.dtype
    xf = at_least_fp32(x)
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + at_least_fp32(gamma))).to(dt)


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


def position_index(pos, device) -> torch.Tensor:
    """A decode step's position as a (1,) int64 tensor on ``device``: the
    index its cache write (``index_copy_``) and reads (``index_select``)
    take.  ``pos`` is a Python int (a fill, no host copy) or a 0-d integer
    tensor on ``device``, which a captured step reads as the graph's
    copied-in position; it never goes into a slice or to the host."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).long()
    return torch.full((1,), int(pos), dtype=torch.long, device=device)


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
