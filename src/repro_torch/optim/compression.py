"""Gradient compression for the cross-pod reduction, as the reference's
``optim/compression.py``: int8 linear quantisation (per-leaf absmax scale)
and top-k sparsification, both with error feedback.

The reference models the deployed compress -> pod-reduce -> decompress as
compress -> decompress around the pod mean, so the numerics are
reproducible in one process; these functions are that model.  The train
step applies them only across a ``"pod"`` data-parallel axis, which one
card does not have (``launch/steps.py``).
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["int8_compress", "int8_decompress", "topk_compress",
           "topk_decompress", "compress_tree", "compressed_bytes"]


def int8_compress(x: torch.Tensor):
    absmax = x.abs().max() + 1e-12
    q = torch.clamp(torch.round(x / absmax * 127.0), -127, 127).to(torch.int8)
    return q, absmax


def int8_decompress(q: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * (absmax / 127.0)


def topk_compress(x: torch.Tensor, frac: float):
    """The ``max(int(size * frac), 1)`` entries of largest magnitude: their
    values, their flat indices and the flat size.  Which of several equal
    magnitudes is kept is the library's choice, as in the reference."""
    flat = x.reshape(-1)
    k = max(int(flat.numel() * frac), 1)
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx, flat.numel()


def topk_decompress(kept: torch.Tensor, idx: torch.Tensor, size: int,
                    shape) -> torch.Tensor:
    out = torch.zeros(size, dtype=kept.dtype, device=kept.device)
    return out.index_put((idx,), kept).reshape(shape)


def compress_tree(grads: dict, residual: dict | None, scheme: str = "int8",
                  topk_frac: float = 0.01):
    """Error-feedback compression: returns ``(decompressed_grads,
    new_residual)``.  ``residual`` (None: zeros) holds what compression
    dropped last round and is added back before this one."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                            grads)

    def one(g, r):
        x = g.float() + r
        if scheme == "int8":
            d = int8_decompress(*int8_compress(x))
        elif scheme == "topk":
            kept, idx, size = topk_compress(x, topk_frac)
            d = topk_decompress(kept, idx, size, x.shape)
        else:
            raise ValueError(scheme)
        return d.to(g.dtype), x - d

    pairs = tree_map(one, grads, residual)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def compressed_bytes(grads: dict, scheme: str = "int8",
                     topk_frac: float = 0.01) -> int:
    """Cross-pod bytes after compression (the roofline's collective term)."""
    n = sum(x.numel() for x in tree_leaves(grads))
    if scheme == "int8":
        return n  # 1 byte an entry
    if scheme == "topk":
        return int(n * topk_frac) * 8  # value + index
    raise ValueError(scheme)
