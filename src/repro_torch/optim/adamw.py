"""AdamW with decoupled weight decay, global-norm clipping and fp32 moments
over fp32 or bf16 params: the reference's ``optim/adamw.py`` over the
port's nested-dict trees.

The state is the reference's tree, ``{"m": <params-shaped fp32>, "v":
<params-shaped fp32>, "step": int32 scalar}``, so a checkpoint holds the
same keys in either package.  The arithmetic is the reference's, op for
op, in float32.  ``apply_updates`` writes the new params, moments and step
count into the tensors it is given (the reference returns new trees): a
training step then allocates no second copy of either, and a captured
train step (``launch.steps``) replays on the same state.  It updates a
leaf in slices along its first axis of at most ``UPDATE_SLICE`` elements,
the clip scale applied there too: the arithmetic is elementwise, so the
values are the same, and the update's fp32 temporaries are a slice's,
not a leaf's (the reference's XLA fuses them into one loop).
"""
from __future__ import annotations

import dataclasses

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "init_state", "global_norm", "apply_updates",
           "UPDATE_SLICE"]

# the most elements of a leaf that one slice of the update takes
UPDATE_SLICE = 1 << 22


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0


def init_state(params: dict) -> dict:
    """Zero fp32 moments shaped like ``params`` (on their devices) and an
    int32 step of 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                  lr_scale=1.0, grad_norm: torch.Tensor | None = None):
    """One AdamW step: returns ``(params, state, {"grad_norm"})``, with
    ``params``, the moments and ``state["step"]`` (one higher) updated in
    place.  ``lr_scale`` multiplies ``cfg.lr`` (a float or a float32
    scalar tensor, such as ``cosine_with_warmup``'s).  ``grad_norm`` is
    the global norm of the gradient where ``grads`` holds only this
    rank's shards of it (FSDP); by default ``global_norm(grads)``."""
    step = state["step"].add_(1)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    lr = cfg.lr * lr_scale

    for leaves in zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(state["m"]), tree_leaves(state["v"])):
        for p, g, m, v in zip(*map(_slices, leaves)):
            if scale is not None:
                g = g * scale.to(g.dtype)
            g32 = g.float()
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * g32 * g32
            mhat = m_new / bc1
            vhat = v_new / bc2
            delta = (mhat / (torch.sqrt(vhat) + cfg.eps)
                     + cfg.weight_decay * p.float())
            p.copy_(p.float() - lr * delta)
            m.copy_(m_new)
            v.copy_(v_new)
    return params, state, {"grad_norm": gnorm}


def _slices(t: torch.Tensor) -> list:
    """``t`` as views of whole rows of its first axis, each of at most
    ``UPDATE_SLICE`` elements (one row where a row holds more)."""
    if t.ndim == 0 or t.numel() <= UPDATE_SLICE:
        return [t]
    rows = max(UPDATE_SLICE // (t.numel() // t.shape[0]), 1)
    return list(t.split(rows, dim=0))
