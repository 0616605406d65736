"""Step-function builders: train / prefill / serve, as the reference's
``launch/steps.py`` on one device.

The reference returns each step with its shardings for ``jax.jit``; the
port runs eagerly on one card and returns the step alone.  FSDP and the
param / optimizer / batch shardings wait for the port's sharding slice
(ROADMAP Queue A 11).
"""
from __future__ import annotations

import dataclasses
import warnings

import torch
from torch.utils.checkpoint import checkpoint

from ..optim import AdamWConfig, apply_updates
from ..optim.schedule import cosine_with_warmup
from ..tree import tree_from_items, tree_items, tree_map

__all__ = ["TrainConfig", "value_and_grad", "accumulated_value_and_grad",
           "build_train_step", "build_prefill_step", "build_serve_step"]

COMPRESSION = (None, "int8", "topk")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    warmup: int = 100
    total_steps: int = 10000
    # None | "int8" | "topk": applies across a "pod" data-parallel axis
    # only, which one card does not have (see build_train_step)
    grad_compression: str | None = None
    # the whole loss under torch.utils.checkpoint: backward recomputes
    # the forward, saving only the inputs
    remat: bool = False
    # gradient accumulation over this many equal slices of the batch:
    # saved activations scale with B / microbatches
    microbatches: int = 1

    def __post_init__(self):
        if self.grad_compression not in COMPRESSION:
            raise ValueError(f"grad_compression {self.grad_compression!r}: "
                             f"one of {COMPRESSION}")
        if self.microbatches < 1:
            raise ValueError(f"microbatches={self.microbatches}")


def value_and_grad(loss_fn, params: dict, batch: dict, remat: bool = False):
    """``(loss, grads)`` of ``loss_fn(params, batch)``: the loss detached,
    ``grads`` a tree like ``params`` (zeros for a leaf the loss does not
    reach, as ``jax.grad`` gives).  The params need not require grad: the
    loss is taken over views of them that do."""
    items = [(path, p.detach().requires_grad_(True))
             for path, p in tree_items(params)]
    tracked = tree_from_items(items)
    with torch.enable_grad():
        if remat:
            loss = checkpoint(loss_fn, tracked, batch, use_reentrant=False)
        else:
            loss = loss_fn(tracked, batch)
        grads = torch.autograd.grad(loss, [p for _, p in items],
                                    allow_unused=True)
    return loss.detach(), tree_from_items(
        [(path, torch.zeros_like(p) if g is None else g)
         for (path, p), g in zip(items, grads)])


def _slices(batch: dict, m: int) -> list[dict]:
    """The batch cut into ``m`` equal slices along its first axis; a leaf
    that does not cut evenly (a scalar) goes whole to every slice."""
    def cut(x, i):
        if x.ndim >= 1 and x.shape[0] % m == 0:
            n = x.shape[0] // m
            return x[i * n:(i + 1) * n]
        return x
    return [tree_map(lambda x: cut(x, i), batch) for i in range(m)]


def accumulated_value_and_grad(loss_fn, params: dict, batch: dict,
                               microbatches: int = 1, remat: bool = False):
    """``(loss, grads)`` of the train step.  With ``microbatches = m > 1``
    the gradient is accumulated over m equal slices of the batch, each
    slice's gradient divided by m into an fp32 sum, and the loss is the
    mean of the slices' losses, as the reference computes them."""
    m = microbatches
    if m == 1:
        return value_and_grad(loss_fn, params, batch, remat)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    losses = []
    for mb in _slices(batch, m):
        loss, g = value_and_grad(loss_fn, params, mb, remat)
        acc = tree_map(lambda a, gg: a + gg.to(a.dtype) / m, acc, g)
        losses.append(loss)
    return torch.stack(losses).mean(), acc


def build_train_step(bundle, tcfg: TrainConfig = TrainConfig()):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the params and moments updated in place, the gradient that
    of ``accumulated_value_and_grad`` over ``tcfg.microbatches`` slices.
    The learning rate is ``opt.lr`` times ``cosine_with_warmup`` of the
    state's step count.

    Gradient compression, as in the reference, compresses only the
    contribution that crosses a ``"pod"`` data-parallel axis.  One card has
    no such axis, so ``grad_compression`` is accepted and does not apply,
    exactly as on the reference's host mesh, and a warning says so; the
    multi-process path comes with the port's sharding slice (ROADMAP
    Queue A 11).
    """
    if tcfg.grad_compression is not None:
        warnings.warn(
            f"grad_compression={tcfg.grad_compression!r} does not apply: it "
            "compresses only across a 'pod' data-parallel axis, which one "
            "device does not have (the multi-process path is ROADMAP Queue "
            "A 11)", stacklevel=2)

    def train_step(params, opt_state, batch):
        loss, grads = accumulated_value_and_grad(
            bundle.loss_fn, params, batch, tcfg.microbatches, tcfg.remat)
        lr_scale = cosine_with_warmup(opt_state["step"], warmup=tcfg.warmup,
                                      total=tcfg.total_steps)
        params, opt_state, metrics = apply_updates(
            params, grads, opt_state, tcfg.opt, lr_scale)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def build_prefill_step(bundle):
    def prefill(params, batch):
        return bundle.prefill_fn(params, batch)

    return prefill


def build_serve_step(bundle):
    def serve(params, cache, batch):
        logits, cache = bundle.decode_fn(params, cache, batch)
        # greedy next token (the serving loop feeds it back)
        next_tok = logits[:, -1, :].argmax(dim=-1).to(torch.int32)
        return next_tok, cache

    return serve
