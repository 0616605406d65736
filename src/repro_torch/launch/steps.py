"""Step-function builders: train / prefill / serve, as the reference's
``launch/steps.py`` on one device, and their compiled forms.

The reference returns each step with its shardings for ``jax.jit``; the
port returns the step alone, and the specs those shardings are made of
apart: ``batch_pspecs``, ``cache_pspecs`` and ``opt_state_pspecs`` (with
``models.common.schema_pspecs`` for the params) on a mesh's axis sizes,
and ``make_opt_shapes``, the optimizer state as meta tensors.  Executing
a step sharded over processes (FSDP, expert parallelism) is ROADMAP
Queue A item 3(b).

The reference's launchers ``jax.jit`` three steps: the decode step and the
cache-filling prefill (with the cache donated) and the train step (with
params and optimizer state donated).  The port's counterpart is a CUDA
graph per step and argument signature (``core.graphs.GraphSet``):
``CompiledStep`` replays ``fn(*trees)`` with the leaves of its resident
trees (params, caches, optimizer state) used and written in place, as the
donation does, and the rest (a batch, tokens) copied in; ``compiled_decode``,
``compiled_prefill`` and ``compiled_train_step`` wrap the bundle's steps.
With ``graphs=None`` each runs eagerly.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from ..core.graphs import GraphSet
from ..core.pipeline import Program
from ..models.common import checkpointed
from ..optim import AdamWConfig, apply_updates, init_state
from ..optim.schedule import cosine_with_warmup
from ..sharding import PartitionSpec, resolve_pspec
from ..tree import tree_from_items, tree_items, tree_map

__all__ = ["TrainConfig", "value_and_grad", "accumulated_value_and_grad",
           "batch_pspecs", "cache_pspecs", "opt_state_pspecs",
           "make_opt_shapes",
           "build_train_step", "build_prefill_step", "build_serve_step",
           "CompiledStep", "compiled_decode", "compiled_prefill",
           "compiled_train_step"]

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


def batch_pspecs(bundle, batch_shapes: dict, mesh) -> dict:
    """The ``PartitionSpec`` of each batch leaf (tensors or meta tensors)
    on ``mesh``: the bundle's ``batch_axes`` resolved against the leaf's
    shape."""
    axes = bundle.batch_axes(batch_shapes)
    return tree_map(lambda leaf, ax: resolve_pspec(leaf.shape, ax, mesh.shape),
                    batch_shapes, axes)


def cache_pspecs(bundle, cache_shapes: dict, mesh) -> dict:
    """The ``PartitionSpec`` of each cache leaf on ``mesh``, from the
    bundle's ``cache_axes``."""
    axes = bundle.cache_axes(cache_shapes)
    return tree_map(lambda leaf, ax: resolve_pspec(leaf.shape, ax, mesh.shape),
                    cache_shapes, axes)


def opt_state_pspecs(param_pspecs: dict) -> dict:
    """AdamW's moments sharded as the params, its step replicated."""
    return {"m": param_pspecs, "v": param_pspecs, "step": PartitionSpec()}


def make_opt_shapes(bundle, dtype: torch.dtype = torch.float32) -> dict:
    """The AdamW state of the bundle's params in ``dtype``, as meta
    tensors: ``init_state`` over ``param_shapes``, no storage."""
    return init_state(bundle.param_shapes(dtype))


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
            loss = checkpointed(loss_fn, tracked, batch)
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
    multi-process path comes with the port's sharding execution (ROADMAP
    Queue A item 3(b)).
    """
    if tcfg.grad_compression is not None:
        warnings.warn(
            f"grad_compression={tcfg.grad_compression!r} does not apply: it "
            "compresses only across a 'pod' data-parallel axis, which one "
            "device does not have (the multi-process path is ROADMAP Queue "
            "A item 3(b))", stacklevel=2)

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


# ---------------------------------------------------------------------------
# compiled steps: the counterpart of the reference's jax.jit
# ---------------------------------------------------------------------------


class CompiledStep:
    """``fn(*trees)`` replayed from a CUDA graph of ``graphs`` (one per
    argument signature), or run eagerly where ``graphs`` is None.

    Each argument is a tree (a nested dict of tensors) or a tensor.  The
    leaves of the trees at the positions ``resident`` are used in place by
    the graph (a replay reads and writes them where they lie; another
    storage under the same signature raises ``ResidentMoved``); the other
    trees' leaves are copied into the graph's static inputs before each
    replay.  ``writes`` names the resident trees that ``fn`` writes in
    place and reads again (a recurrent state, an optimizer's), which the
    capture restores so that the first call advances them once.  ``fn``
    returns fresh tensors (the logits, a loss), which each call gets as
    clones of the graph's outputs.  A capture that fails raises
    ``GraphCaptureError``; nothing gives way to eager execution."""

    def __init__(self, fn, graphs: GraphSet | None, *, name: str,
                 resident: tuple = (), writes: tuple = ()):
        self.fn = fn
        self.graphs = graphs
        self.name = name
        self.resident = tuple(resident)
        self.writes = tuple(writes)
        self._program: Program | None = None
        self._layout: tuple | None = None  # each argument's key paths

    def __call__(self, *trees):
        if self.graphs is None:
            return self.fn(*trees)
        items = [tree_items(t) for t in trees]
        layout = tuple(tuple(path for path, _ in it) for it in items)
        if self._program is None:
            self._layout = layout
            starts = [0]
            for paths in layout:
                starts.append(starts[-1] + len(paths))

            def leaves_of(args):
                return tuple(j for i in args
                             for j in range(starts[i], starts[i + 1]))

            self._program = Program(self._flat, name=self.name,
                                    resident=leaves_of(self.resident),
                                    writes=leaves_of(self.writes),
                                    graphs=self.graphs)
        elif layout != self._layout:
            raise ValueError(f"{self.name}: the arguments' trees are not the "
                             f"ones the step was compiled for")
        return self._program(*(leaf for it in items for _, leaf in it))

    def _flat(self, *leaves):
        trees, k = [], 0
        for paths in self._layout:
            part = leaves[k:k + len(paths)]
            k += len(paths)
            trees.append(part[0] if paths == ((),) else
                         tree_from_items(zip(paths, part)))
        return self.fn(*trees)


def compiled_decode(bundle, graphs: GraphSet | None, max_len: int, device):
    """``decode(params, cache, tokens, pos) -> logits (B, 1, V)``: one
    ``bundle.decode_fn`` step at the Python int ``pos``, the cache written
    in place.  With ``graphs``, one graph per (batch, max_len): params,
    cache and a device scalar of the position are resident (the cache
    written, as the reference's donation), the tokens copied in; the
    position is filled into its scalar before each replay, after a check
    that it lies in ``0..max_len-1``.  Without, ``decode_fn`` eagerly."""
    if graphs is None:
        def eager(params, cache, tokens, pos):
            return bundle.decode_fn(params, cache,
                                    {"tokens": tokens, "pos": pos})[0]
        return eager

    at = torch.zeros((), dtype=torch.long, device=device)
    step = CompiledStep(
        lambda params, cache, pos, tokens: bundle.decode_fn(
            params, cache, {"tokens": tokens, "pos": pos})[0],
        graphs, name="decode", resident=(0, 1, 2), writes=(1,))

    def decode(params, cache, tokens, pos: int):
        if not 0 <= pos < max_len:
            raise ValueError(f"position {pos} is outside the cache length "
                             f"{max_len}")
        at.fill_(pos)
        return step(params, cache, at, tokens)

    return decode


def compiled_prefill(bundle, graphs: GraphSet | None):
    """``prefill(params, cache, tokens) -> logits (B, P, V)``:
    ``bundle.prefill_cache_fn`` over the prompt, the cache written in
    place; with ``graphs``, one graph per (batch, prompt length, max_len),
    params and cache resident, the tokens copied in."""
    return CompiledStep(
        lambda params, cache, tokens: bundle.prefill_cache_fn(
            params, cache, {"tokens": tokens})[0],
        graphs, name="prefill", resident=(0, 1), writes=(1,))


def compiled_train_step(train_step, graphs: GraphSet | None):
    """``train_step`` (``build_train_step``'s) with the same call and
    returns; with ``graphs``, one graph per batch signature holding the
    loss, its gradient, the schedule and the AdamW update: params and
    optimizer state resident and written in place (the reference's
    donation), the batch copied in, the loss and gradient norm cloned
    out."""
    if graphs is None:
        return train_step

    def metrics(params, opt_state, batch):
        _, _, m = train_step(params, opt_state, batch)
        return m["loss"], m["grad_norm"]

    step = CompiledStep(metrics, graphs, name="train_step", resident=(0, 1),
                        writes=(0, 1))

    def compiled(params, opt_state, batch):
        loss, gnorm = step(params, opt_state, batch)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return compiled
