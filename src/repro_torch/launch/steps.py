"""Step-function builders: train / prefill / serve, as the reference's
``launch/steps.py`` on one device, and their compiled forms.

The reference returns each step with its shardings for ``jax.jit``; the
port returns the step alone, and the specs those shardings are made of
apart: ``batch_pspecs``, ``cache_pspecs`` and ``opt_state_pspecs`` (with
``models.common.schema_pspecs`` for the params) on a mesh's axis sizes,
and ``make_opt_shapes``, the optimizer state as meta tensors.

Under a process mesh of several ranks (``launch.mesh.ProcessMesh``)
``build_train_step`` returns a ``ParallelStep``: each rank takes its rows
of the global batch (at batch 1, its block of the sequence over the data
axes: ``sharding.hold_sequence``), the gradients are averaged over the pod
and data axes, and with ``fsdp`` the params and AdamW moments live as this
rank's shards (each layer's gathered over the data axes as the model runs
it, its gradient reduce-scattered back onto them).  Over a ``model`` axis
of more than one rank every family runs tensor parallel, and the
transformer's MoE expert
parallel (each rank its cut of every leaf: ``models.transformer``,
``rwkv6``, ``hymba``, ``whisper``), the transformer's residual stream
sequence parallel under ``REPRO_SEQ_PARALLEL=1``.  The prefill step keeps
the logits as each rank's vocab block (``sharding.keep_vocab_cut``) and
the serve step picks the greedy token across the blocks.

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
from ..models.common import checkpointed, greedy, schema_shardings
from ..optim import AdamWConfig, apply_updates, compress_tree, init_state
from ..optim.schedule import cosine_with_warmup
from ..sharding import (BATCH, MODEL, QUEUE_3C, NamedSharding, PartitionSpec,
                        check_data_parallel, gather_layers, gather_shard,
                        gather_tree, hold_sequence, keep_vocab_cut,
                        resolve_pspec, rows_alike, shard_tree,
                        sharded_dim_over, spec_axes, use_mesh)
from ..tree import tree_from_items, tree_items, tree_leaves, tree_map
from .mesh import ProcessMesh

__all__ = ["TrainConfig", "value_and_grad", "accumulated_value_and_grad",
           "batch_pspecs", "cache_pspecs", "opt_state_pspecs",
           "make_opt_shapes", "spans_ranks", "ParallelStep",
           "build_train_step", "build_prefill_step", "build_serve_step",
           "CompiledStep", "compiled_decode", "compiled_prefill",
           "compiled_train_step"]

COMPRESSION = (None, "int8", "topk")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    warmup: int = 100
    total_steps: int = 10000
    # None | "int8" | "topk": applies where the mesh has a "pod" axis
    # (see build_train_step)
    grad_compression: str | None = None
    # the whole loss under torch.utils.checkpoint: backward recomputes
    # the forward, saving only the inputs
    remat: bool = False
    # gradient accumulation over this many equal slices of the batch:
    # saved activations scale with B / microbatches
    microbatches: int = 1
    # FSDP/ZeRO: under a process mesh, params, gradients and optimizer
    # state live as this rank's shards over the data axes
    fsdp: bool = True

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


def spans_ranks(mesh) -> bool:
    """Whether ``mesh`` is a process mesh of more than one rank."""
    return isinstance(mesh, ProcessMesh) and mesh.size > 1


def build_train_step(bundle, tcfg: TrainConfig = TrainConfig(), mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the params and moments updated in place, the gradient that
    of ``accumulated_value_and_grad`` over ``tcfg.microbatches`` slices.
    The learning rate is ``opt.lr`` times ``cosine_with_warmup`` of the
    state's step count.

    With no mesh, or a mesh of one process, the step runs here on the
    whole batch.  Under a process mesh of several ranks it is a
    ``ParallelStep``.  Gradient compression, as in the reference,
    applies where the mesh has a ``"pod"`` axis: the averaged gradient
    goes through ``compress_tree(grads, None, mode)``.  Without one
    ``grad_compression`` is accepted, does not apply, and a warning says
    so.
    """
    compress = (tcfg.grad_compression is not None and mesh is not None
                and "pod" in mesh.shape)
    if tcfg.grad_compression is not None and not compress:
        warnings.warn(
            f"grad_compression={tcfg.grad_compression!r} does not apply: it "
            "compresses only across a 'pod' data-parallel axis, which this "
            "run's mesh does not have", stacklevel=2)
    if spans_ranks(mesh):
        return ParallelStep(bundle, tcfg, mesh, compress)

    def train_step(params, opt_state, batch):
        loss, grads = accumulated_value_and_grad(
            bundle.loss_fn, params, batch, tcfg.microbatches, tcfg.remat)
        if compress:
            grads, _ = compress_tree(grads, None, tcfg.grad_compression)
        lr_scale = cosine_with_warmup(opt_state["step"], warmup=tcfg.warmup,
                                      total=tcfg.total_steps)
        params, opt_state, metrics = apply_updates(
            params, grads, opt_state, tcfg.opt, lr_scale)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


class ParallelStep:
    """The train step on a process mesh of (pod, data, model) ranks: the
    batch split over the pod and data axes, each leaf cut over ``model``
    as ``schema_shardings`` places it (every family's tensor parallelism:
    the transformer's heads, FFN columns, experts and vocab, and under
    ``REPRO_SEQ_PARALLEL=1`` its residual stream's sequence; RWKV6's
    heads, FFN columns and vocab; Hymba's heads or head_dim, SSM channels
    and FFN columns; Whisper's heads and FFN columns; what a model cannot
    cut raises in the model's code, 3(c)).

    ``param_shardings`` / ``opt_shardings`` place the params and the AdamW
    state: with ``fsdp``, ``schema_shardings(..., fsdp=True)`` also cuts
    the stacked layer weights over the data axes; ``sharding.shard_tree``
    cuts full trees, ``gather_tree`` rebuilds them.  A call takes the
    global batch and, on each rank: cuts its rows (``batch_pspecs``),
    takes the loss and gradient of its rows with each layer's FSDP shards
    all-gathered over the data axes only as the model runs that layer
    (``sharding.gather_layers``: the ``model`` cuts stay, the gradient
    comes back reduce-scattered onto the shards, and a rematerialised
    layer gathers again in backward, as the reference's scan does), a leaf
    cut along its stack's layer dimension gathered whole before the
    forward; averages the loss and the gradient over the data axes (the
    layers' shards divided by the ranks, a reduce-scatter onto the other
    FSDP shards, an all-reduce for the rest), and runs AdamW on what it
    holds with the global gradient norm.  The gradient of a ``model``-cut
    leaf is this rank's block; a whole leaf's (the norms, MLA's ``wkv_a``)
    is the same on every ``model`` rank, the model's *f* summing the
    ranks' parts.  With ``compress`` the averaged gradient is gathered whole,
    compressed as the reference compresses each leaf, then cut.  Every
    rank returns the same loss and norm."""

    def __init__(self, bundle, tcfg: TrainConfig, mesh: ProcessMesh,
                 compress: bool):
        self.bundle, self.tcfg, self.mesh = bundle, tcfg, mesh
        self.compress = compress
        self.data_axes = tuple(a for a in BATCH if a in mesh.shape)
        self.ranks = mesh.group_size(self.data_axes)
        self.param_shardings = schema_shardings(bundle.schema, mesh,
                                                fsdp=tcfg.fsdp)
        for path, sh in tree_items(self.param_shardings):
            check_data_parallel(sh.spec, sharded_dim_over(sh, self.data_axes),
                                mesh.shape, True, f"param {'/'.join(path)}",
                                sharded_dim_over(sh, (MODEL,)))
        self.opt_shardings = {"m": self.param_shardings,
                              "v": self.param_shardings,
                              "step": NamedSharding(mesh, PartitionSpec())}
        self.layer_dims, self.per_layer = self._layer_cuts()

    def _layer_cuts(self) -> tuple[dict, set]:
        """``(dims, paths)``: for ``gather_layers``, each layer stack's
        (a top-level key ending in ``layers``, with a leaf the data axes
        cut) tree of the dimension of a layer's leaf that they cut, or
        None; and the key paths of the leaves gathered so, a layer at a
        time.  A leaf cut along its stack's layer dimension (Hymba's
        ``conv``) is not among them."""
        dims, paths = {}, set()
        for path, sh in tree_items(self.param_shardings):
            if not path[0].endswith("layers"):
                continue
            d = sharded_dim_over(sh, self.data_axes)
            node = dims.setdefault(path[0], {})
            for k in path[1:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = d - 1 if d else None
            if d:
                paths.add(path)
        return {k: v for k, v in dims.items()
                if any(p[0] == k for p in paths)}, paths

    def held_sequence(self, batch: dict) -> tuple:
        """The data axes that cut a batch of one row along its sequence
        (the bundle's ``batch_axes`` place a batch-1 sequence over
        ``data``), else ``()``: the axes ``hold_sequence`` names around the
        loss.  A sequence that does not divide over them (the tokens' or a
        prefix's positions) is held whole on every data rank, as the
        reference's ``resolve_pspec`` replicates it."""
        k = self.mesh.shape.get("data", 1)
        if batch["tokens"].shape[0] != 1 or k == 1:
            return ()
        if any(x.ndim >= 2 and x.shape[1] % k for x in batch.values()):
            return ()
        return ("data",)

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of every leaf of the global ``batch``, cut over
        the pod and data axes that divide them (``batch_pspecs``).  Where
        one does not (fewer rows than ranks, as in a smoke-scaled dry-run
        cell), its ranks hold the same rows: the loss and gradient averaged
        over every data rank are still the batch's, each block of rows
        being held by as many ranks (a MoE counts each row once:
        ``alike_axes``).  A batch of one row is cut along its sequence over
        ``data`` instead (tokens, labels and a prefix alike, equal blocks
        of one position or more): each rank's loss is the mean over its
        block, so the average over the data ranks is the sequence's mean.
        A sequence that does not divide is held whole on every data rank,
        a row held alike.

        With ``microbatches = m > 1`` the rows are the reference's
        microbatch slices, m slices of consecutive global rows: each rank
        takes its block of every slice, in slice order
        (``_reference_rows``), so its i-th local slice is its block of the
        reference's slice i.  Where a slice's rows do not cut over the
        ranks that would cut the batch (``_whole_slices``), every rank
        holds the batch whole, its rows alike, and the ranks share the
        slices (``_share``)."""
        specs = batch_pspecs(self.bundle, batch, self.mesh)
        seq = self.held_sequence(batch)
        if (batch["tokens"].shape[0] == 1 and not seq) or \
                self._whole_slices(batch):  # the rows whole
            specs = {k: PartitionSpec(*(None,) * batch[k].ndim)
                     for k in specs}
        for key, spec in specs.items():
            what = f"batch leaf {key!r} {tuple(batch[key].shape)}"
            if seq:
                check_data_parallel(spec, None, self.mesh.shape, True, what,
                                    seq_dim=1, seq_axes=seq)
                continue
            rows = spec_axes(spec[0]) if len(spec) else ()
            alike = [a for a in BATCH if self.mesh.shape.get(a, 1) > 1
                     and a not in rows]
            # dimension 0 over the data axes that cut it (the others held
            # as if of one rank), and no other dimension over any axis
            check_data_parallel(spec, 0, {**self.mesh.shape,
                                          **dict.fromkeys(alike, 1)}, True, what)
            check_data_parallel(PartitionSpec(None, *spec[1:]), None,
                                self.mesh.shape, False, what)
        local = self._reference_rows(batch, specs)
        if local is not None:
            return local
        return shard_tree(batch, tree_map(lambda sp: NamedSharding(
            self.mesh, sp), specs))

    def _row_axes(self, batch: dict) -> tuple:
        """The pod and data axes that cut the rows of ``batch`` as
        ``batch_pspecs`` places them."""
        spec = batch_pspecs(self.bundle, batch, self.mesh)["tokens"]
        return spec_axes(spec[0]) if len(spec) else ()

    def _whole_slices(self, batch: dict) -> bool:
        """Whether the reference's m > 1 microbatch slices of ``batch``
        (B / m consecutive rows each) do not cut over the ranks that cut
        its B rows: each slice is then held whole on those ranks, as
        ``resolve_pspec`` replicates a dimension that does not divide."""
        m, b = self.tcfg.microbatches, batch["tokens"].shape[0]
        if m == 1 or b % m:
            return False
        k = self.mesh.group_size(self._row_axes(batch))
        return k > 1 and (b // m) % k != 0

    def _reference_rows(self, batch: dict, specs: dict) -> dict | None:
        """This rank's rows of ``batch`` as the reference's microbatch
        slices hold them, or None where the plain cut is the same: one
        slice, rows held whole, or rows that do not cut into m slices
        (the reference then gives every microbatch the whole batch, and
        ``_slices`` every one this rank's rows).  The rows viewed as (m
        slices, k ranks, rows) give rank r ``[:, r]``: one copy of its
        rows, as the plain cut makes."""
        m = self.tcfg.microbatches
        spec = specs["tokens"]
        rows = spec_axes(spec[0]) if len(spec) else ()
        k = self.mesh.group_size(rows)
        if m == 1 or k == 1 or batch["tokens"].shape[0] % m:
            return None
        r = self.mesh.group_rank(rows)

        def take(x, sp):
            if len(sp) and sp[0] is not None:
                return x.unflatten(0, (m, k, -1))[:, r].clone(
                    memory_format=torch.contiguous_format).flatten(0, 1)
            return x.clone()

        return tree_map(take, batch, specs)

    def alike_axes(self, batch: dict) -> tuple:
        """The pod and data axes of more than one rank whose ranks hold
        the same rows of ``batch`` (its rows fewer than the ranks), which
        ``sharding.rows_alike`` names around the loss: a MoE's dispatch
        groups are those of the distinct rows."""
        if self.held_sequence(batch):
            return ()
        rows = () if self._whole_slices(batch) else self._row_axes(batch)
        return tuple(a for a in BATCH if self.mesh.shape.get(a, 1) > 1
                     and a not in rows)

    def _share(self, batch: dict, alike: tuple, m: int):
        """``(rows, microbatches)`` this rank runs of its rows ``batch``
        cut into ``m`` microbatch slices.  Where ``k`` ranks along
        ``alike`` hold the same rows and ``k`` and ``m`` divide one
        another, they share the slices instead of each running all of
        them: ``m / k`` slices a rank, or one slice for ``k / m`` ranks.
        Each rank's gradient is then the mean over its slices, and the
        mean over every data rank is still the batch's (the slices are
        equal).  Each layer's FSDP gathers are made once a slice, so this
        also divides them by ``min(k, m)``."""
        k = self.mesh.group_size(alike) if alike else 1
        rows = batch["tokens"].shape[0]
        if k == 1 or m == 1 or rows % m:
            return batch, m
        i = self.mesh.group_rank(alike)
        if m % k == 0:
            return _slices(batch, k)[i], m // k
        if k % m == 0:
            return _slices(batch, m)[i % m], 1
        return batch, m

    def _mean(self, g, sh: NamedSharding, summed: bool):
        """The mean over the data ranks of one leaf's gradient, as the
        leaf is held: ``summed`` where it arrived as this rank's shard of
        the sum (a layer gathered by ``gather_layer``)."""
        if not summed:
            d = sharded_dim_over(sh, self.data_axes)
            g = (self.mesh.all_reduce(g, self.data_axes) if d is None else
                 self.mesh.reduce_scatter(g, self.data_axes, d))
        return g / self.ranks

    def _grad_norm(self, grads: dict) -> torch.Tensor:
        """The global norm of a gradient held as shards and whole leaves:
        each leaf's sum of squares added over the axes that cut it, a
        whole leaf counted once."""
        by_axes: dict = {}
        for g, sh in zip(tree_leaves(grads), tree_leaves(self.param_shardings)):
            axes = tuple(a for a in self.mesh.axis_names
                         if sharded_dim_over(sh, (a,)) is not None)
            by_axes.setdefault(axes, []).append(g.float().square().sum())
        total = 0.0
        for axes, sums in sorted(by_axes.items()):
            total = total + self.mesh.all_reduce(sum(sums), axes)
        return torch.sqrt(total)

    def __call__(self, params, opt_state, batch):
        with use_mesh(self.mesh):
            return self._step(params, opt_state, batch)

    def _step(self, params, opt_state, batch):
        tcfg, mesh = self.tcfg, self.mesh
        held = tree_from_items(
            (path, p if path in self.per_layer
             else gather_shard(p, sh, self.data_axes))
            for (path, p), sh in zip(tree_items(params),
                                     tree_leaves(self.param_shardings)))
        alike = self.alike_axes(batch)
        local, micro = self._share(self.local_batch(batch), alike,
                                   tcfg.microbatches)
        with hold_sequence(self.held_sequence(batch)), rows_alike(
                alike), gather_layers(mesh, self.data_axes, self.layer_dims):
            loss, grads = accumulated_value_and_grad(
                self.bundle.loss_fn, held, local, micro, tcfg.remat)
        del held
        loss = mesh.all_reduce(loss, self.data_axes) / self.ranks
        # each leaf's local gradient released as its mean is taken
        items = tree_items(grads)
        del grads
        means = []
        for i, sh in enumerate(tree_leaves(self.param_shardings)):
            path, g = items[i]
            items[i] = None
            means.append((path, self._mean(g, sh, path in self.per_layer)))
        del g
        grads = tree_from_items(means)
        if self.compress:  # compressed whole, as the reference does
            grads = gather_tree(grads, self.param_shardings)
            grads, _ = compress_tree(grads, None, tcfg.grad_compression)
            grads = shard_tree(grads, self.param_shardings)
        lr_scale = cosine_with_warmup(opt_state["step"], warmup=tcfg.warmup,
                                      total=tcfg.total_steps)
        params, opt_state, metrics = apply_updates(
            params, grads, opt_state, tcfg.opt, lr_scale,
            grad_norm=self._grad_norm(grads))
        return params, opt_state, {"loss": loss, **metrics}


def build_prefill_step(bundle):
    """``prefill(params, batch) -> logits``: over model ranks each rank's
    vocab block of them, as the reference's output is held cut
    (``bundle.prefill_fn`` outside the step gathers them whole)."""
    def prefill(params, batch):
        with keep_vocab_cut():
            return bundle.prefill_fn(params, batch)

    return prefill


def build_serve_step(bundle):
    """``serve(params, cache, batch) -> (next token (B,) int32, cache)``:
    the greedy token of one decode step, picked across the ranks' vocab
    blocks over model ranks (``models.common.greedy``)."""
    def serve(params, cache, batch):
        with keep_vocab_cut():
            logits, cache = bundle.decode_fn(params, cache, batch)
        # greedy next token (the serving loop feeds it back)
        next_tok = greedy(logits[:, -1, :], bundle.cfg.vocab).to(torch.int32)
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
    out.  A ``ParallelStep`` runs collectives between its local parts,
    which no graph holds: with ``graphs`` it raises ``NotImplementedError``
    (the captured split is ROADMAP Queue A item 3(c))."""
    if graphs is None:
        return train_step
    if isinstance(train_step, ParallelStep):
        raise NotImplementedError(
            "a train step over a process mesh runs eagerly (graphs=False): "
            "its collectives sit between the captured parts; " + QUEUE_3C)

    def metrics(params, opt_state, batch):
        _, _, m = train_step(params, opt_state, batch)
        return m["loss"], m["grad_norm"]

    step = CompiledStep(metrics, graphs, name="train_step", resident=(0, 1),
                        writes=(0, 1))

    def compiled(params, opt_state, batch):
        loss, gnorm = step(params, opt_state, batch)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return compiled
