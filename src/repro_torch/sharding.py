"""Logical sharding axes and their resolution on a mesh: the reference's
``sharding.py`` without its jax half.

A logical axis is an entry of a leaf's axes tuple: ``None``, a mesh axis
name, or a tuple of candidate names used jointly (``BATCH`` =
``("pod", "data")``).  ``resolve_pspec`` picks, per dimension, the
candidates that exist in the mesh and divide the dimension, so one model
resolves on one device, a 16 x 16 pod or a 2 x 16 x 16 multi-pod mesh
alike (SmolLM's 9 heads fall back to replication on ``model = 16``).

``use_mesh`` makes a mesh the active one for a block (``active_mesh``), as
the reference's ``compat.set_mesh`` does.  ``shard_hint`` is the
reference's ``with_sharding_constraint`` under the active mesh.  Under a
process mesh each rank holds its rows of the batch, split over the pod
and data axes, and, with tensor parallelism, its block of one dimension
over ``model`` where the model code holds it so (``model_dim``: the MoE
buffer's experts, a head-cut activation).  A hint whose resolved
placement is exactly that states what already holds and returns ``x``
itself; so does one of a held sequence's block (``seq_dim``: the sequence
over ``data`` at batch 1, the sequence-parallel residual stream over
``model``).  Any other placement over an axis of more than one rank (a
``model`` placement the code does not hold) raises
``NotImplementedError``.  Where a dimension does not divide
its mesh axes the reference replicates it and the model code holds it
whole on every rank; a MoE dispatch group that covers rows of several
data ranks gathers them (``row_axes``: the axes whose ranks hold distinct
rows, not those holding rows alike, ``rows_alike``).
``model_ranks`` gives the model code the ``model`` axis of the active
process mesh (its size, this rank's index, the collectives over it).

A ``NamedSharding`` is one leaf's placement on a mesh; ``shard_tree`` cuts
a tree of full leaves to this rank's shards and ``gather_tree`` undoes
it, by slicing and all-gather alone.  Inside an FSDP train step
(``gather_layers``) the model gathers each layer's shards as it runs
that layer (``gather_layer``), so no rank holds the whole tree.  A mesh
whose ranks are processes (``launch.mesh.ProcessMesh``) is known here by
its ``coordinate``, this rank's index on each axis, so this module
imports nothing above it.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os

from .tree import tree_from_items, tree_items, tree_map

__all__ = ["BATCH", "MODEL", "WORKERS", "QUEUE_3C", "baseline", "PartitionSpec",
           "resolve_pspec", "worker_devices", "use_mesh", "active_mesh",
           "batch_ranks", "row_axes", "rows_alike", "ModelRanks",
           "model_ranks", "hold_sequence", "whole_sequence",
           "held_sequence", "SequenceRanks", "sequence_ranks",
           "keep_vocab_cut", "vocab_cut_kept", "placement", "use_placement",
           "hint_pspec",
           "shard_hint", "check_data_parallel", "spec_axes", "NamedSharding",
           "sharded_dim_over", "shard_tree", "gather_shard", "gather_tree",
           "gather_layers", "gather_layer"]

# canonical logical axes
BATCH = ("pod", "data")  # batch (or sequence for long context) shards here
MODEL = "model"
WORKERS = "workers"  # the coded cluster's n-worker axis (1-D worker mesh)

# where the placements the port does not execute yet are queued
QUEUE_3C = "ROADMAP Queue A item 3(c)"


def baseline() -> bool:
    """Whether ``REPRO_BASELINE=1`` asks for the reference's paper-faithful
    baseline: head-cut caches written in place (``transformer.cache_layout``),
    the full attention rectangle (``LMConfig.flash_block_skip``), the MoE's
    float-scatter dispatch, and train cells without microbatches or FSDP
    (``launch.dryrun.train_config``)."""
    return os.environ.get("REPRO_BASELINE") == "1"


class PartitionSpec(tuple):
    """One leaf's placement on a mesh, dimension by dimension: ``None``
    (replicated), a mesh axis name, or a tuple of names sharded jointly.
    An immutable tuple of those entries (the reference's
    ``jax.sharding.PartitionSpec`` compares equal to the same tuple)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def worker_devices(mesh, n: int) -> list:
    """The n coded workers' devices, read off a worker mesh
    (``launch.mesh.make_worker_mesh``): worker ``i`` runs on device
    ``i % mesh size``.  With fewer devices than workers the round-robin
    oversubscribes evenly (one device holds every worker); with at least
    ``n`` devices each worker owns its device."""
    devs = list(mesh.devices.flat)
    if not devs:
        raise ValueError("empty mesh")
    return [devs[i % len(devs)] for i in range(n)]


def _resolve_dim(dim: int, cand, mesh_shape) -> tuple[str, ...] | None:
    if cand is None:
        return None
    if isinstance(cand, str):
        cand = (cand,)
    chosen = tuple(a for a in cand if a in mesh_shape)
    if not chosen:
        return None
    total = math.prod(mesh_shape[a] for a in chosen)
    if total and dim % total == 0:
        return chosen
    # else the single axis that divides, first come
    for a in chosen:
        if dim % mesh_shape[a] == 0:
            return (a,)
    return None


def resolve_pspec(shape, axes, mesh_shape) -> PartitionSpec:
    """The ``PartitionSpec`` of a leaf of ``shape`` whose dimensions take
    the logical ``axes`` on a mesh of ``mesh_shape`` (axis name -> size):
    each dimension takes the candidates that exist and divide it, and no
    mesh axis is used twice."""
    out = []
    used: set[str] = set()
    for dim, cand in zip(shape, axes):
        r = _resolve_dim(dim, cand, mesh_shape)
        if r is None or any(a in used for a in r):
            out.append(None)
        else:
            used.update(r)
            out.append(r if len(r) > 1 else r[0])
    return PartitionSpec(*out)


# -- the active mesh ---------------------------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                         default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` active inside the block (the reference's
    ``compat.set_mesh``); the one before it restored after."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    """The mesh ``use_mesh`` made active in this context, else None (the
    reference's empty ``get_abstract_mesh``)."""
    return _ACTIVE.get()


_SEQUENCE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sequence", default=())
_VOCAB_CUT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_vocab_cut", default=False)
_LAYERS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_fsdp_layers", default=None)
_ALIKE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_rows_alike", default=())


@contextlib.contextmanager
def hold_sequence(axes=("data",)):
    """Inside the block the batch is one row whose sequence is cut over
    ``axes`` of the active process mesh (the reference's batch-1 fallback,
    ``shard_hint(x, BATCH, "data", None)``): a pass over the sequence
    takes this rank's block of it, equal blocks of one position or more in
    group order; a decode step's one position is whole on every rank
    (``whole_sequence``); a cache holds this rank's block of its positions
    where they divide."""
    token = _SEQUENCE.set(tuple((axes,) if isinstance(axes, str) else axes))
    try:
        yield
    finally:
        _SEQUENCE.reset(token)


@contextlib.contextmanager
def whole_sequence():
    """Inside the block a pass is whole on every rank of a held sequence's
    axes (a decode step's one position, or a prompt that does not divide
    over them, as the reference's ``resolve_pspec`` replicates it): no
    sequence is held, and those axes' ranks hold the same row
    (``rows_alike``).  A cache keeps the cut it was made with."""
    held = _SEQUENCE.get()
    alike = _ALIKE.get()
    tokens = (_SEQUENCE.set(()),
              _ALIKE.set(alike + tuple(a for a in held if a not in alike)))
    try:
        yield
    finally:
        _ALIKE.reset(tokens[1])
        _SEQUENCE.reset(tokens[0])


def held_sequence() -> tuple[str, ...]:
    """The mesh axes of more than one rank that cut a held sequence under
    the active process mesh (``hold_sequence``), else ``()``."""
    mesh = active_mesh()
    if mesh is None or not _holds_ranks(mesh):
        return ()
    return tuple(a for a in mesh.axis_names
                 if a in _SEQUENCE.get() and mesh.shape[a] > 1)


@contextlib.contextmanager
def keep_vocab_cut():
    """Inside the block a model's logits over model ranks stay this rank's
    block of the vocabulary (``models.common.vocab_logits``), as the
    reference's output is held cut: the prefill step and the greedy loop
    read them so (``models.common.greedy``)."""
    token = _VOCAB_CUT.set(True)
    try:
        yield
    finally:
        _VOCAB_CUT.reset(token)


def vocab_cut_kept() -> bool:
    return _VOCAB_CUT.get()


@contextlib.contextmanager
def rows_alike(axes=()):
    """Inside the block the ranks along the pod and data ``axes`` hold the
    same rows of the batch (fewer rows than ranks: ``launch.steps.
    ParallelStep.local_batch``), so only the other batch axes hold
    distinct rows (``row_axes``)."""
    token = _ALIKE.set(tuple(axes))
    try:
        yield
    finally:
        _ALIKE.reset(token)


_PLACEMENT = (_ACTIVE, _SEQUENCE, _VOCAB_CUT, _LAYERS, _ALIKE)


def placement() -> tuple:
    """The active mesh, held sequence, vocab cut, per-layer gathers and
    rows held alike: what a recompute (``models.common.checkpointed``)
    runs under again."""
    return tuple(var.get() for var in _PLACEMENT)


@contextlib.contextmanager
def use_placement(state: tuple):
    """``placement()``'s ``state`` active inside the block."""
    tokens = [var.set(v) for var, v in zip(_PLACEMENT, state)]
    try:
        yield
    finally:
        for var, token in zip(_PLACEMENT, tokens):
            var.reset(token)


def _holds_ranks(mesh) -> bool:
    """Whether ``mesh``'s points are the processes of a job (a
    ``launch.mesh.ProcessMesh``: it knows this rank's coordinate)."""
    return getattr(mesh, "coordinate", None) is not None


def row_axes() -> tuple[str, ...]:
    """The pod and data axes of more than one rank whose ranks hold
    distinct rows of the batch (or blocks of a held sequence) under the
    active process mesh: all of them but those holding rows alike
    (``rows_alike``); ``()`` without a process mesh."""
    mesh = active_mesh()
    if mesh is None or not _holds_ranks(mesh):
        return ()
    return tuple(a for a in mesh.axis_names if a in BATCH
                 and mesh.shape[a] > 1 and a not in _ALIKE.get())


def batch_ranks() -> int:
    """The ranks holding distinct rows of the batch under the active mesh:
    the product of the sizes of ``row_axes``, 1 without a process mesh."""
    mesh = active_mesh()
    return 1 if mesh is None else math.prod(mesh.shape[a] for a in row_axes())


@dataclasses.dataclass(frozen=True)
class ModelRanks:
    """The ``model`` axis of the active process mesh, as the model code
    uses it: ``size`` ranks, this one at ``rank``, and the collectives over
    the axis (``copy``, ``reduce`` and ``gather`` carry gradients: the
    mesh's ``copy_to``, ``reduce_from``, ``gather_from``)."""

    mesh: object
    size: int
    rank: int

    def copy(self, x):
        """Megatron's *f*: ``x``; its gradient summed over the ranks."""
        return self.mesh.copy_to(x, MODEL)

    def reduce(self, x):
        """Megatron's *g*: the sum over the ranks."""
        return self.mesh.reduce_from(x, MODEL)

    def gather(self, x, dim: int):
        """The ranks' blocks concatenated along ``dim``; backward, this
        rank's slice of the gradient (right where what follows computes
        the same on every rank)."""
        return self.mesh.gather_from(x, MODEL, dim)

    def gather_partial(self, x, dim: int):
        """``gather`` where what follows differs by rank: backward, the
        ranks' gradients summed, then this rank's slice."""
        return self.copy(self.gather(x, dim))

    def all_reduce(self, x, op: str = "sum"):
        """The sum (or maximum) over the ranks, no gradient."""
        return self.mesh.all_reduce(x, MODEL, op)

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` entries cut evenly over the ranks."""
        c = n // self.size
        return slice(self.rank * c, (self.rank + 1) * c)

    def cut(self, leaf, dim: int, full: int) -> bool:
        """Whether this rank holds ``leaf``'s dimension ``dim`` of ``full``
        entries as its block (else whole)."""
        n = leaf.shape[dim]
        if n == full:
            return False
        if n * self.size != full:
            raise ValueError(f"dimension {dim} of {tuple(leaf.shape)}: {n} of "
                             f"{full} over model = {self.size}")
        return True


    def scatter(self, x, dim: int):
        """This rank's block of ``x`` along ``dim``; backward, the blocks'
        gradients gathered (the sequence-parallel stream's entry)."""
        return self.mesh.scatter_to(x, MODEL, dim)

    def reduce_scatter(self, x, dim: int):
        """This rank's block along ``dim`` of the sum over the ranks;
        backward, the gradient gathered (the sequence-parallel *g*)."""
        return self.mesh.reduce_scatter_from(x, MODEL, dim)


def model_ranks() -> ModelRanks | None:
    """The active process mesh's ``model`` axis where it has more than one
    rank, else None (one device, or data parallelism alone)."""
    mesh = active_mesh()
    if mesh is None or not _holds_ranks(mesh) or mesh.shape.get(MODEL, 1) == 1:
        return None
    return ModelRanks(mesh, mesh.shape[MODEL], mesh.coordinate[MODEL])


@dataclasses.dataclass(frozen=True)
class SequenceRanks:
    """The mesh axes that cut a sequence (``axes``, of ``size`` ranks
    jointly, this one at ``rank`` in group order), as the model code uses
    them: this rank's block of positions, the gather of every rank's block
    and the merges over them."""

    mesh: object
    axes: tuple
    size: int
    rank: int

    def lo(self, n: int) -> int:
        """The first position of this rank's block of ``n``."""
        return self.rank * n

    def gather(self, x, dim: int):
        """The ranks' blocks of ``x`` concatenated along ``dim`` in group
        order; backward, the ranks' gradients summed and this rank's block
        kept (the reduce-scatter): what follows differs by rank."""
        return self.mesh.gather_to(x, self.axes, dim)

    def all_reduce(self, x, op: str = "sum"):
        """The sum (or maximum) over the ranks, no gradient (the
        log-sum-exp merge of ``models.transformer.merged_decode``)."""
        return self.mesh.all_reduce(x, self.axes, op)

    def positions(self, lens, device):
        """``(this rank's positions, every rank's in group order)`` of a
        sequence of segments each cut evenly over the ranks (PaliGemma's
        prefix, then its tokens): ``lens`` this rank's length of each; as
        int32 (1, n) tensors."""
        import torch

        def of(r):
            parts, off = [], 0
            for n in lens:
                parts.append(torch.arange(off + r * n, off + (r + 1) * n,
                                          dtype=torch.int32, device=device))
                off += n * self.size
            return torch.cat(parts)

        return (of(self.rank)[None],
                torch.cat([of(r) for r in range(self.size)])[None])


def _axis_group(mesh, axes) -> SequenceRanks | None:
    live = mesh._live(axes)
    if not live:
        return None
    return SequenceRanks(mesh, live, mesh.group_size(live),
                         mesh.group_rank(live))


def sequence_ranks(axes=None) -> SequenceRanks | None:
    """The axes that cut a held sequence (``hold_sequence``; ``axes`` where
    given, those of them with more than one rank) under the active process
    mesh, else None."""
    mesh = active_mesh()
    if mesh is None or not _holds_ranks(mesh):
        return None
    if axes is None:
        axes = held_sequence()
        if not axes:
            return None
    return _axis_group(mesh, axes)


def _batch_dim(axes) -> int | None:
    """The first dimension whose candidates name a data-parallel axis."""
    for i, cand in enumerate(axes):
        names = (cand,) if isinstance(cand, str) else tuple(cand or ())
        if any(a in BATCH for a in names):
            return i
    return None


def hint_pspec(shape, axes, mesh_shape, split: bool = True,
               model_dim: int | None = None, seq_dim: int | None = None,
               seq_axes: tuple = ()):
    """``(global shape, PartitionSpec)`` of a ``shard_hint`` of a local
    tensor of ``shape`` on a mesh of ``mesh_shape``: with ``split`` (a
    process mesh, whose ranks each hold their rows of the batch) the first
    dimension whose candidates name ``pod`` or ``data`` is that many times
    larger globally, the product of those of the axes that do not cut the
    sequence, dimension ``model_dim`` (a block a rank holds) the model
    size larger, and dimension ``seq_dim`` (a block of the sequence) the
    product of ``seq_axes``' sizes; then the spec as ``resolve_pspec``
    gives it on the global shape."""
    shape = list(int(d) for d in shape)
    i = _batch_dim(axes)
    if split and i is not None:
        shape[i] *= math.prod(mesh_shape.get(a, 1) for a in BATCH
                              if a not in seq_axes)
    if split and model_dim is not None:
        shape[model_dim] *= mesh_shape.get(MODEL, 1)
    if split and seq_dim is not None:
        shape[seq_dim] *= math.prod(mesh_shape.get(a, 1) for a in seq_axes)
    return tuple(shape), resolve_pspec(shape, axes, mesh_shape)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one ``PartitionSpec`` entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_hint(x, *axes, model_dim: int | None = None,
               seq_dim: int | None = None, seq_axes=None):
    """``x`` under the active mesh's placement of ``axes`` (one entry a
    dimension: None, an axis name, or a tuple of candidates used jointly,
    as ``BATCH``): the identity with no active mesh, and where the
    resolved spec shards nothing but the batch dimension that a process
    mesh has already split over its pod and data axes and, where the
    caller holds ``x``'s dimension ``model_dim`` as this rank's block over
    ``model``, that dimension over ``model``, and, where it holds
    dimension ``seq_dim`` as this rank's block of the sequence, that
    dimension over the axes that cut it (``seq_axes``, by default the held
    sequence's: ``hold_sequence``).  Any other placement over an axis of
    more than one rank raises ``NotImplementedError`` (ROADMAP Queue A
    item 3(c))."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"{len(axes)} axes for a tensor of rank {x.ndim}")
    split = _holds_ranks(mesh)
    if seq_dim is None or not split:
        seq_axes = ()
    elif seq_axes is None:
        seq_axes = held_sequence()
    else:
        seq_axes = tuple(a for a in mesh.axis_names if a in seq_axes
                         and mesh.shape[a] > 1)
    _, spec = hint_pspec(x.shape, axes, mesh.shape, split, model_dim,
                         seq_dim, seq_axes)
    check_data_parallel(spec, _batch_dim(axes), mesh.shape, split,
                        f"shard_hint{tuple(axes)} on {tuple(x.shape)}",
                        model_dim if split else None,
                        seq_dim if seq_axes else None, seq_axes)
    return x


def check_data_parallel(spec, batch_dim: int | None, mesh_shape: dict,
                        split: bool, what: str,
                        model_dim: int | None = None,
                        seq_dim: int | None = None,
                        seq_axes: tuple = ()) -> None:
    """Raise ``NotImplementedError`` unless ``spec`` places nothing over a
    mesh axis of more than one rank but dimension ``batch_dim`` over all
    of the pod and data axes that have more than one and do not cut the
    sequence (``split``: the ranks of a process mesh hold their rows of
    the batch), dimension ``model_dim``, where given, over ``model`` where
    it has more than one, and dimension ``seq_dim``, where given, over
    ``seq_axes`` (the block of a sequence a rank holds): the placements
    that data, tensor and sequence parallelism execute (ROADMAP Queue A
    item 3(c))."""
    held = tuple(a for a in BATCH if mesh_shape.get(a, 1) > 1
                 and a not in seq_axes) if split else ()
    model = (MODEL,) if mesh_shape.get(MODEL, 1) > 1 else ()
    seq = tuple(a for a in seq_axes if mesh_shape.get(a, 1) > 1)
    for d, entry in enumerate(spec):
        live = tuple(a for a in spec_axes(entry) if mesh_shape[a] > 1)
        want = ((held if d == batch_dim else ())
                + (model if d == model_dim else ())
                + (seq if d == seq_dim else ()))
        if live != want:
            raise NotImplementedError(
                f"{what} places dimension {d} over {live or 'no axis'} on "
                f"mesh {mesh_shape}: only the batch split over "
                f"{held or 'no axis'}, a block the code holds over "
                f"{model or 'no axis'} and a held sequence over "
                f"{seq or 'no axis'} execute here; {QUEUE_3C}")


# -- a leaf's placement, and cutting trees by it -----------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """One leaf's placement on a mesh, the reference's ``NamedSharding``:
    the mesh and the leaf's ``PartitionSpec``.  A dimension sharded over
    several axes is cut over them in mesh order, the first axis the
    outermost (the only order ``PartitionSpec`` tuples take here)."""

    mesh: object
    spec: PartitionSpec

    def __post_init__(self):
        names = list(self.mesh.axis_names)
        for entry in self.spec:
            axes = spec_axes(entry)
            if [names.index(a) for a in axes] != sorted(names.index(a)
                                                       for a in axes):
                raise ValueError(f"{self.spec}: axes {axes} out of the mesh's "
                                 f"order {tuple(names)}")

    def sharded_dim(self, axis: str) -> int | None:
        """The leaf dimension cut over mesh axis ``axis``, else None."""
        for d, entry in enumerate(self.spec):
            if axis in spec_axes(entry):
                return d
        return None

    @property
    def placements(self) -> tuple:
        """DTensor placements, one a mesh dimension: ``Shard(d)`` where the
        leaf's dimension ``d`` is cut over it, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        dims = [self.sharded_dim(a) for a in self.mesh.axis_names]
        return tuple(Replicate() if d is None else Shard(d) for d in dims)


def sharded_dim_over(sh: NamedSharding, axes) -> int | None:
    """The leaf dimension cut over one of the mesh axes ``axes`` that has
    more than one rank, else None."""
    for axis in axes:
        if sh.mesh.shape.get(axis, 1) > 1 and sh.sharded_dim(axis) is not None:
            return sh.sharded_dim(axis)
    return None


def _cuts(sh: NamedSharding, axes=None):
    """``(axis, dim, size, index)`` of each mesh axis of more than one rank
    (of ``axes`` where given) that cuts the leaf, in mesh order, with this
    rank's index on it."""
    mesh = sh.mesh
    out = []
    for axis, size in zip(mesh.axis_names, mesh.axis_sizes):
        d = sh.sharded_dim(axis)
        if d is None or size == 1 or (axes is not None and axis not in axes):
            continue
        if not _holds_ranks(mesh):
            raise ValueError(f"mesh {mesh.shape} holds no rank to cut a "
                             f"leaf for: use a process mesh")
        out.append((axis, d, size, mesh.coordinate[axis]))
    return out


def shard_tree(tree, shardings):
    """This rank's shard of every full leaf of ``tree``: each dimension
    cut over its mesh axes in mesh order (the even split a
    ``PartitionSpec`` resolves to), copied into a tensor of its own."""
    def cut(t, sh):
        for axis, d, size, i in _cuts(sh):
            if t.shape[d] % size:
                raise ValueError(f"dimension {d} of {tuple(t.shape)} does not "
                                 f"split over {axis} = {size}")
            n = t.shape[d] // size
            t = t.narrow(d, i * n, n)
        return t.clone()

    return tree_map(cut, tree, shardings)


def gather_shard(t, sh: NamedSharding, axes=None):
    """The full leaf of the shard ``t`` placed by ``sh``: all-gathered over
    each cutting axis, innermost first.  With ``axes`` only over those
    (FSDP's data axes), the cuts over the others kept."""
    for axis, d, _, _ in reversed(_cuts(sh, axes)):
        t = sh.mesh.all_gather(t, axis, dim=d)
    return t


def gather_tree(tree, shardings, axes=None):
    """The full leaves of a tree of shards (``shard_tree``'s inverse):
    ``gather_shard`` of each leaf."""
    return tree_map(lambda t, sh: gather_shard(t, sh, axes), tree, shardings)


@contextlib.contextmanager
def gather_layers(mesh, axes, dims: dict):
    """Inside the block (an FSDP train step) the model's layer stacks hold
    this rank's shards over the data ``axes`` of ``mesh``, and each layer
    gathers its own as it runs (``gather_layer``).  ``dims`` maps a stack's
    params key (``"dense_layers"``, ``"layers"``, ...) to a tree like one
    layer's weights: the dimension of the layer's leaf that ``axes`` cut,
    or None where the leaf is whole."""
    token = _LAYERS.set((mesh, tuple(axes), dims))
    try:
        yield
    finally:
        _LAYERS.reset(token)


def gather_layer(w, stack: str):
    """One layer's weights ``w`` of the stack ``params[stack]`` with each
    leaf that the data axes cut all-gathered over them; the cuts over
    ``model`` stay.  The layer's shards go as one flat buffer a dtype, so
    a layer costs one all-gather through the mesh's ``gather_to`` (and,
    backward, one reduce-scatter of the gradient back onto the shards), as
    FSDP's flat parameters do.  Outside ``gather_layers``, or for a stack
    it does not name, ``w`` itself."""
    import torch

    state = _LAYERS.get()
    dims = None if state is None else state[2].get(stack)
    if dims is None:
        return w
    mesh, axes, _ = state
    k = mesh.group_size(axes)
    out = dict(tree_items(w))
    groups: dict = {}
    for (path, t), (_, d) in zip(tree_items(w), tree_items(dims)):
        if d is not None:
            groups.setdefault(t.dtype, []).append((path, t, d))
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for _, t, _ in group])
        full = mesh.gather_to(flat, axes, 0).view(k, -1)
        off = 0
        for path, t, d in group:
            part = full[:, off:off + t.numel()].reshape((k,) + tuple(t.shape))
            shape = list(t.shape)
            shape[d] *= k
            out[path] = part.movedim(0, d).reshape(shape)
            off += t.numel()
    return tree_from_items(out.items())
