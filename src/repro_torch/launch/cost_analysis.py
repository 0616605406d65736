"""Op-level cost of one eager step: the counterpart of the reference's
``launch/hlo_analysis.py``.

The reference parses the compiled HLO of a step.  The port compiles
nothing between the step and the device, so its program is the sequence
of aten ops the step dispatches, and each op is a boundary where data
goes to HBM.  ``CostCounter`` runs a step under a ``TorchDispatchMode``
that sees each of them (the backward's too) and counts, as the reference
counts an HLO instruction:

  * ``dot_flops``: the products (mm, bmm, addmm, baddbmm, convolution,
    the attention ops) by ``torch.utils.flop_counter``'s formulas, but an
    ``mm``/``bmm`` over a contraction of one element, an outer product
    that XLA rewrites as a multiply, counted as elementwise;
  * ``flops``: those, plus one FLOP per result element of every other op
    that computes (``hlo_analysis.py``'s elementwise rule);
  * ``bytes``: each op's operands read once and its results written once.
    Views, ``detach`` and ``empty`` move nothing (the reference's
    ``_NO_TRAFFIC``); an in-place write (``copy_``, ``index_copy_``,
    ``index_put_``) costs twice its update, as a dynamic-update-slice;
  * the argument bytes: the step's inputs that an op reads (``jax.jit``
    drops an unused argument, so the reference's count has only those);
  * the live bytes of the storages the step makes, whose peak is the
    step's temporary memory: each storage is followed by a weak reference
    and leaves the count when it is freed;
  * the work of a hand-written kernel's launch where its wrapper stands
    in for it (``record_kernel``: K4 on meta operands), counted by kernel
    and added to the FLOPs and bytes;
  * the collectives of a ``ProcessMesh`` (its ``trace``): wire bytes per
    rank with the reference's ring factors (``wire_bytes``), by kind and
    by the mesh axes they span, and their operand and result bytes.

Every count is this rank's, as the reference's are per device.  On meta
tensors (``launch.dryrun``) nothing is allocated and nothing runs; on the
card the same counter reads a real step.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from ..kernels.native import cost_counter, record_kernel

__all__ = ["Cost", "CostCounter", "wire_bytes", "record_kernel",
           "tree_bytes"]

# the port's collective kinds (``ProcessMesh`` trace) by the reference's
# HLO opcode; the port's reduce-scatter is an all-reduce and a cut, so it
# is traced, and counted, as the all-reduce it issues
_KIND = {"all_gather": "all-gather", "all_reduce_sum": "all-reduce",
         "all_reduce_max": "all-reduce"}

_aten = torch.ops.aten
# ops that make no data movement: factories of uninitialised storage, and
# aliases (every view op is caught by ``is_view`` too)
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_like.default,
               _aten.empty_strided.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten.detach.default,
               _aten.alias.default, _aten.lift_fresh.default,
               _aten._unsafe_view.default}
# in-place writes of an update into (part of) a buffer: the argument that
# holds the update
_WRITES = {_aten.copy_.default: 1, _aten.index_copy_.default: 3,
           _aten.index_put_.default: 2}


@dataclasses.dataclass
class Cost:
    """The reference's ``Cost`` (``hlo_analysis.py:70-102``)."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    dot_flops: float = 0.0

    def __iadd__(self, other):
        self.flops += other.flops
        self.bytes += other.bytes
        self.collective_bytes += other.collective_bytes
        self.dot_flops += other.dot_flops
        for k, v in other.collectives.items():
            self.collectives[k] += v
        return self

    def scaled(self, f: float) -> "Cost":
        c = Cost(self.flops * f, self.bytes * f, self.collective_bytes * f,
                 dot_flops=self.dot_flops * f)
        c.collectives = defaultdict(
            float, {k: v * f for k, v in self.collectives.items()})
        return c

    def as_dict(self):
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.collective_bytes,
                "dot_flops": self.dot_flops,
                "collectives": dict(self.collectives)}


def wire_bytes(kind: str, in_bytes: float, out_bytes: float, group: int) -> float:
    """Bytes one rank puts on the wire for a collective over ``group``
    ranks, with the reference's ring factors (``hlo_analysis.py:15-20``):
    all-reduce ``2 * in * (g-1)/g``, all-gather ``out * (g-1)/g``,
    reduce-scatter and all-to-all ``in * (g-1)/g``, collective-permute
    ``in``.  ``kind`` is the reference's opcode name."""
    factor = (group - 1) / group if group > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * in_bytes * factor
    if kind == "all-gather":
        return out_bytes * factor
    if kind in ("reduce-scatter", "all-to-all"):
        return in_bytes * factor
    if kind == "collective-permute":
        return float(in_bytes)
    raise ValueError(f"unknown collective {kind!r}")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def _operands(args, kwargs) -> list:
    """The tensors among an op's arguments (nested one list deep, as
    aten's ``Tensor[]`` arguments are)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _signature(x):
    """A hashable stand-in for an op argument that fixes what a meta
    kernel computes from it; raises ``TypeError`` for anything else (a
    tensor off the meta device, whose values count)."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise TypeError("not a meta tensor")
        return (x.shape, x.stride(), x.storage_offset(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(map(_signature, x))
    hash(x)
    return x


def tree_bytes(tree) -> int:
    """The bytes of the distinct storages that the tensors of ``tree`` (any
    nesting of dicts, lists and tuples) lie in: what they hold on the
    device."""
    seen: dict = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _outer(packet, args) -> bool:
    """Whether ``mm``/``bmm`` contract over one element: an outer product,
    which XLA's algebraic simplifier turns into a multiply, an elementwise
    op to ``hlo_analysis.py`` (a product's backward where its result has a
    dimension of one, as a 3-operand ``einsum``'s per-element contraction
    has)."""
    return (packet in (_aten.mm, _aten.bmm)
            and args[0].shape[-1] == 1)


_OP_INFO: dict = {}


def _op_info(func) -> tuple[bool, bool, bool]:
    """``(passed, fresh, pure)`` of an op: run and not counted here (a c10d
    collective, which the mesh's trace carries, or an alias of an operand,
    which moves and makes nothing); its results new storages (no alias in
    its schema's returns); fresh and mutating no argument."""
    fresh = not any(r.alias_info is not None for r in func._schema.returns)
    passed = func.namespace in ("c10d", "_c10d_functional") or (
        not fresh and (func.is_view or func in _NO_TRAFFIC))
    return passed, fresh, fresh and not func._schema.is_mutable


class _Mode(TorchDispatchMode):
    def __init__(self, counter: "CostCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.counter._dispatch(func, args, kwargs or {})


class CostCounter:
    """``with CostCounter(arguments, mesh) as c: out = step(*arguments)``
    counts what the step costs this rank (the module's docstring): ``c.cost``
    (a ``Cost``), ``c.kernels`` (launches, FLOPs and bytes by kernel),
    ``c.by_axis`` (collective calls, wire and operand bytes by the mesh
    axes they span) and, with ``c.memory(out)``, the reference's three
    memory sizes.  ``arguments`` is the step's inputs (any tree of
    tensors): the storages of them that its ops read are its argument
    bytes, and none is counted as made by the step; ``read`` names inputs
    to count as read (a position the step takes as a host int).  ``mesh``
    is the ``ProcessMesh`` whose collectives are read from its ``trace``
    (set for the block, restored after)."""

    def __init__(self, arguments=(), mesh=None, read=(), by_op=False):
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.mesh = mesh
        self.cost = Cost()
        self.kernels: dict = {}
        self.by_axis: dict = {}
        self._arguments = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                           for t in _tensors(arguments)}
        self._read = {t.untyped_storage()._cdata for t in _tensors(read)}
        self._live: dict = {}  # storage id -> (bytes, weak reference)
        self.live_bytes = 0
        self.peak_bytes = 0
        # with ``by_op``: at the peak, the live bytes by the op that made
        # each storage (``peak_by_op``, the breakdown of the temporaries)
        self._by_op = by_op
        self.peak_by_op: dict = {}
        # meta ops by signature: their results' (shape, stride, dtype) and
        # cost.  Torch computes many meta kernels in Python; a layer stack
        # repeats the same signatures, so each is computed once
        self._memo: dict = {}

    def __enter__(self):
        if self.mesh is not None:
            self._saved_trace, self.mesh.trace = self.mesh.trace, []
        self._token = cost_counter.set(self)
        self._mode = _Mode(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        cost_counter.reset(self._token)
        if self.mesh is not None:
            trace, self.mesh.trace = self.mesh.trace, self._saved_trace
            for entry in trace:
                self._collective(entry)
        return False

    # -- counting ----------------------------------------------------------

    @property
    def argument_bytes(self) -> int:
        """The bytes of the argument storages that an op of the step read
        (or the caller named in ``read``): an argument the step never reads
        is none of the program's, as ``jax.jit`` drops an unused argument
        from the executable the reference measures."""
        return sum(n for key, n in self._arguments.items() if key in self._read)

    def _dispatch(self, func, args, kwargs):
        info = _OP_INFO.get(func)
        if info is None:
            info = _OP_INFO[func] = _op_info(func)
        passed, fresh, pure = info
        if not (func.is_view or func in _NO_TRAFFIC):
            self._read.update(t.untyped_storage()._cdata
                              for t in _operands(args, kwargs))
        if passed:
            return func(*args, **kwargs)
        key = None
        if pure:
            try:
                key = (func, _signature(args),
                       _signature(tuple(kwargs.items())) if kwargs else ())
            except TypeError:
                key = None
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            kind, metas, cost = hit
            out = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                   for shape, stride, dtype in metas]
            out = out[0] if kind is torch.Tensor else kind(out)
        else:
            out = func(*args, **kwargs)
            cost = self._cost(func, args, kwargs, out)
            results = out if isinstance(out, (list, tuple)) else (out,)
            # a result in an operand's storage (``_unsafe_view``) is no new
            # storage: never rebuilt as one
            inputs = {t.untyped_storage()._cdata for t in _operands(args, kwargs)}
            if key is not None and all(
                    isinstance(t, torch.Tensor) and t.is_meta
                    and t.storage_offset() == 0
                    and t.untyped_storage()._cdata not in inputs
                    for t in results):
                self._memo[key] = (type(out), [(tuple(t.shape), t.stride(),
                                                t.dtype) for t in results], cost)
        flops, dot, nbytes = cost
        c = self.cost
        c.flops += flops
        c.dot_flops += dot
        c.bytes += nbytes
        if fresh:
            for t in _operands((out,), {}):
                self._made(t, func)
        return out

    def _cost(self, func, args, kwargs, out) -> tuple:
        """``(flops, dot_flops, bytes)`` of one op."""
        if func in _NO_TRAFFIC or func.is_view:
            return 0.0, 0.0, 0
        results = _operands((out,), {})
        if func in _WRITES:
            return 0.0, 0.0, 2 * _nbytes(args[_WRITES[func]])
        nbytes = sum(map(_nbytes, _operands(args, kwargs))) \
            + sum(map(_nbytes, results))
        packet = func.overloadpacket
        if packet in self._formulas and not _outer(packet, args):
            f = float(self._formulas[packet](*args, **kwargs, out_val=out))
            return f, f, nbytes
        return float(results[0].numel() if results else 0), 0.0, nbytes

    def _made(self, t: torch.Tensor, func=None) -> None:
        """Follow a storage the step made (by op ``func``) until it is
        freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._arguments:
            return
        n = st.nbytes()

        def freed(_, key=key):
            self.live_bytes -= self._live.pop(key)[0]

        self._live[key] = (n, weakref.ref(st, freed), func)
        self.live_bytes += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            if self._by_op:
                by: dict = defaultdict(int)
                for nb, _, f in self._live.values():
                    by[str(f)] += nb
                self.peak_by_op = dict(by)

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        """One launch of kernel ``name`` (``kernels.native.record_kernel``)."""
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.cost.flops += flops
        self.cost.dot_flops += flops
        self.cost.bytes += nbytes

    def _collective(self, entry) -> None:
        kind = _KIND[entry.kind]
        out = entry.nbytes * (entry.group if kind == "all-gather" else 1)
        wire = wire_bytes(kind, entry.nbytes, out, entry.group)
        self.cost.collective_bytes += wire
        self.cost.collectives[kind] += wire
        self.cost.bytes += entry.nbytes + out
        ax = self.by_axis.setdefault(entry.axes, {"calls": 0, "wire_bytes": 0.0,
                                                  "bytes": 0})
        ax["calls"] += 1
        ax["wire_bytes"] += wire
        ax["bytes"] += entry.nbytes

    def memory(self, outputs) -> dict:
        """The reference's ``memory_analysis`` sizes for this rank: the
        arguments' bytes, the outputs' (their distinct storages, arguments
        written in place included, as a donated buffer is) and the peak of
        the storages the step made, live at once."""
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": tree_bytes(outputs),
                "temp_size_in_bytes": self.peak_bytes}
