"""Dispatch-level introspection for the contract analyzer: the port's
counterpart of the reference's ``jaxpr_tools``.

The reference traces a program to a jaxpr without running it.  Torch has
no trace of an eager program, so ``record`` runs a program cell's ``fn``
once, on arguments ``materialize`` builds on a device, under ``Recorder``,
a ``TorchDispatchMode`` that sees every aten op the call dispatches, and
keeps:

- each op, with the dtypes and devices of its outputs;
- every tensor operand that is neither an argument of the call nor made
  inside it: a constant the program holds (what a jaxpr bakes);
- every host sync it can see: ``aten._local_scalar_dense`` (``.item()``,
  ``bool(t)``) and ops whose output shape depends on the data
  (``nonzero``, boolean-mask indexing, ``unique``, ...);
- every copy off the cell's device (an op that reads a tensor on the
  cell's device and writes one elsewhere) and every copy of a host tensor
  onto the cell's CUDA device — both block the host, and neither can be
  captured into a CUDA graph.

It cannot see inside a K1-K4 launch: those are ``ctypes`` calls into the
kernel library, not aten ops (the buffers their wrappers allocate are
seen).  That is what the capture half of ``contracts`` checks on the card.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["OpRecord", "Recording", "Recorder", "record", "materialize",
           "survivors", "on_device", "SYNC_OPS"]

_aten = torch.ops.aten

# ops that read a device value back to the host, or whose output shape the
# host can only learn by waiting for the data
SYNC_OPS = {
    _aten._local_scalar_dense, _aten.nonzero, _aten.masked_select,
    _aten.unique_consecutive, _aten._unique, _aten._unique2, _aten.unique_dim,
    _aten.equal, _aten.is_nonzero, _aten.bincount,
}
# indexing ops that turn a boolean mask into indices (a hidden nonzero)
_MASK_INDEX_OPS = {_aten.index, _aten.index_put, _aten.index_put_,
                   _aten._index_put_impl_}
_COPY_OPS = {_aten._to_copy, _aten.copy_, _aten._copy_from,
             _aten._copy_from_and_resize}


@dataclasses.dataclass(frozen=True)
class OpRecord:
    name: str  # e.g. "aten.mm.default"
    out_dtypes: tuple  # torch.dtype per output tensor
    out_devices: tuple  # torch.device per output tensor


@dataclasses.dataclass
class Recording:
    """What one recorded call dispatched (see the module docstring)."""

    ops: list = dataclasses.field(default_factory=list)
    consts: list = dataclasses.field(default_factory=list)
    syncs: list = dataclasses.field(default_factory=list)
    outputs: list = dataclasses.field(default_factory=list)

    def op_names(self) -> set[str]:
        return {op.name for op in self.ops}


def on_device(dev: torch.device, device: torch.device) -> bool:
    """Is ``dev`` the cell's ``device`` (``cuda`` matches any index)?"""
    if dev.type != device.type:
        return False
    return device.index is None or dev.index == device.index


class Recorder(TorchDispatchMode):
    """Records the aten ops of a call whose arguments are ``args``, run for
    a cell on ``device``.  Tensors are told apart by identity (a weak
    reference guards against a reused ``id``)."""

    def __init__(self, args, device: torch.device):
        super().__init__()
        self.device = torch.device(device)
        self.rec = Recording()
        self._known: dict[int, weakref.ref] = {}
        self._const_ids: set[int] = set()
        for a in tree_leaves(args):
            if isinstance(a, torch.Tensor):
                self._know(a)

    def _know(self, t: torch.Tensor) -> None:
        self._known[id(t)] = weakref.ref(t)

    def _is_known(self, t: torch.Tensor) -> bool:
        ref = self._known.get(id(t))
        return ref is not None and ref() is t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        for t in ins:
            if not self._is_known(t) and id(t) not in self._const_ids:
                self._const_ids.add(id(t))
                self.rec.consts.append(t)
        packet = func.overloadpacket
        if packet in SYNC_OPS:
            self.rec.syncs.append(f"{func} reads a value back to the host")
        elif packet in _MASK_INDEX_OPS and any(
                t.dtype in (torch.bool, torch.uint8) for t in ins[1:]):
            self.rec.syncs.append(f"{func} with a boolean mask (its output "
                                  f"shape depends on the data)")
        elif packet is _aten.repeat_interleave and kwargs.get(
                "output_size") is None and func.name().endswith("Tensor"):
            self.rec.syncs.append(f"{func} without output_size")
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._know(t)
        dev = self.device
        if (any(on_device(t.device, dev) for t in ins)
                and any(not on_device(t.device, dev) for t in outs)):
            self.rec.syncs.append(f"{func} copies off {dev} to "
                                  f"{sorted({str(t.device) for t in outs})}")
        if (dev.type == "cuda" and packet in _COPY_OPS
                and any(t.device.type == "cpu" for t in ins)
                and any(on_device(t.device, dev) for t in outs)):
            self.rec.syncs.append(f"{func} copies a host tensor onto {dev}")
        self.rec.ops.append(OpRecord(str(func), tuple(t.dtype for t in outs),
                                     tuple(t.device for t in outs)))
        return out


def record(fn, args, device) -> Recording:
    """Run ``fn(*args)`` once under a ``Recorder``; the recording's
    ``outputs`` are the result's tensors."""
    with Recorder(args, device) as mode:
        # a pipeline ``Program`` is recorded op by op, never replayed
        result = getattr(fn, "eager", fn)(*args)
    mode.rec.outputs = [t for t in tree_leaves(result)
                        if isinstance(t, torch.Tensor)]
    return mode.rec


def survivors(pipe, layer: int, variant: int = 0) -> tuple[int, ...]:
    """A survivor subset of ``layer``: the first delta workers (variant 0)
    or the last delta (variant 1, another subset wherever delta < n)."""
    if variant == 0:
        return pipe.layer_worker_ids(layer)
    delta = pipe.layer_delta(layer)
    return tuple(range(pipe.n - delta, pipe.n))


def materialize(pipe, cell, device, generator: torch.Generator,
                variant: int = 0) -> tuple:
    """The cell's arguments as tensors on ``device`` (on the host where the
    spec says so), drawn from ``generator``: normal values for ``data``,
    integers below ``high`` for ``index``, and the pipeline's own code
    operands for a survivor subset (``variant``, see ``survivors``) for
    ``decode`` / ``encode`` / ``encode_all``."""
    device = torch.device(device)
    gen_dev = generator.device
    out = []
    for a in cell.args:
        dev = torch.device("cpu") if a.host else device
        if a.role == "data":
            t = torch.randn(a.shape, generator=generator, device=gen_dev,
                            dtype=a.dtype)
        elif a.role == "index":
            t = torch.randint(0, a.high, a.shape, generator=generator,
                              device=gen_dev, dtype=a.dtype)
        elif a.role == "decode":
            t = pipe.decode_operand(a.layer, survivors(pipe, a.layer, variant))
        elif a.role == "encode":
            t = pipe.encode_operand(a.layer, survivors(pipe, a.layer, variant))
        elif a.role == "encode_all":
            t = pipe.encode_columns_all(a.layer)
        else:
            raise ValueError(f"unknown argument role {a.role!r}")
        t = t.to(dev, a.dtype)
        if tuple(t.shape) != tuple(a.shape):
            raise ValueError(f"{cell.cell_id}: materialised {tuple(t.shape)}, "
                             f"spec {tuple(a.shape)}")
        out.append(t)
    return tuple(out)
