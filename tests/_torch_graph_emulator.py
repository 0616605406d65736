"""A CUDA graph's semantics on the CPU, for the tests of the port's
compiled programs (``tests/test_torch_graphs.py``,
``tests/test_torch_compiled.py``).

The CPU has no CUDA graphs, so these tests pass ``EmulatedGraph``: between
``capture_begin`` and ``capture_end`` it records every op the captured
function runs (a dispatch mode, thread-local like a ``thread_local``
capture), with the very tensors it ran on; ``replay`` runs those ops again
on the same static inputs and copies each result into the same output
tensor the capture made.  So it has a graph's aliasing semantics: a
replay reads whatever the static and resident tensors hold now and
overwrites the outputs of the last replay; and, like a capture, it raises
on a host sync.  Unlike a CUDA capture, which records kernels without
running them, the recording runs the ops: a capture that writes state in
place advances it.  The runtime never picks it: ``graphs=True`` runs
eagerly on the CPU.
"""
import itertools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _Record(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("host sync inside a graph capture")
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, tree_leaves(out)))
        return out


class EmulatedGraph:
    """A CUDA graph's semantics on the CPU (see the module docstring)."""

    _pools = itertools.count()

    @staticmethod
    def pool_handle():
        return ("emulated", next(EmulatedGraph._pools))

    def __init__(self):
        self.ops = []
        self._mode = None

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        self._mode = _Record(self.ops)
        self._mode.__enter__()

    def capture_end(self):
        self._mode.__exit__(None, None, None)
        self._mode = None

    def replay(self):
        # the recorded ops of a train step include its backward: replay
        # them as the kernels they are, outside autograd
        with torch.no_grad():
            for func, args, kwargs, outs in self.ops:
                res = tree_leaves(func(*args, **kwargs))
                for o, r in zip(outs, res):
                    if isinstance(o, torch.Tensor) and \
                            o.untyped_storage().data_ptr() != \
                            r.untyped_storage().data_ptr():
                        o.copy_(r)
