"""Compiled programs: CUDA-graph capture and replay, the port's counterpart
of the reference's ``jax.jit`` executables.

A ``GraphSet`` belongs to one *owner* — one device-pool worker, or the
master — and holds that owner's captured programs.  A program is captured
once per (program, argument signature, slot) and replayed after that:

* **Capture.** One warm-up call (the kernels' build and load, ``ctypes``
  lookups, allocator warm-up), then the call again under
  ``graph.capture_begin(pool=..., capture_error_mode="thread_local")`` on
  a capture stream of the capturing thread's own, which waits on the
  caller's stream.  Thread-local mode matters: the device pool's timer
  thread launches delayed dispatches (and allocates) while the master
  captures, which the default global mode forbids.  The capture stream
  is made by libcuda's ``cuStreamCreate``, never drawn from PyTorch's
  stream pool: two ``torch.cuda.Stream()`` objects may share one CUDA
  stream there, and a capture on a shared stream would take in another
  thread's launches.  It is destroyed when its thread exits.  A capture that fails raises ``GraphCaptureError``;
  nothing gives way to eager execution.
* **State a program advances.** The warm-up runs the program for real,
  and so does a capture under a graph class that executes what it
  records (the CPU tests' emulator).  A program that writes a resident
  argument in place and reads it again (a recurrent state, AdamW's
  params, moments and step count) names it in ``writes``: the capture
  clones those arguments first and copies the clones back after the
  warm-up and after the capture, so the first call, the replay that
  follows the capture, advances them exactly once.  A write that is the
  same every time (a KV write at a fixed position) needs no entry.
* **Arguments.** Each tensor argument is either *copied* into a static
  buffer before every replay, or *resident* (the program's ``resident``
  indices): used in place, never copied, and held by the graph.  A
  resident argument that is another storage than the one captured under
  the same key raises ``ResidentMoved`` — a replay never reads a stale
  address.  ``slot`` names which resident a call means (a layer, a round),
  so one program serves several residents with one graph each.
* **Outputs** are cloned out of the graph's memory on the replaying
  stream right after the replay: the next replay of the same graph
  overwrites its outputs, and a delayed straggler, a second round in
  flight or a transition shared between layers may still read the last
  ones.  An output that *is* an argument (the attention glue returns the
  KV cache it wrote in place) is returned as the caller's tensor.
* **Memory.** The graphs of one owner share one memory pool; the owner's
  calls run in stream order (a call on another stream than the last one
  waits on it first), so graphs of one pool never overlap.
* **Counts.** Captures, replays and capture seconds per program name; the
  kernel launches each graph holds (a wrapper called during a capture
  records into the graph, ``kernels.native.held_launches``), which every
  replay adds to the kernels' launch counters.

``graph_cls`` defaults to ``torch.cuda.CUDAGraph``; any class with
``capture_begin(pool=, capture_error_mode=)``, ``capture_end()`` and
``replay()`` (and optionally a ``pool_handle()`` static method) will do.
The runtime picks ``torch.cuda.CUDAGraph`` on a CUDA device and runs
eagerly on the CPU (``graph_class``); only an explicit class, as the CPU
tests pass, captures elsewhere.
"""
from __future__ import annotations

import contextlib
import ctypes
import sys
import threading
import time
import warnings

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..kernels.native import held_launches

__all__ = ["GraphCaptureError", "GraphSet", "ResidentMoved", "capture_stream",
           "graph_class", "live_capture_streams", "merge_stats",
           "owner_graphs", "signature"]


class GraphCaptureError(RuntimeError):
    """A program could not be captured into a graph."""


class ResidentMoved(ValueError):
    """A resident argument is another storage than the one captured."""


def graph_class(graphs, device) -> type | None:
    """The graph class a ``graphs`` switch selects on ``device``: ``True``
    gives ``torch.cuda.CUDAGraph`` on a CUDA device and None (eager) on the
    CPU, where the caller asked for the plain path; ``False`` gives None;
    a class gives that class on any device."""
    if graphs is True:
        return (torch.cuda.CUDAGraph if torch.device(device).type == "cuda"
                else None)
    if graphs is False:
        return None
    if not isinstance(graphs, type):
        raise TypeError(f"graphs must be True, False or a graph class, "
                        f"got {graphs!r}")
    return graphs


_libcuda_lock = threading.Lock()
_libcuda: ctypes.CDLL | None = None  # guarded-by: _libcuda_lock
_streams_live = 0  # capture streams made and not yet destroyed  # guarded-by: _libcuda_lock


class _ThreadStreams:
    """One thread's capture streams by device index.  The thread's local
    data drops it when the thread exits, and its streams are destroyed
    then: a pool's timer thread or a server's engine thread leaves no
    CUDA stream behind."""

    def __init__(self):
        self.by_device: dict = {}

    def __del__(self):
        global _streams_live
        if sys.is_finalizing():
            return
        for index, s in self.by_device.items():
            with contextlib.suppress(Exception), torch.cuda.device(index):
                if _libcuda.cuStreamDestroy_v2(ctypes.c_void_p(s.cuda_stream)) == 0:
                    with _libcuda_lock:
                        _streams_live -= 1


_capture_streams = threading.local()  # per thread: its _ThreadStreams


def live_capture_streams() -> int:
    """Capture streams made by ``capture_stream`` and not yet destroyed."""
    with _libcuda_lock:
        return _streams_live


def capture_stream(device) -> torch.cuda.ExternalStream:
    """The calling thread's capture stream on ``device``: a non-blocking
    stream made once by libcuda's ``cuStreamCreate``, used by nothing but
    this thread's captures, and destroyed when the thread exits.  A stream
    from PyTorch's pool could be another stream object's CUDA stream
    too."""
    global _libcuda, _streams_live
    device = torch.device("cuda", device) if isinstance(device, int) \
        else torch.device(device)
    holder = getattr(_capture_streams, "streams", None)
    if holder is None:
        holder = _capture_streams.streams = _ThreadStreams()
    s = holder.by_device.get(device.index)
    if s is None:
        with _libcuda_lock:
            if _libcuda is None:
                _libcuda = ctypes.CDLL("libcuda.so.1")
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            torch.cuda.current_stream(device).query()  # context current here
            rc = _libcuda.cuStreamCreate(ctypes.byref(handle),
                                        ctypes.c_uint(1))  # NON_BLOCKING
        if rc != 0:
            raise GraphCaptureError(f"cuStreamCreate failed: CUresult {rc}")
        with _libcuda_lock:
            _streams_live += 1
        s = holder.by_device[device.index] = torch.cuda.ExternalStream(
            handle.value, device=device)
    return s


def owner_graphs(sets: dict, graphs, device, owner: str = "master"):
    """The graph set a ``graphs`` switch selects for ``owner`` (None:
    eager), kept in ``sets`` by graph class so that switching back finds
    the graphs already captured."""
    cls = graph_class(graphs, device)
    if cls is None:
        return None
    gs = sets.get(cls)
    if gs is None:
        gs = sets[cls] = GraphSet(owner, device, cls)
    return gs


def signature(args) -> tuple:
    """What a program specialises on: its tensor arguments' shapes and
    dtypes."""
    return tuple((tuple(a.shape), str(a.dtype)) for a in args
                 if isinstance(a, torch.Tensor))


class _Captured:
    """One captured program: the graph, its static arguments, the
    residents it was captured with, and its output leaves."""

    __slots__ = ("graph", "copied", "resident", "outs", "from_arg", "spec",
                 "held")

    def __init__(self, graph, copied, resident, outs, from_arg, spec, held):
        self.graph = graph
        self.copied = copied  # [(argument index, static buffer)]
        self.resident = resident  # {index: (tensor, data_ptr, stride)}
        self.outs = outs
        self.from_arg = from_arg  # per output leaf: argument index or None
        self.spec = spec
        self.held = held  # {LaunchCounter: launches the graph holds}


class GraphSet:
    """The captured programs of one owner on one device (see the module
    docstring).  ``run(program, args, slot)`` captures on first sight of
    (program, signature, slot) and replays after that; ``program`` needs
    ``fn``, ``name``, ``resident`` and ``writes``."""

    def __init__(self, owner: str, device, graph_cls=torch.cuda.CUDAGraph):
        self.owner = owner
        self.device = torch.device(device)
        self.graph_cls = graph_cls
        self._cuda = self.device.type == "cuda"
        # "cuda" without an index means the device current at first use
        self._index = self.device.index
        # one owner's calls run one at a time (master thread, or a worker's
        # dispatching thread and the pool's timer thread)
        self._lock = threading.RLock()
        self._graphs: dict[tuple, _Captured] = {}  # guarded-by: self._lock
        self._pool = None  # guarded-by: self._lock
        self._stream = None  # guarded-by: self._lock
        self._raw = None  # the last stream's raw handle  # guarded-by: self._lock
        self.captures: dict[str, int] = {}  # guarded-by: self._lock
        self.replays: dict[str, int] = {}  # guarded-by: self._lock
        self.held: dict[str, dict] = {}  # guarded-by: self._lock
        self.capture_s = 0.0  # guarded-by: self._lock
        self.static_bytes = 0  # guarded-by: self._lock
        self._by_program: dict = {}  # guarded-by: self._lock

    # -- introspection -----------------------------------------------------
    @property
    def num_graphs(self) -> int:
        return len(self._graphs)

    def captures_of(self, program) -> int:
        return self._by_program.get(program, 0)

    def pool_bytes(self, snapshot=None) -> int | None:
        """Bytes the card reserved for this owner's graph pool (None where
        the allocator's snapshot does not name pools)."""
        if not self._cuda or self._pool is None:
            return 0
        segs = torch.cuda.memory_snapshot() if snapshot is None else snapshot
        named = [s for s in segs if "segment_pool_id" in s]
        if not named:
            return None
        pool = tuple(self._pool)
        return sum(int(s["total_size"]) for s in named
                   if tuple(s["segment_pool_id"]) == pool)

    def stats(self, snapshot=None) -> dict:
        with self._lock:
            return {"owner": self.owner, "graphs": len(self._graphs),
                    "captures": dict(self.captures),
                    "replays": dict(self.replays),
                    "held": {k: dict(v) for k, v in self.held.items()},
                    "capture_s": self.capture_s,
                    "static_bytes": self.static_bytes,
                    "pool_bytes": self.pool_bytes(snapshot)}

    def clear(self) -> None:
        """Drop every graph (their memory returns when nothing else holds
        it); later calls capture again."""
        with self._lock:
            self._graphs.clear()
            self._by_program.clear()

    def drop(self, slot_prefix: str) -> int:
        """Drop the graphs whose slot is a name starting with
        ``slot_prefix`` (a model's layers, when it is unloaded or
        replaced), and with them the residents they hold; returns how
        many went."""
        with self._lock:
            stale = [k for k in self._graphs
                     if isinstance(k[2], str) and k[2].startswith(slot_prefix)]
            for key in stale:
                del self._graphs[key]
                self._by_program[key[0]] -= 1
            return len(stale)

    # -- capture and replay ------------------------------------------------
    def _device_ctx(self):
        if self._cuda and torch.cuda.current_device() != self._index:
            return torch.cuda.device(self._index)
        return contextlib.nullcontext()

    def run(self, program, args: tuple, slot=None, sig=None):
        """``program.fn(*args)`` as a replay of its graph under ``slot``
        (captured now on first sight); outputs are fresh tensors.  ``sig``:
        the arguments' ``signature``, where the caller has it."""
        key = (program, signature(args) if sig is None else sig, slot)
        if self._cuda and self._index is None:
            self._index = torch.cuda.current_device()
        with self._lock, self._device_ctx():
            cur = None
            if self._cuda:
                # the raw handle is cheap; the stream object is made only
                # where it is needed: a stream switch, or a capture
                raw = torch._C._cuda_getCurrentRawStream(self._index)
                if raw != self._raw:
                    cur = torch.cuda.current_stream(self._index)
                    if self._stream is not None:
                        cur.wait_stream(self._stream)  # this owner runs in order
                    self._stream, self._raw = cur, raw
            g = self._graphs.get(key)
            if g is None:
                if self._cuda and cur is None:
                    cur = torch.cuda.current_stream(self._index)
                g = self._graphs[key] = self._capture(program, args, cur, slot)
            else:
                for j, (_, ptr, stride) in g.resident.items():
                    a = args[j]
                    if a.data_ptr() != ptr or a.stride() != stride:
                        raise ResidentMoved(
                            f"{program.name} on {self.owner} (slot {slot!r}): "
                            f"resident argument {j} is another storage than "
                            f"the one captured; a replay would read a stale "
                            f"address")
            for j, static in g.copied:
                static.copy_(args[j])
            g.graph.replay()
            name = program.name
            self.replays[name] = self.replays.get(name, 0) + 1
            for counter, k in g.held.items():
                counter.add(k)
            if g.spec is None:  # one tensor out, not an argument
                return g.outs[0].clone()
            leaves = [args[src] if src is not None
                      else (t.clone() if isinstance(t, torch.Tensor) else t)
                      for t, src in zip(g.outs, g.from_arg)]
            return tree_unflatten(leaves, g.spec)

    def _capture(self, program, args, cur, slot) -> _Captured:
        t0 = time.perf_counter()
        resident = set(program.resident)
        static, copied, held_res = [], [], {}
        for j, a in enumerate(args):
            if not isinstance(a, torch.Tensor):
                static.append(a)
            elif j in resident:
                static.append(a)
                held_res[j] = (a, a.data_ptr(), a.stride())
            else:
                s = torch.empty(a.shape, dtype=a.dtype, device=a.device)
                s.copy_(a)
                static.append(s)
                copied.append((j, s))
                self.static_bytes += s.numel() * s.element_size()
        gcls = self.graph_cls
        if self._pool is None:
            self._pool = getattr(gcls, "pool_handle",
                                 torch.cuda.graph_pool_handle)()
        side = capture_stream(self._index) if self._cuda else None
        if side is not None:
            side.wait_stream(cur)
            ctx = torch.cuda.stream(side)
        else:
            ctx = contextlib.nullcontext()
        where = f"{program.name} on {self.owner} (slot {slot!r})"
        written = [static[j] for j in program.writes]
        with ctx:
            saved = [t.clone() for t in written]

            def restore():
                for t, s in zip(written, saved):
                    t.copy_(s)

            program.fn(*static)  # warm-up: build, load, allocate
            restore()
            graph = gcls()
            try:
                with held_launches() as held:
                    try:
                        graph.capture_begin(pool=self._pool,
                                            capture_error_mode="thread_local")
                    except Exception as err:
                        raise GraphCaptureError(f"capture of {where} could not "
                                                f"begin: {err}") from err
                    try:
                        out = program.fn(*static)
                    except BaseException as err:
                        with contextlib.suppress(Exception):
                            graph.capture_end()
                        raise GraphCaptureError(
                            f"capture of {where} failed: {type(err).__name__}: "
                            f"{err}") from err
                    with warnings.catch_warnings():
                        # a program of views captures no kernel
                        warnings.filterwarnings(
                            "ignore", message="The CUDA Graph is empty")
                        try:
                            graph.capture_end()
                        except Exception as err:
                            raise GraphCaptureError(
                                f"capture of {where} failed at its end: "
                                f"{err}") from err
            finally:  # also where the capture failed: the call did not run
                restore()
                del saved
        if side is not None:
            cur.wait_stream(side)
        leaves, spec = tree_flatten(out)
        from_arg = [next((j for j, s in enumerate(static)
                          if isinstance(t, torch.Tensor) and t is s), None)
                    for t in leaves]
        if isinstance(out, torch.Tensor) and from_arg == [None]:
            spec = None  # the common case, replayed without the tree
        name = program.name
        self.captures[name] = self.captures.get(name, 0) + 1
        self._by_program[program] = self._by_program.get(program, 0) + 1
        tally = self.held.setdefault(name, {})
        for counter, k in held.items():
            tally[counter.name] = tally.get(counter.name, 0) + k
        self.capture_s += time.perf_counter() - t0
        return _Captured(graph, copied, held_res, leaves, from_arg, spec,
                         dict(held))


def merge_stats(sets) -> dict:
    """Totals over several owners' graph sets: graphs, captures and replays
    by program name, launches replayed by kernel, capture seconds, static
    and pool bytes (one allocator snapshot for all)."""
    sets = [s for s in sets if s is not None]
    snapshot = None
    if any(s._cuda and s._pool is not None for s in sets):
        snapshot = torch.cuda.memory_snapshot()
    out = {"owners": len(sets), "graphs": 0, "captures": {}, "replays": {},
           "capture_s": 0.0, "static_bytes": 0, "pool_bytes": 0}
    for s in sets:
        st = s.stats(snapshot)
        out["graphs"] += st["graphs"]
        for k in ("captures", "replays"):
            for name, v in st[k].items():
                out[k][name] = out[k].get(name, 0) + v
        out["capture_s"] += st["capture_s"]
        out["static_bytes"] += st["static_bytes"]
        if st["pool_bytes"] is None or out["pool_bytes"] is None:
            out["pool_bytes"] = None
        else:
            out["pool_bytes"] += st["pool_bytes"]
    return out
