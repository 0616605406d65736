"""Worker pools behind ``FcdccCluster``'s submit/collect seam.

Two interchangeable executors for the n coded subtasks of one master/worker
round:

  * ``ThreadWorkerPool`` (``pool="threads"``): one persistent single-thread
    executor per worker, stragglers injected as ``sleep()``s after the
    compute, and the simulated clock for ``mode="simulated"``.  On a CUDA
    device each worker thread owns one ``torch.cuda.Stream`` created with
    the pool: the master records an event on its own stream at submit, the
    worker's stream waits on it, the subtask launches under
    ``torch.cuda.stream(s)``, and the worker synchronises its stream before
    it stamps ``worker_times`` — so a finished future always holds a
    finished output.
  * ``DeviceWorkerPool`` (``pool="device"``): each worker pinned to a device
    (``devices.worker_devices``: every visible card, round-robin when there
    are fewer cards than workers) with one stream of its own there.
    ``submit`` dispatches from the master thread with no thread hop: each
    live worker's stream waits on the master's ready event, runs the
    subtask and records a completion event.  ``collect`` reaps the fastest
    delta by ``torch.cuda.Event.query()``, spinning briefly before it backs
    off into sleeps (``_POLL_MIN`` up to ``_POLL_MAX``; a fixed
    ``poll_interval_s`` when given).  Injected straggler delays are delayed
    dispatch (a simulated network or queueing delay ahead of the subtask)
    by one timer thread a pool, which holds the due dispatches in time
    order: starting a ``threading.Timer`` a round cost the master more
    than the round's own dispatch.  A dead worker (``inf``) is never
    dispatched.  A dispatch that raises on the timer thread is stored for
    its worker: the round reports ready and ``collect`` re-raises it (or,
    when the round was already reaped, the next ``submit`` does) — a
    failing kernel is never mistaken for a dead worker.  Worker programs are kept
    per (program key, worker): the n workers share a card but not their
    problems (one graph launched on two streams would be serialised, and
    its static buffers would race).  Worker programs run eagerly unless
    the caller passes a graph class (``program(..., graph_cls=)``, which
    the cluster does for a pipeline that asks for worker graphs): then
    each worker's programs run as CUDA graphs of its own ``GraphSet``
    (``core/graphs.py``), one per (program, signature, slot), the slot
    naming the layer or round whose coded filter shard is resident;
    ``warm`` captures every live worker's graph, and a dispatch (from the
    master or the timer thread) copies the share in, replays on the
    worker's stream and clones the output out.  ``drop_filters`` drops a
    model's graphs with its shards.  Coded filter shards are placed on
    their workers once.  On the CPU every worker's device is ``cpu`` and
    dispatch is synchronous.

Both pools expose a non-blocking ``ready(pending, delta)`` beside the
blocking ``collect``, and share the ``PendingBatch`` in-flight handle and
the inf = dead / nan = discarded / finite = measured ``worker_times``
convention.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait

import numpy as np
import torch

from ..core.graphs import GraphSet
from ..core.pipeline import Program
from ..devices import canonical_device, resolve_device, worker_devices

__all__ = [
    "ClusterDegraded", "DeviceWorkerPool", "PendingBatch", "StragglerModel",
    "ThreadWorkerPool", "make_pool", "resolve_pool",
]


class ClusterDegraded(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerModel:
    """Per-worker latency injection (seconds added to compute time)."""

    delays: np.ndarray  # (n,) extra seconds; np.inf = dead worker

    @staticmethod
    def none(n: int) -> "StragglerModel":
        return StragglerModel(np.zeros(n))

    @staticmethod
    def fixed(n: int, stragglers: int, delay: float, seed: int = 0) -> "StragglerModel":
        rng = np.random.default_rng(seed)
        d = np.zeros(n)
        idx = rng.choice(n, size=stragglers, replace=False)
        d[idx] = delay
        return StragglerModel(d)

    @staticmethod
    def random_uniform(n: int, p: float, delay: float, seed: int = 0) -> "StragglerModel":
        rng = np.random.default_rng(seed)
        return StragglerModel(np.where(rng.random(n) < p, delay, 0.0))


@dataclasses.dataclass
class PendingBatch:
    """In-flight coded dispatch: n submitted subtasks awaiting ``collect``.

    ``futures`` holds the per-worker futures (threads mode); ``results``
    the precomputed outputs (simulated mode) or, under the device pool, the
    dispatched ``(output, completion event)`` pairs, filled in under
    ``lock`` as timer-deferred stragglers dispatch.  ``worker_times`` is
    live — workers write into it as they finish — so ``collect`` snapshots
    it.  Device pool only: ``expected`` is the set of live workers whose
    result will appear, ``errors`` the dispatches that raised, and
    ``reaped`` marks a round ``collect`` has returned."""

    futures: dict
    results: dict  # guarded-by: self.lock
    worker_times: list  # guarded-by: single-writer-slots
    t_start: float
    expected: set | None = None
    lock: threading.Lock | None = None
    errors: dict = dataclasses.field(default_factory=dict)  # guarded-by: self.lock
    reaped: bool = False  # guarded-by: self.lock


def resolve_pool(pool: str | None, mode: str, devices=None) -> str:
    """The pool-selection rule shared by every entry point.

    An explicit ``"threads"`` or ``"device"`` is honoured (``"device"``
    requires ``mode="threads"``: the simulated clock has no device queues to
    race).  ``None`` picks the device pool when ``mode="threads"`` and
    either a device list was given or more than one CUDA device is visible,
    else the thread pool."""
    if pool is None:
        if mode == "threads" and (devices is not None
                                  or torch.cuda.device_count() > 1):
            return "device"
        return "threads"
    if pool not in ("threads", "device"):
        raise ValueError(f"unknown pool {pool!r}; use 'threads' or 'device'")
    if pool == "device" and mode != "threads":
        raise ValueError(
            f"pool='device' requires mode='threads', got mode={mode!r}")
    return pool


def make_pool(pool: str, n: int, straggler: StragglerModel, *,
              mode: str = "threads", device: str | torch.device = "cuda",
              devices=None):
    if resolve_pool(pool, mode, devices) == "device":
        return DeviceWorkerPool(n, straggler, devices=devices, device=device)
    return ThreadWorkerPool(n, straggler, mode=mode, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _master_gather(arr: torch.Tensor, master: torch.device) -> torch.Tensor:
    """One surviving worker output on the master device, read on the
    master's current stream.  The output was allocated on its worker's
    stream; ``record_stream`` keeps the allocator from handing its memory
    to that stream's next subtask before the master's reads have run."""
    out = arr.to(master)
    if master.type == "cuda":
        out.record_stream(torch.cuda.current_stream(master))
    return out


class ThreadWorkerPool:
    """Persistent per-worker single-thread executors (and the simulated
    clock) on one device.  One executor per worker: a straggler still
    sleeping on an abandoned subtask keeps its own node busy (its next
    subtask queues behind, like a real overloaded worker) without ever
    blocking the fast workers."""

    kind = "threads"

    def __init__(self, n: int, straggler: StragglerModel, *,
                 mode: str = "threads", device: str | torch.device = "cuda"):
        assert mode in ("threads", "simulated")
        self.n = n
        self.straggler = straggler
        self.mode = mode
        self.device = resolve_device(device)
        # one stream per worker on the card; written once, here
        self.streams = ([torch.cuda.Stream(device=self.device) for _ in range(n)]
                        if self.device.type == "cuda" and mode == "threads"
                        else None)
        # lazy create (first submit) vs shutdown swap race from another
        # thread: both transitions go through the lock
        self._lifecycle_lock = threading.Lock()
        self._pools: list[ThreadPoolExecutor] | None = None  # guarded-by: self._lifecycle_lock

    # -- lifecycle ---------------------------------------------------------
    def _ensure_pools(self) -> list[ThreadPoolExecutor]:
        with self._lifecycle_lock:
            if self._pools is None:
                self._pools = [
                    ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix=f"fcdcc-worker-{i}")
                    for i in range(self.n)
                ]
            return self._pools

    def shutdown(self) -> None:
        with self._lifecycle_lock:
            pools, self._pools = self._pools, None
        if pools:
            for ex in pools:
                ex.shutdown(wait=False, cancel_futures=True)

    # -- program/filter placement ------------------------------------------
    def program(self, key: tuple, raw, i: int, cache: dict) -> Program:
        """Every worker shares ONE eager program on the one device (the
        caller's cache)."""
        fn = cache.get(key)
        if fn is None:
            fn = cache[key] = Program(raw, name="worker")
        return fn

    def resident_filters(self, name: str, ke):
        return ke  # one device: the master copy IS the resident copy

    def drop_filters(self, prefix: str) -> None:
        pass

    def gather(self, arr: torch.Tensor) -> torch.Tensor:
        return _master_gather(arr, self.device)

    def warm(self, fn, xe, ke, slot=None) -> None:
        """One worker-0 call outside the timed collect (builds and loads the
        kernel library on first use; every worker runs the same program)."""
        fn(0)(xe[0], ke[0])
        _sync(self.device)

    # -- dispatch / reap ---------------------------------------------------
    def submit(self, fn, xe, ke, slot=None) -> PendingBatch:
        delays = self.straggler.delays
        worker_times = [
            float("inf") if not np.isfinite(delays[i]) else float("nan")
            for i in range(self.n)
        ]
        ready = None
        if self.streams is not None:
            # the shares are produced on the master's stream: every worker
            # stream waits on this point of it, and on nothing later
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))

        def work(i):
            if not np.isfinite(delays[i]):
                raise RuntimeError(f"worker {i} failed")
            t = time.perf_counter()
            if ready is not None:
                s = self.streams[i]
                s.wait_event(ready)
                with torch.cuda.stream(s):
                    out = fn(i)(xe[i], ke[i])
                # the master-allocated shares are read on s: keep the
                # allocator from handing their memory out before s is done
                xe.record_stream(s)
                s.synchronize()
            else:
                out = fn(i)(xe[i], ke[i])
                _sync(self.device)
            dt = time.perf_counter() - t
            if self.mode == "threads" and delays[i] > 0:
                time.sleep(delays[i])
            worker_times[i] = dt + delays[i]
            return i, out

        t_start = time.perf_counter()
        futures: dict[int, Future] = {}
        results: dict[int, object] = {}
        if self.mode == "threads":
            pools = self._ensure_pools()
            futures = {i: pools[i].submit(work, i) for i in range(self.n)}
        else:  # simulated clock: compute all live workers synchronously
            for i in range(self.n):
                if np.isfinite(delays[i]):
                    _, out = work(i)
                    results[i] = out
        return PendingBatch(futures, results, worker_times, t_start)

    def ready(self, pending: PendingBatch, delta: int) -> bool:
        """Non-blocking: would ``collect`` return without waiting?  True once
        delta subtasks finished cleanly, or once every future is done
        (possibly with failures), so a degraded round reports ready and
        ``collect`` raises ``ClusterDegraded``."""
        if self.mode != "threads":
            return True
        done = [f for f in pending.futures.values() if f.done()]
        ok = sum(1 for f in done if f.exception() is None)
        return ok >= delta or len(done) == len(pending.futures)

    def collect(self, pending: PendingBatch, delta: int):
        results = dict(pending.results)
        if self.mode == "threads":
            results = {}
            outstanding = set(pending.futures.values())
            while len(results) < delta and outstanding:
                done, outstanding = wait(outstanding, return_when=FIRST_COMPLETED)
                for f in done:
                    try:
                        i, out = f.result()
                        results[i] = out
                    except RuntimeError:
                        pass
            t_compute = time.perf_counter() - pending.t_start
            for f in outstanding:  # abandon stragglers, don't join them
                f.cancel()
        else:  # completion time = max simulated clock over the chosen delta
            order = sorted(results, key=lambda i: pending.worker_times[i])
            results = {i: results[i] for i in order[:delta]}
            t_compute = (max(pending.worker_times[i] for i in results)
                         if results else float("inf"))
        return results, list(pending.worker_times), t_compute


class DeviceWorkerPool:
    """n coded workers pinned to devices (round-robin when there are fewer
    devices than workers), one stream each, with per-device programs and
    resident filter shards.  See the module docstring for the dispatch and
    reap model.

    Memory across streams: a share is produced on the master's stream and
    read on the worker's, possibly a delay later, so dispatch records the
    share on the worker stream; a worker output is produced on the worker's
    stream and read on the master's, so ``gather`` records it on the
    master stream.  A late straggler's output is never gathered; it was
    allocated on its own worker stream, and any reuse of its memory is
    ordered after it on that stream."""

    kind = "device"

    # collect: spin on query() this long before the first sleep (an LM
    # round holds ~15 us of device work, and a sleep lasts tens of us),
    # then back off exponentially from _POLL_MIN toward _POLL_MAX while
    # nothing lands, resetting on every reaped result
    _SPIN_S = 2e-4
    _POLL_MIN = 5e-6
    _POLL_MAX = 1e-3

    def __init__(self, n: int, straggler: StragglerModel, *, devices=None,
                 device: str | torch.device = "cuda",
                 poll_interval_s: float | None = None):
        self.n = n
        self.straggler = straggler
        # the master: where shares are encoded and survivors decoded
        self.master = canonical_device(resolve_device(device))
        self.devices = ([self.master] * n
                        if devices is None and self.master.type == "cpu"
                        else worker_devices(n, devices))
        if any(d.type != self.master.type for d in self.devices):
            raise ValueError(f"worker devices {self.devices} and the master "
                             f"{self.master} must be of one type")
        self.streams = ([torch.cuda.Stream(device=d) for d in self.devices]
                        if self.master.type == "cuda" else None)
        # None = spin, then adaptive backoff; a number = fixed period
        self._poll_interval_s = poll_interval_s
        self.spin_s = self._SPIN_S
        # the engine thread (get-or-create on the hot path) and caller
        # threads (load/unload placement) share these registries
        self._state_lock = threading.RLock()
        self._programs: dict[tuple, Program] = {}  # guarded-by: self._state_lock
        # graph sets by (worker, graph class), made on first use
        self._graph_sets: dict[tuple, GraphSet] = {}  # guarded-by: self._state_lock
        # name -> (master ke, [per-worker shard]); invalidated by identity
        self._filters: dict[str, tuple] = {}  # guarded-by: self._state_lock
        # delayed dispatches: (due time, sequence, dispatch) in time order,
        # run by one timer thread (started on first use, dropped by
        # shutdown, which the thread notices and exits)
        self._timer_cv = threading.Condition()
        self._due: list[tuple] = []  # guarded-by: self._timer_cv
        self._seq = itertools.count()
        self._timer_thread: threading.Thread | None = None  # guarded-by: self._timer_cv
        # a deferred dispatch that failed after its round was reaped
        self._late_error: BaseException | None = None  # guarded-by: self._timer_cv

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self) -> None:
        """Cancel undelivered delayed dispatches, release the timer thread
        and wait for it to exit (a dispatch it is running finishes first,
        so none runs after this returns), and drop programs and filter
        shards (all re-materialise lazily on reuse).  Called from the timer
        thread itself, it cannot wait for itself and returns at once."""
        with self._timer_cv:
            self._due.clear()
            timer, self._timer_thread = self._timer_thread, None
            self._timer_cv.notify_all()
        if timer is not None and timer is not threading.current_thread():
            timer.join()
        with self._state_lock:
            self._programs.clear()
            self._filters.clear()
            self._graph_sets = {}

    # -- program/filter placement ------------------------------------------
    def graph_set(self, i: int, graph_cls) -> GraphSet:
        """Worker ``i``'s graph set for ``graph_cls``."""
        with self._state_lock:
            gs = self._graph_sets.get((i, graph_cls))
            if gs is None:
                gs = self._graph_sets[(i, graph_cls)] = GraphSet(
                    f"worker{i}", self.devices[i], graph_cls)
            return gs

    def graph_sets(self) -> list:
        """The workers' graph sets made so far."""
        with self._state_lock:
            return list(self._graph_sets.values())

    def program(self, key: tuple, raw, i: int, cache: dict | None = None,
                graph_cls=None) -> Program:
        """Worker ``i``'s program: one per (program key, worker, graph
        class), replayed from the worker's graph set of ``graph_cls``, or
        eager where it is None."""
        with self._state_lock:
            fn = self._programs.get((key, i, graph_cls))
            if fn is None:
                fn = self._programs[(key, i, graph_cls)] = Program(
                    raw, name="worker", resident=(1,),
                    graphs=(None if graph_cls is None
                            else self.graph_set(i, graph_cls)))
            return fn

    def program_traces(self) -> dict:
        """Distinct shape signatures per device, ``{device: count}`` (over
        the device's workers and program keys): the device pool's half of
        the bounded-program contract."""
        out: dict = {}
        with self._state_lock:
            programs = dict(self._programs)
        for (key, i, _), fn in programs.items():
            sigs = out.setdefault(self.devices[i], set())
            sigs.update((key, sig) for sig in fn.signatures)
        return {dev: len(sigs) for dev, sigs in out.items()}

    def graph_counts(self) -> list[int]:
        """Graphs held per worker (0 where it runs eagerly)."""
        counts = [0] * self.n
        with self._state_lock:
            for (i, _), gs in self._graph_sets.items():
                counts[i] += gs.num_graphs
        return counts

    def resident_filters(self, name: str, ke) -> list:
        """The per-worker shards of coded filters ``ke`` under the
        namespaced layer ``name``: placed once, reused until ``ke`` is a
        different tensor.  A worker on the master's device gets ``ke[i]``
        itself, with no copy."""
        with self._state_lock:
            ent = self._filters.get(name)
            if ent is None or ent[0] is not ke:
                shards = [ke[i].to(self.devices[i]) for i in range(self.n)]
                for dev in {d for d in self.devices if d != ke.device}:
                    torch.cuda.synchronize(dev)  # copies land before use
                ent = self._filters[name] = (ke, shards)
            return ent[1]

    def drop_filters(self, prefix: str) -> None:
        """Drop the filter shards under names starting with ``prefix``, and
        the worker graphs whose slot they were (those graphs hold the
        shards, and a replacement under the same names captures anew)."""
        with self._state_lock:
            for name in [k for k in self._filters if k.startswith(prefix)]:
                del self._filters[name]
            for gs in self._graph_sets.values():
                gs.drop(prefix)

    def gather(self, arr: torch.Tensor) -> torch.Tensor:
        """One survivor to the master device (discarded outputs never
        move)."""
        return _master_gather(arr, self.master)

    def warm(self, fn, xe, ke, slot=None) -> None:
        """Run every live worker once outside the timed collect: with
        graphs, this captures each one's graph for ``slot`` (on its own
        stream's order)."""
        ready = self._ready_event()
        for i in range(self.n):
            if np.isfinite(self.straggler.delays[i]):
                self._launch(fn, xe, ke, i, ready, slot)
        if self.streams is not None:
            for dev in set(self.devices):
                torch.cuda.synchronize(dev)

    # -- dispatch / reap ---------------------------------------------------
    def _ready_event(self):
        """An event at the current point of the master's stream, where the
        shares were produced (None on the CPU)."""
        if self.streams is None:
            return None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.master))
        return ready

    def _launch(self, fn, xe, ke, i: int, ready, slot=None):
        """Dispatch worker ``i``'s subtask: ``(output, completion event)``,
        the event None on the CPU.  Runs on the master thread or on a
        timer thread, so it enters the worker's device and stream itself:
        the kernels (or the graph) launch on the calling thread's current
        stream.  ``slot`` names the resident filters (graphs only)."""
        dev = self.devices[i]
        kw = {} if slot is None else {"slot": slot}
        if self.streams is None:
            return fn(i)(xe[i].to(dev), ke[i], **kw), None
        s = self.streams[i]
        with torch.cuda.device(dev), torch.cuda.stream(s):
            s.wait_event(ready)
            out = fn(i)(xe[i].to(dev, non_blocking=True), ke[i], **kw)
            done = torch.cuda.Event()
            done.record(s)
        if xe.device == dev:
            xe.record_stream(s)
        return out, done

    def submit(self, fn, xe, ke, slot=None) -> PendingBatch:
        with self._timer_cv:
            late, self._late_error = self._late_error, None
        if late is not None:
            raise late
        delays = self.straggler.delays
        worker_times = [
            float("inf") if not np.isfinite(delays[i]) else float("nan")
            for i in range(self.n)
        ]
        pending = PendingBatch({}, {}, worker_times, time.perf_counter(),
                               expected=set(), lock=threading.Lock())
        ready = self._ready_event()
        for i in range(self.n):
            if not np.isfinite(delays[i]):
                continue  # dead worker: never dispatched
            pending.expected.add(i)
            if delays[i] > 0:
                self._defer(float(delays[i]), pending, i, fn, xe, ke, ready,
                            slot)
            else:
                res = self._launch(fn, xe, ke, i, ready, slot)
                with pending.lock:
                    pending.results[i] = res
        return pending

    def _defer(self, delay: float, pending: PendingBatch, i: int, fn, xe, ke,
               ready, slot=None) -> None:
        """Dispatch worker ``i`` ``delay`` seconds from now, on the timer
        thread.  A dispatch that raises is kept for ``collect`` to re-raise
        (or, when the round was already reaped, for the next ``submit``)."""
        def run():
            try:
                res = self._launch(fn, xe, ke, i, ready, slot)
            except Exception as err:  # surfaces in collect or the next submit
                with pending.lock:
                    late = pending.reaped
                    if not late:
                        pending.errors[i] = err
                if late:
                    with self._timer_cv:
                        self._late_error = err
            else:
                with pending.lock:
                    pending.results[i] = res

        with self._timer_cv:
            heapq.heappush(self._due, (time.perf_counter() + delay,
                                       next(self._seq), run))
            if self._timer_thread is None:
                self._timer_thread = threading.Thread(
                    target=self._timer_loop, name="fcdcc-device-timer",
                    daemon=True)
                self._timer_thread.start()
            self._timer_cv.notify()

    def _timer_loop(self) -> None:
        """Run each delayed dispatch at its due time, in time order, until
        ``shutdown`` replaces this thread."""
        me = threading.current_thread()
        while True:
            with self._timer_cv:
                while True:
                    if self._timer_thread is not me:
                        return
                    wait_s = (self._due[0][0] - time.perf_counter()
                              if self._due else None)
                    if wait_s is not None and wait_s <= 0:
                        break
                    self._timer_cv.wait(wait_s)
                run = heapq.heappop(self._due)[2]
            run()

    def ready(self, pending: PendingBatch, delta: int) -> bool:
        """Non-blocking: are ``delta`` results (all expected ones, for a
        degraded round) complete right now, or has a dispatch failed?"""
        need = min(delta, len(pending.expected))
        with pending.lock:
            if pending.errors:
                return True
            avail = list(pending.results.values())
        return sum(1 for _, ev in avail if ev is None or ev.query()) >= need

    def collect(self, pending: PendingBatch, delta: int):
        """Poll completion events until the fastest ``delta`` workers have
        delivered; later arrivals are discarded (their subtask finishes on
        its own stream, but the output is never gathered).  Spins on
        ``query()`` for ``spin_s``, then sleeps with exponential backoff
        reset on progress, or for a fixed ``poll_interval_s`` when given.
        Re-raises a failed dispatch."""
        need = min(delta, len(pending.expected))
        reaped: dict[int, torch.Tensor] = {}
        sleep_s = self._POLL_MIN
        spin_until = time.perf_counter() + self.spin_s
        while True:
            with pending.lock:
                if pending.errors:
                    raise pending.errors[min(pending.errors)]
                avail = {i: r for i, r in pending.results.items()
                         if i not in reaped}
            progressed = False
            for i, (out, ev) in avail.items():
                if ev is None or ev.query():
                    reaped[i] = out
                    pending.worker_times[i] = \
                        time.perf_counter() - pending.t_start
                    progressed = True
                    if len(reaped) >= need:
                        break
            if len(reaped) >= need:
                break
            if progressed:
                sleep_s = self._POLL_MIN
            elif self._poll_interval_s is not None:
                time.sleep(self._poll_interval_s)
            elif time.perf_counter() >= spin_until:
                time.sleep(sleep_s)
                sleep_s = min(sleep_s * 2, self._POLL_MAX)
        with pending.lock:
            pending.reaped = True
        t_compute = time.perf_counter() - pending.t_start
        return reaped, list(pending.worker_times), t_compute
