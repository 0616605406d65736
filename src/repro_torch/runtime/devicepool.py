"""Worker pools behind ``FcdccCluster``'s submit/collect seam.

``ThreadWorkerPool`` (``pool="threads"``): one persistent single-thread
executor per worker, stragglers injected as ``sleep()``s after the compute,
and the simulated clock for ``mode="simulated"``.  On a CUDA device each
worker thread owns one ``torch.cuda.Stream`` created with the pool: the
master records an event on its own stream at submit, the worker's stream
waits on it, the subtask launches under ``torch.cuda.stream(s)``, and the
worker synchronises its stream before it stamps ``worker_times`` — so the
n subtasks overlap on the card as far as its resources allow, and a
finished future always holds a finished output.

The device pool of the reference (one device per worker) is a later slice
of the port; ``pool="device"`` raises ``NotImplementedError``.

Both sides of the seam share the ``PendingBatch`` in-flight handle and the
inf = dead / nan = discarded / finite = measured ``worker_times``
convention.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait

import numpy as np
import torch

from ..devices import resolve_device

__all__ = [
    "ClusterDegraded", "PendingBatch", "StragglerModel", "ThreadWorkerPool",
    "make_pool", "resolve_pool",
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
    the precomputed outputs (simulated mode).  ``worker_times`` is live —
    workers write into it as they finish — so ``collect`` snapshots it."""

    futures: dict
    results: dict  # guarded-by: submit-thread
    worker_times: list  # guarded-by: single-writer-slots
    t_start: float


def resolve_pool(pool: str | None, mode: str) -> str:
    """The pool-selection rule shared by every entry point: ``None`` and
    ``"threads"`` give the thread pool."""
    if pool is None or pool == "threads":
        return "threads"
    if pool == "device":
        raise NotImplementedError(
            "pool='device' (one device per worker, reaped by CUDA events) is "
            "a later slice of the port (ROADMAP Queue A 5); use 'threads'")
    raise ValueError(f"unknown pool {pool!r}; use 'threads'")


def make_pool(pool: str, n: int, straggler: StragglerModel, *,
              mode: str = "threads", device: str | torch.device = "cuda"):
    resolve_pool(pool, mode)
    return ThreadWorkerPool(n, straggler, mode=mode, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


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

    def warm(self, fn, xe, ke) -> None:
        """One worker-0 call outside the timed collect (builds and loads the
        kernel library on first use; every worker runs the same program)."""
        fn(0)(xe[0], ke[0])
        _sync(self.device)

    # -- dispatch / reap ---------------------------------------------------
    def submit(self, fn, xe, ke) -> PendingBatch:
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
