"""Continuous-batching scheduler for coded CNN inference requests.

The sglang-style serving decomposition, adapted from token iterations to
ConvL iterations: a thread-safe ``RequestQueue`` admits single-image
requests, and the ``Scheduler`` assembles them into bucketed
``ScheduledBatch``es and decides which in-flight batch advances by one
layer next.

Two properties make this *continuous* rather than static batching:

  * late arrivals are admitted at every **layer boundary** — the engine
    asks the scheduler for work between layers, so a request that shows up
    while batch A is on conv3 starts as batch B at conv1 immediately
    instead of waiting for A to drain;
  * batch sizes are **bucketed** (padded up to the pipeline's
    ``bucket_sizes``), so the pipeline sees one program shape per (layer,
    bucket) — a bounded set — never one per observed batch size.

Scheduling policy is deepest-layer-first: finishing an almost-done batch
frees its requests (latency) before opening a new front (throughput);
ties break FIFO.

Multi-model serving stacks one ``Scheduler`` per registered model under a
``MultiScheduler``: each model keeps its own queue, buckets, and in-flight
set, and the engine's pick is fair-share — a rotating round-robin sweep
*across* the models with in-flight work (no model with pending work ever
waits more than one full sweep of the others, and idle periods build up
no deficit), then deepest-first *within* the chosen model.  Two in-flight batches of the
same model sitting at the same layer boundary are coalesced into one
bucketed batch when their combined real size fits (``coalesce``), so
bursty arrivals converge back to full buckets instead of draining as
fragments.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable

import torch

__all__ = ["Request", "RequestHandle", "RequestQueue", "ScheduledBatch",
           "Scheduler", "MultiScheduler"]


def _take_batch(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """The first ``n`` entries of ``x`` along ``axis`` (static slice)."""
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(0, n)
    return x[tuple(idx)]


@dataclasses.dataclass
class Request:
    """One in-flight inference request for a single ``(C, H, W)`` image."""

    request_id: int
    x: torch.Tensor
    arrival_t: float
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: object = None  # guarded-by: self._finish_lock
    error: BaseException | None = None  # guarded-by: self._finish_lock
    # set when its batch is first *dispatched* to the workers (queue-wait
    # ends at dispatch, not collect — under round pipelining a batch can
    # sit dispatched while an older round collects)  # guarded-by: engine-thread
    start_t: float = float("nan")
    finish_t: float = float("nan")  # guarded-by: self._finish_lock
    _finish_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False
    )
    # shared completion condition (MultiScheduler.completion): notified on
    # every finish so a bounded waiter pool (such as an HTTP front-end's)
    # can wait for many requests on ONE condition instead of parking a
    # thread per request.  None for standalone queues.
    completion: threading.Condition | None = dataclasses.field(
        default=None, repr=False
    )

    def finish(self, result=None, error: BaseException | None = None) -> None:
        """First writer wins: the engine thread and a shutdown-timeout
        ``cancel_all`` may race here, and a result delivered just before
        the cancellation must never be overwritten by it (nor vice versa)."""
        with self._finish_lock:
            if self.done.is_set():
                return
            self.result = result
            self.error = error
            self.finish_t = time.perf_counter()
            self.done.set()
        # outside _finish_lock: waiters re-check handle.done() themselves,
        # and nesting the condition under the finish lock would order them
        completion = self.completion
        if completion is not None:
            with completion:
                completion.notify_all()


class RequestHandle:
    """Caller-side future for a submitted request."""

    def __init__(self, request: Request):
        self._request = request

    @property
    def request_id(self) -> int:
        return self._request.request_id

    def done(self) -> bool:
        return self._request.done.is_set()

    def result(self, timeout: float | None = 60.0):
        """Block until the request completes; raises its error (e.g. a
        ``ClusterDegraded``) or ``TimeoutError``.  The default timeout is a
        fail-fast guard — a wedged scheduler thread surfaces here instead
        of hanging the caller forever."""
        if not self._request.done.wait(timeout):
            raise TimeoutError(
                f"request {self._request.request_id} not done after {timeout}s"
            )
        if self._request.error is not None:
            raise self._request.error
        return self._request.result

    @property
    def latency_s(self) -> float:
        """End-to-end seconds (nan until done)."""
        return self._request.finish_t - self._request.arrival_t


class RequestQueue:
    """Thread-safe FIFO with a condition the engine loop can wait on.

    ``not_empty``/``ids`` may be shared across queues: a ``MultiScheduler``
    hands every model queue the same condition (one engine wait covers all
    models) and the same id counter (request ids stay unique server-wide).
    """

    def __init__(self, not_empty: threading.Condition | None = None,
                 ids=None, completion: threading.Condition | None = None):
        # reentrant: the engine holds the condition while checking len()
        self.not_empty = (threading.Condition(threading.RLock())
                          if not_empty is None else not_empty)
        self._lock = self.not_empty
        self._queue: list[Request] = []  # guarded-by: self._lock
        self._ids = itertools.count() if ids is None else ids
        # handed to every Request: notified when it finishes (see Request)
        self._completion = completion

    def submit(self, x: torch.Tensor) -> RequestHandle:
        req = Request(next(self._ids), x, time.perf_counter(),
                      completion=self._completion)
        with self.not_empty:
            self._queue.append(req)
            self.not_empty.notify_all()
        return RequestHandle(req)

    def pop_up_to(self, k: int) -> list[Request]:
        with self._lock:
            taken, self._queue = self._queue[:k], self._queue[k:]
            return taken

    def drain(self) -> list[Request]:
        with self._lock:
            taken, self._queue = self._queue, []
            return taken

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)


@dataclasses.dataclass
class ScheduledBatch:
    """A bucketed group of requests advancing through the ConvL stack
    together.  ``x`` is the current activation — ``(bucket, C, H, W)`` on
    the round-trip path, or (partition-resident serving, mid-stack) the
    coded input shares ``(n, ell_a, bucket, C, h_hat, Wp)`` with the batch
    on ``batch_axis``; entries past ``len(requests)`` along that axis are
    zero padding."""

    requests: list[Request]
    x: torch.Tensor
    bucket: int
    layer_idx: int = 0
    model: str = ""
    timings: list = dataclasses.field(default_factory=list)
    # which axis of ``x`` is the request batch: 0 for raw/merged tensors,
    # 2 while carrying partition-resident coded shares between layers
    batch_axis: int = 0
    # True while a worker round for this batch is in flight (dispatched but
    # not collected): such a batch must not be picked again or coalesced —
    # its ``x`` is stale until the round lands.  The engine thread flips it
    # around dispatch/collect.  # guarded-by: engine-thread
    dispatched: bool = False

    @property
    def real(self) -> int:
        return len(self.requests)


class Scheduler:
    """Queue + in-flight set + assembly/advance policy for ONE model.

    ``pad_to_bucket`` comes from the model's pipeline so the padded batch
    sizes match its program buckets exactly.  The engine loop drives
    it: ``admit()`` at each layer boundary, ``coalesce()`` to re-pack
    equal-depth fragments, then ``next_batch()`` to pick what advances.
    """

    def __init__(self, pad_to_bucket: Callable, *, max_batch: int,
                 max_inflight: int = 2, name: str = "",
                 queue: RequestQueue | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.name = name
        self.queue = queue if queue is not None else RequestQueue()
        self.inflight: list[ScheduledBatch] = []  # guarded-by: self._lock
        # guards ``inflight``: normally only the engine thread mutates it,
        # but a shutdown whose join timed out calls ``cancel_all`` from the
        # caller thread while the engine may still be running
        self._lock = threading.Lock()
        self.pad_to_bucket = pad_to_bucket
        self.max_batch = max_batch
        self.max_inflight = max_inflight
        # two-phase deregistration fencing (``CodedServer.unregister_model``):
        # ``closed`` rejects NEW submits while queued + in-flight work
        # drains; ``fenced`` additionally stops admission/coalescing — after
        # the fence the model's ``pad_to_bucket``/bucket bindings are never
        # consulted again, so the pipeline behind them can be torn down.
        # Writes go through ``_lock`` so a close/fence from the caller
        # thread is a proper release/acquire edge against the engine's
        # reads (a plain unfenced bool write has no ordering guarantee).
        self.closed = False  # guarded-by: self._lock
        self.fenced = False  # guarded-by: self._lock
        # admissions between popping the queue and joining ``inflight``:
        # ``has_work`` counts them, so a drain never sees a request in
        # neither place
        self._admitting = 0  # guarded-by: self._lock

    def close(self) -> None:
        """Phase 1 of removal: reject new submits, keep serving what's in."""
        with self._lock:
            self.closed = True

    def fence(self) -> None:
        """Phase 2 of removal: stop consulting this model's bucket bindings
        entirely (implies ``close``).  Idempotent."""
        with self._lock:
            self.closed = True
            self.fenced = True

    def submit(self, x: torch.Tensor) -> RequestHandle:
        if self.closed:
            raise RuntimeError(
                f"model {self.name!r} is being unregistered; no new requests"
            )
        return self.queue.submit(x)

    def has_work(self) -> bool:
        # the queue first: an admission counts itself in ``_admitting``
        # before it pops, so a request that left the queue after this read
        # is seen below as admitting or in flight
        if len(self.queue) > 0:
            return True
        with self._lock:
            return bool(self.inflight) or self._admitting > 0

    def admit(self, limit: int | None = None) -> ScheduledBatch | None:
        """Assemble waiting requests into one new bucketed batch (layer 0)
        if capacity allows.  Called at every layer boundary — this is the
        continuous-batching admission point.  ``limit`` caps the batch
        below ``max_batch`` (tests use it to force fragmented batches)."""
        if self.fenced:  # mid-removal: bucket bindings must not be consulted
            return None
        with self._lock:
            if len(self.inflight) >= self.max_inflight:
                return None
            self._admitting += 1
        try:
            take = self.max_batch if limit is None else min(limit, self.max_batch)
            reqs = self.queue.pop_up_to(take)
            if not reqs:
                return None
            x = torch.stack([r.x for r in reqs], dim=0)
            x, real = self.pad_to_bucket(x)
            assert real == len(reqs)
            batch = ScheduledBatch(reqs, x, bucket=int(x.shape[0]),
                                   model=self.name)
            # start_t is NOT stamped here: queue-wait ends at the batch's
            # first *dispatch* (the engine stamps it), so admitted-but-waiting
            # time — e.g. behind a full pipeline window — still counts as
            # queueing
            with self._lock:
                self.inflight.append(batch)
            return batch
        finally:
            with self._lock:
                self._admitting -= 1

    def can_admit(self) -> bool:
        """Non-mutating: would ``admit()`` assemble a batch right now?"""
        if self.fenced:
            return False
        with self._lock:
            if len(self.inflight) >= self.max_inflight:
                return False
        return len(self.queue) > 0

    def has_undispatched(self) -> bool:
        """Any in-flight batch waiting at a boundary (not mid-round)?"""
        with self._lock:
            return any(not b.dispatched for b in self.inflight)

    def coalesce(self) -> int:
        """Merge in-flight batches sitting at the SAME layer boundary into
        one bucketed batch while the combined real size fits ``max_batch``.

        Rows are independent through every coded layer (the batch axis
        rides inside each worker's subtask), so a merged batch decodes to
        exactly the per-batch results — this only trades fragments for one
        fuller bucket (fewer master/worker rounds).  Fragments arise from
        admission racing arrivals, and — under multi-model fair share —
        from a model's batches waiting at a boundary while another model
        advances.  Partition-resident batches merge the same way, just on
        their coded-share batch axis (equal depth implies equal state
        layout; zero padding encodes to zero shares).  Returns the number
        of merges performed (the engine accounts them into
        ``MetricsCollector`` — the single counter)."""
        if self.fenced:  # pad_to_bucket is off-limits mid-removal
            return 0
        merges = 0
        with self._lock:
            by_depth: dict[int, list[ScheduledBatch]] = {}
            for b in self.inflight:
                if b.dispatched:
                    # mid-round: its ``x`` is stale until the collect lands,
                    # so only same-boundary batches NOT in flight merge
                    continue
                by_depth.setdefault(b.layer_idx, []).append(b)
            for group in by_depth.values():
                group.sort(key=lambda b: b.real)
                while len(group) > 1:
                    a, b = group[0], group[1]
                    if a.real + b.real > self.max_batch:
                        break
                    ax = a.batch_axis
                    assert ax == b.batch_axis, (ax, b.batch_axis)
                    x = torch.cat(
                        [_take_batch(a.x, a.real, ax),
                         _take_batch(b.x, b.real, ax)], dim=ax
                    )
                    # pass axis only off the default: pad_to_bucket may be a
                    # plain (x) -> (padded, real) callable without an axis
                    # parameter (only CodedPipeline's method accepts one,
                    # and only partition-resident batches need it)
                    x, real = (self.pad_to_bucket(x) if ax == 0
                               else self.pad_to_bucket(x, axis=ax))
                    a.requests.extend(b.requests)
                    a.x, a.bucket = x, int(x.shape[ax])
                    # a's timings describe the merged batch's past; b's are
                    # dropped with b (only per-request metrics survive)
                    self.inflight.remove(b)
                    group.pop(1)
                    group.sort(key=lambda b: b.real)
                    merges += 1
        return merges

    def next_batch(self) -> ScheduledBatch | None:
        """Deepest-layer-first (FIFO among ties): drain nearly-finished
        batches before starting fresh ones.  Batches with a round already
        in flight are skipped — they advance when their collect lands, not
        by being picked again."""
        with self._lock:
            ready = [b for b in self.inflight if not b.dispatched]
            if not ready:
                return None
            return max(ready, key=lambda b: b.layer_idx)

    def retire(self, batch: ScheduledBatch) -> None:
        with self._lock:
            if batch in self.inflight:  # may already be gone: a shutdown
                self.inflight.remove(batch)  # timeout cancel_all'ed it

    def cancel_all(self, error: BaseException) -> int:
        """Fail every queued and in-flight request (engine shutdown without
        drain, or a shutdown whose engine join timed out).  Returns the
        number of requests cancelled.  ``Request.finish`` is first-writer-
        wins, so racing the still-running engine can't clobber a result it
        delivered concurrently."""
        with self._lock:
            batches, self.inflight = self.inflight, []
        cancelled = 0
        for req in self.queue.drain():
            req.finish(error=error)
            cancelled += 1
        for batch in batches:
            for req in batch.requests:
                req.finish(error=error)
                cancelled += 1
        return cancelled


class MultiScheduler:
    """Per-model ``Scheduler``s under one fair-share policy.

    Every model registered with ``add_model`` gets its own queue (sharing
    ONE condition and id counter, so a submit to any model wakes the one
    engine loop and request ids stay unique server-wide), its own buckets,
    and its own in-flight capacity.  The engine drives:

      * ``admit()``   — one new batch from some model with queued work and
        free capacity, rotating so no model's queue monopolizes admission;
      * ``coalesce()``— equal-depth merges inside every model;
      * ``next_batch()`` — the fair-share pick: a rotating sweep over the
        models, granting up to ``weight`` consecutive layer rounds to the
        next model with in-flight work (idle models are skipped without
        losing their turn's place).  A model with work is never more than
        the sum of the *other* models' weights rounds away from its next
        round — with unit weights, one full sweep — and the bound is
        positional, NOT a least-served count, so a model that idles while
        another serves builds up no deficit it could later monopolize the
        engine with.  Within the chosen model the pick stays deepest-first.
    """

    def __init__(self):
        self.not_empty = threading.Condition(threading.RLock())
        # notified (by the finishing thread) whenever ANY request of any
        # model completes: one condition serves every result waiter
        self.completion = threading.Condition()
        self._ids = itertools.count()
        self.schedulers: dict[str, Scheduler] = {}  # guarded-by: self.not_empty
        # integer fair-share weights: a model gets up to ``weight``
        # consecutive rounds per sweep position
        self.weights: dict[str, int] = {}  # guarded-by: self.not_empty
        # accounting only (stats/tests): layer-rounds granted per model
        self.served_rounds: dict[str, int] = {}  # guarded-by: self.not_empty
        # sweep cursors: only the engine thread advances these
        self._admit_rr = 0  # guarded-by: engine-thread
        self._pick_rr = 0  # guarded-by: engine-thread
        # rounds granted at the current sweep position
        self._pick_credit = 0  # guarded-by: engine-thread

    def add_model(self, name: str, pad_to_bucket: Callable, *,
                  max_batch: int, max_inflight: int = 2,
                  weight: int = 1) -> Scheduler:
        if not isinstance(weight, int) or weight < 1:
            raise ValueError(f"weight must be an integer >= 1, got {weight!r}")
        sched = Scheduler(
            pad_to_bucket, max_batch=max_batch, max_inflight=max_inflight,
            name=name,
            queue=RequestQueue(self.not_empty, self._ids, self.completion),
        )
        # registry mutations serialize on ``not_empty``: the engine may be
        # registering/removing a model live while its loop snapshots names
        with self.not_empty:
            if name in self.schedulers:
                raise ValueError(f"model {name!r} already registered")
            self.schedulers[name] = sched
            self.weights[name] = weight
            self.served_rounds[name] = 0
        return sched

    def remove_model(self, name: str) -> Scheduler:
        """Drop model ``name`` from the registry (its scheduler should
        already be fenced and drained/cancelled — this only unlinks it).
        The rotating sweep positions are plain indices modulo the live name
        list, re-snapshotted every call, so no re-indexing is needed."""
        with self.not_empty:
            sched = self.schedulers.pop(name)
            self.weights.pop(name, None)
            self.served_rounds.pop(name, None)
        return sched

    def fence(self, name: str) -> Scheduler:
        """Fence one model mid-removal: its ``pad_to_bucket``/bucket
        bindings are never consulted again (submit/admit/coalesce all
        refuse) while the registry entry stays visible for draining."""
        sched = self.schedulers[name]
        sched.fence()
        return sched

    def _snapshot(self) -> list[str]:
        with self.not_empty:
            return list(self.schedulers)

    def __getitem__(self, name: str) -> Scheduler:
        return self.schedulers[name]

    def submit(self, model: str, x: torch.Tensor) -> RequestHandle:
        return self.schedulers[model].submit(x)

    def has_work(self) -> bool:
        return any(s.has_work() for s in list(self.schedulers.values()))

    def queued(self) -> int:
        return sum(len(s.queue) for s in list(self.schedulers.values()))

    def dispatchable(self) -> bool:
        """Is there work the engine could dispatch *right now* — a queued
        request that would admit, or an in-flight batch waiting at a
        boundary?  The reaper polls this to abandon its wait when a free
        pipeline-window slot could be filled instead."""
        return any(s.can_admit() or s.has_undispatched()
                   for s in list(self.schedulers.values()))

    def admit(self) -> ScheduledBatch | None:
        """Admit one new batch from the next model (rotating) that has both
        queued requests and free in-flight capacity.  The engine loops this
        until it returns None — all models' capacity fills at one boundary.
        The name list is a lock-guarded snapshot: a model registered or
        removed concurrently is simply missed/skipped this boundary."""
        names = self._snapshot()
        for off in range(len(names)):
            name = names[(self._admit_rr + off) % len(names)]
            sched = self.schedulers.get(name)
            if sched is None:  # removed since the snapshot
                continue
            batch = sched.admit()
            if batch is not None:
                self._admit_rr = (self._admit_rr + off + 1) % len(names)
                return batch
        return None

    def coalesce(self) -> dict[str, int]:
        """Equal-depth merges per model (empty dict = nothing merged)."""
        out = {}
        for name in self._snapshot():
            sched = self.schedulers.get(name)
            merges = sched.coalesce() if sched is not None else 0
            if merges:
                out[name] = merges
        return out

    def next_batch(self) -> tuple[str, ScheduledBatch] | None:
        """Fair-share pick: the rotating weighted sweep (see class
        docstring), one served round accounted to the winner.  A model with
        ``weight=w`` is granted up to ``w`` consecutive rounds before the
        sweep position advances; skipping an idle model forfeits any credit
        it had at its position (positional bound, no banked deficit)."""
        names = self._snapshot()
        for off in range(len(names)):
            pos = (self._pick_rr + off) % len(names)
            name = names[pos]
            sched = self.schedulers.get(name)
            if sched is None:  # removed since the snapshot
                continue
            batch = sched.next_batch()
            if batch is not None:
                if off:  # swept past idle models: restart credit here
                    self._pick_rr, self._pick_credit = pos, 0
                self._pick_credit += 1
                if self._pick_credit >= self.weights.get(name, 1):
                    self._pick_rr = (pos + 1) % len(names)
                    self._pick_credit = 0
                # under the condition: ``remove_model`` may pop the entry
                # from another thread between the membership check and the
                # increment, resurrecting the key with a stale count
                with self.not_empty:
                    if name in self.served_rounds:
                        self.served_rounds[name] += 1
                return name, batch
        return None

    def retire(self, model: str, batch: ScheduledBatch) -> None:
        sched = self.schedulers.get(model)
        if sched is not None:  # may have been unregistered mid-flight
            sched.retire(batch)

    def cancel_all(self, error: BaseException) -> int:
        return sum(s.cancel_all(error) for s in list(self.schedulers.values()))
