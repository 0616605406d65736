"""``CodedServer``: a continuous-batching, multi-model serving engine over
resident ``CodedPipeline``s sharing one ``FcdccCluster``, on one device
(the card unless the caller asks for the CPU).

The paper's deployment model (Sec. IV, Fig. 1) pre-stores coded filters on
the workers and streams inference through the coded cluster; this module
turns that into a *server*: concurrent callers ``submit()`` single images,
a background engine thread assembles them into bucketed batches and
advances in-flight batches one ConvL at a time through the cluster's
``run_pipeline_layer`` master/worker rounds, admitting late arrivals at
every layer boundary.

Several models share the one persistent worker pool: ``register_model``
loads each ``CodedPipeline`` (e.g. lenet5 + alexnet under different
``(k_a, k_b)`` plans) into its own cluster namespace — resident coded
filters and program caches never collide — and each model gets its own
scheduler (queue, buckets, in-flight capacity).  The engine picks work
fair-share: a rotating round-robin sweep across the models with in-flight
work, deepest batch first within a model, with equal-depth batches of one
model coalesced back into full buckets when capacity allows.  Constructing the server with a
single pipeline is the unchanged single-model API (one model named
``"default"``).

Two execution paths share the resident pipelines:

  * ``execution="cluster"`` — every layer is a full master/worker round
    (encode, dispatch n coded subtasks via the cluster's persistent
    per-worker pool, fastest-delta collect, decode).  Stragglers and dead
    workers behave exactly as in ``run_pipeline``.
  * ``execution="direct"`` — survivors are pre-picked from the straggler
    model (dead workers excluded, slowest gamma dropped) and the whole
    stack runs through ``CodedPipeline.run_prepared``: no host-side code
    prep between layers, so decode of layer *i* overlaps encode of layer
    *i+1* on the device queue.

Batch sizes are padded to each pipeline's ``bucket_sizes``, so each program
sees one shape per (layer, bucket) — ``warmup()`` runs them all once, and
the shape count summed over models stays bounded by geometries x buckets
no matter how request batch sizes vary.

A pipeline built with ``fuse_transitions=True`` serves on the
partition-resident path: between ConvL boundaries a batch's state is the
next layer's coded input shares (decode only to the partition grid,
relu/pool per spatial partition with halo exchange, re-encode — one fused
transition program per (layer, bucket)), and the full activation tensor is
materialized only at the final layer.  Late admission is unchanged (new
batches enter at layer 0 with raw images) and coalescing merges
partition-space batches on their coded-share batch axis.
``register_model(..., weight=w)`` sets the integer fair share: the rotating
sweep grants a model up to ``w`` consecutive rounds per sweep position, so
a backlogged model waits at most the sum of the other models' weights.

On a CUDA device the rounds replay CUDA graphs (``core/graphs.py``) as
each pipeline's ``graphs`` switch says: the master's programs from the
pipeline, and the workers' from the device pool where the pipeline asks
for worker graphs.  ``warmup()`` captures them on the stream the engine
thread serves on, so capture time stays out of the served timings.
The pipeline's ``set_graphs(False)`` serves eagerly, op by op; it is only
ever an explicit call.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from ..core.pipeline import CodedPipeline, build_cnn_pipeline
from ..runtime import FcdccCluster, PendingRound, StragglerModel

from .metrics import (MetricsCollector, OverlapStats, RequestRecord,
                      ServingStats)
from .scheduler import MultiScheduler, RequestHandle, ScheduledBatch

__all__ = ["CodedServer"]

DEFAULT_BUCKETS = (1, 2, 4, 8)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclasses.dataclass
class _ModelState:
    """Engine-side view of one registered model.

    The name -> pipeline registry lives ONLY in the cluster
    (``FcdccCluster.pipelines``, written by ``load_pipeline``); this object
    holds the serving-side extras (the direct-mode survivor plan) and
    resolves ``pipeline`` through the cluster — so the engine and the
    cluster can never disagree about what is resident.  The fair-share
    weight likewise lives only in the ``MultiScheduler``."""

    name: str
    cluster: FcdccCluster
    # direct-mode survivor plan, built lazily  # guarded-by: engine-thread
    prepared: tuple | None = None

    @property
    def pipeline(self) -> CodedPipeline:
        return self.cluster.pipelines[self.name]


@dataclasses.dataclass
class _InFlightRound:
    """One dispatched-but-uncollected worker round in the engine's pipeline
    window.  Engine-private: only the engine thread creates, polls, and
    consumes these.  # guarded-by: engine-thread"""

    state: _ModelState
    batch: ScheduledBatch
    rnd: PendingRound
    dispatch_s: float  # master-side encode + submit time for this round


class CodedServer:
    """Continuous-batching inference server over resident coded pipelines.

    Owns one ``FcdccCluster`` (persistent per-worker pool shared by every
    registered model) and one engine thread.  ``submit()`` is thread-safe
    and returns a ``RequestHandle``; ``stats()`` aggregates per-request
    metrics (``stats(model=...)`` for one model).  Use as a context manager
    or call ``start()``/``shutdown()``.  Compiled programs follow each
    registered pipeline's own switch (``pipeline.set_graphs``).
    """

    def __init__(self, pipeline: CodedPipeline | None = None,
                 straggler: StragglerModel | None = None, *,
                 mode: str = "simulated", execution: str = "cluster",
                 bucket_sizes=None, max_inflight: int = 2,
                 pipeline_depth: int = 2,
                 poll_interval_s: float = 0.005, model: str = "default",
                 pool: str | None = None, devices=None):
        if execution not in ("cluster", "direct"):
            raise ValueError(f"unknown execution mode {execution!r}")
        if not isinstance(pipeline_depth, int) or pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be an integer >= 1, got {pipeline_depth!r}"
            )
        self.execution = execution
        # round-pipelining window: how many dispatched worker rounds (of
        # any model) may be in flight at once.  1 = the classic serial
        # dispatch -> collect loop; 2+ overlaps batch A's collect + fused
        # transition on the master with batch B's worker compute
        self.pipeline_depth = pipeline_depth
        self.mode = mode
        self.cluster: FcdccCluster | None = None
        # worker-pool preference for the shared cluster (None = auto): an
        # explicit argument wins, else the first registered pipeline's own
        # preference rides along
        self._pool = pool
        self._devices = devices
        # the master's stream on the card: warmup captures there, and the
        # engine thread serves there
        self._master_stream = None  # guarded-by: control-thread
        self._straggler = straggler
        self._default_buckets = bucket_sizes
        self._default_max_inflight = max_inflight
        # registry writes (register/unregister from caller threads) go
        # through the lock; the engine thread only reads via ``.get``
        self._registry_lock = threading.Lock()
        self.models: dict[str, _ModelState] = {}  # guarded-by: self._registry_lock
        self.scheduler = MultiScheduler()
        self.metrics = MetricsCollector()
        self._poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._drain = True  # guarded-by: control-thread
        self._thread: threading.Thread | None = None  # guarded-by: control-thread
        if pipeline is not None:
            self.register_model(model, pipeline)

    # -- construction helpers ----------------------------------------------
    @classmethod
    def from_cnn(cls, name: str, params: dict, n: int, *,
                 q: int | None = None, default_kab=None, input_hw=None,
                 straggler: StragglerModel | None = None,
                 mode: str = "simulated", execution: str = "cluster",
                 backend: str = "kernel", bucket_sizes=None,
                 max_inflight: int = 2, pipeline_depth: int = 2,
                 model: str | None = None,
                 fuse_transitions: bool = False,
                 pool: str | None = None, devices=None,
                 device: str | torch.device = "cuda") -> "CodedServer":
        """Compile a named CNN (``lenet5``/``alexnet``/``vgg16``) into a
        bucketed resident pipeline and wrap a server around it; the model
        registers under ``model`` (default: the arch name).  Register more
        models afterwards with ``register_model``.

        ``backend="kernel"`` (the default) serves every batch through the
        hand-written CUDA kernels (their plain versions on ``device="cpu"``);
        ``backend="torch"`` through ``F.conv2d`` and plain matmuls.
        ``fuse_transitions=True`` serves on the partition-resident path:
        batches advance between ConvL boundaries as coded partition shares,
        never materializing the full activation between layers."""
        pipeline = build_cnn_pipeline(
            name, params, n, q=q, default_kab=default_kab, input_hw=input_hw,
            backend=backend,
            bucket_sizes=(bucket_sizes if bucket_sizes is not None
                          else DEFAULT_BUCKETS),
            fuse_transitions=fuse_transitions, pool=pool, devices=devices,
            device=device,
        )
        return cls(pipeline, straggler, mode=mode, execution=execution,
                   max_inflight=max_inflight, pipeline_depth=pipeline_depth,
                   model=model if model is not None else name)

    # -- model registry ------------------------------------------------------
    def register_model(self, name: str, pipeline: CodedPipeline, *,
                       bucket_sizes=None, max_inflight: int | None = None,
                       weight: int = 1) -> None:
        """Load ``pipeline`` as model ``name`` onto the shared worker pool.

        The first registration creates the cluster (inheriting the
        pipeline's backend and device); later ones must target the same
        worker count, backend and device.  Each model gets its own scheduler
        (queue, buckets, in-flight capacity) — registration happens before
        ``start()``.  The pipeline registry itself is the cluster's
        ``pipelines`` mapping (one source of truth); ``self.models`` holds
        only the per-model serving state viewing it.

        ``weight`` is the integer fair share: the engine's rotating sweep
        grants the model up to ``weight`` consecutive layer rounds per
        sweep position, so under contention round counts converge to the
        weight ratio (a backlogged model waits at most the sum of the
        other models' weights between its rounds)."""
        if name in self.models:
            raise ValueError(f"model {name!r} already registered")
        if not isinstance(weight, int) or weight < 1:
            raise ValueError(f"weight must be an integer >= 1, got {weight!r}")
        # validate shared-pool compatibility BEFORE any mutation: a failed
        # registration must not leave the caller's pipeline re-bucketed
        if self.cluster is not None:
            if pipeline.n != self.cluster.n:
                raise ValueError(
                    f"model {name!r} targets n={pipeline.n}, shared pool "
                    f"has n={self.cluster.n}"
                )
            if (pipeline.backend, pipeline.device) != \
                    (self.cluster.backend, self.cluster.device):
                raise ValueError(
                    f"model {name!r} built for backend="
                    f"{pipeline.backend!r} on {pipeline.device}, shared pool "
                    f"runs {self.cluster.backend!r} on {self.cluster.device}"
                )
        buckets = bucket_sizes if bucket_sizes is not None \
            else self._default_buckets
        if pipeline.bucket_sizes is None:
            pipeline.bucket_sizes = CodedPipeline.normalize_buckets(
                buckets if buckets is not None else DEFAULT_BUCKETS
            )
        elif buckets is not None and \
                CodedPipeline.normalize_buckets(buckets) \
                != pipeline.bucket_sizes:
            raise ValueError(
                f"pipeline already bucketed as {pipeline.bucket_sizes}, "
                f"got bucket_sizes={tuple(buckets)}"
            )
        if self.cluster is None:
            # the cluster runs each pipeline's own worker programs, so it
            # shares the pipelines' backend and device; the worker pool
            # comes from the server's explicit preference, else the
            # pipeline's
            self.cluster = FcdccCluster(
                pipeline.specs[0].plan, self._straggler, mode=self.mode,
                backend=pipeline.backend,
                pool=self._pool if self._pool is not None else pipeline.pool,
                devices=(self._devices if self._devices is not None
                         else pipeline.devices),
                device=pipeline.device,
            )
        self.cluster.load_pipeline(pipeline, name)
        # publish order matters for LIVE registration (engine running):
        # the scheduler entry goes in LAST, after the pipeline is resident
        # and the serving state exists — the engine loop resolves work it
        # picked through ``self.models``/the cluster, so a model it can
        # pick must already be fully registered
        with self._registry_lock:
            self.models[name] = _ModelState(name, self.cluster)
        self.scheduler.add_model(
            name, pipeline.pad_to_bucket, max_batch=pipeline.max_batch,
            # the default in-flight capacity grows with the pipeline window:
            # fewer than ``pipeline_depth`` admissible batches could never
            # fill the window, silently serializing the rounds again
            max_inflight=(max_inflight if max_inflight is not None
                          else max(self._default_max_inflight,
                                   self.pipeline_depth)),
            weight=weight,
        )

    def unregister_model(self, name: str, *, drain: bool = True,
                         timeout: float = 60.0) -> None:
        """Remove model ``name`` from a (possibly live) server.

        Two-phase teardown so the engine never touches a half-removed
        model: first the model's scheduler is *closed* (new submits are
        refused while queued + in-flight requests finish — or, with
        ``drain=False``, are cancelled immediately), then it is *fenced*
        (its ``pad_to_bucket``/bucket bindings are never consulted again)
        and only then are the scheduler entry, serving state, resident
        filters torn down.  On timeout the
        model is left closed-but-registered and the ``TimeoutError``
        surfaces (retry or ``drain=False`` to force)."""
        if name not in self.models:
            raise ValueError(
                f"unknown model {name!r}; registered: {sorted(self.models)}"
            )
        sched = self.scheduler[name]
        sched.close()
        engine_live = self._thread is not None and not self._stop.is_set()
        if drain and engine_live:
            deadline = time.perf_counter() + timeout
            while sched.has_work():
                if time.perf_counter() > deadline:
                    raise TimeoutError(
                        f"model {name!r} still has in-flight work after "
                        f"{timeout}s; retry or unregister with drain=False"
                    )
                time.sleep(self._poll_interval_s)
        else:
            sched.cancel_all(RuntimeError(f"model {name!r} unregistered"))
        # fence BEFORE teardown: from here the engine can still hold a
        # reference to the scheduler from a stale snapshot, but every entry
        # point that would consult the model's bucket bindings refuses
        sched.fence()
        if not drain:  # cancel again: a request admitted during the close-
            sched.cancel_all(  # to-cancel window must not be stranded
                RuntimeError(f"model {name!r} unregistered"))
        self.scheduler.remove_model(name)
        with self._registry_lock:
            del self.models[name]
        self.cluster.unload_pipeline(name)

    def model_names(self) -> list[str]:
        return list(self.models)

    @property
    def pipeline(self) -> CodedPipeline:
        """The single registered pipeline (single-model back-compat view);
        ambiguous — and an error — once several models are registered."""
        if len(self.models) != 1:
            raise ValueError(
                f"{len(self.models)} models registered "
                f"({sorted(self.models)}); use models[name].pipeline"
            )
        return next(iter(self.models.values())).pipeline

    def _resolve(self, model: str | None) -> _ModelState:
        if not self.models:
            raise ValueError("no model registered; call register_model()")
        if model is None:
            if len(self.models) > 1:
                raise ValueError(
                    f"{len(self.models)} models registered "
                    f"({sorted(self.models)}); pass model="
                )
            return next(iter(self.models.values()))
        try:
            return self.models[model]
        except KeyError:
            raise ValueError(
                f"unknown model {model!r}; registered: {sorted(self.models)}"
            ) from None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "CodedServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        if not self.models:
            raise RuntimeError("no model registered; call register_model()")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._engine_main, name="coded-server-engine", daemon=True
        )
        self._thread.start()
        return self

    def shutdown(self, *, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the engine.  ``drain=True`` (default) finishes queued and
        in-flight requests first; ``drain=False`` cancels them with a
        ``RuntimeError``.  Idempotent.

        If the engine thread is still alive after ``timeout``, ``_thread``
        is kept (so a retry joins it again instead of silently skipping)
        and all outstanding requests are failed with the ``TimeoutError``
        — callers blocked on ``result()`` surface the wedged engine
        instead of hanging until their own timeouts."""
        self._drain = drain
        self._stop.set()
        thread = self._thread
        if thread is not None:
            with self.scheduler.not_empty:
                self.scheduler.not_empty.notify_all()
            thread.join(timeout)
            if thread.is_alive():
                err = TimeoutError(f"engine thread not done after {timeout}s")
                self.scheduler.cancel_all(err)
                # release the worker pools even though the engine may still
                # be wedged on them: a never-retried shutdown must not leak
                # n executors, and the cluster re-creates pools lazily if
                # the engine ever resumes
                self.cluster.shutdown()
                raise err
            self._thread = None
            # a submit that passed the gate while the engine was exiting
            # enqueued onto a dead engine — fail it rather than strand it
            self.scheduler.cancel_all(RuntimeError("server shut down"))
        if self.cluster is not None:
            self.cluster.shutdown()

    def __enter__(self) -> "CodedServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- request path --------------------------------------------------------
    def submit(self, x, model: str | None = None) -> RequestHandle:
        """Enqueue one ``(C, H, W)`` image for ``model`` (optional while a
        single model is registered); returns a handle whose ``result()``
        blocks for the decoded output.

        Inputs are cast to the pipeline dtype and moved to its device: a
        stray uint8/float16 request must not open a new program signature —
        the bounded-program contract is shape *and* dtype."""
        state = self._resolve(model)
        pipe = state.pipeline
        x = torch.as_tensor(x, dtype=pipe.input_dtype, device=pipe.device)
        if tuple(x.shape) != pipe.input_shape:
            raise ValueError(
                f"request shape {tuple(x.shape)} != model "
                f"{state.name!r} input {pipe.input_shape}"
            )
        # _stop closes the gate the moment shutdown begins (also after a
        # timed-out shutdown, where _thread is deliberately kept): a late
        # submit must not enqueue onto an engine that will never serve it
        if self._thread is None or self._stop.is_set():
            raise RuntimeError("server not running; call start()")
        return self.scheduler.submit(state.name, x)

    def submit_many(self, xs, model: str | None = None) -> list[RequestHandle]:
        return [self.submit(x, model) for x in xs]

    def warmup(self, model: str | None = None) -> None:
        """Run every (layer, bucket) program once — of one model, or of
        every registered model (default) — with one zero batch per bucket
        end-to-end.  This builds and loads the kernels, warms the worker
        programs outside timed collects, and makes first-request latency
        flat.  With CUDA graphs, this is where every round's graphs are
        captured, on the stream the engine serves on."""
        states = ([self._resolve(model)] if model is not None
                  else list(self.models.values()))
        with self._master_ctx():
            self._warmup(states)

    def _master_ctx(self):
        """The master's stream on the card (made once), nothing on the
        CPU."""
        device = self.cluster.device
        if device.type != "cuda":
            return contextlib.nullcontext()
        if self._master_stream is None:
            self._master_stream = torch.cuda.Stream(device=device)
        return torch.cuda.stream(self._master_stream)

    def _warmup(self, states) -> None:
        for state in states:
            pipe = state.pipeline
            for bucket in pipe.bucket_sizes:
                x = torch.zeros((bucket,) + pipe.input_shape,
                                dtype=pipe.input_dtype, device=pipe.device)
                if self.execution == "direct":
                    pipe.run_prepared(x, self._direct_plan(state))
                    _sync(pipe.device)
                else:
                    self.cluster.run_pipeline(x, model=state.name)

    def stats(self, model: str | None = None) -> ServingStats:
        return self.metrics.stats(model)

    def per_model_stats(self) -> dict[str, ServingStats]:
        return self.metrics.per_model_stats()

    def overlap_stats(self, model: str | None = None) -> OverlapStats:
        """Per-phase round timings + pipelining efficiency (see
        ``OverlapStats``) — all models, or one model's rounds."""
        return self.metrics.overlap_stats(model)

    def wait_many(self, handles, timeout: float | None = 60.0, *,
                  slice_s: float = 0.05) -> bool:
        """Block until every handle is done (True) or ``timeout`` elapses
        (False: no request is cancelled, some may have finished).

        One shared condition (``MultiScheduler.completion``) serves every
        waiter with timeout-sliced waits, so a bounded pool of threads can
        park on many pending requests at once: the HTTP front-end's handler
        pool gathers batched requests through here instead of dedicating
        one blocked thread per ``result()`` call."""
        deadline = (None if timeout is None
                    else time.perf_counter() + float(timeout))
        completion = self.scheduler.completion
        with completion:
            while True:
                if all(h.done() for h in handles):
                    return True
                wait_s = slice_s
                if deadline is not None:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        return False
                    wait_s = min(wait_s, left)
                completion.wait(wait_s)

    # -- engine loop ---------------------------------------------------------
    # reaper poll floor: first wait after a dispatch (backs off toward
    # ``poll_interval_s`` while nothing lands, resets per reap)
    _REAP_POLL_MIN_S = 50e-6

    def _engine_main(self) -> None:
        """The engine thread.  On the card the master runs on a stream of
        its own: the legacy default stream would synchronise implicitly
        with every worker stream and serialise master work (decode,
        transition, encode) with the workers' subtasks."""
        with self._master_ctx():
            self._engine_loop()

    def _engine_loop(self) -> None:
        sched = self.scheduler
        # the pipeline window: dispatched-but-uncollected worker rounds,
        # oldest first (collects happen in whatever order rounds finish)
        rounds: list[_InFlightRound] = []  # guarded-by: engine-thread
        busy_t0 = 0.0  # wall-clock start of the current busy span
        while True:
            if self._stop.is_set() and (
                not self._drain or (not rounds and not sched.has_work())
            ):
                # drain=False abandons in-flight rounds: their results are
                # never gathered and cancel_all below fails their requests
                break
            # layer boundary: admit late arrivals (all models, rotating)
            # until every queue is empty or every inflight slot is filled —
            # a single admit per iteration would fill free capacity one
            # layer-round late
            while sched.admit() is not None:
                pass
            # re-pack equal-depth fragments into full buckets (batches with
            # a round in flight are skipped — their state is mid-round)
            for name, merges in sched.coalesce().items():
                self.metrics.count_coalesced(name, merges)
            # dispatch phase: fill the window with fair-share picks, each
            # pick one layer round, so batch B's workers start before
            # batch A's collect
            while len(rounds) < self.pipeline_depth:
                picked = sched.next_batch()
                if picked is None:
                    break
                name, batch = picked
                state = self.models.get(name)
                if state is None:  # unregistered between pick and dispatch:
                    break          # its requests were cancelled by the
                                   # fence; re-snapshot from the loop top
                if not rounds:
                    busy_t0 = time.perf_counter()
                self._stamp_start(batch)
                if self.execution == "direct":
                    try:
                        self._advance(state, batch)
                    except Exception as err:  # degraded cluster etc.
                        self._fail_batch(name, batch, err)
                    break  # synchronous: back to admission, like depth 1
                t0 = time.perf_counter()
                try:
                    rnd = self.cluster.dispatch_pipeline_layer(
                        batch.layer_idx, batch.x, name
                    )
                except Exception as err:  # encode/submit failed
                    self._fail_batch(name, batch, err)
                    continue
                batch.dispatched = True
                rounds.append(_InFlightRound(
                    state, batch, rnd, time.perf_counter() - t0
                ))
                self.metrics.note_depth(len(rounds))
            if not rounds:
                if not self._stop.is_set():
                    with sched.not_empty:
                        if not sched.queued() and not self._stop.is_set():
                            sched.not_empty.wait(self._poll_interval_s)
                continue
            ent = self._poll_rounds(
                rounds, can_dispatch=len(rounds) < self.pipeline_depth
            )
            if ent is None:
                continue  # new dispatchable work, or stop without drain
            self._finish_round(ent)
            if not rounds:
                self.metrics.note_busy(time.perf_counter() - busy_t0)
        if not self._drain:
            self.scheduler.cancel_all(RuntimeError("server shut down"))

    def _stamp_start(self, batch: ScheduledBatch) -> None:
        """Queue-wait ends here: stamp ``start_t`` on every request seeing
        its first dispatch (later rounds of the same batch, and rows merged
        in by coalescing after their own first dispatch, keep theirs)."""
        now = time.perf_counter()
        for r in batch.requests:
            if np.isnan(r.start_t):
                r.start_t = now

    def _fail_batch(self, name: str, batch: ScheduledBatch,
                    err: BaseException) -> None:
        self.scheduler.retire(name, batch)
        for req in batch.requests:
            req.finish(error=err)

    def _poll_rounds(self, rounds: list, can_dispatch: bool):
        """Reap whichever in-flight round is ready first (removed from
        ``rounds`` and returned) — NOT FIFO: under mixed models/straggler
        draws a younger round can land before an older one.  Returns None
        to hand control back to the dispatch phase: a free window slot has
        dispatchable work, or shutdown-without-drain sheds the window.
        Waits on ``not_empty`` with exponential backoff so new submits
        interrupt the sleep immediately."""
        sched = self.scheduler
        wait_s = self._REAP_POLL_MIN_S
        while True:
            for k, ent in enumerate(rounds):
                if self.cluster.round_ready(ent.rnd):
                    return rounds.pop(k)
            if self._stop.is_set() and not self._drain:
                return None
            if can_dispatch and sched.dispatchable():
                return None
            with sched.not_empty:
                sched.not_empty.wait(wait_s)
            wait_s = min(wait_s * 2.0, self._poll_interval_s)

    def _finish_round(self, ent: "_InFlightRound") -> None:
        """The collect half of one pipelined round: gather + decode (or the
        fused transition), advance the batch one boundary, account the
        phase timings, and complete the batch when it ran its last layer.

        Everything is resolved through the ``PendingRound`` (pipeline
        captured at dispatch), so a model unregistered mid-flight still
        finishes cleanly — its requests were already cancelled by the
        fence, ``finish`` is first-writer-wins, and retire tolerates the
        missing scheduler."""
        state, batch, pipe = ent.state, ent.batch, ent.rnd.pipe
        t0 = time.perf_counter()
        try:
            y, timing = self.cluster.collect_pipeline_layer(ent.rnd)
        except Exception as err:  # degraded cluster etc: fail the batch
            self._fail_batch(state.name, batch, err)
            return
        t_reap = time.perf_counter() - t0
        batch.x = y
        batch.timings.append(timing)
        batch.layer_idx += 1
        # partition-resident pipelines carry coded shares between rounds —
        # the request batch sits on axis 2 of (n, ell_a, B, C, h_hat, Wp)
        # until the final merge, and coalescing/padding must slice that axis
        batch.batch_axis = (
            2 if pipe.fuse_transitions
            and 0 < batch.layer_idx < len(pipe.specs) else 0
        )
        batch.dispatched = False
        self.metrics.record_phases(
            state.name,
            dispatch_s=ent.dispatch_s,
            worker_s=timing.compute_s,
            collect_s=max(t_reap - timing.decode_s, 0.0),
            transition_s=timing.decode_s,
        )
        if batch.layer_idx >= len(pipe.specs):
            self._complete(state, batch)

    def _advance(self, state: _ModelState, batch: ScheduledBatch) -> None:
        """Direct execution: run one batch through the whole prepared stack
        (cluster execution advances batches round by round through
        ``_finish_round`` instead)."""
        pipe = state.pipeline
        batch.x = pipe.run_prepared(batch.x, self._direct_plan(state))
        _sync(pipe.device)
        batch.layer_idx = len(pipe.specs)
        self._complete(state, batch)

    def _complete(self, state: _ModelState, batch: ScheduledBatch) -> None:
        self.scheduler.retire(state.name, batch)
        y = batch.x.detach().cpu().numpy()
        for row, req in enumerate(batch.requests):
            req.finish(result=y[row])
            if req.error is not None:
                # a shutdown-timeout cancellation won the finish race: the
                # caller saw the error, so this request was not served —
                # keep it out of the served-request metrics
                continue
            self.metrics.record(RequestRecord(
                request_id=req.request_id,
                arrival_t=req.arrival_t,
                start_t=req.start_t,
                finish_t=req.finish_t,
                bucket=batch.bucket,
                batch_real=batch.real,
                model=state.name,
            ))

    # -- direct-mode survivor pre-pick ---------------------------------------
    def _direct_plan(self, state: _ModelState):
        """The ``prepare`` plan over pre-picked survivors: dead workers
        excluded, remaining sorted by injected delay (fastest first) so each
        layer decodes from the delta best.  Cached per model — every batch
        reuses it until the straggler model changes, or until the resident
        pipeline under this name is replaced (the cache holds the pipeline
        reference itself and compares by identity — not ``id()``, whose
        values CPython reuses after GC — so a plan prepared against old
        encode/decode matrices can never serve the replacement)."""
        delays = self.cluster.straggler.delays
        pipe = state.pipeline
        key = tuple(np.asarray(delays).tolist())
        if (state.prepared is None or state.prepared[0] is not pipe
                or state.prepared[1] != key):
            alive = [i for i in range(self.cluster.n)
                     if np.isfinite(delays[i])]
            alive.sort(key=lambda i: (delays[i], i))
            state.prepared = (pipe, key, pipe.prepare(alive))
        return state.prepared[2]
