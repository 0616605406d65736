"""Master/worker cluster for FCDCC.

Mirrors the paper's mpi4py methodology on one host: n coded workers,
per-worker injected delays (``sleep()``-style stragglers, as in Experiment
4) and hard failures.  The master collects the fastest delta results and
decodes immediately; later arrivals are discarded, like the paper's
asynchronous collection.  Workers run behind the pool seam of
``devicepool`` (one thread and, on the card, one CUDA stream per worker).

The cluster is persistent: pipelines loaded with ``load_pipeline`` keep
their coded filters resident, and the worker pool lives across calls, so a
straggler still busy with a discarded subtask backpressures only its own
node.  Pipelines are registered by model name, and every round runs
against its own pipeline's filters, so several models share one pool
without ever serving each other's filters.  A pipeline is a
``CodedPipeline`` (ConvL rounds) or a ``CodedDecoderPipeline`` (the coded
GEMM rounds of LM decode): the seam reads only the surface both expose
(``n``, ``device``, ``specs``, ``coded_filters``, ``fuse_transitions``,
``encoder``, ``worker_program``, ``decode_operand``, ``decoder_fn``),
so one pool serves both families.

  * ``submit`` / ``collect`` — the asynchronous master: dispatch n coded
    subtasks without blocking, reap the fastest delta later.
  * ``dispatch_pipeline_layer`` / ``round_ready`` /
    ``collect_pipeline_layer`` — one pipeline layer split into its send
    and reap halves, so the serving engine keeps several rounds in flight;
    ``run_pipeline_layer`` / ``run_pipeline`` run them back to back.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from ..core.fcdcc import FcdccPlan, check_backend
from ..core.pipeline import CodedPipeline
from ..devices import resolve_device
from .devicepool import (
    ClusterDegraded,
    PendingBatch,
    StragglerModel,
    make_pool,
    resolve_pool,
)

__all__ = ["FcdccCluster", "LayerTiming", "PendingRound"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclasses.dataclass
class LayerTiming:
    encode_s: float
    compute_s: float  # master-visible completion time of the delta-th result
    decode_s: float
    # per-worker seconds: finite = measured, inf = dead worker, nan =
    # discarded before finishing (aggregate with ``finished_worker_s``)
    worker_compute_s: list
    used_workers: list
    name: str = ""

    @property
    def total_s(self):
        return self.encode_s + self.compute_s + self.decode_s

    @property
    def finished_worker_s(self) -> list:
        """Times of workers that actually finished."""
        return [t for t in self.worker_compute_s if np.isfinite(t)]


@dataclasses.dataclass
class PendingRound:
    """One dispatched pipeline-layer round awaiting its collect half.  It
    holds the pipeline object itself, so finishing a round stays safe even
    if the model is unloaded between dispatch and collect."""

    idx: int
    pipe: CodedPipeline  # or a CodedDecoderPipeline
    spec: object  # the layer's CodedLayerSpec / GemmRoundSpec
    pending: PendingBatch
    t_encode: float
    fused_mid: bool  # fused pipeline, non-final layer: transition, no decode


class FcdccCluster:
    """n workers executing coded conv subtasks behind the pool seam, on one
    device (``cuda`` unless the caller asks for the CPU)."""

    def __init__(self, plan: FcdccPlan, straggler: StragglerModel | None = None,
                 mode: str = "threads", backend: str = "kernel",
                 pool: str | None = None, device: str | torch.device = "cuda"):
        assert mode in ("threads", "simulated")
        self.plan = plan
        self.straggler = straggler or StragglerModel.none(plan.n)
        self.mode = mode
        self.backend = check_backend(backend)
        self.device = resolve_device(device)
        self.pool = resolve_pool(pool, mode)
        # one reentrant lock over pool creation and every persistent cache:
        # the engine thread and caller threads (load/unload) hit these
        # concurrently, and the lazy pool build must not run twice
        self._registry_lock = threading.RLock()
        self._pool_obj = None  # guarded-by: self._registry_lock
        # registered pipelines by model name (insertion-ordered: the first
        # one is the default for single-model callers)
        self.pipelines: dict[str, CodedPipeline] = {}  # guarded-by: self._registry_lock
        # worker-program signatures already run once outside a timed collect
        self._warmed: set[tuple] = set()  # guarded-by: self._registry_lock

    @property
    def n(self) -> int:
        return self.plan.n

    # -- persistent worker pool --------------------------------------------
    def _pool_impl(self):
        with self._registry_lock:
            if self._pool_obj is None:
                self._pool_obj = make_pool(self.pool, self.n, self.straggler,
                                           mode=self.mode, device=self.device)
            return self._pool_obj

    @property
    def _pools(self):
        """The pool's executors (None before first dispatch / after
        shutdown)."""
        impl = self._pool_obj
        return impl._pools if impl is not None else None

    def shutdown(self) -> None:
        """Release the worker pool (idempotent; re-created lazily)."""
        with self._registry_lock:
            pool = self._pool_obj
        if pool is not None:
            pool.shutdown()

    def __del__(self):  # best-effort: interpreter teardown may race us
        try:
            self.shutdown()
        except Exception:
            pass

    def __enter__(self) -> "FcdccCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- pipeline registry --------------------------------------------------
    def load_pipeline(self, pipeline: CodedPipeline, name: str = "default") -> None:
        """Adopt a compiled ``CodedPipeline`` (or ``CodedDecoderPipeline``)
        under the model namespace ``name``; its coded filters (encoded
        exactly once, on this cluster's device) are what every round of the
        model runs against.
        Re-registering a name replaces its pipeline."""
        if pipeline.n != self.n:
            raise ValueError(f"pipeline targets n={pipeline.n}, cluster has n={self.n}")
        if pipeline.device != self.device:
            raise ValueError(f"pipeline lives on {pipeline.device}, cluster "
                             f"on {self.device}")
        with self._registry_lock:
            self.pipelines[name] = pipeline

    def unload_pipeline(self, name: str) -> None:
        """Evict model ``name`` (its filters go with its pipeline)."""
        with self._registry_lock:
            if name not in self.pipelines:
                raise ValueError(
                    f"unknown model {name!r}; loaded: {sorted(self.pipelines)}")
            del self.pipelines[name]

    @property
    def pipeline(self) -> CodedPipeline | None:
        """The default (first-registered) pipeline, or None."""
        return next(iter(self.pipelines.values()), None)

    def get_pipeline(self, model: str | None = None) -> CodedPipeline:
        """Resolve a registered pipeline; ``model=None`` means "the only
        one" (an error once several models are loaded)."""
        if not self.pipelines:
            raise ValueError("no pipeline loaded; call load_pipeline() first")
        if model is None:
            if len(self.pipelines) > 1:
                raise ValueError(
                    f"{len(self.pipelines)} pipelines loaded "
                    f"({sorted(self.pipelines)}); pass model=")
            return next(iter(self.pipelines.values()))
        try:
            return self.pipelines[model]
        except KeyError:
            raise ValueError(
                f"unknown model {model!r}; loaded: {sorted(self.pipelines)}"
            ) from None

    # -- fastest-delta collection ------------------------------------------
    def submit(self, compute_one, xe, ke) -> PendingBatch:
        """Dispatch n coded subtasks without waiting (the master's send
        phase).  ``worker_times`` starts as inf for dead workers and nan for
        live ones; a worker overwrites its slot only when it finishes."""
        return self._pool_impl().submit(lambda i: compute_one, xe, ke)

    def collect(self, pending: PendingBatch, delta: int, *, block: bool = True):
        """Reap the fastest ``delta`` results of a ``submit``; returns
        ``(results, worker_times, t_compute)`` (``worker_times`` a
        snapshot).  ``block=False`` returns None when the round is not
        ready yet."""
        impl = self._pool_impl()
        if not block and not impl.ready(pending, delta):
            return None
        results, worker_times, t_compute = impl.collect(pending, delta)
        if len(results) < delta:
            raise ClusterDegraded(
                f"only {len(results)} of delta={delta} results; "
                f"gamma={self.n - delta} exceeded")
        return results, worker_times, t_compute

    def _gather_outs(self, results: dict, delta: int):
        """The fastest delta worker outputs, sorted by worker id (a
        canonical order keeps the decode bit-stable across completion
        orders), stacked on the master's stream.  A worker output was
        allocated on its worker's stream; ``record_stream`` keeps the
        allocator from handing its memory to that stream's next subtask
        before the master's reads of it have run."""
        ids = sorted(results)[:delta]
        outs = [results[i] for i in ids]
        if self.device.type == "cuda":
            master = torch.cuda.current_stream(self.device)
            for o in outs:
                o.record_stream(master)
        return ids, torch.stack(outs, dim=0)

    # -- whole network ------------------------------------------------------
    def dispatch_pipeline_layer(self, idx: int, x, model: str | None = None) -> PendingRound:
        """The send half of one pipeline-layer round: encode the batched
        input (or adopt the previous fused round's coded shares), warm the
        worker program on first sight of these shapes, and dispatch the n
        coded subtasks.  Pipelining changes only the dispatch order; each
        round's arithmetic is untouched."""
        pipe = self.get_pipeline(model)
        spec = pipe.specs[idx]
        fused = pipe.fuse_transitions
        last = idx == len(pipe.specs) - 1
        # the pipeline's own filters, never a name-keyed lookup
        ke = pipe.coded_filters[idx]

        t0 = time.perf_counter()
        if fused and idx > 0:
            xe = x  # coded shares from the previous round's transition
            t_encode = 0.0
        else:
            xe = pipe.encoder(idx)(x)
            _sync(self.device)
            t_encode = time.perf_counter() - t0

        impl = self._pool_impl()
        program = pipe.worker_program(idx, over_workers=False)
        fn = lambda i: program  # noqa: E731  (every worker runs the same program)
        wkey = (self.pool, spec.program_key, tuple(xe.shape), tuple(ke[0].shape))
        if wkey not in self._warmed:
            impl.warm(fn, xe, ke)
            with self._registry_lock:
                self._warmed.add(wkey)
        pending = impl.submit(fn, xe, ke)
        return PendingRound(idx, pipe, spec, pending, t_encode,
                            fused_mid=fused and not last)

    def round_ready(self, rnd: PendingRound) -> bool:
        """Non-blocking: would ``collect_pipeline_layer(rnd)`` return
        without waiting on the pool?"""
        return self._pool_impl().ready(rnd.pending, rnd.spec.plan.delta)

    def collect_pipeline_layer(self, rnd: PendingRound) -> tuple:
        """The reap half: keep the fastest delta of the round, then decode
        (+ relu + pool for a ConvL; the fused partition-resident transition,
        which re-encodes for all n workers; or the plain column-block decode
        of an LM GEMM round).  Returns ``(y, LayerTiming)``."""
        pipe, spec = rnd.pipe, rnd.spec
        delta = spec.plan.delta
        results, worker_times, t_compute = self.collect(rnd.pending, delta)

        ids, outs = self._gather_outs(results, delta)
        t2 = time.perf_counter()
        d = pipe.decode_operand(rnd.idx, tuple(ids))
        if rnd.fused_mid:
            y = pipe.transition_fn(rnd.idx)(
                outs, d, pipe.encode_columns_all(rnd.idx + 1))
        else:
            y = pipe.decoder_fn(rnd.idx)(outs, d)
        _sync(self.device)
        t_decode = time.perf_counter() - t2
        return y, LayerTiming(rnd.t_encode, t_compute, t_decode, worker_times,
                              ids, spec.name)

    def run_pipeline_layer(self, idx: int, x, model: str | None = None) -> tuple:
        """One ConvL of a loaded pipeline as a full master/worker round.
        With a ``fuse_transitions`` pipeline, every non-final round returns
        the next layer's coded input shares ``(n, ell_a, B, C, h_hat, Wp)``
        and only the final round merges to the full tensor."""
        return self.collect_pipeline_layer(
            self.dispatch_pipeline_layer(idx, x, model))

    def run_pipeline(self, x, pipeline: CodedPipeline | None = None,
                     model: str | None = None) -> tuple:
        """Stream a batched ``(B, C, H, W)`` input (or one image) through
        every ConvL of a loaded pipeline.  Returns ``(y, [LayerTiming])``."""
        if pipeline is not None:
            model = model if model is not None else "default"
            self.load_pipeline(pipeline, model)
        pipe = self.get_pipeline(model)
        x = pipe._as_input(x)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        timings = []
        for idx in range(len(pipe.specs)):
            x, timing = self.run_pipeline_layer(idx, x, model)
            timings.append(timing)
        return (x[0] if squeeze else x), timings
