"""Master/worker cluster for FCDCC.

Mirrors the paper's mpi4py methodology on one host: n coded workers,
per-worker injected delays (``sleep()``-style stragglers, as in Experiment
4) and hard failures.  The master collects the fastest delta results and
decodes immediately; later arrivals are discarded, like the paper's
asynchronous collection.  Workers run behind the pool seam of
``devicepool``: ``pool="threads"`` (one thread and, on the card, one CUDA
stream per worker) or ``pool="device"`` (each worker pinned to a device
with a stream of its own, dispatched from the master and reaped by CUDA
events, filter shards resident per worker).

The cluster is persistent: pipelines loaded with ``load_pipeline`` keep
their coded filters resident, and the worker pool lives across calls, so a
straggler still busy with a discarded subtask backpressures only its own
node.  Pipelines are registered by model name, and every round runs
against its own pipeline's filters, so several models share one pool
without ever serving each other's filters.  A pipeline is a
``CodedPipeline`` (ConvL rounds) or a ``CodedDecoderPipeline`` (the coded
GEMM rounds of LM decode): the seam reads only the surface both expose
(``n``, ``device``, ``specs``, ``layers``, ``coded_filters``,
``fuse_transitions``, ``encoder``, ``_cluster_programs``,
``decode_operand``, ``decoder_fn``), so one pool serves both families.

  * ``run_layer`` — one FCDCC ConvL as a master/worker round, its filters
    encoded now, preloaded (``preload_filters``) or passed in coded;
    ``run_layer_elastic`` re-plans with a smaller (k_a, k_b) grid when more
    than gamma workers fail, and retries.
  * ``submit`` / ``collect`` — the asynchronous master: dispatch n coded
    subtasks without blocking, reap the fastest delta later.
  * ``dispatch_pipeline_layer`` / ``round_ready`` /
    ``collect_pipeline_layer`` — one pipeline layer split into its send
    and reap halves, so the serving engine keeps several rounds in flight;
    ``run_pipeline_layer`` / ``run_pipeline`` run them back to back.

Compiled programs: on a CUDA device the pipeline rounds run as CUDA graphs
(``core/graphs.py``), the counterpart of the reference's ``jax.jit``, as
each pipeline's ``graphs`` switch says.  The master's encoder, transition
and CNN decoder replay from the pipeline's ``master_graphs`` (on both
pools; the LM decoder stays eager, since K3 takes its survivor inverse by
value).  Worker rounds run eagerly unless the pipeline asks for worker
graphs too (``set_graphs(..., workers=True)``): then, under
``pool="device"``, each worker's round replays from its own graph set,
with the layer's filter shards resident under the slot
``"{model}/{layer}"``.  Captures happen in ``_warm``, outside the timed
collects; loading or unloading a model drops its worker graphs.
``run_layer`` runs eagerly: its filters may be encoded per call.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from ..core.fcdcc import CodedConv2d, FcdccPlan, check_backend
from ..core.graphs import graph_class
from ..core.partition import ConvGeometry
from ..core.pipeline import CodedPipeline, Program
from ..devices import resolve_device
from .devicepool import (
    ClusterDegraded,
    PendingBatch,
    StragglerModel,
    make_pool,
    resolve_pool,
)

__all__ = ["FcdccCluster", "LayerTiming", "PendingRound", "run_layer_elastic"]


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
    """n workers executing coded conv subtasks behind the pool seam, with
    the master on one device (``cuda`` unless the caller asks for the
    CPU).

    Persistent state across calls: worker programs (keyed by the
    worker-program signature; per device under ``pool="device"``),
    per-layer ``CodedConv2d`` instances, and resident coded filters (from
    ``preload_filters`` or ``load_pipeline``; per-worker shards under the
    device pool)."""

    def __init__(self, plan: FcdccPlan, straggler: StragglerModel | None = None,
                 mode: str = "threads", backend: str = "kernel",
                 pool: str | None = None, devices=None,
                 device: str | torch.device = "cuda"):
        assert mode in ("threads", "simulated")
        self.plan = plan
        self.straggler = straggler or StragglerModel.none(plan.n)
        self.mode = mode
        self.backend = check_backend(backend)
        self.device = resolve_device(device)
        # None picks the device pool where there is real parallelism
        self.pool = resolve_pool(pool, mode, devices)
        self._devices = devices
        # one reentrant lock over pool creation and every persistent cache:
        # the engine thread and caller threads (load/unload/preload) hit
        # these concurrently, and the lazy pool build must not run twice
        self._registry_lock = threading.RLock()
        self._pool_obj = None  # guarded-by: self._registry_lock
        self._coded_layers: dict[tuple, CodedConv2d] = {}  # guarded-by: self._registry_lock
        self._programs: dict[tuple, object] = {}  # guarded-by: self._registry_lock
        # resident coded filters, one entry per layer name: (filter-code
        # key, coded filters, source); pipeline layers live under
        # "model/layer" keys so two models never collide
        self._resident: dict[str, tuple] = {}  # guarded-by: self._registry_lock
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
                                           mode=self.mode, device=self.device,
                                           devices=self._devices)
            return self._pool_obj

    @property
    def worker_devices(self) -> list | None:
        """Per-worker device pinning (device pool), else None."""
        impl = self._pool_impl()
        return list(impl.devices) if impl.kind == "device" else None

    @property
    def _pools(self):
        """The thread pool's executors (None for the device pool, before
        first dispatch or after shutdown)."""
        impl = self._pool_obj
        return impl._pools if impl is not None and impl.kind == "threads" \
            else None

    def _ensure_pools(self):
        """Materialise the thread pool's executors."""
        impl = self._pool_impl()
        if impl.kind != "threads":
            raise RuntimeError("cluster runs the device pool; no thread "
                               "executors to materialise")
        return impl._ensure_pools()

    def shutdown(self) -> None:
        """Release the worker pool (idempotent; re-created lazily).  The
        pool drops its programs (and their graphs), so every worker is
        warmed again on its next first sight."""
        with self._registry_lock:
            pool = self._pool_obj
            self._warmed.clear()
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

    # -- persistent program/filter caches ---------------------------------
    def coded_layer(self, geo: ConvGeometry, plan: FcdccPlan | None = None) -> CodedConv2d:
        plan = plan or self.plan
        key = (plan, geo)
        with self._registry_lock:
            layer = self._coded_layers.get(key)
            if layer is None:
                layer = self._coded_layers[key] = CodedConv2d(
                    plan, geo, backend=self.backend)
            return layer

    def worker_program(self, layer: CodedConv2d) -> Program:
        """The one-worker program on the master device, shared by layers
        with the same signature (the device pool keeps its own per-device
        twins, ``DeviceWorkerPool.program``)."""
        key = (layer.plan.ell_a, layer.plan.ell_b, layer.geo.stride)
        with self._registry_lock:
            fn = self._programs.get(key)
            if fn is None:
                fn = self._programs[key] = Program(layer.worker_compute)
            return fn

    @staticmethod
    def _filter_code_key(plan: FcdccPlan, geo: ConvGeometry) -> tuple:
        """The parts of (plan, geo) that determine ``encode_filters``: coded
        filters do not depend on the input size, so one preload serves any
        H/W/stride/padding."""
        return (plan, geo.in_channels, geo.out_channels,
                geo.kernel_h, geo.kernel_w)

    def _as_tensor(self, t) -> torch.Tensor:
        return torch.as_tensor(t, dtype=torch.float32, device=self.device)

    def preload_filters(self, name: str, geo: ConvGeometry, k,
                        plan: FcdccPlan | None = None) -> torch.Tensor:
        """Encode ``k`` once and keep the coded filters resident under
        ``name`` (the deployment case: filters pre-stored on workers)."""
        plan = plan or self.plan
        ke = self.coded_layer(geo, plan).encode_filters(self._as_tensor(k))
        _sync(self.device)
        with self._registry_lock:
            self._resident[name] = (self._filter_code_key(plan, geo), ke, k)
        return ke

    # -- pipeline registry --------------------------------------------------
    def load_pipeline(self, pipeline: CodedPipeline, name: str = "default") -> None:
        """Adopt a compiled ``CodedPipeline`` (or ``CodedDecoderPipeline``)
        under the model namespace ``name``: its coded filters (encoded
        exactly once, on this cluster's device) become resident as
        ``"{name}/{layer}"`` entries and, under the device pool, are
        scattered to their workers now, at load time, so the serving hot
        path never pays the placement.  Re-registering a name replaces its
        pipeline and every entry of the old one."""
        if pipeline.n != self.n:
            raise ValueError(f"pipeline targets n={pipeline.n}, cluster has n={self.n}")
        if pipeline.device != self.device:
            raise ValueError(f"pipeline lives on {pipeline.device}, cluster "
                             f"on {self.device}")
        prefix = f"{name}/"
        with self._registry_lock:
            for stale in [k for k in self._resident if k.startswith(prefix)]:
                del self._resident[stale]
            impl = self._pool_impl()
            impl.drop_filters(prefix)
            self._drop_warmed(prefix)
            self.pipelines[name] = pipeline
            for spec, ke in zip(pipeline.specs, pipeline.coded_filters):
                key = self._filter_code_key(spec.plan, spec.geo)
                self._resident[f"{name}/{spec.name}"] = (key, ke, pipeline)
                impl.resident_filters(f"{name}/{spec.name}", ke)

    def unload_pipeline(self, name: str) -> None:
        """Evict model ``name``: its registration, resident filters and
        (device pool) per-worker filter shards."""
        with self._registry_lock:
            if name not in self.pipelines:
                raise ValueError(
                    f"unknown model {name!r}; loaded: {sorted(self.pipelines)}")
            del self.pipelines[name]
            prefix = f"{name}/"
            for stale in [k for k in self._resident if k.startswith(prefix)]:
                del self._resident[stale]
            self._pool_impl().drop_filters(prefix)
            self._drop_warmed(prefix)

    def _drop_warmed(self, prefix: str) -> None:
        """Forget the warm-ups of the worker slots under ``prefix`` (their
        graphs went with ``drop_filters``), so a model loaded again under
        the name is warmed, and captured, again."""
        with self._registry_lock:
            self._warmed = {k for k in self._warmed
                            if not (isinstance(k[1], str)
                                    and k[1].startswith(prefix))}

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

    def _model_name(self, model: str | None, pipe) -> str:
        if model is not None:
            return model
        for nm, p in self.pipelines.items():
            if p is pipe:
                return nm
        return "default"

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
        canonical order keeps the decode bit-stable across pools and
        completion orders), gathered to the master device and stacked on
        its stream; discarded outputs never move."""
        impl = self._pool_impl()
        ids = sorted(results)[:delta]
        return ids, torch.stack([impl.gather(results[i]) for i in ids], dim=0)

    def _warm(self, impl, fn, xe, ke, wkey: tuple, slot=None) -> None:
        """Run the worker program once on first sight of these shapes (and
        ``slot``: the device pool captures each worker's graph here), so
        the timed collects measure steady state (never again after: it
        would run a whole discarded subtask)."""
        if wkey not in self._warmed:
            impl.warm(fn, xe, ke, slot)
            with self._registry_lock:
                self._warmed.add(wkey)

    # -- one ConvL ----------------------------------------------------------
    def run_layer(self, geo: ConvGeometry, x, k=None, *, coded_filters=None,
                  layer_name: str | None = None,
                  plan: FcdccPlan | None = None) -> tuple:
        """One FCDCC ConvL as a master/worker round; returns ``(y,
        LayerTiming)``.  ``x`` may be ``(C, H, W)`` or ``(B, C, H, W)``.
        Filters come from, in priority order: ``coded_filters``
        (pre-encoded), the resident store under ``layer_name``, or ``k``
        (encoded now and, when ``layer_name`` is given, kept resident)."""
        plan = plan or self.plan
        layer = self.coded_layer(geo, plan)
        delta = plan.delta

        t0 = time.perf_counter()
        xe = layer.encode_inputs(self._as_tensor(x))
        ke = coded_filters
        code_key = self._filter_code_key(plan, geo)
        if ke is None and layer_name is not None:
            # a hit only under the same filter-code key and with no weights
            # or the very weights object the entry was built from: a plan
            # change or new weights under an old name re-encode instead of
            # decoding against filters coded with other matrices
            ent = self._resident.get(layer_name)
            if ent is not None and ent[0] == code_key and (k is None or ent[2] is k):
                ke = ent[1]
        if ke is None:
            if k is None:
                raise ValueError("need k, coded_filters, or resident layer_name")
            ke = layer.encode_filters(self._as_tensor(k))
            if layer_name is not None:
                with self._registry_lock:
                    self._resident[layer_name] = (code_key, ke, k)
        _sync(self.device)
        t_encode = time.perf_counter() - t0

        impl = self._pool_impl()
        pkey = (layer.plan.ell_a, layer.plan.ell_b, layer.geo.stride)
        fn = lambda i: impl.program(pkey, layer.worker_compute, i,  # noqa: E731
                                    self._programs)
        ke = impl.resident_filters(layer_name or "__layer", ke)
        self._warm(impl, fn, xe, ke,
                   (self.pool,) + pkey + (tuple(xe.shape), tuple(ke[0].shape)))
        results, worker_times, t_compute = self.collect(
            impl.submit(fn, xe, ke), delta)

        ids, outs = self._gather_outs(results, delta)
        t2 = time.perf_counter()
        y = layer.decode(ids, outs)
        _sync(self.device)
        t_decode = time.perf_counter() - t2
        return y, LayerTiming(t_encode, t_compute, t_decode, worker_times, ids,
                              layer_name or "")

    # -- whole network ------------------------------------------------------
    def dispatch_pipeline_layer(self, idx: int, x, model: str | None = None) -> PendingRound:
        """The send half of one pipeline-layer round: encode the batched
        input (or adopt the previous fused round's coded shares), warm the
        worker program on first sight of these shapes, and dispatch the n
        coded subtasks against the pipeline's resident filters.  Pipelining
        changes only the dispatch order; each round's arithmetic is
        untouched."""
        pipe = self.get_pipeline(model)
        spec = pipe.specs[idx]
        fused = pipe.fuse_transitions
        last = idx == len(pipe.specs) - 1
        # the pipeline's own filters, never a name-keyed lookup: a later
        # preload or run_layer under a colliding name must not swap in
        # foreign filters under this pipeline's decode
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
        compute = pipe.layers[idx].worker_compute
        slot, kw = None, {}
        if impl.kind == "device":
            # the layer's resident filter shards: the worker graphs' slot
            slot = f"{self._model_name(model, pipe)}/{spec.name}"
            ke = impl.resident_filters(slot, ke)
            if pipe.worker_graphs:
                kw["graph_cls"] = graph_class(pipe.graphs, self.device)
        fn = lambda i: impl.program(spec.program_key, compute, i,  # noqa: E731
                                    pipe._cluster_programs, **kw)
        self._warm(impl, fn, xe, ke, (self.pool, slot, spec.program_key,
                                      kw.get("graph_cls"), tuple(xe.shape),
                                      tuple(ke[0].shape)),
                   slot)
        pending = impl.submit(fn, xe, ke, slot)
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
                outs, d, pipe.encode_columns_all(rnd.idx + 1), slot=rnd.idx)
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


def run_layer_elastic(plan: FcdccPlan, geo: ConvGeometry, x, k,
                      straggler: StragglerModel, mode: str = "simulated",
                      max_retries: int = 2, pool: str | None = None,
                      devices=None, *, backend: str = "kernel",
                      device: str | torch.device = "cuda"):
    """Elastic recovery: on ``ClusterDegraded``, shrink the subtask grid
    (halve k_a or k_b: a smaller delta) and retry on the surviving
    workers.  ``pool``/``devices`` select the worker pool of every attempt.
    Returns ``(y, LayerTiming, the plan that served)``."""
    attempt_plan = plan
    for _ in range(max_retries + 1):
        # context-managed: each attempt's pool is released on exit
        with FcdccCluster(attempt_plan, straggler, mode=mode, backend=backend,
                          pool=pool, devices=devices, device=device) as cluster:
            try:
                y, timing = cluster.run_layer(geo, x, k)
                return y, timing, attempt_plan
            except ClusterDegraded:
                k_a, k_b = attempt_plan.k_a, attempt_plan.k_b
                if k_a >= k_b and k_a > 1:
                    k_a = max(k_a // 2, 1)
                elif k_b > 1:
                    k_b = max(k_b // 2, 1)
                else:
                    raise
                attempt_plan = FcdccPlan(n=plan.n, k_a=k_a, k_b=k_b)
    raise ClusterDegraded("elastic retries exhausted")
