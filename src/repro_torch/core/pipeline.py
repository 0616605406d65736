"""Batched multi-layer coded inference engine: the ``CodedPipeline``.

The paper's deployment model (Sec. IV, Fig. 1) pre-stores coded filters on
the workers and streams a whole CNN's ConvL stack through the coded
cluster:

  * ``plan_layers``   — compile a ConvL stack (LeNet-5 / AlexNet / VGG-16
    descriptors from ``repro_torch.models.cnn``) into ``CodedLayerSpec``s,
    choosing per-layer ``(k_a, k_b)`` via the Sec. IV-E cost model unless
    pinned by the caller.
  * ``CodedPipeline`` — encodes every layer's filters exactly once at
    construction (the resident coded-filter store), keeps one worker
    program per worker-program signature, and runs decode -> relu -> pool
    -> re-encode between layers for batched ``(B, C, H, W)`` inputs.

Programs are held in dicts keyed like the reference's jit caches; each
``Program`` records the argument shapes it has seen, so the bounded-program
contract (at most geometries x buckets shape signatures) is checked the
same way the reference counts jit traces.  On a CUDA device the master's
programs (encoder, transition, decoder) run as CUDA graphs of the
pipeline's ``master_graphs`` (``core/graphs.py``), captured once per
(program, signature, slot) and replayed — the counterpart of the
reference's ``jax.jit``; ``graphs=False`` runs them op by op.  The
device pool's worker rounds run eagerly unless ``set_graphs(...,
workers=True)`` asks for worker graphs too: a worker program is one K1
launch, and its graph's copy-in and clone-out cost the master more than
the launch it replaces.
``CodedPipeline.program_space`` enumerates every program cell the pipeline
can launch, as ``ProgramCell``s whose arguments are ``ArgSpec``s, for the
analysis gate (``repro_torch.analysis``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from ..devices import resolve_device
from ..kernels.conv2d.ops import coded_transition, transition_gemms
from .cost import CostWeights, optimal_partition
from .crme import recovery_matrix
from .fcdcc import CodedConv2d, FcdccPlan, check_backend
from .graphs import GraphSet, owner_graphs, signature
from .nsctc import encode_tensor_list, group_by_worker
from .partition import ConvGeometry, merge_output, partition_transition

__all__ = [
    "ArgSpec",
    "CodedLayerSpec",
    "CodedPipeline",
    "Program",
    "ProgramCell",
    "dtype_name",
    "plan_layers",
    "build_cnn_pipeline",
    "relu_pool",
]


class Program:
    """One program of the pipeline: ``fn`` plus the record of the tensor
    argument shapes and dtypes it was called with (the port's count of
    specialised programs, what the reference counts as jit traces).

    With ``graphs`` (its owner's ``GraphSet``) a call replays the
    program's CUDA graph for this signature and ``slot``, captured on
    first sight (``core/graphs.py``): the counterpart of the reference's
    ``jax.jit`` executable.  ``resident`` are the argument indices used in
    place by the graph (never copied per replay); ``writes`` those of them
    that ``fn`` writes in place (a recurrent state, an optimizer's), which
    the capture restores after running ``fn``, so that a call advances
    them once.  Without ``graphs``, and always through ``eager``, it calls
    ``fn`` op by op."""

    def __init__(self, fn, *, name: str = "program", resident: tuple = (),
                 writes: tuple = (), graphs: GraphSet | None = None):
        if not set(writes) <= set(resident):
            raise ValueError(f"{name}: writes {sorted(writes)} are not all "
                             f"resident {sorted(resident)}")
        self.fn = fn
        self.name = name
        self.resident = tuple(resident)
        self.writes = tuple(writes)
        self.graphs = graphs
        self.signatures: set[tuple] = set()

    @property
    def captures(self) -> int:
        """Graphs of this program its owner holds."""
        return 0 if self.graphs is None else self.graphs.captures_of(self)

    def eager(self, *args):
        # set.add of a hashable is atomic under the GIL; worker threads call
        # the one shared cluster program concurrently
        self.signatures.add(signature(args))
        return self.fn(*args)

    def __call__(self, *args, slot=None):
        if self.graphs is None:
            return self.eager(*args)
        sig = signature(args)
        self.signatures.add(sig)
        return self.graphs.run(self, args, slot, sig)


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``: the reference's dtype names."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """One argument of a program cell in shape space: what a checker
    materialises on a device, from an explicit ``torch.Generator``, to run
    the cell (the counterpart of the reference's ``ShapeDtypeStruct``).

    ``role`` says what values the argument takes: ``data`` (any),
    ``index`` (integers in ``[0, high)``), ``decode`` (the decode operand of
    a survivor subset of round ``layer``), ``encode`` (the encode columns of
    a survivor subset of layer ``layer``), ``encode_all`` (layer ``layer``'s
    full-n encode columns).  ``host``: the argument stays on the host (the
    LM decode inverse, which K3 takes by value)."""

    shape: tuple
    dtype: torch.dtype
    role: str = "data"
    layer: int = 0
    high: int | None = None
    host: bool = False


@dataclasses.dataclass(frozen=True)
class ProgramCell:
    """One (program, argument-shape) cell of a pipeline's shape space.

    ``program_space`` enumerates every cell the pipeline can ever launch —
    per execution mode, layer, and batch bucket — as ``ArgSpec`` arguments
    plus the program, so the analysis gate (``repro_torch.analysis``) can
    run, record and capture each one.

    ``kind``: ``encoder`` / ``worker`` / ``transition`` / ``decoder`` (and
    ``glue`` on the LM decoder).  ``mode``: ``direct`` (single-process path)
    or ``cluster`` (per-worker runtime path); ``master`` for glue.
    ``cache_key``: the pipeline-side program-cache key; cells sharing
    (kind, mode, cache_key) and an argument signature share one program
    specialisation, which is what the bounded-trace proof counts.
    ``allowed_const_shapes``: shapes a constant the program reads may
    legitimately take (the cluster encoder reads the full-n A-code matrix:
    subset-independent, so it cannot mint a specialisation).
    ``donate_argnums``: always ``()``; torch has no buffer donation.
    ``eager_only``: why the cell cannot be replayed from a CUDA-graph
    capture (empty when it can).
    """

    cell_id: str
    kind: str
    mode: str
    layer: int
    bucket: int
    cache_key: tuple
    fn: object
    args: tuple
    allowed_const_shapes: tuple = ()
    donate_argnums: tuple = ()
    eager_only: str = ""

    @property
    def trace_signature(self) -> tuple:
        """What a program specialises on: its identity + argument shapes."""
        return (
            self.kind,
            self.mode,
            self.cache_key,
            tuple((tuple(a.shape), dtype_name(a.dtype)) for a in self.args),
        )


@dataclasses.dataclass(frozen=True)
class CodedLayerSpec:
    """One compiled ConvL of a coded pipeline (static plan + geometry)."""

    name: str
    plan: FcdccPlan
    geo: ConvGeometry
    pool: int = 1  # max-pool factor applied after relu

    @property
    def out_hw(self) -> int:
        """Spatial size seen by the next layer (after pooling)."""
        return self.geo.out_h // self.pool if self.pool > 1 else self.geo.out_h

    @property
    def program_key(self) -> tuple:
        """Worker-program signature: layers sharing it share one program."""
        return (self.plan.ell_a, self.plan.ell_b, self.geo.stride)


def relu_pool(y: torch.Tensor, pool: int) -> torch.Tensor:
    """ReLU then ``pool x pool`` max-pool on the trailing (H, W) dims."""
    y = torch.relu(y)
    if pool == 1:
        return y
    h, w = y.shape[-2:]
    h2, w2 = h - h % pool, w - w % pool
    y = y[..., :h2, :w2]
    return y.reshape(tuple(y.shape[:-2]) + (h2 // pool, pool, w2 // pool, pool)
                     ).amax(dim=(-3, -1))


def _choose_kab(geo0: ConvGeometry, q: int, n: int, weights: CostWeights):
    """Cost-optimal feasible (k_a, k_b) with k_a*k_b = q and delta <= n."""
    _, _, landscape = optimal_partition(geo0, q, weights)
    for kab, _cost in sorted(landscape.items(), key=lambda kv: kv[1]):
        try:
            FcdccPlan(n=n, k_a=kab[0], k_b=kab[1])
        except ValueError:
            continue
        return kab
    raise ValueError(f"no feasible (k_a, k_b) for q={q} on n={n} workers")


def plan_layers(
    layers: Iterable,
    input_hw: int,
    n: int,
    *,
    q: int | None = None,
    default_kab: tuple[int, int] | None = None,
    per_layer_kab: dict | None = None,
    weights: CostWeights = CostWeights(),
) -> list[CodedLayerSpec]:
    """Compile a ConvL stack into per-layer coded specs.

    ``layers``: descriptors with ``name/in_ch/out_ch/kernel/stride/padding/
    pool`` attributes.  Each layer's (k_a, k_b) comes from
    ``per_layer_kab[name]``, then ``default_kab``, then the cost-optimal
    feasible split of the ``q``-subtask budget (Sec. IV-E).
    """
    if q is None and default_kab is None:
        raise ValueError("need q (subtask budget) or default_kab")
    specs = []
    hw = input_hw
    for layer in layers:
        geo0 = ConvGeometry(
            in_channels=layer.in_ch, out_channels=layer.out_ch, height=hw,
            width=hw, kernel_h=layer.kernel, kernel_w=layer.kernel,
            stride=layer.stride, padding=layer.padding,
        )
        kab = (per_layer_kab or {}).get(layer.name, default_kab)
        if kab is None:
            kab = _choose_kab(geo0, q, n, weights)
        k_a, k_b = kab
        plan = FcdccPlan(n=n, k_a=k_a, k_b=k_b)
        geo = dataclasses.replace(geo0, k_a=k_a, k_b=k_b)
        spec = CodedLayerSpec(layer.name, plan, geo, getattr(layer, "pool", 1))
        specs.append(spec)
        hw = spec.out_hw
    return specs


class CodedPipeline:
    """A whole CNN ConvL stack compiled against one coded cluster.

    Construction encodes every layer's filters exactly once (asserted by
    ``filter_encode_calls``) onto ``device``; running feeds a
    ``(B, C, H, W)`` batch through encode -> coded worker convs -> decode
    -> relu -> pool per layer.  ``repro_torch.runtime.FcdccCluster`` runs
    the same specs and filters against straggling workers.
    """

    def __init__(self, specs: Sequence[CodedLayerSpec], params: dict, *,
                 backend: str = "kernel", fused_worker: bool = True,
                 bucket_sizes: Sequence[int] | None = None,
                 fuse_transitions: bool = False,
                 pool: str | None = None, devices=None,
                 device: str | torch.device = "cuda", graphs=True):
        specs = list(specs)
        if not specs:
            raise ValueError("empty pipeline")
        ns = {s.plan.n for s in specs}
        if len(ns) != 1:
            raise ValueError(f"all layers must target the same cluster, got n={ns}")
        self.specs = specs
        self.n = ns.pop()
        self.backend = check_backend(backend)
        self.device = resolve_device(device)
        # worker-pool preference (and the device pool's worker devices)
        # carried to the cluster / server that adopts this pipeline (None =
        # auto-select there)
        self.pool = pool
        self.devices = devices
        # partition-resident transitions: between ConvLs the activation is
        # decoded only to the (k_a, k_b) grid, relu+pool run per spatial
        # partition with halo exchange, and the partitions re-encode
        # directly; the final layer always merges
        self.fuse_transitions = fuse_transitions
        # batch-size buckets: callers pad request batches up to one of these
        # (``pad_to_bucket``) so the program set stays bounded
        self.bucket_sizes: tuple[int, ...] | None = (
            self.normalize_buckets(bucket_sizes) if bucket_sizes else None
        )
        self.layers = [
            CodedConv2d(s.plan, s.geo, backend=backend, fused_worker=fused_worker)
            for s in specs
        ]
        # resident coded filters: encoded exactly once, reused every run
        self.coded_filters = [
            layer.encode_filters(torch.as_tensor(params[s.name], device=self.device))
            for s, layer in zip(specs, self.layers)
        ]
        self.input_encode_calls = 0
        # program caches, keyed like the reference's ----------------------
        self._encoders: dict[int, Program] = {}
        self._cluster_programs: dict[tuple, Program] = {}  # filled by the cluster
        self._batch_programs: dict[tuple, Program] = {}  # looped over workers
        self._decoders: dict[int, Program] = {}  # one per layer, any subset
        self._transitions: dict[tuple, Program] = {}  # by transition key
        # full-n A-code encode columns, resident like the filters: built
        # here, so no program ever converts a host float64 matrix
        self._all_encode_columns = [self._on_device(layer.a_code.matrix)
                                    for layer in self.layers]
        # decode operands by (layer, survivors), fp32 on the device
        self._decode_memo: dict[tuple, torch.Tensor] = {}  # guarded-by: engine-thread
        # the master's compiled programs (None: eager), kept by class
        self._graph_sets: dict[type, GraphSet] = {}  # by graph class
        self.master_graphs: GraphSet | None = None
        self.worker_graphs = False
        self.set_graphs(graphs)

    def set_graphs(self, graphs, workers: bool | None = None) -> None:
        """Switch the master's programs between CUDA-graph replays
        (``True``, or a graph class) and eager calls (``False``); the
        graphs already captured are kept for a later switch back.
        ``workers`` (None: unchanged; off at construction) says whether
        the device pool's worker rounds replay graphs of the same class
        too.  The cluster and the servers read this switch; it is the
        only one."""
        if workers is not None:
            self.worker_graphs = bool(workers)
        self.graphs = graphs
        self.master_graphs = owner_graphs(self._graph_sets, graphs, self.device)
        for prog in self._master_programs():
            prog.graphs = self.master_graphs

    def _master_programs(self) -> list:
        return (list(self._encoders.values()) + list(self._decoders.values())
                + list(self._transitions.values()))

    @property
    def master_graph_bound(self) -> int:
        """Master graphs the cluster path can capture: per bucket, the
        encoders (layer 0 when fused, every layer when not), one transition
        per fused boundary (one graph per layer: its resident next-layer
        encode columns differ) and the decoders."""
        layers = len(self.specs)
        buckets = len(self.bucket_sizes) if self.bucket_sizes else 1
        per_bucket = (1 + (layers - 1) + 1 if self.fuse_transitions
                      else 2 * layers)
        return per_bucket * buckets

    @property
    def worker_graph_bound(self) -> int:
        """Graphs one device-pool worker can capture: one per (layer,
        bucket), each layer's coded filter shard resident."""
        buckets = len(self.bucket_sizes) if self.bucket_sizes else 1
        return len(self.specs) * buckets

    @staticmethod
    def normalize_buckets(bucket_sizes: Sequence[int]) -> tuple[int, ...]:
        """Sorted, deduplicated, validated bucket tuple."""
        buckets = tuple(sorted(set(int(b) for b in bucket_sizes)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {bucket_sizes}")
        return buckets

    # -- introspection -----------------------------------------------------
    @property
    def input_shape(self) -> tuple[int, int, int]:
        """Per-image ``(C, H, W)`` the first layer expects."""
        geo = self.specs[0].geo
        return (geo.in_channels, geo.height, geo.width)

    @property
    def input_dtype(self) -> torch.dtype:
        """Request dtype: everything is cast to the coded-filter dtype."""
        return self.coded_filters[0].dtype

    @property
    def num_geometries(self) -> int:
        """Distinct (program key, geometry) pairs."""
        return len({(s.program_key, s.geo) for s in self.specs})

    @staticmethod
    def _transition_key(spec: CodedLayerSpec, nxt: CodedLayerSpec) -> tuple:
        """Transition-program signature: everything the program closes over."""
        return (spec.geo, spec.pool, nxt.geo, nxt.plan.ell_a)

    @property
    def num_transitions(self) -> int:
        """Distinct fused transition signatures (zero when unfused)."""
        if not self.fuse_transitions:
            return 0
        return len({self._transition_key(s, n)
                    for s, n in zip(self.specs, self.specs[1:])})

    @property
    def transition_program_traces(self) -> int:
        """Shape signatures seen across the transition programs."""
        return sum(len(fn.signatures) for fn in self._transitions.values())

    @property
    def program_trace_bound(self) -> int:
        """The bounded-program contract under bucketing: worker plus
        transition shape signatures never exceed (worker geometries + fused
        transition geometries) x buckets."""
        buckets = len(self.bucket_sizes) if self.bucket_sizes else 1
        return (self.num_geometries + self.num_transitions) * buckets

    @property
    def filter_encode_calls(self) -> int:
        """Total ``encode_filters`` calls (== layers under encode-once)."""
        return sum(layer.filter_encode_calls for layer in self.layers)

    @property
    def num_worker_programs(self) -> int:
        """Distinct worker programs in use: the looped single-process cache
        and the per-worker cluster cache hold distinct programs even for
        the same program key, so both count."""
        return len(self._batch_programs) + len(self._cluster_programs)

    @property
    def worker_program_traces(self) -> int:
        """Shape signatures seen across the worker programs of both caches."""
        return sum(len(fn.signatures)
                   for cache in (self._batch_programs, self._cluster_programs)
                   for fn in cache.values())

    def layer_delta(self, idx: int) -> int:
        return self.specs[idx].plan.delta

    # -- batch-size bucketing ----------------------------------------------
    @property
    def max_batch(self) -> int | None:
        return self.bucket_sizes[-1] if self.bucket_sizes else None

    def bucketize(self, batch: int) -> int:
        """Smallest bucket >= ``batch`` (identity when unbucketed)."""
        if self.bucket_sizes is None:
            return batch
        for b in self.bucket_sizes:
            if b >= batch:
                return b
        raise ValueError(
            f"batch {batch} exceeds the largest bucket {self.bucket_sizes[-1]}")

    def pad_to_bucket(self, x: torch.Tensor, axis: int = 0) -> tuple[torch.Tensor, int]:
        """Zero-pad a batch up to its bucket size along ``axis`` (0 for the
        plain batch, 2 for mid-stack coded shares ``(n, ell_a, B, ...)``).
        Zero rows encode to zero shares, convolve to zero and stay zero
        through relu/pool/halo, so they ride the stack as dead weight.
        Returns ``(padded, real_batch)``."""
        b = x.shape[axis]
        bucket = self.bucketize(b)
        if bucket == b:
            return x, b
        pad_shape = tuple(x.shape[:axis]) + (bucket - b,) + tuple(x.shape[axis + 1:])
        return torch.cat([x, x.new_zeros(pad_shape)], dim=axis), b

    # -- program caches ----------------------------------------------------
    def _on_device(self, m) -> torch.Tensor:
        """A host float64 code matrix as a device tensor in the input dtype."""
        return torch.as_tensor(m, dtype=self.input_dtype, device=self.device)

    def encoder(self, idx: int) -> Program:
        """APCP+encode program for layer ``idx``, taking ``(x, matrix)``
        (``encode_inputs``).  The one-argument form, the cluster's, encodes
        all n workers' shares with the layer's resident full-n columns
        (``encode_columns_all``): no host matrix is copied to the device
        per call."""
        fn = self._encoders.get(idx)
        if fn is None:
            layer = self.layers[idx]

            def enc(x, matrix=None, _idx=idx):
                if matrix is None:
                    matrix = self.encode_columns_all(_idx)
                return layer.encode_inputs(x, matrix)

            fn = self._encoders[idx] = Program(enc, name="encoder",
                                               graphs=self.master_graphs)
        return fn

    def worker_program(self, idx: int, *, over_workers: bool = True) -> Program:
        """The coded worker program for layer ``idx``.

        ``over_workers=True``: over all selected workers (``(m, ell_a,
        ...)`` shares, the single-process path); ``False``: the one-worker
        program the cluster dispatches per worker (``_cluster_programs``,
        which the thread pool fills with the same programs).  Layers with
        the same ``program_key`` share one program."""
        key = self.specs[idx].program_key
        compute = self.layers[idx].worker_compute
        if not over_workers:
            fn = self._cluster_programs.get(key)
            if fn is None:
                fn = self._cluster_programs[key] = Program(compute,
                                                           name="worker")
            return fn
        fn = self._batch_programs.get(key)
        if fn is None:
            def compute_all(xe, ke, _compute=compute):
                return torch.stack([_compute(xe[j], ke[j])
                                    for j in range(xe.shape[0])])

            fn = self._batch_programs[key] = Program(compute_all, name="worker")
        return fn

    def encode_columns(self, idx: int, worker_ids: tuple[int, ...]) -> np.ndarray:
        """The A-code encoding columns of the selected workers (host numpy):
        encoding with them produces only those workers' shares."""
        code = self.layers[idx].a_code
        return np.concatenate([code.worker_columns(i) for i in worker_ids], axis=1)

    def encode_columns_all(self, idx: int) -> torch.Tensor:
        """The full-n A-code encode columns of layer ``idx`` as a resident
        device tensor (one per layer, built with the pipeline; the
        cluster's encoder and fused rounds encode for all n workers every
        round)."""
        return self._all_encode_columns[idx]

    def decode_matrix(self, idx: int, worker_ids: tuple[int, ...]) -> np.ndarray:
        """The QxQ decode inverse of layer ``idx`` for the surviving subset,
        in float64 on the host (callers cast it to the device dtype)."""
        layer = self.layers[idx]
        e = recovery_matrix(layer.a_code, layer.b_code, list(worker_ids))
        return np.linalg.inv(e.T)

    def decoder_fn(self, idx: int) -> Program:
        """The decode+merge+relu+pool program of layer ``idx``, taking
        ``(outs, decode_matrix)``; the matrix is an argument, so any subset
        reuses the one program."""
        spec = self.specs[idx]
        fn = self._decoders.get(idx)
        if fn is None:
            q = spec.plan.k_a * spec.plan.k_b

            def dec(outs, d, _q=q, _geo=spec.geo, _pool=spec.pool):
                rows = outs.reshape(outs.shape[0] * outs.shape[1], -1)
                true_rows = d.to(rows.dtype) @ rows
                blocks = true_rows.reshape((_q,) + tuple(outs.shape[2:]))
                return relu_pool(merge_output(blocks, _geo), _pool)

            fn = self._decoders[idx] = Program(dec, name="decoder",
                                               graphs=self.master_graphs)
        return fn

    def decode_operand(self, idx: int, worker_ids: tuple[int, ...]) -> torch.Tensor:
        """The decode and transition programs' matrix argument: the
        subset's float64 host inverse (``decode_matrix``) as a device
        tensor in the input dtype, memoised per (layer, survivors), so a
        round copies nothing from the host."""
        key = (idx, tuple(worker_ids))
        d = self._decode_memo.get(key)
        if d is None:
            d = self._decode_memo[key] = self._on_device(
                self.decode_matrix(idx, worker_ids))
        return d

    def encode_operand(self, idx: int, worker_ids: tuple[int, ...]) -> torch.Tensor:
        """The encoder's and transitions' column argument: the selected
        workers' encode columns as a device tensor."""
        return self._on_device(self.encode_columns(idx, worker_ids))

    def decoder(self, idx: int, worker_ids: tuple[int, ...]):
        """``decoder_fn`` with the subset's decode inverse bound."""
        fn = self.decoder_fn(idx)
        d = self.decode_operand(idx, worker_ids)
        return lambda outs: fn.eager(outs, d)

    def transition_fn(self, idx: int) -> Program:
        """The partition-resident transition program between ConvL ``idx``
        and ``idx + 1``, taking ``(outs, decode_matrix,
        next_encode_columns)``: decode only to the partition grid with the
        ReLU in the decode epilogue, per-partition max-pool with halo
        exchange, re-slice into the next layer's APCP parts, re-encode.  On
        the kernel backend both GEMMs run on K2.  Adjacent pairs with the
        same transition signature share one program; its graphs are per
        layer (``slot``), the next layer's encode columns resident."""
        if not 0 <= idx < len(self.specs) - 1:
            raise ValueError(f"no transition after layer {idx} "
                             f"({len(self.specs)} layers)")
        key = self._transition_key(self.specs[idx], self.specs[idx + 1])
        fn = self._transitions.get(key)
        if fn is None:
            q = self.specs[idx].plan.k_a * self.specs[idx].plan.k_b
            ell_next = self.specs[idx + 1].plan.ell_a
            assemble = self._assemble(idx)
            if self.backend == "kernel":
                def trans(outs, d, m_next):
                    coded = coded_transition(outs, d, m_next, assemble)
                    return group_by_worker(coded, ell_next)
            else:
                def trans(outs, d, m_next):
                    rows = outs.reshape(outs.shape[0] * outs.shape[1], -1)
                    blocks = torch.relu(d.to(rows.dtype) @ rows).reshape(
                        (q,) + tuple(outs.shape[2:]))
                    coded = encode_tensor_list(assemble(blocks), m_next)
                    return group_by_worker(coded, ell_next)

            fn = self._transitions[key] = Program(
                trans, name="transition", resident=(2,),
                graphs=self.master_graphs)
        return fn

    def _assemble(self, idx: int):
        """The transition after layer ``idx``'s partition-space step: the
        decoded grid (ReLU already applied by the decode epilogue) to the
        next layer's APCP parts."""
        geo, pool = self.specs[idx].geo, self.specs[idx].pool
        geo_next = self.specs[idx + 1].geo

        def assemble(blocks):
            return partition_transition(blocks, geo, pool, geo_next,
                                        relu=False)

        return assemble

    # -- kernel autotuning ---------------------------------------------------
    def _tune_cells(self, bucket_sizes: Sequence[int] | None = None):
        """The cells ``autotune_kernels`` sweeps, in the reference's order:
        per bucket and layer, K1's worker cell ``("worker", share shape,
        filter-group shape, stride)``, then, under ``fuse_transitions``,
        the transition's K2 GEMMs ``("matmul", m, k, n, relu)``: the
        decode with its ReLU and the re-encode at both widths (the
        fastest-delta subset and the all-n round the cluster re-encodes
        for), as ``coded_transition`` launches them
        (``transition_gemms``)."""
        buckets = (self.normalize_buckets(bucket_sizes) if bucket_sizes
                   else (self.bucket_sizes or (1,)))
        last = len(self.specs) - 1
        for bucket in buckets:
            for idx, spec in enumerate(self.specs):
                geo, plan = spec.geo, spec.plan
                yield ("worker", (plan.ell_a, bucket, geo.in_channels,
                                  geo.h_hat, geo.padded_w),
                       tuple(self.coded_filters[idx].shape[1:]), geo.stride)
                if not (self.fuse_transitions and idx < last):
                    continue
                outs = (self.layer_delta(idx), plan.ell_a * plan.ell_b,
                        bucket, geo.out_c_block, geo.out_h_block, geo.out_w)
                widths = sorted({
                    self.encode_columns(
                        idx + 1, self.layer_worker_ids(idx + 1)).shape[1],
                    self.encode_columns_all(idx + 1).shape[1]})
                for gemm in transition_gemms(outs, plan.k_a * plan.k_b,
                                             widths, self._assemble(idx)):
                    yield ("matmul",) + gemm

    def autotune_kernels(self, bucket_sizes: Sequence[int] | None = None, *,
                         repeat: int = 3, force: bool = False,
                         path: str | None = None) -> dict:
        """Time every K1/K2 cell this pipeline launches on the card and
        record the winning launch plans in the autotune ledger
        (``repro_torch.kernels.autotune``), then drop the worker and
        transition programs and the master's graph captures, so they are
        rebuilt with the tuned plans at their next call.

        The cells come from ``_tune_cells``, one per (layer geometry,
        bucket): the worker's implicit-GEMM convolution and, under
        ``fuse_transitions``, the transition's decode GEMM and both
        re-encode GEMM widths.  Recorded cells return at once (``force``
        sweeps again), so calling this at server start-up costs sweeps
        only on a cold ledger.  Returns ``{ledger key: winning params}``
        for the cells visited; ``{}`` off the card or off the kernel
        backend."""
        if self.backend != "kernel" or self.device.type != "cuda":
            return {}
        from ..kernels import autotune

        tuned: dict[str, dict] = {}
        for kind, *cell in self._tune_cells(bucket_sizes):
            if kind == "worker":
                xe, ke, stride = cell
                key = autotune.worker_key(xe, ke, stride, device=self.device)
                tuned[key] = autotune.tune_worker(
                    xe, ke, stride, device=self.device, repeat=repeat,
                    force=force, path=path)
            else:
                m, k, n, relu = cell
                key = autotune.matmul_key(m, k, n, relu=relu,
                                          device=self.device)
                tuned[key] = autotune.tune_matmul(
                    m, k, n, relu=relu, device=self.device, repeat=repeat,
                    force=force, path=path)
        # rebuilt programs and fresh captures launch the winners
        self._batch_programs.clear()
        self._cluster_programs.clear()
        self._transitions.clear()
        for graphs in self._graph_sets.values():
            graphs.clear()
        return tuned

    # -- shape-space enumeration -------------------------------------------
    def program_space(self, bucket_sizes: Sequence[int] | None = None, *,
                      modes: Sequence[str] = ("direct", "cluster")):
        """Enumerate every program cell this pipeline can launch, in shape
        space — nothing runs.

        Yields one ``ProgramCell`` per (mode, layer, bucket, program kind),
        walking the encode -> worker -> transition/decode chain as
        execution would (the reference's ``program_space``, cell for cell),
        with the shapes from the layer geometry.  ``direct`` is the
        single-process path (worker looped over the fastest-delta axis,
        subset-width re-encodes); ``cluster`` the runtime path (per-worker
        programs, full-n re-encodes, full-matrix encoder).  Survivor
        subsets never appear in the signatures, only their size delta: the
        shape-space half of the no-respecialisation contract, whose other
        half (matrices as arguments, not constants) ``repro_torch.analysis``
        checks by running each cell."""
        buckets = (self.normalize_buckets(bucket_sizes) if bucket_sizes
                   else (self.bucket_sizes or (1,)))
        last = len(self.specs) - 1
        dtype = self.input_dtype
        for mode in modes:
            if mode not in ("direct", "cluster"):
                raise ValueError(f"unknown mode {mode!r}")
            for bucket in buckets:
                x = ArgSpec((bucket,) + self.input_shape, dtype)
                for idx, (spec, layer) in enumerate(zip(self.specs, self.layers)):
                    def cid(kind):
                        return f"{spec.name}[b={bucket}]/{kind}:{mode}"

                    geo, plan = spec.geo, spec.plan
                    ids = self.layer_worker_ids(idx)
                    delta = len(ids)
                    m_sel = ArgSpec(self.encode_columns(idx, ids).shape, dtype,
                                    "encode", idx)
                    ke_shape = tuple(self.coded_filters[idx].shape[1:])
                    # the encoder runs on every layer when unfused, and only
                    # on layer 0 when transitions re-encode in coded space
                    if not self.fuse_transitions or idx == 0:
                        if mode == "direct":
                            yield ProgramCell(
                                cid("encoder"), "encoder", mode, idx, bucket,
                                (idx,), self.encoder(idx), (x, m_sel))
                        else:
                            # the cluster encodes all n workers' shares with
                            # the resident full matrix (subset-independent)
                            yield ProgramCell(
                                cid("encoder"), "encoder", mode, idx, bucket,
                                (idx,), self.encoder(idx), (x,),
                                allowed_const_shapes=(
                                    tuple(layer.a_code.matrix.shape),))
                    share = (plan.ell_a, bucket, geo.in_channels, geo.h_hat,
                             geo.padded_w)
                    if mode == "direct":
                        yield ProgramCell(
                            cid("worker"), "worker", mode, idx, bucket,
                            spec.program_key, self.worker_program(idx),
                            (ArgSpec((delta,) + share, dtype),
                             ArgSpec((delta,) + ke_shape, dtype)))
                    else:
                        yield ProgramCell(
                            cid("worker"), "worker", mode, idx, bucket,
                            spec.program_key,
                            self.worker_program(idx, over_workers=False),
                            (ArgSpec(share, dtype), ArgSpec(ke_shape, dtype)))
                    outs = ArgSpec(
                        (delta, plan.ell_a * plan.ell_b, bucket,
                         geo.out_c_block, geo.out_h_block, geo.out_w), dtype)
                    q = plan.k_a * plan.k_b
                    d = ArgSpec((q, q), dtype, "decode", idx)
                    if self.fuse_transitions and idx < last:
                        if mode == "direct":
                            m_next = ArgSpec(
                                self.encode_columns(
                                    idx + 1,
                                    self.layer_worker_ids(idx + 1)).shape,
                                dtype, "encode", idx + 1)
                        else:
                            m_next = ArgSpec(
                                tuple(self.encode_columns_all(idx + 1).shape),
                                dtype, "encode_all", idx + 1)
                        yield ProgramCell(
                            cid("transition"), "transition", mode, idx,
                            bucket,
                            self._transition_key(spec, self.specs[idx + 1]),
                            self.transition_fn(idx), (outs, d, m_next))
                    if not self.fuse_transitions or idx == last:
                        yield ProgramCell(
                            cid("decoder"), "decoder", mode, idx, bucket,
                            (idx,), self.decoder_fn(idx), (outs, d))
                    x = ArgSpec((bucket, geo.out_channels, spec.out_hw,
                                 spec.out_hw), dtype)

    # -- execution ---------------------------------------------------------
    def layer_worker_ids(self, idx: int, worker_ids=None) -> tuple[int, ...]:
        """The survivors layer ``idx`` decodes from: the first delta of the
        available workers (all n when ``worker_ids`` is None)."""
        delta = self.layer_delta(idx)
        avail = list(range(self.n)) if worker_ids is None else list(worker_ids)
        if len(avail) < delta:
            raise ValueError(
                f"layer {self.specs[idx].name} needs delta={delta} workers, "
                f"got {len(avail)}")
        return tuple(avail[:delta])

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.input_dtype, device=self.device)

    def run(self, x, worker_ids=None) -> torch.Tensor:
        """Coded inference of the whole ConvL stack.

        ``x``: ``(B, C, H, W)`` batch or one ``(C, H, W)`` image.
        ``worker_ids``: the available workers (any >= delta subset of n per
        layer decodes to the same output); default all n.
        """
        if self.fuse_transitions:
            return self.run_prepared(x, self.prepare(worker_ids))
        x = self._as_input(x)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        for idx in range(len(self.layers)):
            ids = self.layer_worker_ids(idx, worker_ids)
            self.input_encode_calls += 1
            xe = self.encoder(idx).eager(x, self.encode_operand(idx, ids))
            sel = torch.as_tensor(ids, device=self.device)
            outs = self.worker_program(idx)(xe, self.coded_filters[idx][sel])
            x = self.decoder(idx, ids)(outs)
        return x[0] if squeeze else x

    def prepare(self, worker_ids=None) -> list[tuple]:
        """Pre-pick every layer's survivor subset and build the code
        artifacts up front: per-layer ``(encode_columns, selector,
        decode_matrix)`` as device tensors.

        ``worker_ids`` is one available-worker list shared by all layers
        (each decodes from its first delta) or a per-layer sequence of
        subsets."""
        per_layer = (
            worker_ids is not None
            and len(worker_ids) == len(self.specs)
            and all(isinstance(w, (list, tuple)) for w in worker_ids)
        )
        prepped = []
        for idx in range(len(self.specs)):
            avail = worker_ids[idx] if per_layer else worker_ids
            ids = self.layer_worker_ids(idx, avail)
            prepped.append((
                self.encode_operand(idx, ids),
                torch.as_tensor(ids, device=self.device),
                self.decode_operand(idx, ids),
            ))
        return prepped

    def run_prepared(self, x, prepared=None, *, worker_ids=None) -> torch.Tensor:
        """Coded inference over pre-picked survivor subsets (the serving
        fast path): no host work between layers, so the whole stack is
        enqueued without a sync.  The single-process path runs its
        programs eagerly."""
        if prepared is None:
            prepared = self.prepare(worker_ids)
        if len(prepared) != len(self.specs):
            raise ValueError(
                f"prepared plan covers {len(prepared)} layers, "
                f"pipeline has {len(self.specs)}")
        x = self._as_input(x)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        if self.fuse_transitions:
            # partition-resident: encode once into layer 0's shares, then
            # each transition re-encodes directly for the next layer's
            # selected workers; only the final layer merges
            last = len(self.specs) - 1
            self.input_encode_calls += 1
            xe = self.encoder(0).eager(x, prepared[0][0])
            for idx, (_m_sel, sel, d) in enumerate(prepared):
                outs = self.worker_program(idx)(xe, self.coded_filters[idx][sel])
                if idx < last:
                    xe = self.transition_fn(idx).eager(outs, d,
                                                      prepared[idx + 1][0])
                else:
                    x = self.decoder_fn(idx).eager(outs, d)
            return x[0] if squeeze else x
        for idx, (m_sel, sel, d) in enumerate(prepared):
            self.input_encode_calls += 1
            xe = self.encoder(idx).eager(x, m_sel)
            outs = self.worker_program(idx)(xe, self.coded_filters[idx][sel])
            x = self.decoder_fn(idx).eager(outs, d)
        return x[0] if squeeze else x


def build_cnn_pipeline(
    name: str,
    params: dict,
    n: int,
    *,
    q: int | None = None,
    default_kab: tuple[int, int] | None = None,
    per_layer_kab: dict | None = None,
    input_hw: int | None = None,
    weights: CostWeights = CostWeights(),
    backend: str = "kernel",
    bucket_sizes: Sequence[int] | None = None,
    fuse_transitions: bool = False,
    pool: str | None = None,
    devices=None,
    device: str | torch.device = "cuda",
    graphs=True,
) -> CodedPipeline:
    """Compile one of the named CNNs (``lenet5``/``alexnet``/``vgg16``) into
    a ``CodedPipeline`` on ``device`` (CUDA unless the caller asks for the
    CPU); ``graphs`` as in ``CodedPipeline.set_graphs``."""
    from ..models.cnn import CNN_SPECS

    hw0, layers = CNN_SPECS[name]
    specs = plan_layers(
        layers, input_hw if input_hw is not None else hw0, n, q=q,
        default_kab=default_kab, per_layer_kab=per_layer_kab, weights=weights,
    )
    return CodedPipeline(specs, params, backend=backend,
                         bucket_sizes=bucket_sizes,
                         fuse_transitions=fuse_transitions, pool=pool,
                         devices=devices, device=device, graphs=graphs)
