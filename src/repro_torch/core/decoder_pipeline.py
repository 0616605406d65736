"""Coded LM decode serving: the ``CodedDecoderPipeline``.

The FCDCC machinery treats a ConvL as ``coded inputs x resident coded
filters``; a transformer decode step is the same shape of problem four
times per layer — the qkv / attention-output / gate-up / down projections
are GEMMs ``x (B, d_in) @ W (d_in, d_out)`` whose weights are static for
the lifetime of the model.  This module compiles a GQA decoder stack into
per-layer coded GEMM *rounds* against the same cluster seam CNNs use
(``FcdccCluster.load_pipeline`` / ``dispatch_pipeline_layer`` /
``collect_pipeline_layer``), so one coded worker pool serves CNN ConvL
rounds and LM decode rounds alike:

  * weights are column-partitioned (``k_b`` parts of the output axis) and
    CRME-encoded **once** at construction (``crme_encode``, K3 on the
    card) — the resident coded-filter store.  Each worker's ``ell_b``
    coded column blocks are kept side by side as one ``(d_in, ell_b*ob)``
    matrix, so a round does no transpose;
  * the token activation is broadcast to every worker (``k_a = 1``: decode
    batches are small and the master keeps the KV cache, so input
    partitioning buys nothing);
  * every worker computes one ``(B, d_in) @ (d_in, ell_b*ob)`` GEMM a round
    (K2 on the card with ``backend="kernel"``); the master decodes the
    fastest ``delta`` workers' outputs with one ``crme_decode`` (K3) by a
    ``(Q, Q)`` inverse passed as a *runtime argument*, so any survivor
    subset reuses the one decode program;
  * everything between the GEMM rounds — embedding, RMS norms, RoPE and
    attention over the master-resident KV slot cache, SiLU gating,
    residual adds, unembed/argmax — runs master-side as torch glue
    (``glue_fn`` / ``attn_fn``), each glue program taking its weights as
    arguments, so no glue program holds a constant of its own.  On a CUDA
    device the glue programs run as CUDA graphs of the pipeline's
    ``master_graphs`` (``core/graphs.py``; ``graphs=False``: op by op):
    the embedding table and the head are resident, as are the KV slot
    cache leaves the attention glue writes in place (one graph per layer
    and bucket); activations and the 576-float norm gammas are copied per
    replay.  The broadcast encoder launches no kernel and the decoder
    takes its inverse by value (K3), so both stay eager;
  * an admitted group's prompts are prefilled in ONE full-stack pass on
    the master (``prefill_prompt``, attention on K4), the reference's
    jitted prefill: on the card one graph per bucket, the params and a
    scratch K/V cache per bucket resident, the scratch cleared inside the
    graph.

``UncodedPlan`` is the straggler-bound baseline: the same worker pool and
worker program, weights split ``n`` ways with no redundancy, identity
decode — every round waits for ALL ``n`` workers.

Slot caches are updated in place (the reference returns new arrays): a
decode step writes each row's K/V at its own position, ``slot_write``
copies rows into the cache it is given.  ``slot_cache`` is the pipeline's
own cache, allocated once and zeroed in place on reuse, so the captured
attention glue always finds its resident leaves where it captured them.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import weakref
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..kernels.coded_gemm import crme_decode, crme_encode
from ..kernels.matmul import matmul
from ..models import transformer as lm
from ..models.common import apply_rope, rms_norm, rope_inv_freq, softcap
from ..tree import tree_from_items, tree_items
from .crme import recovery_matrix
from .fcdcc import FcdccPlan, check_backend
from .graphs import GraphSet, owner_graphs
from .pipeline import ArgSpec, Program, ProgramCell

__all__ = [
    "GemmGeometry",
    "GemmRoundSpec",
    "UncodedPlan",
    "CodedDecoderPipeline",
    "build_lm_decoder_pipeline",
]


# why a decoder cell cannot be replayed from a CUDA-graph capture
DECODE_EAGER_ONLY = (
    "K3 takes the survivor inverse by value from the host "
    "(src/repro_torch/kernels/csrc/coded_gemm.cu, kernels/coded_gemm/"
    "kernel.py): a capture would bake the captured subset's inverse")


@dataclasses.dataclass(frozen=True)
class UncodedPlan:
    """Uncoded column-split baseline: worker ``i`` holds the ``i``-th of
    ``n`` weight column blocks, decode is the identity gather — so the
    recovery threshold is all ``n`` workers (``gamma = 0``).  Duck-types
    the ``FcdccPlan`` attributes the cluster/pipeline seams consult."""

    n: int

    @property
    def k_a(self) -> int:
        return 1

    @property
    def k_b(self) -> int:
        return self.n

    @property
    def ell_a(self) -> int:
        return 1

    @property
    def ell_b(self) -> int:
        return 1

    @property
    def delta(self) -> int:
        return self.n

    @property
    def gamma(self) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class GemmGeometry:
    """Geometry of one decoder GEMM round, shaped like the ``ConvGeometry``
    attributes ``FcdccCluster._filter_code_key`` consults (a 1x1 "conv" of
    ``in_channels -> out_channels``), so coded GEMM weights live in the same
    resident-filter registry as ConvL filters."""

    in_channels: int
    out_channels: int
    kernel_h: int = 1
    kernel_w: int = 1


@dataclasses.dataclass(frozen=True)
class GemmRoundSpec:
    """One coded GEMM round of a decoder layer (static plan + geometry).

    ``kind``: ``qkv`` / ``wo`` / ``gateup`` / ``down``.  ``program_key``
    carries the backend so an LM pipeline never collides with a ConvL
    program (ConvL keys are int tuples) in a shared pool."""

    name: str
    kind: str
    layer: int
    plan: object  # FcdccPlan | UncodedPlan
    geo: GemmGeometry
    backend: str = "kernel"

    @property
    def program_key(self) -> tuple:
        return ("gemm", self.backend, self.plan.ell_a, self.plan.ell_b)


class _GemmRound:
    """Per-round holder mirroring ``CodedPipeline.layers[idx]`` — the
    cluster seam reads ``.worker_compute`` off it."""

    def __init__(self, worker_compute):
        self.worker_compute = worker_compute


def _make_worker_compute(backend: str, ell_b: int):
    """The coded GEMM worker program of one plan.

    ``xe_i``: (ell_a=1, B, d_in) — the broadcast activation share;
    ``ke_i``: (d_in, ell_b*ob) — the worker's resident coded weight
    columns, its ``ell_b`` blocks side by side.  Returns
    (ell_a*ell_b, B, ob), slot ``ell_b*b1 + b2`` (a view of the GEMM's
    (B, ell_b*ob) output)."""

    def worker_compute(xe_i, ke_i):
        x = xe_i[0]
        if backend == "kernel":  # one K2 launch for all ell_b coded blocks
            y = matmul(x, ke_i)
        else:
            y = x @ ke_i
        b, width = y.shape
        return y.reshape(b, ell_b, width // ell_b).transpose(0, 1)

    return worker_compute


class CodedDecoderPipeline:
    """A GQA decoder stack compiled into coded GEMM rounds on one cluster.

    Construction encodes every round's weights exactly once (counted by
    ``weight_encode_calls``).  A decode step runs ``4 * layers`` worker
    rounds through ``run_round`` — either the cluster
    (``run_decode_step_cluster``) or the single-process path with forced
    survivor subsets (``run_decode_step_direct``) — with the KV cache,
    norms, RoPE/attention, activations and unembed kept master-side.
    Per-request state lives in *slot caches*: row ``i`` of every layer's
    (slots, max_len, hkv, hd) K/V cache belongs to request slot ``i``,
    written at its own position each step.
    """

    def __init__(self, cfg: lm.LMConfig, params: dict, plan, *,
                 backend: str = "kernel",
                 bucket_sizes: Sequence[int] | None = None,
                 max_len: int | None = None,
                 device: str | torch.device = "cuda", graphs=True):
        # the other families' configs (RWKV6, Hymba, Whisper) have no attn
        if getattr(cfg, "attn", None) != "gqa":
            raise ValueError(f"coded decode supports attn='gqa', got "
                             f"{getattr(cfg, 'attn', None)!r}")
        if cfg.moe is not None:
            raise ValueError("coded decode does not support MoE layers")
        if plan.k_a != 1:
            raise ValueError(
                f"decoder rounds broadcast the activation: need k_a=1, got "
                f"k_a={plan.k_a}")
        self.cfg = cfg
        self.plan = plan
        self.n = plan.n
        self.backend = check_backend(backend)
        self.device = resolve_device(device)
        # worker-pool preference read by the server that adopts this
        # pipeline, as ``CodedPipeline.pool`` / ``.devices`` (None = auto)
        self.pool = None
        self.devices = None
        self.fuse_transitions = False  # GEMM rounds have no fused transitions
        self.max_len = int(max_len if max_len is not None else cfg.max_seq)
        self.bucket_sizes: tuple[int, ...] | None = (
            self.normalize_buckets(bucket_sizes) if bucket_sizes else None)

        # master-side params: full tree (prefill) + per-layer glue weights
        params = lm.map_params(
            lambda t: torch.as_tensor(t, dtype=torch.float32, device=self.device),
            params)
        self.params = params
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.qkv_dim = (h + 2 * hkv) * hd
        lp = params["dense_layers"]
        self.glue_w: list[dict] = []
        for l in range(cfg.layers):
            g = {"ln_attn": lp["ln_attn"][l], "ln_ffn": lp["ln_ffn"][l]}
            if cfg.qk_norm:
                g["q_ln"], g["k_ln"] = lp["q_ln"][l], lp["k_ln"][l]
            if cfg.sandwich_norms:
                g["ln_attn_post"] = lp["ln_attn_post"][l]
                g["ln_ffn_post"] = lp["ln_ffn_post"][l]
            self.glue_w.append(g)
        self.embed_table = params["embed"]
        self.ln_f = params["ln_f"]
        self.head = (params["embed"].t() if cfg.tie_embeddings
                     else params["lm_head"])

        # compile the round specs and encode weights exactly once ---------
        self.weight_encode_calls = 0
        compute = _make_worker_compute(self.backend, plan.ell_b)
        self.specs: list[GemmRoundSpec] = []
        self.layers: list[_GemmRound] = []
        self.coded_filters: list[torch.Tensor] = []
        self._windows = lm._layer_windows(cfg, cfg.layers)
        for l in range(cfg.layers):
            rounds = [
                ("qkv", torch.cat([lp["wq"][l], lp["wk"][l], lp["wv"][l]], dim=1)),
                ("wo", lp["wo"][l]),
                ("gateup", torch.cat([lp["w_gate"][l], lp["w_up"][l]], dim=1)),
                ("down", lp["w_down"][l]),
            ]
            for kind, w in rounds:
                d_in, d_out = int(w.shape[0]), int(w.shape[1])
                if d_out % plan.k_b:
                    raise ValueError(
                        f"round L{l:02d}.{kind}: d_out={d_out} not divisible "
                        f"by k_b={plan.k_b}")
                self.specs.append(GemmRoundSpec(
                    f"L{l:02d}.{kind}", kind, l, plan,
                    GemmGeometry(d_in, d_out), self.backend))
                self.layers.append(_GemmRound(compute))
                self.coded_filters.append(self._encode_weights(w))

        # program caches ----------------------------------------------------
        self._encoder_fn: Program | None = None
        self._decoder: Program | None = None
        self._cluster_programs: dict[tuple, Program] = {}  # filled by the cluster
        self._batch_programs: dict[tuple, Program] = {}  # looped over workers
        self._glue: dict[str, Program] = {}  # master-side glue by name
        self._attn_fns: dict = {}  # decode attention by sliding window
        self._prefill: Program | None = None  # the full-stack prefill
        self._param_items = tree_items(params)  # its params, as arguments
        # the prefill's scratch K/V cache by group size: resident in its
        # graphs, returned as its ks/vs
        self._prefill_caches: dict[int, tuple] = {}  # guarded-by: engine-thread
        # decode inverses by survivor tuple (one plan for every round), as
        # fp32 host tensors; written by the engine thread only
        self._decode_memo: dict[tuple, torch.Tensor] = {}  # guarded-by: engine-thread
        # the pipeline's KV slot caches by slot count (``slot_cache``), and
        # the server that serves from them (a weak reference: a server
        # dropped without a shutdown lets them go)
        self._slot_caches: dict[int, list] = {}  # guarded-by: engine-thread
        self._cache_lock = threading.Lock()
        self._cache_owner = None  # guarded-by: self._cache_lock
        self._graph_sets: dict[type, GraphSet] = {}  # by graph class
        self.master_graphs: GraphSet | None = None
        self.worker_graphs = False
        self.set_graphs(graphs)

    def set_graphs(self, graphs, workers: bool | None = None) -> None:
        """Switch the glue programs between CUDA-graph replays (``True``,
        or a graph class) and eager calls (``False``); the graphs already
        captured are kept for a later switch back.  ``workers`` as in
        ``CodedPipeline.set_graphs`` (a worker round is one K2 launch)."""
        if workers is not None:
            self.worker_graphs = bool(workers)
        self.graphs = graphs
        self.master_graphs = owner_graphs(self._graph_sets, graphs, self.device)
        progs = list(self._glue.values()) + list(self._attn_fns.values())
        if self._prefill is not None:
            progs.append(self._prefill)
        for prog in progs:
            prog.graphs = self.master_graphs

    @property
    def glue_graph_bound(self) -> int:
        """Master graphs a server can capture: per bucket, one each of
        embed, norm, add, act and finish, one attention graph per layer
        (its cache leaves are resident), and the prefill of a group of
        prompts at the server's prompt width."""
        buckets = len(self.bucket_sizes) if self.bucket_sizes else 1
        return (6 + self.cfg.layers) * buckets

    @property
    def worker_graph_bound(self) -> int:
        """Graphs one device-pool worker can capture: one per (round,
        bucket), each round's coded weight columns resident."""
        buckets = len(self.bucket_sizes) if self.bucket_sizes else 1
        return len(self.specs) * buckets

    # -- weight encoding (once, at construction) ---------------------------
    def _encode_weights(self, w: torch.Tensor) -> torch.Tensor:
        """(d_in, d_out) -> resident coded columns (n, d_in, ell_b*ob)."""
        self.weight_encode_calls += 1
        plan = self.plan
        d_in, d_out = w.shape
        ob = d_out // plan.k_b
        parts = w.reshape(d_in, plan.k_b, ob).transpose(0, 1)  # (k_b, d_in, ob)
        if isinstance(plan, UncodedPlan):
            matrix = np.eye(plan.n)  # worker i holds column block i
        else:
            matrix = plan.codes[1].matrix  # B-code, (k_b, ell_b*n)
        coded = crme_encode(parts.contiguous(), matrix)  # (ell_b*n, d_in, ob)
        eb = plan.ell_b
        return (coded.reshape(self.n, eb, d_in, ob).permute(0, 2, 1, 3)
                .reshape(self.n, d_in, eb * ob).contiguous())

    # -- bucketing (same contract as CodedPipeline) ------------------------
    @staticmethod
    def normalize_buckets(bucket_sizes: Sequence[int]) -> tuple[int, ...]:
        buckets = tuple(sorted(set(int(b) for b in bucket_sizes)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {bucket_sizes}")
        return buckets

    @property
    def max_batch(self) -> int | None:
        return self.bucket_sizes[-1] if self.bucket_sizes else None

    def bucketize(self, batch: int) -> int:
        if self.bucket_sizes is None:
            return batch
        for b in self.bucket_sizes:
            if b >= batch:
                return b
        raise ValueError(
            f"batch {batch} exceeds the largest bucket {self.bucket_sizes[-1]}")

    def pad_to_bucket(self, x: torch.Tensor, axis: int = 0) -> tuple[torch.Tensor, int]:
        b = x.shape[axis]
        bucket = self.bucketize(b)
        if bucket == b:
            return x, b
        pad_shape = list(x.shape)
        pad_shape[axis] = bucket - b
        return torch.cat([x, x.new_zeros(pad_shape)], dim=axis), b

    # -- introspection -----------------------------------------------------
    @property
    def num_geometries(self) -> int:
        """Distinct (program key, GEMM geometry) pairs: 4 for a homogeneous
        decoder stack no matter how many layers."""
        return len({(s.program_key, s.geo) for s in self.specs})

    @property
    def num_transitions(self) -> int:
        return 0

    @property
    def program_trace_bound(self) -> int:
        buckets = len(self.bucket_sizes) if self.bucket_sizes else 1
        return self.num_geometries * buckets

    @property
    def num_rounds_per_step(self) -> int:
        return len(self.specs)

    @property
    def num_worker_programs(self) -> int:
        """Distinct worker programs in use, both caches counted."""
        return len(self._batch_programs) + len(self._cluster_programs)

    @property
    def worker_program_traces(self) -> int:
        """Shape signatures seen across the worker programs of both caches."""
        return sum(len(fn.signatures)
                   for cache in (self._batch_programs, self._cluster_programs)
                   for fn in cache.values())

    def layer_delta(self, idx: int) -> int:
        return self.specs[idx].plan.delta

    def layer_worker_ids(self, idx: int, worker_ids=None) -> tuple[int, ...]:
        delta = self.layer_delta(idx)
        avail = list(range(self.n)) if worker_ids is None else list(worker_ids)
        if len(avail) < delta:
            raise ValueError(
                f"round {self.specs[idx].name} needs delta={delta} workers, "
                f"got {len(avail)}")
        return tuple(avail[:delta])

    # -- coded program caches (the CodedPipeline duck-type surface) --------
    def encoder(self, idx: int) -> Program:
        """k_a=1 'encoding' is a broadcast: every worker receives the whole
        (B, d_in) activation as its single coded share — an ``expand``, no
        copy.  One program serves every round."""
        if self._encoder_fn is None:
            n = self.n
            self._encoder_fn = Program(
                lambda x: x.expand((n, 1) + tuple(x.shape)), name="encoder")
        return self._encoder_fn

    def worker_program(self, idx: int, *, over_workers: bool = True) -> Program:
        """The worker program of round ``idx``: over all selected workers
        (``(m, 1, B, d_in)`` shares, the single-process path), or with
        ``over_workers=False`` the one-worker program the cluster dispatches
        (``_cluster_programs``, which the thread pool fills with the same
        programs).  Rounds with the same ``program_key`` share one
        program."""
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

    def decode_matrix(self, idx: int, worker_ids: tuple[int, ...]) -> torch.Tensor:
        """The (Q, Q) decode inverse for the given survivor subset: inverted
        in float64 on the host, then memoised per subset as the fp32 host
        tensor the decode program takes — K3 takes it by value, so a round
        neither copies it to the device nor synchronises a stream.  Uncoded
        rounds accept only the full worker set and decode with the
        identity — sorted-id gather order IS column-block order."""
        plan = self.specs[idx].plan
        if isinstance(plan, UncodedPlan):
            ids = tuple(sorted(worker_ids))
            if ids != tuple(range(plan.n)):
                raise ValueError(
                    f"uncoded round needs all {plan.n} workers, got {ids}")
            key = ids
        else:
            key = tuple(worker_ids)
        d = self._decode_memo.get(key)
        if d is None:
            if isinstance(plan, UncodedPlan):
                m = np.eye(plan.n)
            else:
                a_code, b_code = plan.codes
                m = np.linalg.inv(
                    recovery_matrix(a_code, b_code, list(worker_ids)).T)
            d = self._decode_memo[key] = torch.as_tensor(m, dtype=torch.float32)
        return d

    def decode_operand(self, idx: int, worker_ids: tuple[int, ...]) -> torch.Tensor:
        """The decode program's matrix argument: ``decode_matrix`` as is."""
        return self.decode_matrix(idx, worker_ids)

    def decoder_fn(self, idx: int) -> Program:
        """One decode program for EVERY round: ``(outs, d)`` with the (Q, Q)
        inverse a runtime argument; with k_a=1 the decoded blocks are plain
        column blocks, so decode + concat is round-geometry-agnostic."""
        if self._decoder is None:
            def dec(outs, d):
                # outs (delta, ell2, B, ob) sorted by worker id
                q = outs.shape[0] * outs.shape[1]
                b, ob = outs.shape[2], outs.shape[3]
                true_rows = crme_decode(d, outs.reshape(q, b * ob))
                return true_rows.reshape(q, b, ob).transpose(0, 1).reshape(b, q * ob)

            self._decoder = Program(dec, name="decoder")
        return self._decoder

    def decoder(self, idx: int, worker_ids: tuple[int, ...]):
        fn = self.decoder_fn(idx)
        d = self.decode_matrix(idx, worker_ids)
        return lambda outs: fn(outs, d)

    # -- master-side glue ------------------------------------------------------
    def glue_fn(self, name: str) -> Program:
        """The master-side glue program ``name``, taking its weights as
        arguments (the reference's ``_glue_fn``): ``embed(table, tokens)``,
        ``norm(x, gamma)``, ``add(x, y)``, ``act(gu)`` and ``finish(x,
        gamma, head) -> (logits, argmax)``.  The table and the head are
        resident in its graphs."""
        fn = self._glue.get(name)
        if fn is not None:
            return fn
        cfg = self.cfg
        resident = ()
        if name == "embed":
            resident = (0,)
            scale = math.sqrt(cfg.d_model)

            def fn(table, tokens):
                x = table[tokens.long()]
                return x * scale if cfg.embed_scale else x
        elif name == "norm":
            fn = rms_norm
        elif name == "add":
            def fn(x, y):
                return x + y
        elif name == "act":
            def fn(gu):
                g, u = gu.chunk(2, dim=-1)
                g = g.float()
                g = (F.silu(g) if cfg.act == "silu"
                     else F.gelu(g, approximate="tanh"))
                return g.to(u.dtype) * u
        elif name == "finish":
            resident = (2,)

            def fn(x, gamma, head):
                logits = (rms_norm(x, gamma) @ head).float()
                if cfg.logit_softcap is not None:
                    logits = softcap(logits, cfg.logit_softcap)
                return logits, logits.argmax(dim=-1).to(torch.int32)
        else:
            raise KeyError(name)
        prog = self._glue[name] = Program(fn, name=f"glue.{name}",
                                          resident=resident,
                                          graphs=self.master_graphs)
        return prog

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.glue_fn("embed")(self.embed_table, tokens)

    def act(self, gu: torch.Tensor) -> torch.Tensor:
        return self.glue_fn("act")(gu)

    def finish(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.glue_fn("finish")(x, self.ln_f, self.head)

    def attn_fn(self, layer: int):
        """The decode-attention glue of ``layer`` (one program per sliding
        window): split the coded qkv round's output, RoPE at each row's own
        position (the frequencies computed in the program, not held by
        it), write K/V into row ``i``'s cache slot at position ``pos[i]``
        (in place), attend causally over the slot cache (plain
        ``attention``: one query per row at its own position is not K4's
        index-causal function).  Returns the merged head context and the
        (updated) caches.  The caches are resident in its graphs, one
        graph per layer (``slot``) and bucket."""
        window = self._windows[layer]
        fn = self._attn_fns.get(window)
        if fn is not None:
            return fn
        cfg = self.cfg
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

        def raw(qkv, ck, cv, pos, *ln):
            b = qkv.shape[0]
            q, k, v = qkv.split([h * hd, hkv * hd, hkv * hd], dim=-1)
            q = q.reshape(b, 1, h, hd)
            k = k.reshape(b, 1, hkv, hd)
            v = v.reshape(b, 1, hkv, hd)
            if cfg.qk_norm:
                q = rms_norm(q, ln[0])
                k = rms_norm(k, ln[1])
            rope = rope_inv_freq(hd, cfg.rope_base, qkv.device)
            q = apply_rope(q, rope, pos[:, None])
            k = apply_rope(k, rope, pos[:, None])
            rows = torch.arange(b, device=qkv.device)
            ck[rows, pos.long()] = k[:, 0]
            cv[rows, pos.long()] = v[:, 0]
            max_len = ck.shape[1]
            k_pos = torch.arange(max_len, dtype=torch.int32,
                                 device=qkv.device).expand(b, max_len)
            # causal mask k_pos <= pos hides not-yet-written slots
            ctx = lm._attend(q, ck[:b], cv[:b], pos[:, None], k_pos, cfg, window)
            return ctx.reshape(b, h * hd), ck, cv

        prog = self._attn_fns[window] = Program(
            raw, name="glue.attn", resident=(1, 2), graphs=self.master_graphs)
        return prog

    # -- KV slot cache ------------------------------------------------------
    def init_slot_cache(self, slots: int) -> list[dict]:
        """Per-layer K/V slot caches: row ``i`` belongs to request slot
        ``i`` for its whole lifetime (prefill-scattered in, advanced one
        position per decode step, recycled on completion)."""
        cfg = self.cfg
        shape = (slots, self.max_len, cfg.n_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(shape, device=self.device),
                 "v": torch.zeros(shape, device=self.device)}
                for _ in range(cfg.layers)]

    def slot_cache(self, slots: int) -> list[dict]:
        """The pipeline's own slot caches for ``slots`` rows: allocated on
        first use, zeroed in place on every later call (a server starting,
        or recovering from a failed step), so the captured attention glue
        keeps finding its resident leaves.  The server that claimed them
        (``claim_slot_cache``) serves from them."""
        cache = self._slot_caches.get(slots)
        if cache is None:
            cache = self._slot_caches[slots] = self.init_slot_cache(slots)
        else:
            for c in cache:
                c["k"].zero_()
                c["v"].zero_()
        return cache

    def claim_slot_cache(self, owner) -> None:
        """Make ``owner`` (a server) the one that serves from the slot
        caches.  Two servers on one pipeline would write into one cache and
        zero each other's, so a claim while another live server holds them
        raises; ``release_slot_cache`` gives them up."""
        with self._cache_lock:
            held = None if self._cache_owner is None else self._cache_owner()
            if held is not None and held is not owner:
                raise RuntimeError(
                    "another server serves from this pipeline's KV slot "
                    "caches; shut it down first")
            self._cache_owner = weakref.ref(owner)

    def release_slot_cache(self, owner) -> None:
        """Give up ``owner``'s claim on the slot caches (no-op for another
        owner)."""
        with self._cache_lock:
            if self._cache_owner is not None and self._cache_owner() is owner:
                self._cache_owner = None

    @staticmethod
    def slot_write(cache_leaf: torch.Tensor, new: torch.Tensor, row: int) -> torch.Tensor:
        """Write ``new`` (G, max_len, hkv, hd) into rows [row, row+G), in
        place; returns the cache."""
        cache_leaf[row:row + new.shape[0]] = new
        return cache_leaf

    @staticmethod
    def slot_take(cache_leaf: torch.Tensor, row: int) -> torch.Tensor:
        """A copy of one slot row (1, max_len, hkv, hd) at ``row``."""
        return cache_leaf[row:row + 1].clone()

    def prefill_program(self) -> Program:
        """The cache-filling prefill of a group of prompts, one full-stack
        pass (``models.transformer.prefill``, attention on K4): ``(tokens
        (G, P), k, v, *param leaves) -> (logits (G, P, V), k, v)``, with
        ``k`` / ``v`` the ``(L, G, max_len, hkv, hd)`` scratch cache,
        cleared and then filled in place.  The scratch and the params are
        resident in its graphs (one a group size and prompt width), the
        tokens copied in; the scratch is declared written, so a capture
        restores it after the warm-up's real run."""
        if self._prefill is None:
            cfg = self.cfg
            paths = [path for path, _ in self._param_items]

            def raw(tokens, k, v, *leaves):
                k.zero_()
                v.zero_()
                params = tree_from_items(zip(paths, leaves))
                logits, _ = lm.prefill(params, cfg, {"dense": {"k": k, "v": v}},
                                       tokens.long())
                return logits, k, v

            self._prefill = Program(
                raw, name="prefill", resident=tuple(range(1, 3 + len(paths))),
                writes=(1, 2), graphs=self.master_graphs)
        return self._prefill

    def prefill_cache(self, group: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The prefill's scratch K/V of ``group`` rows, allocated on first
        use and kept: its graphs hold it."""
        kv = self._prefill_caches.get(group)
        if kv is None:
            cfg = self.cfg
            shape = (cfg.layers, group, self.max_len, cfg.n_kv_heads,
                     cfg.head_dim)
            kv = self._prefill_caches[group] = (
                torch.zeros(shape, device=self.device),
                torch.zeros(shape, device=self.device))
        return kv

    def prefill_prompt(self, prompts):
        """Batched cache-filling prefill for a group of admitted prompts:
        ONE full-stack pass on the master (``prefill_program``; replayed
        from its graph on the card) — prompt positions never go through
        worker rounds.  Returns ``(logits (G, P, V), ks, vs)`` with ks/vs
        ``(L, G, max_len, hkv, hd)`` ready to scatter into the slot
        caches.  ks/vs ARE the scratch cache of group size G, which the
        next prefill of G rows overwrites: consume them (``slot_write``)
        before that; the logits are the caller's own."""
        tokens = torch.as_tensor(prompts, device=self.device)
        k, v = self.prefill_cache(tokens.shape[0])
        return self.prefill_program()(
            tokens, k, v, *(leaf for _, leaf in self._param_items))

    # -- decode-step entry points ---------------------------------------------
    def _decode_step(self, tokens, cache, pos, run_round):
        """One decode step over the first ``B = len(tokens)`` cache slots.

        ``tokens`` (B,) int, ``pos`` (B,) int32 (each row's next position),
        ``cache`` the full slot-cache list (slots >= B, written in place).
        Every projection GEMM goes through ``run_round(idx, x)``; everything
        else is master-side glue.  Returns (logits (B, V), next_tokens (B,),
        cache)."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device)
        norm, add = self.glue_fn("norm"), self.glue_fn("add")
        x = self.embed(tokens)
        for l in range(cfg.layers):
            g = self.glue_w[l]
            base = 4 * l
            qkv = run_round(base + 0, norm(x, g["ln_attn"]))
            ln = (g["q_ln"], g["k_ln"]) if cfg.qk_norm else ()
            ctx, cache[l]["k"], cache[l]["v"] = self.attn_fn(l)(
                qkv, cache[l]["k"], cache[l]["v"], pos, *ln, slot=l)
            attn_out = run_round(base + 1, ctx)
            if cfg.sandwich_norms:
                attn_out = norm(attn_out, g["ln_attn_post"])
            x = add(x, attn_out)
            gu = run_round(base + 2, norm(x, g["ln_ffn"]))
            ffn_out = run_round(base + 3, self.act(gu))
            if cfg.sandwich_norms:
                ffn_out = norm(ffn_out, g["ln_ffn_post"])
            x = add(x, ffn_out)
        logits, next_tokens = self.finish(x)
        return logits, next_tokens, cache

    def run_round_direct(self, idx: int, x, worker_ids=None):
        """One coded GEMM round on the single-process path with an
        explicitly forced survivor subset (tests, parity baselines)."""
        ids = tuple(sorted(self.layer_worker_ids(idx, worker_ids)))
        xe = self.encoder(idx)(x)
        sel = torch.as_tensor(ids, device=self.device)
        outs = self.worker_program(idx)(xe[sel], self.coded_filters[idx][sel])
        return self.decoder(idx, ids)(outs)

    def run_decode_step_direct(self, tokens, cache, pos, worker_ids=None):
        """Full decode step, every round decoded from the forced subset."""
        return self._decode_step(
            tokens, cache, pos,
            lambda idx, x: self.run_round_direct(idx, x, worker_ids))

    def run_decode_step_cluster(self, cluster, tokens, cache, pos, *,
                                model: str = "lm", timings: list | None = None):
        """Full decode step through the master/worker runtime: each round
        dispatches n coded subtasks via ``dispatch_pipeline_layer`` and
        reaps the fastest delta via ``collect_pipeline_layer`` (stragglers
        beyond gamma are never waited for)."""
        def run_round(idx, x):
            rnd = cluster.dispatch_pipeline_layer(idx, x, model)
            y, timing = cluster.collect_pipeline_layer(rnd)
            if timings is not None:
                timings.append(timing)
            return y

        return self._decode_step(tokens, cache, pos, run_round)

    # -- shape-space enumeration -------------------------------------------
    def program_space(self, bucket_sizes: Sequence[int] | None = None, *,
                      modes: Sequence[str] = ("direct", "cluster")):
        """Enumerate every program cell a decode step can launch, in shape
        space (the reference's ``program_space``, cell for cell).  Round
        cells mirror ``CodedPipeline.program_space`` (worker cells are what
        the bounded-trace proof counts); the master-side glue programs are
        ``glue`` cells under the ``master`` pseudo-mode.  Two layouts are
        the port's own: a worker's coded weights are ``(d_in, ell_b*ob)``
        (the reference's ``(ell_b, d_in, ob)``), and the decode inverse
        stays on the host, where K3 takes it by value — so a decoder cell
        is ``eager_only``.  The ``prefill`` cells, one a bucket, are the
        port's own (the reference jits its prefill outside its program
        space): the prompt-group prefill at a width of ``max_len // 2``
        tokens (a server pads to one width below ``max_len``; the program
        is the same at every width)."""
        buckets = (self.normalize_buckets(bucket_sizes) if bucket_sizes
                   else (self.bucket_sizes or (1,)))
        cfg = self.cfg
        f32, i32 = torch.float32, torch.int32
        prompt_len = self.max_len // 2
        geoms = set()
        for mode in modes:
            if mode not in ("direct", "cluster"):
                raise ValueError(f"unknown mode {mode!r}")
            for bucket in buckets:
                for idx, spec in enumerate(self.specs):
                    key = (mode, bucket, spec.program_key, spec.geo)
                    if key in geoms:
                        continue  # repeated layer geometry: same programs
                    geoms.add(key)
                    plan = spec.plan
                    d_in = spec.geo.in_channels
                    ob = spec.geo.out_channels // plan.k_b
                    delta, ea, eb = plan.delta, plan.ell_a, plan.ell_b
                    q = plan.k_a * plan.k_b

                    def cid(kind):
                        return f"{spec.name}[b={bucket}]/{kind}:{mode}"

                    yield ProgramCell(
                        cid("encoder"), "encoder", mode, idx, bucket,
                        ("bcast",), self.encoder(idx),
                        (ArgSpec((bucket, d_in), f32),))
                    if mode == "direct":
                        yield ProgramCell(
                            cid("worker"), "worker", mode, idx, bucket,
                            spec.program_key, self.worker_program(idx),
                            (ArgSpec((delta, ea, bucket, d_in), f32),
                             ArgSpec((delta, d_in, eb * ob), f32)))
                    else:
                        yield ProgramCell(
                            cid("worker"), "worker", mode, idx, bucket,
                            spec.program_key,
                            self.worker_program(idx, over_workers=False),
                            (ArgSpec((ea, bucket, d_in), f32),
                             ArgSpec((d_in, eb * ob), f32)))
                    yield ProgramCell(
                        cid("decoder"), "decoder", mode, idx, bucket,
                        ("dec",), self.decoder_fn(idx),
                        (ArgSpec((delta, ea * eb, bucket, ob), f32),
                         ArgSpec((q, q), f32, "decode", idx, host=True)),
                        eager_only=DECODE_EAGER_ONLY)
        # master-side glue (mode-independent; checked, never trace-counted)
        d, v = cfg.d_model, cfg.vocab
        hkv, hd = cfg.n_kv_heads, cfg.head_dim
        params = tuple(ArgSpec(tuple(leaf.shape), f32)
                       for _, leaf in self._param_items)
        for bucket in buckets:
            def gid(kind):
                return f"glue.{kind}[b={bucket}]:master"

            x = ArgSpec((bucket, d), f32)
            cells = [
                ("embed", (ArgSpec((v, d), f32),
                           ArgSpec((bucket,), i32, "index", high=v))),
                ("norm", (x, ArgSpec((d,), f32))),
                ("add", (x, x)),
                ("act", (ArgSpec((bucket, 2 * cfg.d_ff), f32),)),
                ("finish", (x, ArgSpec((d,), f32), ArgSpec((d, v), f32))),
            ]
            for kind, args in cells:
                yield ProgramCell(gid(kind), "glue", "master", 0, bucket,
                                  (kind,), self.glue_fn(kind), args)
            cache = ArgSpec((bucket, self.max_len, hkv, hd), f32)
            ln = ((ArgSpec((hd,), f32),) * 2 if cfg.qk_norm else ())
            for window in sorted(set(self._windows), key=repr):
                layer = self._windows.index(window)
                yield ProgramCell(
                    f"glue.attn[w={window},b={bucket}]:master", "glue",
                    "master", layer, bucket, ("attn", window),
                    self.attn_fn(layer),
                    (ArgSpec((bucket, self.qkv_dim), f32), cache, cache,
                     ArgSpec((bucket,), i32, "index", high=self.max_len))
                    + ln)
            scratch = ArgSpec((cfg.layers, bucket, self.max_len, hkv, hd), f32)
            yield ProgramCell(
                f"prefill[b={bucket}]:master", "prefill", "master", 0, bucket,
                ("prefill",), self.prefill_program(),
                (ArgSpec((bucket, prompt_len), i32, "index", high=v),
                 scratch, scratch) + params)


def build_lm_decoder_pipeline(
    cfg: lm.LMConfig,
    params: dict,
    n: int,
    *,
    k_b: int | None = None,
    plan=None,
    backend: str = "kernel",
    bucket_sizes: Sequence[int] | None = None,
    max_len: int | None = None,
    device: str | torch.device = "cuda",
    graphs=True,
) -> CodedDecoderPipeline:
    """Compile a GQA ``LMConfig`` + fp32 params into a coded decoder
    pipeline on ``device``.  Pass ``k_b`` (even) for a CRME-coded plan with
    recovery threshold ``k_b/2``, or ``plan=UncodedPlan(n)`` for the
    straggler-bound uncoded baseline; ``plan`` wins when both are given."""
    if plan is None:
        if k_b is None:
            raise ValueError("need k_b or plan")
        plan = FcdccPlan(n=n, k_a=1, k_b=k_b)
    if plan.n != n:
        raise ValueError(f"plan targets n={plan.n}, requested n={n}")
    return CodedDecoderPipeline(
        cfg, params, plan, backend=backend, bucket_sizes=bucket_sizes,
        max_len=max_len, device=device, graphs=graphs)
