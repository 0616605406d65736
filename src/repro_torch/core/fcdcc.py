"""FCDCC: the end-to-end coded distributed convolution layer (Sec. IV).

Pipeline (Fig. 1):
  APCP(X) -> encode with A      KCCP(K) -> encode with B   (master)
  worker i: ell_a*ell_b pairwise convs of its coded inputs x coded filters
  master: pick any delta workers, invert E, decode, merge.

``backend="kernel"`` runs the worker through the K1 CUDA kernel
(``repro_torch.kernels.conv2d``; its plain version on CPU tensors);
``backend="torch"`` runs ``F.conv2d``.  ``x`` may be ``(C, H, W)`` or
``(B, C, H, W)``: the batch rides inside each worker's subtask.

Two execution paths share the same math: ``run_simulated`` runs every
worker in this process; ``run_sharded`` runs worker ``i`` on rank ``i`` of
a process mesh's axis (``launch.mesh.ProcessMesh``), all-gathers the
coded outputs over that axis and decodes them on every rank.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.nn.functional as F

from ..kernels.conv2d.ops import coded_worker, conv2d_im2col
from .crme import CrmeAxisCode, make_axis_codes
from .nsctc import decode_blocks, encode_tensor_list, group_by_worker
from .partition import (
    ConvGeometry,
    apcp_partition,
    block_output_shape,
    kccp_partition,
    merge_output,
)

__all__ = ["FcdccPlan", "CodedConv2d", "BACKENDS"]

BACKENDS = ("kernel", "torch")


def check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")
    return backend


@dataclasses.dataclass(frozen=True)
class FcdccPlan:
    """Static plan: worker count, partition factors, derived code params."""

    n: int
    k_a: int
    k_b: int
    q: int | None = None

    def __post_init__(self):
        make_axis_codes(self.k_a, self.k_b, self.n, self.q)  # validate

    @property
    def codes(self) -> tuple[CrmeAxisCode, CrmeAxisCode]:
        return make_axis_codes(self.k_a, self.k_b, self.n, self.q)

    @property
    def ell_a(self) -> int:
        return 1 if self.k_a == 1 else 2

    @property
    def ell_b(self) -> int:
        return 1 if self.k_b == 1 else 2

    @property
    def delta(self) -> int:
        """Recovery threshold (with the degenerate-axis rule)."""
        return (self.k_a * self.k_b) // (self.ell_a * self.ell_b)

    @property
    def gamma(self) -> int:
        return self.n - self.delta


def _fp32_conv():
    """cuDNN convolutions in IEEE fp32 whatever the process's TF32 flag:
    the CRME decode multiplies rounding error by the recovery matrix's
    condition number, and PyTorch turns cuDNN's TF32 on by default."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def _conv_valid(x, k, stride, backend):
    """VALID conv of one coded block pair: x ([B,]C,H,W) * k (N,C,KH,KW)."""
    batched = x.ndim == 4
    if backend == "kernel":
        if batched:
            return torch.stack([conv2d_im2col(xi, k, stride) for xi in x])
        return conv2d_im2col(x, k, stride)
    with _fp32_conv():
        y = F.conv2d(x if batched else x[None], k, stride=stride)
    return y if batched else y[0]


class CodedConv2d:
    """One FCDCC-coded convolution layer.

    ``plan`` fixes (n, k_a, k_b); ``geo`` the conv geometry.  The filter is
    encoded once (``encode_filters``) and kept — the paper's deployment,
    where coded filters are pre-stored on the workers.
    """

    def __init__(self, plan: FcdccPlan, geo: ConvGeometry, backend: str = "kernel",
                 fused_worker: bool = True):
        if geo.k_a != plan.k_a or geo.k_b != plan.k_b:
            geo = dataclasses.replace(geo, k_a=plan.k_a, k_b=plan.k_b)
        self.plan = plan
        self.geo = geo
        self.backend = check_backend(backend)
        self.fused_worker = fused_worker
        self.a_code, self.b_code = plan.codes
        # instrumentation: pipelines and tests assert encode-once semantics
        self.filter_encode_calls = 0
        self.input_encode_calls = 0

    # -- master side: encode ---------------------------------------------
    def encode_inputs(self, x: torch.Tensor, matrix=None) -> torch.Tensor:
        """([B,]C,H,W) -> coded inputs (n, ell_a, [B,] C, h_hat, W+2p).

        ``matrix`` overrides the A-code encoding matrix: pass a column subset
        (``(k_a, ell_a*m)``) to encode only m selected workers' shares."""
        self.input_encode_calls += 1
        parts = apcp_partition(x, self.geo)
        coded = encode_tensor_list(
            parts, self.a_code.matrix if matrix is None else matrix)
        return group_by_worker(coded, self.a_code.ell)

    def encode_from_partitions(self, parts: torch.Tensor, matrix=None) -> torch.Tensor:
        """Encode pre-sliced APCP parts ``(k_a, [B,] C, h_hat, W+2p)``: the
        partition-resident transition assembles layer *i+1*'s parts from
        layer *i*'s decoded partitions (``partition.partition_transition``),
        so ``encode_inputs``' ``apcp_partition`` is skipped.  ``matrix`` as
        in ``encode_inputs``."""
        self.input_encode_calls += 1
        assert parts.shape[0] == self.plan.k_a, (tuple(parts.shape), self.plan)
        coded = encode_tensor_list(
            parts, self.a_code.matrix if matrix is None else matrix)
        return group_by_worker(coded, self.a_code.ell)

    def encode_filters(self, k: torch.Tensor, matrix=None) -> torch.Tensor:
        """(N,C,KH,KW) -> coded filters (n, ell_b, N/k_b, C, KH, KW);
        ``matrix`` a column subset of the B code, as in ``encode_inputs``."""
        self.filter_encode_calls += 1
        parts = kccp_partition(k, self.geo)
        coded = encode_tensor_list(
            parts, self.b_code.matrix if matrix is None else matrix)
        return group_by_worker(coded, self.b_code.ell).contiguous()

    # -- worker side -------------------------------------------------------
    def worker_compute(self, xe_i: torch.Tensor, ke_i: torch.Tensor) -> torch.Tensor:
        """Coded subtask of one worker (Algorithm 4 lines 6-11).

        ``xe_i``: (ell_a, [B,] C, h_hat, Wp); ``ke_i``: (ell_b, N/k_b, C, KH, KW).
        Returns (ell_a*ell_b, [B,] N/k_b, H'/k_a, W'), slot ``ell_b*b1 + b2``.

        The fused form runs the ell_a*ell_b pairwise convolutions as one GEMM
        (the K1 kernel, or one ``F.conv2d`` with the coded inputs as the
        batch and the coded filters concatenated along output channels);
        ``fused_worker=False`` is the paper-literal loop."""
        if not self.fused_worker:
            outs = [
                _conv_valid(xe_i[b1], ke_i[b2], self.geo.stride, self.backend)
                for b1 in range(self.plan.ell_a)
                for b2 in range(self.plan.ell_b)
            ]
            return torch.stack(outs, dim=0)
        if self.backend == "kernel":
            return coded_worker(xe_i.contiguous(), ke_i.contiguous(),
                                self.geo.stride)
        ea, eb = self.plan.ell_a, self.plan.ell_b
        nb = ke_i.shape[1]
        k_cat = ke_i.reshape((eb * nb,) + tuple(ke_i.shape[2:]))
        batched = xe_i.ndim == 5
        b = xe_i.shape[1] if batched else 1
        xin = xe_i.reshape((ea * b,) + tuple(xe_i.shape[-3:]))
        with _fp32_conv():
            y = F.conv2d(xin, k_cat, stride=self.geo.stride)  # (ea*B, eb*nb, H', W')
        if not batched:
            return y.reshape((ea * eb, nb) + tuple(y.shape[2:]))
        y = y.reshape((ea, b, eb, nb) + tuple(y.shape[2:]))
        return y.permute(0, 2, 1, 3, 4, 5).reshape(
            (ea * eb, b, nb) + tuple(y.shape[4:]))

    # -- master side: decode ------------------------------------------------
    def decode_to_partitions(self, worker_ids, outputs: torch.Tensor) -> torch.Tensor:
        """Any-delta decode to the A-major ``(k_a*k_b, *block)`` partition
        grid (merge skipped)."""
        blocks = decode_blocks(self.a_code, self.b_code, worker_ids, outputs,
                               tuple(outputs.shape[2:]))
        assert tuple(blocks.shape[-3:]) == block_output_shape(self.geo)
        return blocks

    def decode(self, worker_ids, outputs: torch.Tensor) -> torch.Tensor:
        """Any-delta decode + merge; ``outputs``: (delta, ell2, *block)."""
        return merge_output(self.decode_to_partitions(worker_ids, outputs),
                            self.geo)

    # -- end-to-end path -----------------------------------------------------
    def run_simulated(self, x, k, worker_ids=None):
        """Single-device end-to-end run; ``worker_ids`` are the survivors."""
        ids = list(range(self.plan.delta)) if worker_ids is None else list(worker_ids)
        xe = self.encode_inputs(x)
        ke = self.encode_filters(k)
        outs = torch.stack([self.worker_compute(xe[i], ke[i]) for i in ids])
        return self.decode(ids, outs)

    def run_sharded(self, mesh, axis: str, x, k, worker_ids=None,
                    timings: dict | None = None):
        """SPMD run on a process mesh whose axis ``axis`` holds the n
        workers (its size must equal ``plan.n``).  Rank ``i`` of the axis
        encodes worker ``i``'s ``ell_a`` input shares and ``ell_b`` filter
        groups from the full ``x`` and ``k`` it holds, runs its subtask
        (K1 on the card), and all-gathers the ``(1, ell_a*ell_b, *block)``
        coded outputs over the axis; every rank then decodes the
        statically chosen survivors ``worker_ids`` (default the first
        delta) with ``D = inv(E^T)`` taken in float64 on the host, and
        merges.  The output is replicated: each rank returns the same
        tensor.  ``timings``, where given, gets the seconds of the three
        phases, each ended by a device synchronisation: ``worker_s`` (this
        rank's encode and subtask), ``gather_s`` and ``decode_s`` (decode
        and merge)."""
        n = self.plan.n
        if mesh.shape[axis] != n:
            raise AssertionError((mesh.shape, axis, n))
        ids = list(range(self.plan.delta)) if worker_ids is None else list(worker_ids)
        i = mesh.coordinate[axis]
        clock = _PhaseClock(timings, x.device)
        xe = self.encode_inputs(x, self.a_code.worker_columns(i))
        ke = self.encode_filters(k, self.b_code.worker_columns(i))
        out = self.worker_compute(xe[0], ke[0])[None]  # (1, ell2, *block)
        clock.lap("worker_s")
        allout = mesh.all_gather(out, axis, dim=0)  # (n, ell2, *block)
        clock.lap("gather_s")
        y = self.decode(ids, allout[ids])
        clock.lap("decode_s")
        return y


class _PhaseClock:
    """Seconds between laps into ``timings`` (nothing where it is None),
    each lap after the device has finished its work."""

    def __init__(self, timings: dict | None, device: torch.device):
        self.timings, self.device = timings, device
        self.t = time.perf_counter()

    def lap(self, key: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[key] = now - self.t
        self.t = now
