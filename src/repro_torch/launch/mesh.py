"""Meshes: the reference's ``launch/mesh.py`` without jax, and a mesh over
the processes of a ``torch.distributed`` job.

A ``Mesh`` names the axes of a grid of devices that one process holds: the
host mesh (one device) and the coded cluster's worker mesh (the devices its
workers run on).  The production meshes, single pod ``(data 16, model
16)`` and multi-pod ``(pod 2, data 16, model 16)``, carry their axis sizes
only: the sharding specs resolve against them (``sharding.resolve_pspec``,
``models.common.spec_to_pspec``).

A ``ProcessMesh`` (``make_process_mesh``) lays the ranks of a
``torch.distributed`` job out on named axes, over
``torch.distributed.device_mesh.init_device_mesh``, one rank a mesh
point.  It has the same ``shape`` dict, so the specs resolve on it
unchanged, and it runs the collectives the port's SPMD paths need
(``all_gather``, ``all_reduce``, ``reduce_scatter``) over the process
group of one axis or of several.  ``use_mesh`` makes a mesh the active
one for a block (``active_mesh``), as the reference's ``compat.set_mesh``
does (both live in ``sharding``, whose ``shard_hint`` reads it).

Tensor parallelism (Megatron-LM, Shoeybi et al., arXiv:1909.08053 §3)
needs collectives that carry gradients.  ``copy_to`` is Megatron's *f*:
the identity forward, an all-reduce of the gradient backward; it goes at
the input of a column-cut product, whose gradient with respect to its
input is each rank's partial sum.  ``reduce_from`` is its conjugate *g*:
an all-reduce forward, the identity backward, after a row-cut product.
``gather_from`` all-gathers forward and takes this rank's slice of the
gradient backward (right where what follows computes the same on every
rank; ``copy_to`` after it sums partial gradients first).  The sequence
pair (Megatron's sequence parallelism, Korthikanti et al.,
arXiv:2205.05198 §4.2): ``scatter_to`` takes this rank's block forward and
gathers the gradient backward; ``reduce_scatter_from`` reduce-scatters
forward and gathers backward, the *g* of a sequence-parallel stream.
``gather_to`` all-gathers forward and reduce-scatters the gradient
backward: a sequence's blocks gathered where what follows differs by
rank (K/V over the ranks that cut the sequence).  The plain
collectives detach their operands.  ``stats`` counts calls, seconds and
operand bytes, in total and by the axes a collective spans; ``trace``,
where a list, records each collective as a ``Collective``: its kind, axes,
operand shape, the address of the operand's storage (which tells a
parameter or a cache leaf sent as it is from an activation), the operand's
bytes and the ranks of its group (``launch.cost_analysis`` reads its wire
bytes from them).

The backend follows from where the ranks run:

* ``nccl`` where each rank of a host has its own card;
* ``gloo`` where ranks share a card: NCCL refuses two ranks on one device,
  so several ranks on one H100 run over gloo.  Gloo moves CUDA tensors
  through host memory: every collective here copies its operand to the
  host, runs there and copies the result back (``ProcessMesh._staged``),
  so on one card a collective costs two PCIe copies and a loopback
  transfer a rank;
* ``gloo`` on the CPU.

A job is started by ``torchrun --nproc-per-node N`` (``make_process_mesh``
reads its environment) or by ``run_ranks``, which spawns the ranks from
one process with a ``FileStore`` rendezvous, joins each with a timeout
and raises where any rank failed or hung.
"""
from __future__ import annotations

import datetime
import math
import os
import queue
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch

from ..devices import canonical_device, resolve_device
from ..sharding import active_mesh, use_mesh

__all__ = ["Mesh", "ProcessMesh", "Collective", "make_host_mesh",
           "make_worker_mesh",
           "make_production_mesh", "make_process_mesh", "backend_for",
           "use_mesh", "active_mesh", "run_ranks"]


class Mesh:
    """Axis names, their sizes and, where one process holds them, the
    devices: an object array of ``torch.device`` shaped by the sizes."""

    def __init__(self, axis_names, axis_sizes, devices=None):
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.axis_sizes}")
        if devices is not None:
            arr = np.empty(len(devices), dtype=object)
            arr[:] = list(devices)
            devices = arr.reshape(self.axis_sizes)
        self.devices = devices

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16 x 16 = 256 devices, axes (data, model).  Multi-pod:
    2 x 16 x 16 = 512, axes (pod, data, model), the pod axis carrying data
    parallelism across the pods.  Sizes only, no devices."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(device: str | torch.device = "cuda") -> Mesh:
    """The 1 x 1 (data, model) mesh on ``device``."""
    return Mesh(("data", "model"), (1, 1), [resolve_device(device)])


def make_worker_mesh(n: int, devices=None) -> Mesh:
    """The 1-D ``("workers",)`` mesh of the coded cluster's device pool:
    ``devices`` when given (a ``torch.device``, a name or a CUDA index
    each), else every visible CUDA device, capped at ``n`` (a 6-worker
    cluster on an 8-card host leaves 2 cards free).  Fewer devices than
    workers is fine: the pool round-robins the workers over the mesh
    (``sharding.worker_devices``)."""
    if n < 1:
        raise ValueError(f"need n >= 1 workers, got {n}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device visible; pass devices= or "
                               "device='cpu'")
        devices = range(torch.cuda.device_count())
    devs = [canonical_device(resolve_device(
        torch.device("cuda", d) if isinstance(d, int) else d))
        for d in list(devices)[:n]]
    if not devs:
        raise ValueError("empty device list")
    return Mesh(("workers",), (len(devs),), devs)


# -- the process mesh --------------------------------------------------------


class Collective(NamedTuple):
    """One collective of a ``ProcessMesh`` (its ``trace``): ``kind``
    (``all_gather``, ``all_reduce_sum``, ``all_reduce_max``), the mesh
    axes it spans joined by ``+``, the operand's shape, the address of its
    storage, its bytes and the ranks of the group."""
    kind: str
    axes: str
    shape: tuple
    address: int
    nbytes: int
    group: int


def backend_for(device: str | torch.device, ranks_per_host: int) -> str:
    """``nccl`` where each of a host's ``ranks_per_host`` ranks has a card
    of its own, ``gloo`` where ranks share a card (NCCL refuses two ranks
    on one device) and on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _local_rank() -> int:
    import torch.distributed as dist

    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def _bind_card(rank: int) -> torch.device:
    """This rank's card: ``rank % cards`` (every rank on card 0 where the
    host has one)."""
    idx = rank % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


class ProcessMesh:
    """The ranks of a ``torch.distributed`` job on named axes (a
    ``DeviceMesh``), with this rank's device and the job's backend.  Rank
    ``r`` sits at the row-major coordinate of ``r`` in the axis sizes."""

    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.axis_sizes = tuple(int(s) for s in device_mesh.mesh.shape)
        self.device = device
        self.backend = backend
        self.coordinate = dict(zip(self.axis_names,
                                   device_mesh.get_coordinate()))
        # seconds, calls and operand bytes of this mesh's collectives, host
        # staging included (gloo's are synchronous; an nccl call returns
        # at its enqueue); "by_axis" splits them by the axes spanned, e.g.
        # "model" against "data"
        self.stats = {"collectives": 0, "collective_s": 0.0,
                      "collective_bytes": 0, "by_axis": {}}
        # a list to record each collective (a ``Collective``)
        self.trace: list | None = None
        self._groups = self._joint_groups()

    def _joint_groups(self) -> dict:
        """The process groups of every set of two or more axes of more than
        one rank short of the whole job, made now: every rank must create
        every group, in the same order."""
        import torch.distributed as dist

        out = {}
        for axes, blocks in joint_group_ranks(self.axis_names,
                                              self.axis_sizes).items():
            for block in blocks:
                group = dist.new_group(block)
                if self.device_mesh.get_rank() in block:
                    out[axes] = group
        return out

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def _live(self, axes) -> tuple[str, ...]:
        """The axes of ``axes`` (a name or a tuple of candidate names, as
        ``sharding.BATCH``) that this mesh has with more than one rank, in
        mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def group_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._live(axes))

    def group_rank(self, axes) -> int:
        """This rank's index in the group of ``axes``, mesh-major (the
        order in which a dimension sharded over them is cut)."""
        idx = 0
        for a in self._live(axes):
            idx = idx * self.shape[a] + self.coordinate[a]
        return idx

    def group(self, axes):
        """The process group spanning ``axes``: None where they hold one
        rank, one axis' group, the whole job where they cover every axis
        of more than one rank, else the group made for them at
        construction (pod and data beside a model axis)."""
        live = self._live(axes)
        if not live:
            return None
        if len(live) == 1:
            return self.device_mesh.get_group(live[0])
        if math.prod(self.shape[a] for a in live) == self.size:
            import torch.distributed as dist

            return dist.group.WORLD
        return self._groups[live]

    def _staged(self, t: torch.Tensor, run, kind: str, axes) -> torch.Tensor:
        """``run(operand)`` on ``t``: where gloo carries a CUDA tensor, the
        operand is an explicit host copy and the result goes back to the
        card.  Gloo stages CUDA tensors through host memory for the
        collectives it has and lacks others (reduce-scatter) for them;
        staging every one here keeps one path and one cost."""
        t0 = time.perf_counter()
        host = self.backend == "gloo" and t.device.type != "cpu"
        out = run(t.detach().to("cpu") if host else t.detach().contiguous())
        out = out.to(t.device) if host else out
        dt, nbytes = time.perf_counter() - t0, t.numel() * t.element_size()
        key = "+".join(self._live(axes))
        self.stats["collectives"] += 1
        self.stats["collective_s"] += dt
        self.stats["collective_bytes"] += nbytes
        ax = self.stats["by_axis"].setdefault(key, {"calls": 0, "s": 0.0,
                                                    "bytes": 0})
        ax["calls"] += 1
        ax["s"] += dt
        ax["bytes"] += nbytes
        if self.trace is not None:
            self.trace.append(Collective(kind, key, tuple(t.shape),
                                         t.untyped_storage().data_ptr(),
                                         nbytes, self.group_size(axes)))
        return out

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` over ``axes`` concatenated along ``dim`` in
        group order."""
        group = self.group(axes)
        if group is None:
            return t
        import torch.distributed as dist

        def run(x):
            parts = [torch.empty_like(x) for _ in range(self.group_size(axes))]
            dist.all_gather(parts, x, group=group)
            return torch.cat(parts, dim=dim)

        return self._staged(t, run, "all_gather", axes)

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        """The sum (``op="max"``: the maximum) of the ranks' ``t`` over
        ``axes``, a new tensor."""
        group = self.group(axes)
        if group is None:
            return t
        import torch.distributed as dist

        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]

        def run(x):
            x = x.clone()
            dist.all_reduce(x, op=red, group=group)
            return x

        return self._staged(t, run, f"all_reduce_{op}", axes)

    def copy_to(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Megatron's *f*: ``t`` forward; backward, the gradient summed
        over ``axes``."""
        if self.group(axes) is None:
            return t
        return _CopyTo.apply(t, self, axes)

    def reduce_from(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Megatron's *g*: the sum over ``axes`` forward; backward, the
        gradient as it is."""
        if self.group(axes) is None:
            return t
        return _ReduceFrom.apply(t, self, axes)

    def gather_from(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """``all_gather`` along ``dim`` forward; backward, this rank's slice
        of the gradient along ``dim``."""
        if self.group(axes) is None:
            return t
        return _GatherFrom.apply(t, self, axes, dim)

    def scatter_to(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` (cut evenly in group
        order) forward; backward, the gradient all-gathered along
        ``dim``."""
        if self.group(axes) is None:
            return t
        return _ScatterTo.apply(t, self, axes, dim)

    def reduce_scatter_from(self, t: torch.Tensor, axes,
                            dim: int) -> torch.Tensor:
        """``reduce_scatter`` forward; backward, the gradient all-gathered
        along ``dim``."""
        if self.group(axes) is None:
            return t
        return _ReduceScatterFrom.apply(t, self, axes, dim)

    def gather_to(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """``all_gather`` along ``dim`` forward; backward, the
        ``reduce_scatter`` of the gradient along ``dim``."""
        if self.group(axes) is None:
            return t
        return _GatherTo.apply(t, self, axes, dim)

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` of the sum over ``axes`` (the
        slices cut in group order, ``dim`` divisible by the group): an
        all-reduce, then the cut (gloo has no reduce-scatter for CUDA
        tensors; NCCL's ``reduce_scatter_tensor`` waits for a run on
        several cards, ROADMAP Queue A item 3(c)).  The slice is a copy, so
        the summed buffer is freed at once."""
        if self.group(axes) is None:
            return t
        k, i = self.group_size(axes), self.group_rank(axes)
        n = t.shape[dim] // k
        return self.all_reduce(t, axes).narrow(dim, i * n, n).clone(
            memory_format=torch.contiguous_format)


def joint_group_ranks(axis_names, axis_sizes) -> dict:
    """For every set of two or more axes of more than one rank short of
    the whole mesh: the ranks of each of its groups, one group a
    coordinate of the other axes, each in group order (row-major over the
    set's axes, as rank ``r`` sits at the row-major coordinate of ``r``)."""
    import itertools

    names, sizes = tuple(axis_names), tuple(int(s) for s in axis_sizes)
    live = [a for a, n in zip(names, sizes) if n > 1]
    ranks = np.arange(math.prod(sizes)).reshape(sizes)
    out = {}
    for n in range(2, len(live)):
        for axes in itertools.combinations(live, n):
            keep = [names.index(a) for a in axes]
            rest = [i for i in range(len(names)) if i not in keep]
            blocks = np.transpose(ranks, rest + keep).reshape(
                -1, math.prod(sizes[i] for i in keep))
            out[axes] = [[int(r) for r in block] for block in blocks]
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return mesh.all_reduce(t, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.n, ctx.i = t.shape[dim], mesh.group_rank(axes)
        ctx.dim = dim
        return mesh.all_gather(t, axes, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.i * ctx.n, ctx.n), None, None, None


def _block(t: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    k, i = mesh.group_size(axes), mesh.group_rank(axes)
    if t.shape[dim] % k:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not cut "
                         f"over {k} ranks")
    n = t.shape[dim] // k
    return t.narrow(dim, i * n, n)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _block(t, mesh, axes, dim).clone()

    @staticmethod
    def backward(ctx, grad):
        return (ctx.mesh.all_gather(grad.contiguous(), ctx.axes, ctx.dim),
                None, None, None)


class _ReduceScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.reduce_scatter(t, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.mesh.all_gather(grad.contiguous(), ctx.axes, ctx.dim),
                None, None, None)


class _GatherTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(t, axes, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.mesh.reduce_scatter(grad.contiguous(), ctx.axes, ctx.dim),
                None, None, None)


def make_process_mesh(axis_sizes, axis_names, device: str | torch.device = "cuda",
                      backend: str | None = None) -> ProcessMesh:
    """The job's ranks on axes ``axis_names`` of sizes ``axis_sizes`` (their
    product the world size).  Where the default process group is not up
    yet it is initialised from ``torchrun``'s environment with ``backend``
    (default: ``backend_for`` the device and the ranks a host runs); an
    initialised group keeps its backend, and a different ``backend``
    raises.  ``device`` defaults to the card (and raises without one);
    the CPU only when asked.  On the card each rank binds card ``local
    rank % cards``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        world = int(os.environ["WORLD_SIZE"])
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        dist.init_process_group(backend or backend_for(dev, per_host))
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"backend {backend!r} asked, the job runs {have!r}")
    sizes = tuple(int(s) for s in axis_sizes)
    if math.prod(sizes) != dist.get_world_size():
        raise ValueError(f"mesh {dict(zip(axis_names, sizes))} for "
                         f"{dist.get_world_size()} ranks")
    if dev.type == "cuda":
        dev = _bind_card(_local_rank())
    dm = init_device_mesh(dev.type, sizes, mesh_dim_names=tuple(axis_names))
    return ProcessMesh(dm, dev, have)


# -- spawning ranks ----------------------------------------------------------


def _host_values(obj):
    """``obj`` with every tensor as a numpy array (bf16 as float32), so a
    rank's result crosses the queue by value."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _host_values(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_values(v) for v in obj)
    return obj


def _rank_main(fn, rank: int, world: int, store_path: str, device: str,
               backend: str, timeout_s: float, args: tuple, results) -> None:
    import torch.distributed as dist

    try:
        if torch.device(device).type == "cuda":
            _bind_card(rank)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, _host_values(fn(rank, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, *args, store_path: str,
              device: str | torch.device = "cuda", timeout_s: float = 300.0
              ) -> list:
    """``fn(rank, *args)`` in ``world_size`` processes started with
    ``torch.multiprocessing``'s spawn, the default process group up in
    each (``backend_for`` the device and the world, a ``FileStore`` at
    ``store_path``, which must not exist yet, and ``timeout_s`` on every
    collective).  ``fn`` must be importable by name; it builds its mesh
    (``make_process_mesh``) and returns picklable values (tensors come back
    as numpy arrays).  Returns the results by rank.  Every rank is joined
    within ``timeout_s`` of the start; one that failed or did not finish
    raises ``RuntimeError`` with each failing rank's traceback, after the
    rest are terminated."""
    dev = resolve_device(device)
    backend = backend_for(dev, world_size)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank-{r}",
                         args=(fn, r, world_size, store_path, str(dev),
                               backend, timeout_s, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: dict = {}
    failed: dict = {}
    deadline = time.monotonic() + timeout_s
    first_failure = math.inf
    try:
        # drain the queue before joining: a rank blocks in put() until read.
        # After a failure the others get a few seconds to report theirs (the
        # first to report is often a peer whose collective broke)
        while len(got) + len(failed) < world_size:
            if failed:
                deadline = min(deadline, first_failure + 5.0)
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(0.5)  # its traceback may still be in flight
                    if results.empty():
                        for p in dead:
                            failed.setdefault(procs.index(p),
                                              f"exited with {p.exitcode}")
                        first_failure = time.monotonic()
                continue
            (got if ok else failed)[rank] = value
            if not ok and len(failed) == 1:
                first_failure = time.monotonic()
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.0))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    missing = [r for r in range(world_size) if r not in got and r not in failed]
    if failed or missing:
        lines = [f"rank {r} failed:\n{failed[r]}" for r in sorted(failed)]
        lines += [f"rank {r} did not finish within {timeout_s} s"
                  for r in missing]
        raise RuntimeError(f"{len(failed)} of {world_size} ranks failed, "
                           f"{len(missing)} hung or were stopped:\n"
                           + "\n".join(lines))
    return [got[r] for r in range(world_size)]
