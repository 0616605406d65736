"""Program-contract analyzer: the reference's jit contracts, held by running
every program cell.

For every program the pipeline family can build — CNN archs x batch
buckets x {torch, kernel} backends x {fused, unfused} transitions, in the
single-process (``direct``) and runtime (``cluster``) execution modes, plus
the coded LM decoder's program space ({coded, uncoded} plans x backends,
worker GEMM rounds and master-side glue alike) — this module enumerates the
cells (``CodedPipeline.program_space`` / ``CodedDecoderPipeline
.program_space``), runs each one once on arguments materialised on the
device under ``dispatch_tools.Recorder``, and checks:

- ``BAKED-CONST`` (error): decode-inverse / encode-column matrices must
  enter programs as *arguments*, never constants the program holds — a
  held survivor-subset matrix would mean a program (or a CUDA graph) per
  subset.  Any floating constant of >= ``CONST_SIZE_LIMIT`` elements is
  flagged unless the cell allows its shape (the cluster encoder reads the
  full-n A-code matrix: it is subset-independent).
- ``F64`` (error): no float64/complex128 tensor on the cell's device, in
  its arguments or made by any of its ops — the stack is float32-resident.
  The recovery inverse taken in float64 on the host, outside every cell
  (``core/crme.py``, ``CodedPipeline.decode_matrix``), stays allowed, as
  in the reference.
- ``OUT-DTYPE`` (warning): every floating output is float32.  It stands in
  for the reference's ``JIT-WEAK-TYPE``: torch has no weak types, and a
  Python-scalar promotion shows as a wrong dtype instead.
- ``HOST-SYNC`` (error): no host sync the recorder can see inside a cell
  (``.item()``, a data-dependent output shape, a copy off the device or of
  a host tensor onto it).  It stands in for ``JIT-HOST-CALLBACK``.
- ``TRACE-BOUND`` (error): the static proof of the bounded-program
  contract — per execution mode, the distinct worker and transition
  signatures the full shape space induces must not exceed
  ``program_trace_bound`` ((geometries + transitions) x buckets).
- ``CAPTURE`` (error, CUDA only): each cell not declared ``eager_only`` is
  run through the serving path's own capture helper
  (``core.graphs.GraphSet``, ``torch.cuda.CUDAGraph``): captured after one
  warm-up call (the kernels' build and load, ``ctypes`` lookups and
  allocator warm-up happen outside the capture) and replayed, then called
  again on a second set of arguments — for decode and transition cells
  the operand of a *different* survivor subset; a resident argument keeps
  its storage and takes the second set's values in place — which must
  replay, not capture again, and be ``torch.equal`` to an eager call on
  that second set.  A failed capture or a replay that differs is an
  error; ``eager_only`` cells are counted and listed.

``JIT-DONATION`` has no counterpart: torch has no buffer donation (a
program reuses an argument's memory only by writing it in place, which
the caller sees), so every cell's ``donate_argnums`` is ``()``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import torch
from torch.utils._pytree import tree_leaves

from ..core.graphs import GraphSet
from ..core.pipeline import Program, dtype_name
from ..devices import resolve_device
from . import dispatch_tools
from .findings import Report, Severity

# Floating constants smaller than this are tolerated everywhere (eps
# scalars, small masks); coding matrices are always bigger.
CONST_SIZE_LIMIT = 16
F64_DTYPES = {torch.float64, torch.complex128}
BACKENDS = ("torch", "kernel")


@dataclasses.dataclass(frozen=True)
class ContractConfig:
    """One pipeline family member to analyze."""

    arch: str
    backend: str  # "torch" | "kernel"
    fused: bool
    n: int = 4
    kab: tuple = (2, 2)
    buckets: tuple = (1, 2)

    @property
    def label(self) -> str:
        fused = "fused" if self.fused else "unfused"
        return f"{self.arch}/{self.backend}/{fused}"


def iter_configs(archs: Sequence[str] | None = None,
                 backends: Sequence[str] = BACKENDS) -> list[ContractConfig]:
    """The default analysis matrix: every arch x backend x transition mode."""
    if archs is None:
        from ..models.cnn import CNN_SPECS

        archs = sorted(CNN_SPECS)
    return [ContractConfig(arch, backend, fused)
            for arch in archs for backend in backends for fused in (False, True)]


def build_pipeline(cfg: ContractConfig, device="cuda"):
    """The config's pipeline at smoke resolution with zero weights (shapes
    are all that matter; encoding zero filters is cheap)."""
    from ..core.pipeline import build_cnn_pipeline
    from ..models.cnn import CNN_SPECS, input_hw

    _, layers = CNN_SPECS[cfg.arch]
    params = {l.name: torch.zeros((l.out_ch, l.in_ch, l.kernel, l.kernel))
              for l in layers}
    return build_cnn_pipeline(
        cfg.arch, params, n=cfg.n, default_kab=cfg.kab,
        input_hw=input_hw(cfg.arch, smoke=True), backend=cfg.backend,
        bucket_sizes=cfg.buckets, fuse_transitions=cfg.fused, device=device)


@dataclasses.dataclass(frozen=True)
class DecoderContractConfig:
    """One coded-LM-decoder family member: the decoder's program space gets
    the same contracts as the ConvL pipelines."""

    plan_kind: str  # "coded" | "uncoded"
    backend: str  # "torch" | "kernel"
    n: int = 4
    k_b: int = 4
    buckets: tuple = (1, 2)

    @property
    def label(self) -> str:
        return f"lm-decoder/{self.backend}/{self.plan_kind}"


def iter_decoder_configs(
        backends: Sequence[str] = BACKENDS) -> list[DecoderContractConfig]:
    return [DecoderContractConfig(kind, backend)
            for backend in backends for kind in ("coded", "uncoded")]


def build_decoder_pipeline(cfg: DecoderContractConfig, device="cuda"):
    """The smoke LM config with zero weights (shape space only)."""
    from ..configs import smollm_135m
    from ..core.decoder_pipeline import UncodedPlan, build_lm_decoder_pipeline
    from ..models import transformer as lm

    lm_cfg = smollm_135m.smoke()
    params = lm.map_params(torch.zeros_like,
                           lm.init_lm(lm_cfg, torch.Generator().manual_seed(0),
                                      "cpu"))
    plan = UncodedPlan(cfg.n) if cfg.plan_kind == "uncoded" else None
    return build_lm_decoder_pipeline(
        lm_cfg, params, cfg.n, k_b=None if plan else cfg.k_b, plan=plan,
        backend=cfg.backend, bucket_sizes=cfg.buckets, max_len=32,
        device=device)


# -- per-cell checks (unit-testable on any cell-shaped object) --------------

def check_recording(cell, rec: dispatch_tools.Recording, device) -> list:
    """BAKED-CONST / F64 / OUT-DTYPE / HOST-SYNC on one recorded call.
    ``cell`` needs ``cell_id``, ``args`` (specs with ``shape``, ``dtype``
    and ``host``) and ``allowed_const_shapes``."""
    device = torch.device(device)
    report = Report()
    loc = cell.cell_id
    allowed = {tuple(s) for s in getattr(cell, "allowed_const_shapes", ())}

    for t in rec.consts:
        if not (t.is_floating_point() or t.is_complex()):
            continue
        if t.numel() < CONST_SIZE_LIMIT or tuple(t.shape) in allowed:
            continue
        report.add(
            "BAKED-CONST", Severity.ERROR, loc,
            f"program holds a float constant of shape {tuple(t.shape)} "
            f"({dtype_name(t.dtype)}, on {t.device}); coding matrices must "
            f"be arguments so survivor subsets never mint a new program")

    bad = {dtype_name(a.dtype) for a in cell.args
           if a.dtype in F64_DTYPES and not getattr(a, "host", False)}
    bad |= {dtype_name(dtype) for op in rec.ops
            for dtype, dev in zip(op.out_dtypes, op.out_devices)
            if dtype in F64_DTYPES and dispatch_tools.on_device(dev, device)}
    if bad:
        report.add(
            "F64", Severity.ERROR, loc,
            f"program has {'/'.join(sorted(bad))} tensors on {device}; the "
            f"stack is float32-resident")

    wrong = sorted({dtype_name(t.dtype) for t in rec.outputs
                    if (t.is_floating_point() or t.is_complex())
                    and t.dtype != torch.float32})
    if wrong:
        report.add(
            "OUT-DTYPE", Severity.WARNING, loc,
            f"program outputs {wrong} where float32 is expected; a "
            f"Python-scalar promotion leaked into the program")

    if rec.syncs:
        report.add(
            "HOST-SYNC", Severity.ERROR, loc,
            f"host sync(s) inside the program: {'; '.join(rec.syncs[:4])}"
            + (f" (+{len(rec.syncs) - 4} more)" if len(rec.syncs) > 4 else ""))
    return report.findings


def check_cell(cell, args, device) -> list:
    """Run ``cell.fn(*args)`` under the recorder and check the call."""
    return check_recording(cell, dispatch_tools.record(cell.fn, args, device),
                           device)


def _clones(args) -> tuple:
    return tuple(a.clone() for a in args)


def capture_replay(cell, args1, args2, device,
                   graph_cls=torch.cuda.CUDAGraph) -> str | None:
    """CAPTURE on one cell, through the serving path's capture helper: a
    call on ``args1`` captures the cell's program (warm-up, capture,
    replay); a call on ``args2`` — its resident arguments refilled in
    place with ``args2``'s values — must replay that graph, and every
    output must be ``torch.equal`` to an eager call on ``args2``.
    Returns what failed, or None."""
    prog = cell.fn if isinstance(cell.fn, Program) else Program(
        cell.fn, name=cell.kind)
    graphs = GraphSet(f"contracts:{cell.cell_id}", device, graph_cls)
    first = _clones(args1)
    try:
        graphs.run(prog, first)
        second = list(_clones(args2))
        for j in prog.resident:
            first[j].copy_(args2[j])
            second[j] = first[j]
        captured = graphs.run(prog, tuple(second))
    except Exception as err:  # the capture (or its replay) failed
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        return f"capture failed: {type(err).__name__}: {err}"
    if graphs.num_graphs != 1:
        return f"the second argument set captured again ({graphs.num_graphs} graphs)"
    eager = prog.eager(*_clones(args2))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    got = [t for t in tree_leaves(captured) if isinstance(t, torch.Tensor)]
    want = [t for t in tree_leaves(eager) if isinstance(t, torch.Tensor)]
    if len(got) != len(want):
        return f"replay gave {len(got)} outputs, eager {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not torch.equal(g, w):
            diff = ((g.double() - w.double()).abs().max().item()
                    if g.shape == w.shape else float("nan"))
            return (f"replay output {i} differs from eager on a second "
                    f"argument set (max abs diff {diff})")
    return None


def check_trace_bound(pipe, cells: Iterable, label: str) -> Report:
    """TRACE-BOUND: distinct worker + transition signatures per execution
    mode must fit ``pipe.program_trace_bound``.  Static proof by exhaustive
    enumeration: ``program_space`` covers every (layer, bucket, mode) the
    pipeline can launch, and BAKED-CONST separately proves survivor
    subsets cannot mint new signatures."""
    report = Report()
    per_mode: dict[str, set] = {}
    for cell in cells:
        if cell.kind in ("worker", "transition"):
            per_mode.setdefault(cell.mode, set()).add(cell.trace_signature)
    bound = pipe.program_trace_bound
    for mode, sigs in sorted(per_mode.items()):
        report.stats[f"{label}/{mode}/traces"] = len(sigs)
        if len(sigs) > bound:
            report.add(
                "TRACE-BOUND", Severity.ERROR, f"{label}:{mode}",
                f"shape space induces {len(sigs)} worker+transition "
                f"signatures in {mode} mode, exceeding the bounded-program "
                f"contract of {bound} ((geometries={pipe.num_geometries} + "
                f"transitions={pipe.num_transitions}) x "
                f"buckets={len(pipe.bucket_sizes or (1,))})")
    report.stats[f"{label}/bound"] = bound
    return report


# -- running the analyzer ---------------------------------------------------

def analyze(pipe, label: str, device, *, capture: bool | None = None,
            seed: int = 0, cells=None,
            graph_cls=torch.cuda.CUDAGraph) -> Report:
    """Run and check every program cell of one pipeline's shape space (or
    of ``cells``), capturing each one (with ``graph_cls``) on CUDA unless
    ``capture`` says otherwise.  Stats: cells checked, captured and eager-only, and the
    eager-only cells and their reasons."""
    device = resolve_device(device)
    if capture is None:
        capture = device.type == "cuda"
    report = Report()
    cells = list(pipe.program_space()) if cells is None else list(cells)
    report.extend(check_trace_bound(pipe, cells, label))
    gen = torch.Generator(device=device).manual_seed(seed)
    seen: set = set()
    checked = captured = 0
    eager_only: dict[str, str] = {}
    for cell in cells:
        # cells can repeat one (program, argument signature) across modes —
        # checking one representative per program is enough
        key = (id(cell.fn), cell.trace_signature[3])
        if key in seen:
            continue
        seen.add(key)
        args = dispatch_tools.materialize(pipe, cell, device, gen)
        for f in check_cell(cell, args, device):
            report.findings.append(
                dataclasses.replace(f, location=f"{label}/{f.location}"))
        checked += 1
        if not capture:
            continue
        if cell.eager_only:
            eager_only[cell.cell_id] = cell.eager_only
            continue
        args2 = dispatch_tools.materialize(pipe, cell, device, gen, variant=1)
        err = capture_replay(cell, args, args2, device, graph_cls)
        if err is None:
            captured += 1
        else:
            report.add("CAPTURE", Severity.ERROR, f"{label}/{cell.cell_id}", err)
    report.stats[f"{label}/programs_checked"] = checked
    if capture:
        report.stats[f"{label}/captured"] = captured
        report.stats[f"{label}/eager_only"] = len(eager_only)
        if eager_only:
            report.stats[f"{label}/eager_only_cells"] = sorted(eager_only)
            report.stats[f"{label}/eager_only_reasons"] = sorted(
                set(eager_only.values()))
    return report


def analyze_config(cfg: ContractConfig, device="cuda", **kw) -> Report:
    return analyze(build_pipeline(cfg, device), cfg.label, device, **kw)


def analyze_decoder_config(cfg: DecoderContractConfig, device="cuda",
                           **kw) -> Report:
    return analyze(build_decoder_pipeline(cfg, device), cfg.label, device, **kw)


def run(archs: Sequence[str] | None = None,
        backends: Sequence[str] = BACKENDS, device="cuda", **kw) -> Report:
    """The contract analyzer over the full pipeline family: every CNN
    config plus the coded-LM-decoder program space, on ``device``."""
    report = Report()
    configs = iter_configs(archs, backends)
    for cfg in configs:
        report.extend(analyze_config(cfg, device, **kw))
    decoder_configs = iter_decoder_configs(backends)
    for dcfg in decoder_configs:
        report.extend(analyze_decoder_config(dcfg, device, **kw))
    report.stats["contract_configs"] = len(configs) + len(decoder_configs)
    report.stats["contract_device"] = str(resolve_device(device))
    return report
