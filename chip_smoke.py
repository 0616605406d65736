#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port builds, runs and serves on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and the CUDA toolkit, and fails (exit code != 0,
no result line) without them or outside a checkout of the repository.
Phases, in order; any failure raises:

 1. print the card's name and power limit (``nvidia-smi``);
 2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``;
 3. kernel phase: each kernel at every shape the serving phase launches
    (VGG-16 at 224x224, bucket 8), held against its plain PyTorch version
    on the same inputs, timed beside its plain version, a library call
    and its bound;
 4. serving phase: ``CodedServer`` serving 16 VGG-16 224x224 requests on
    n=8 coded workers (2 stragglers at +50 ms, 1 dead worker, fused
    transitions, pipeline depth 2), every result held against the uncoded
    stack; the kernels' launch counts are read around this phase only;
 5. one JSON line with the kernels' numbers, then the result line.

TF32 is off for every product here (the CRME decode multiplies rounding
error by the recovery matrix's condition number).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth.  The bound of a kernel is the larger of its
# operations over the first and its bytes over the second.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

ARCH, HW, N_WORKERS, KAB, BUCKET = "vgg16", 224, 8, (2, 4), 8
N_REQUESTS, STRAGGLER_DELAY_S, SEED = 16, 0.05, 0
# K1 sums up to C*KH*KW = 4608 fp32 products, K2 at most Q = 8; a plain
# version may sum in another order.  Both are held to a bound on
# max|kernel - plain| relative to max|plain|, far above fp32 rounding at
# those depths and far below any indexing or masking fault.
TOL_K1, TOL_K2 = 1e-4, 1e-5
# Served outputs against the uncoded stack, relative to max|uncoded|: the
# reference's own tests use 1e-4 for two small layers.  At 224 the 13
# layers of fp32 sums (K up to 4608), each decode multiplying rounding
# error by the recovery matrix's condition number, were measured at about
# 1e-5 on an H100, so the reference's 1e-4 holds here too.
TOL_SERVE = 1e-4


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events around the run, after ``warm`` untimed calls)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def worker_shapes(pipe, bucket: int) -> list[tuple[tuple, tuple, int]]:
    """K1's ``(xe, ke, stride)`` per layer: one worker's coded shares and
    coded filter groups at ``bucket``."""
    out = []
    for spec in pipe.specs:
        g, p = spec.geo, spec.plan
        out.append(((p.ell_a, bucket, g.in_channels, g.h_hat, g.padded_w),
                    (p.ell_b, g.out_c_block, g.in_channels, g.kernel_h,
                     g.kernel_w), g.stride))
    return out


def transition_shapes(pipe, bucket: int) -> list[tuple[tuple, tuple, bool]]:
    """K2's ``(a, b, relu)`` per fused transition of the cluster path: the
    decode GEMM and the all-n re-encode GEMM."""
    out = []
    for spec, nxt in zip(pipe.specs, pipe.specs[1:]):
        g, p, g2 = spec.geo, spec.plan, nxt.geo
        q = p.k_a * p.k_b
        f = bucket * g.out_c_block * g.out_h_block * g.out_w
        out.append(((q, q), (q, f), True))
        width = nxt.plan.ell_a * pipe.n
        f2 = bucket * g2.in_channels * g2.h_hat * g2.padded_w
        out.append(((width, nxt.plan.k_a), (nxt.plan.k_a, f2), False))
    return out


def _err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    abs_err = float((got - ref).abs().max())
    return abs_err, abs_err / max(float(ref.abs().max()), 1e-30)


def _summarise(entries: list[dict]) -> dict:
    """Totals over one pass of the path (each shape times the layers that
    launch it), worst errors over all shapes."""
    tot = {k: sum(e[k] * e["count"] for e in entries)
           for k in ("ms", "plain_ms", "bound_ms")}
    lib = [e["library_ms"] for e in entries]
    ops = sum(e["bound_ms"] * e["count"] for e in entries
              if e["bound_by"] == "operations")
    return {
        **tot,
        "kernel_ms": tot["ms"],
        "library_ms": (None if any(v is None for v in lib)
                       else sum(v * e["count"] for v, e in zip(lib, entries))),
        "bound_by": "operations" if ops >= tot["bound_ms"] / 2 else "bytes",
        "max_abs_err": max(e["max_abs_err"] for e in entries),
        "max_rel_err": max(e["max_rel_err"] for e in entries),
        "library_rel_err": max(e["library_rel_err"] for e in entries),
    }


def kernel_phase(pipe, bucket: int, device, timed: bool = True) -> list[dict]:
    """Each kernel at each of its serving shapes against its plain version
    (and, timed, beside one library call that computes the same
    function).  Raises when a kernel disagrees beyond its tolerance."""
    from repro_torch.kernels.conv2d.kernel import coded_worker, coded_worker_plain
    from repro_torch.kernels.matmul.kernel import matmul, matmul_plain

    gen = torch.Generator(device=device).manual_seed(SEED)
    k1, k2 = [], []
    seen: dict = {}
    for xs, ks, stride in worker_shapes(pipe, bucket):
        if (xs, ks, stride) in seen:
            seen[(xs, ks, stride)]["count"] += 1
            continue
        xe = torch.randn(xs, generator=gen, device=device)
        ke = torch.randn(ks, generator=gen, device=device) / np.sqrt(np.prod(ks[2:]))
        got, ref = coded_worker(xe, ke, stride), coded_worker_plain(xe, ke, stride)
        abs_err, rel_err = _err(got, ref)
        if not rel_err <= TOL_K1:
            raise AssertionError(f"K1 {xs} x {ks}: rel err {rel_err} > {TOL_K1}")
        ea, b, c, hh, wp = xs
        eb, nb, _, kh, kw = ks
        m = ea * b * got.shape[-2] * got.shape[-1]
        kk, n = c * kh * kw, eb * nb
        bnd, by = bound_ms(2.0 * m * n * kk, 4.0 * (xe.numel() + ke.numel() + got.numel()))
        e = {"xe": list(xs), "ke": list(ks), "stride": stride, "count": 1,
             "gemm_mnk": [m, n, kk], "max_abs_err": abs_err,
             "max_rel_err": rel_err, "bound_ms": bnd, "bound_by": by,
             "ms": None, "plain_ms": None, "library_ms": None}
        if timed:
            xin = xe.reshape(ea * b, c, hh, wp)
            wcat = ke.reshape(eb * nb, c, kh, kw)
            e["ms"] = cuda_ms(lambda: coded_worker(xe, ke, stride))
            e["plain_ms"] = cuda_ms(lambda: coded_worker_plain(xe, ke, stride))
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                e["library_ms"] = cuda_ms(lambda: F.conv2d(xin, wcat, stride=stride))
                lib = F.conv2d(xin, wcat, stride=stride)
            # the library call sums in its own order: a second, independent
            # check of the kernel (same layout after the reference permute)
            lib = lib.reshape(ea, b, eb, nb, *lib.shape[-2:]).transpose(1, 2)
            e["library_rel_err"] = _err(got, lib.reshape(got.shape))[1]
        seen[(xs, ks, stride)] = e
        k1.append(e)
        del xe, ke, got, ref
    seen = {}
    for a_s, b_s, relu in transition_shapes(pipe, bucket):
        if (a_s, b_s, relu) in seen:
            seen[(a_s, b_s, relu)]["count"] += 1
            continue
        a = torch.randn(a_s, generator=gen, device=device)
        b = torch.randn(b_s, generator=gen, device=device)
        got, ref = matmul(a, b, relu=relu), matmul_plain(a, b, relu=relu)
        abs_err, rel_err = _err(got, ref)
        if not rel_err <= TOL_K2:
            raise AssertionError(f"K2 {a_s} x {b_s}: rel err {rel_err} > {TOL_K2}")
        (m, kk), n = a_s, b_s[1]
        bnd, by = bound_ms(2.0 * m * n * kk, 4.0 * (m * kk + kk * n + m * n))
        e = {"a": list(a_s), "b": list(b_s), "relu": relu, "count": 1,
             "max_abs_err": abs_err, "max_rel_err": rel_err,
             "bound_ms": bnd, "bound_by": by, "ms": None, "plain_ms": None,
             "library_ms": None}
        if timed:
            e["ms"] = cuda_ms(lambda: matmul(a, b, relu=relu))
            e["plain_ms"] = cuda_ms(lambda: matmul_plain(a, b, relu=relu))
            e["library_ms"] = cuda_ms(lambda: torch.matmul(a, b))
            lib = torch.matmul(a, b)
            e["library_rel_err"] = _err(got, lib.clamp_min(0) if relu else lib)[1]
        seen[(a_s, b_s, relu)] = e
        k2.append(e)
        del a, b, got, ref
    return [
        {"name": "coded_worker", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/coded_worker.cu",
         "replaces": "src/repro/kernels/conv2d/kernel.py:291",
         "tpu_kernel": "coded_worker_pallas / _fused_worker_gemm "
                       "(src/repro/kernels/conv2d/kernel.py:190)",
         "tol": TOL_K1, "library": "F.conv2d (cuDNN, TF32 off)",
         "shapes": k1, **(_summarise(k1) if timed else {})},
        {"name": "matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul/kernel.py:111",
         "tpu_kernel": "matmul_pallas (src/repro/kernels/matmul/kernel.py:111)",
         "tol": TOL_K2, "library": "torch.matmul (no ReLU)",
         "shapes": k2, **(_summarise(k2) if timed else {})},
    ]


def check_launched_shapes(pipe, bucket: int) -> None:
    """The shapes the kernel phase timed are the ones the serving phase
    ran: every K1 shape appears among the cluster worker program's
    argument signatures, every decode GEMM among the transitions'."""
    seen_k1 = {sig for prog in pipe._cluster_programs.values()
               for sig in prog.signatures}
    for xs, ks, _ in worker_shapes(pipe, bucket):
        if ((xs, "torch.float32"), (ks, "torch.float32")) not in seen_k1:
            raise AssertionError(f"K1 shape {xs} x {ks} never served")
    seen_dec = {(sig[0][0][0] * sig[0][0][1], int(np.prod(sig[0][0][2:])))
                for prog in pipe._transitions.values() for sig in prog.signatures}
    for (q, _), (_, f), relu in transition_shapes(pipe, bucket):
        if relu and (q, f) not in seen_dec:
            raise AssertionError(f"decode GEMM {q}x{f} never served")


def serving_phase(server, xs: np.ndarray, counters) -> tuple[list, object, dict]:
    """Warm up, zero the launch counts, serve ``xs`` as single-image
    requests, read the counts.  Returns (results, stats, launches)."""
    server.warmup()
    for c in counters:
        c.reset()
    with server:
        handles = server.submit_many(xs)
        outs = [h.result(timeout=600.0) for h in handles]
    return outs, server.stats(), {c.name: c.count for c in counters}


def straggler_delays(n: int) -> np.ndarray:
    """2 stragglers at +50 ms and 1 dead worker, placed by the seed."""
    order = np.random.default_rng(SEED).permutation(n)
    delays = np.zeros(n)
    delays[order[:2]] = STRAGGLER_DELAY_S
    delays[order[2]] = np.inf
    return delays


def build_server(device, hw: int):
    from repro_torch.models.cnn import init_cnn
    from repro_torch.runtime import StragglerModel
    from repro_torch.serving import CodedServer

    params = init_cnn(ARCH, torch.Generator().manual_seed(SEED), device)
    server = CodedServer.from_cnn(
        ARCH, params, N_WORKERS, default_kab=KAB, input_hw=hw,
        straggler=StragglerModel(straggler_delays(N_WORKERS)), mode="threads",
        execution="cluster", backend="kernel", bucket_sizes=(1, 2, 4, BUCKET),
        pipeline_depth=2, fuse_transitions=True, device=device)
    return server, params


def check_served(outs, xs: np.ndarray, params, device) -> float:
    """Every served result against the uncoded stack on the same device
    (TF32 off).  Returns the worst error relative to max|uncoded|."""
    from repro_torch.models.cnn import run_convls

    worst = 0.0
    for i in range(0, len(xs), BUCKET):
        ref = run_convls(ARCH, params, torch.as_tensor(xs[i:i + BUCKET], device=device))
        for row, got in enumerate(outs[i:i + BUCKET]):
            r = ref[row].cpu()
            g = torch.as_tensor(got)
            if g.shape != r.shape or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"request {i + row}: shape {tuple(g.shape)}"
                                     f" vs {tuple(r.shape)} or non-finite")
            worst = max(worst, _err(g, r)[1])
    if not worst <= TOL_SERVE:
        raise AssertionError(f"served results off the uncoded stack: "
                             f"rel err {worst} > {TOL_SERVE}")
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this proof "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels.conv2d.kernel import launches as k1_launches
    from repro_torch.kernels.matmul.kernel import launches as k2_launches
    from repro_torch.kernels.native import build_library, load_library

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _, log = build_library()
    load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    server, params = build_server(device, HW)
    pipe = server.pipeline
    t0 = time.perf_counter()
    kernels = kernel_phase(pipe, BUCKET, device)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.3f} ms per pass of its serving shapes "
              f"(plain {k['plain_ms']:.3f}, library {k['library_ms']}, bound "
              f"{k['bound_ms']:.3f} by {k['bound_by']}), max rel err "
              f"{k['max_rel_err']:.2e} <= {k['tol']} vs plain, "
              f"{k['library_rel_err']:.2e} vs library")

    xs = np.random.default_rng(SEED).standard_normal(
        (N_REQUESTS,) + pipe.input_shape).astype(np.float32)
    t0 = time.perf_counter()
    outs, stats, launches = serving_phase(server, xs, (k1_launches, k2_launches))
    print(f"serving phase: {time.perf_counter() - t0:.1f} s (warmup included)")
    check_launched_shapes(pipe, BUCKET)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched while serving")
    worst = check_served(outs, xs, params, device)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    print(f"served {stats.completed} {ARCH} {HW}x{HW} requests on n={N_WORKERS} "
          f"workers (2 stragglers +{STRAGGLER_DELAY_S * 1e3:.0f} ms, 1 dead), "
          f"fused transitions, depth 2, on {card}: "
          f"{stats.images_per_s:.2f} img/s, e2e p50 {stats.e2e_p50_s * 1e3:.1f} "
          f"ms, p99 {stats.e2e_p99_s * 1e3:.1f} ms; max rel err vs uncoded "
          f"{worst:.2e} <= {TOL_SERVE}; launches {launches}")
    ov = server.overlap_stats()
    print(f"round phases over {ov.rounds} rounds (s): dispatch {ov.dispatch_s:.4f}, "
          f"worker {ov.worker_s:.4f}, collect {ov.collect_s:.4f}, transition "
          f"{ov.transition_s:.4f}; busy wall {ov.busy_wall_s:.4f}, overlap "
          f"efficiency {ov.overlap_efficiency:.3f}, max depth {ov.max_depth}")

    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
