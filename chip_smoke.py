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
    on the same inputs and against a second launch of itself (same bits),
    timed beside its plain version, a library call and its bound, with
    the launch plan (tile, split) K1 and K2 took at each shape;
 4. serving phase: ``CodedServer`` serving 16 VGG-16 224x224 requests on
    n=8 coded workers (2 stragglers at +50 ms, 1 dead worker, fused
    transitions, pipeline depth 2), every result held against the uncoded
    stack; the kernels' launch counts are read around this phase only;
 5. LM kernel phase: SmolLM-135M at full width and depth (random weights
    from the seed) compiled into a ``CodedDecoderPipeline`` on n=4 workers
    (k_a=1, k_b=4: delta=2, gamma=2); K2 at the worker GEMM shapes, K3 at
    every decode shape of bucket 4 and every build-time encode shape (the
    code matrix on the host, as the path passes it), K4 at the bucket-4
    prefill in fp32 and, beside it, in bf16 (the TPU kernel's other
    operand type; the served path is fp32), each held against its plain
    version and a second launch of itself, and timed beside a library call
    and its bound, with the launch plan it took;
 6. LM serving phase: ``CodedLMServer`` serving 8 requests (prompts of
    2-16 tokens, 8-16 new tokens, drawn from the seed) under one straggler
    (+50 ms) and one dead worker; the K2, K3 and K4 launch counts are read
    around this phase only;
 7. LM correctness: the logits rows the server chose each token from
    (recorded through ``on_logits`` while it served) held against the
    undistributed ``transformer.prefill`` + ``decode_step``, teacher-forced
    on each served stream: within 1e-4 relative to max|logit|, and each
    served token an argmax of the undistributed logits up to that
    tolerance;
 8. one JSON line with the kernels' numbers (K1-K4; K2's top-level numbers
    are its CNN pass, its LM numbers sit under ``paths.lm``), then the
    result line.

TF32 is off for every product here (the CRME decode multiplies rounding
error by the recovery matrix's condition number).

Two times per call.  ``ms`` is CUDA events around 10 back-to-back calls:
where the host issues a call (``ctypes``, the allocator, the launch) more
slowly than the card runs it, that is the host's rate.  ``device_ms``
holds the stream with ``torch.cuda._sleep`` while the host issues the
same calls, so its events bracket device execution only;
``library_device_ms`` times the library yardstick the same way, and
``profiler_device_ms`` sums ``torch.profiler``'s kernel records as a
cross-check.  Inputs stay in the 50 MB L2 across the 10 calls where they
fit.
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

# The LM path: exp13's plan (n=4, k_a=1, k_b=4) on SmolLM-135M.
LM_N, LM_KB, LM_BUCKETS, LM_MAX_LEN, LM_MAX_PROMPT = 4, 4, (1, 2, 4), 64, 16
LM_REQUESTS, LM_PROMPT_LEN, LM_GEN = 8, (2, 16), (8, 16)
# worker 2 straggles at +50 ms, worker 3 is dead: both within gamma = 2
LM_DELAYS = (0.0, 0.0, STRAGGLER_DELAY_S, float("inf"))
# K3 sums R_in <= 4 products in order; K4 sums 64-term dot products and an
# online softmax over <= 16 keys (expf against the library's exp).  Both
# relative to max|plain|.  K4 in bf16 rounds p and its output to bf16, as
# its plain version does; an fp32 sum in another order may flip either
# rounding, so it is held to one bf16 rounding of the output (2^-7 of
# max|plain|).  Where one 32-key chunk holds every key (S <= 32, the
# prefill), the kernel rounds p exactly where the plain version does, so
# the two outputs are also bit-equal in all but K4_BF16_MISMATCH of their
# elements: an fp32 score summed in another order flips p's rounding in
# fewer, while a kernel that skipped rounding p (within 2^-7 all the same)
# changes about a quarter of them (both held on random data by
# tests/test_torch_lm_kernels.py).
TOL_K3, TOL_K4, TOL_K4_BF16 = 1e-5, 2e-5, 2.0 ** -7
K4_ONE_CHUNK, K4_BF16_MISMATCH = 32, 1e-3
# served (coded, cluster) logits against the undistributed transformer's, relative
# to max|logit|: the reference's own coded-decoder tolerance is 3e-4 abs
# at smoke size; 30 layers of fp32 sums through a decode whose recovery
# matrix has a condition number of a few stay far inside 1e-4
TOL_LM = 1e-4


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, host issue
    included: CUDA events around the run, after ``warm`` untimed calls.
    Where the host issues a call more slowly than the card runs it, this
    is the host's rate (``ms`` in the kernels line)."""
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


_SLEEP_CYCLES_PER_MS: list[float] = []


def _sleep_cycles_per_ms() -> float:
    """``torch.cuda._sleep`` cycles per ms of device time, measured once."""
    if not _SLEEP_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def device_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, host
    issue excluded: a ``torch.cuda._sleep`` holds the stream while the host
    issues the start event, the calls and the end event, so the events
    bracket device execution only.  The hold is sized from a timed run of
    the same calls and checked: the start event must still be pending when
    the host has issued everything.  Raises if no hold covers the issue."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    hold_ms = 2.0 * (time.perf_counter() - t0) * 1e3 + 1.0
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * _sleep_cycles_per_ms()))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        hold_ms *= 4.0
    raise RuntimeError("device_ms: the stream hold never outlasted the host's "
                       "issue of the timed calls")


def profiler_device_ms(fn, reps: int = 10) -> float | None:
    """Mean device time of ``fn`` by ``torch.profiler``'s kernel records
    (the sum of their self device time over ``reps`` calls): a cross-check
    of ``device_ms`` by another clock.  None when the profiler recorded no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        total_us += float(t if t is not None else ev.self_cuda_time_total)
    return total_us / 1e3 / reps if total_us > 0 else None


def timings(fn, plain, library) -> dict:
    """``ms`` / ``device_ms`` (and the profiler's ``profiler_device_ms``)
    of the kernel call ``fn``, ``plain_ms`` of its plain version and
    ``library_ms`` / ``library_device_ms`` of the library yardstick (None
    where there is none)."""
    out = {"ms": cuda_ms(fn), "device_ms": device_ms(fn),
           "profiler_device_ms": profiler_device_ms(fn),
           "plain_ms": cuda_ms(plain), "library_ms": None,
           "library_device_ms": None}
    if library is not None:
        out["library_ms"] = cuda_ms(library)
        out["library_device_ms"] = device_ms(library)
    return out


def check_repeatable(name: str, fn, got: torch.Tensor) -> None:
    """A second launch on the same inputs gives the same bits."""
    if not torch.equal(fn(), got):
        raise AssertionError(f"{name}: two launches on the same inputs differ")


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
           for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    ops = sum(e["bound_ms"] * e["count"] for e in entries
              if e["bound_by"] == "operations")

    def opt_sum(key):
        vals = [e.get(key) for e in entries]
        return (None if any(v is None for v in vals)
                else sum(v * e["count"] for v, e in zip(vals, entries)))

    return {
        **tot,
        "kernel_ms": tot["ms"],
        "profiler_device_ms": opt_sum("profiler_device_ms"),
        "library_ms": opt_sum("library_ms"),
        "library_device_ms": opt_sum("library_device_ms"),
        "bound_by": "operations" if ops >= tot["bound_ms"] / 2 else "bytes",
        "max_abs_err": max(e["max_abs_err"] for e in entries),
        "max_rel_err": max(e["max_rel_err"] for e in entries),
        "library_rel_err": max(e["library_rel_err"] for e in entries),
    }


def kernel_phase(pipe, bucket: int, device, timed: bool = True) -> list[dict]:
    """Each kernel at each of its serving shapes against its plain version
    (and, timed, beside one library call that computes the same
    function).  Raises when a kernel disagrees beyond its tolerance."""
    from repro_torch.kernels.conv2d.kernel import (coded_worker,
                                                   coded_worker_plain,
                                                   worker_plan)
    from repro_torch.kernels.matmul.kernel import matmul, matmul_plain, matmul_plan

    gen = torch.Generator(device=device).manual_seed(SEED)
    k1, k2 = [], []
    seen: dict = {}
    for xs, ks, stride in worker_shapes(pipe, bucket):
        if (xs, ks, stride) in seen:
            seen[(xs, ks, stride)]["count"] += 1
            continue
        xe = torch.randn(xs, generator=gen, device=device)
        ke = torch.randn(ks, generator=gen, device=device) / np.sqrt(np.prod(ks[2:]))
        def run():
            return coded_worker(xe, ke, stride)

        got, ref = run(), coded_worker_plain(xe, ke, stride)
        abs_err, rel_err = _err(got, ref)
        if not rel_err <= TOL_K1:
            raise AssertionError(f"K1 {xs} x {ks}: rel err {rel_err} > {TOL_K1}")
        check_repeatable(f"K1 {xs} x {ks}", run, got)
        ea, b, c, hh, wp = xs
        eb, nb, _, kh, kw = ks
        m = ea * b * got.shape[-2] * got.shape[-1]
        kk, n = c * kh * kw, eb * nb
        bnd, by = bound_ms(2.0 * m * n * kk, 4.0 * (xe.numel() + ke.numel() + got.numel()))
        e = {"xe": list(xs), "ke": list(ks), "stride": stride, "count": 1,
             "gemm_mnk": [m, n, kk], "plan": worker_plan(m, n, kk)._asdict(),
             "max_abs_err": abs_err, "max_rel_err": rel_err, "bound_ms": bnd,
             "bound_by": by, "ms": None, "device_ms": None, "plain_ms": None,
             "library_ms": None, "library_device_ms": None}
        if timed:
            xin = xe.reshape(ea * b, c, hh, wp)
            wcat = ke.reshape(eb * nb, c, kh, kw)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                e.update(timings(run, lambda: coded_worker_plain(xe, ke, stride),
                                 lambda: F.conv2d(xin, wcat, stride=stride)))
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
        def run():
            return matmul(a, b, relu=relu)

        got, ref = run(), matmul_plain(a, b, relu=relu)
        abs_err, rel_err = _err(got, ref)
        if not rel_err <= TOL_K2:
            raise AssertionError(f"K2 {a_s} x {b_s}: rel err {rel_err} > {TOL_K2}")
        check_repeatable(f"K2 {a_s} x {b_s}", run, got)
        (m, kk), n = a_s, b_s[1]
        bnd, by = bound_ms(2.0 * m * n * kk, 4.0 * (m * kk + kk * n + m * n))
        e = {"a": list(a_s), "b": list(b_s), "relu": relu, "count": 1,
             "plan": matmul_plan(m, n, kk)._asdict(),
             "max_abs_err": abs_err, "max_rel_err": rel_err,
             "bound_ms": bnd, "bound_by": by, "ms": None, "device_ms": None,
             "plain_ms": None, "library_ms": None, "library_device_ms": None}
        if timed:
            e.update(timings(run, lambda: matmul_plain(a, b, relu=relu),
                             lambda: torch.matmul(a, b)))
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


# -- the coded LM decode path ---------------------------------------------
def build_lm(device, cfg=None):
    """SmolLM-135M (full width and depth unless ``cfg`` says otherwise)
    with random weights from the seed, compiled into the coded decoder
    pipeline the LM server runs."""
    from repro_torch.configs import smollm_135m
    from repro_torch.core.decoder_pipeline import build_lm_decoder_pipeline
    from repro_torch.models.transformer import init_lm

    cfg = cfg if cfg is not None else smollm_135m.full()
    params = init_lm(cfg, torch.Generator().manual_seed(SEED), device)
    pipe = build_lm_decoder_pipeline(
        cfg, params, LM_N, k_b=LM_KB, bucket_sizes=LM_BUCKETS,
        max_len=LM_MAX_LEN, backend="kernel", device=device)
    return pipe, params


def lm_round_shapes(pipe, bucket: int) -> list[dict]:
    """Per distinct GEMM round geometry: K2's worker GEMM and K3's decode
    at ``bucket`` and K3's build-time weight encode, with how many rounds
    of one decode step (or of the build) launch each."""
    plan = pipe.plan
    eb, q = plan.ell_b, plan.delta * plan.ell_b
    out: dict = {}
    for spec in pipe.specs:
        d_in, d_out = spec.geo.in_channels, spec.geo.out_channels
        ob = d_out // plan.k_b
        key = (d_in, d_out)
        if key in out:
            out[key]["count"] += 1
            continue
        out[key] = {"kind": spec.kind, "count": 1,
                    "worker": ((bucket, d_in), (d_in, eb * ob)),
                    "decode": ((q, q), (q, bucket * ob)),
                    "encode": ((plan.ell_b * plan.n, plan.k_b),
                               (plan.k_b, d_in * ob))}
    return list(out.values())


def _gemm_entry(a_s, b_s, count, fn, plain, gen, device, tol, name,
                timed: bool, plan=None, host_a: bool = False) -> dict:
    """One GEMM shape: ``fn(a, b)`` against ``plain(a, b)``.  With
    ``host_a`` the left operand (K3's code matrix) lies on the host, as
    the path passes it; the library call gets a device copy."""
    a_dev = torch.randn(a_s, generator=gen, device=device)
    b = torch.randn(b_s, generator=gen, device=device)
    a = a_dev.cpu() if host_a else a_dev
    got, ref = fn(a, b), plain(a, b)
    abs_err, rel_err = _err(got, ref)
    if not rel_err <= tol:
        raise AssertionError(f"{name} {a_s} x {b_s}: rel err {rel_err} > {tol}")
    check_repeatable(f"{name} {a_s} x {b_s}", lambda: fn(a, b), got)
    (m, kk), n = a_s, b_s[1]
    bnd, by = bound_ms(2.0 * m * n * kk, 4.0 * (m * kk + kk * n + m * n))
    e = {"a": list(a_s), "b": list(b_s), "count": count,
         **({"a_on": "host"} if host_a else {}),
         **({"plan": plan(m, n, kk)._asdict()} if plan else {}),
         "max_abs_err": abs_err, "max_rel_err": rel_err, "bound_ms": bnd,
         "bound_by": by, "ms": None, "device_ms": None, "plain_ms": None,
         "library_ms": None, "library_device_ms": None}
    if timed:
        e.update(timings(lambda: fn(a, b), lambda: plain(a, b),
                         lambda: torch.matmul(a_dev, b)))
        e["library_rel_err"] = _err(got, torch.matmul(a_dev, b))[1]
    return e


def flash_bound(bh: int, bhkv: int, sq: int, sk: int, d: int,
                width: int = 4) -> tuple[float, str]:
    """Causal attention's least work: each query row i scores and weighs
    min(i + 1, sk) keys (2*d FLOPs each way, fp32 outside the tensor
    cores); each input read once, the output written once, ``width``
    bytes an element."""
    keys = sum(min(i + 1, sk) for i in range(sq))
    return bound_ms(4.0 * d * keys * bh,
                    width * (2 * bh * sq * d + 2 * bhkv * sk * d))


def _k3_plan(m: int, n: int, kk: int):
    from repro_torch.kernels.coded_gemm.kernel import coded_gemm_plan

    return coded_gemm_plan(m, kk, n)


def flash_entry(bh: int, s: int, d: int, rep: int, count: int, dtype, gen,
                device, tol: float, timed: bool) -> dict:
    """K4 at one causal self-attention shape in ``dtype``, against its
    plain version (and, timed, beside SDPA in the same type with K/V
    repeated outside the timed call)."""
    from repro_torch.kernels.flash_attn.kernel import (flash_attention,
                                                       flash_attention_plain,
                                                       flash_plan)

    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
               for shape in ((bh, s, d), (bh // rep, s, d), (bh // rep, s, d)))

    def run():
        return flash_attention(q, k, v, causal=True, rep=rep)

    def plain():
        return flash_attention_plain(q, k, v, causal=True, rep=rep)

    got = run()
    want = plain()
    abs_err, rel_err = _err(got.float(), want.float())
    name = f"K4 {tuple(q.shape)} {dtype}"
    if not rel_err <= tol:
        raise AssertionError(f"{name}: rel err {rel_err} > {tol}")
    mismatch = float((got != want).float().mean())
    if dtype == torch.bfloat16 and s <= K4_ONE_CHUNK and not mismatch <= K4_BF16_MISMATCH:
        raise AssertionError(f"{name}: {mismatch:.2%} of the outputs differ "
                             f"from the plain version's bits > {K4_BF16_MISMATCH:.2%}")
    check_repeatable(name, run, got)
    width = torch.finfo(dtype).bits // 8
    bnd, by = flash_bound(bh, bh // rep, s, s, d, width)
    e = {"q": [bh, s, d], "kv": [bh // rep, s, d], "rep": rep,
         "dtype": str(dtype).removeprefix("torch."), "count": count,
         "plan": flash_plan(bh, s, s, d, rep)._asdict(),
         "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
         "mismatch_share": mismatch,
         "bound_ms": bnd, "bound_by": by, "ms": None, "device_ms": None,
         "plain_ms": None, "library_ms": None, "library_device_ms": None}
    if timed:
        b = bh // rep  # SDPA's (B, H, S, D) with one KV head a batch row
        q4 = q.view(b, rep, s, d)
        k4r = k.view(b, 1, s, d).expand(b, rep, s, d).contiguous()
        v4r = v.view(b, 1, s, d).expand(b, rep, s, d).contiguous()

        def library():
            return F.scaled_dot_product_attention(q4, k4r, v4r, is_causal=True)

        e.update(timings(run, plain, library))
        e["library_rel_err"] = _err(got.float(), library().reshape(got.shape).float())[1]
    return e


def lm_kernel_phase(pipe, bucket: int, device, timed: bool = True) -> dict:
    """K2, K3 and K4 at the LM path's shapes against their plain versions
    (and, timed, beside a library call).  Raises on disagreement."""
    from repro_torch.kernels.coded_gemm.kernel import coded_gemm, coded_gemm_plain
    from repro_torch.kernels.matmul.kernel import matmul, matmul_plain, matmul_plan

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    k2, k3_dec, k3_enc = [], [], []
    for r in lm_round_shapes(pipe, bucket):
        k2.append({"round": r["kind"], **_gemm_entry(
            *r["worker"], r["count"], matmul, matmul_plain, gen, device,
            TOL_K2, "K2", timed, plan=matmul_plan)})
        k3_dec.append({"round": r["kind"], "phase": "decode", **_gemm_entry(
            *r["decode"], r["count"], coded_gemm, coded_gemm_plain, gen,
            device, TOL_K3, "K3", timed, plan=_k3_plan, host_a=True)})
        k3_enc.append({"round": r["kind"], "phase": "encode", **_gemm_entry(
            *r["encode"], r["count"], coded_gemm, coded_gemm_plain, gen,
            device, TOL_K3, "K3", timed, plan=_k3_plan, host_a=True)})
    cfg = pipe.cfg
    h, d = cfg.n_heads, cfg.head_dim
    bh, s, rep = bucket * h, LM_MAX_PROMPT, h // cfg.n_kv_heads
    k4 = flash_entry(bh, s, d, rep, cfg.layers, torch.float32, gen, device,
                     TOL_K4, timed)
    k4_bf16 = flash_entry(bh, s, d, rep, cfg.layers, torch.bfloat16, gen,
                          device, TOL_K4_BF16, timed)
    return {"matmul": k2, "coded_gemm": k3_dec, "coded_gemm_encode": k3_enc,
            "flash_attention": [k4], "flash_attention_bf16": [k4_bf16]}


def check_lm_launched_shapes(pipe, bucket: int) -> None:
    """The shapes the LM kernel phase timed are the ones the serving phase
    ran: every K2 worker GEMM among the cluster worker program's argument
    signatures, every K3 decode among the decode program's."""
    seen_k2 = {sig for prog in pipe._cluster_programs.values()
               for sig in prog.signatures}
    seen_dec = pipe.decoder_fn(0).signatures
    plan = pipe.plan
    for r in lm_round_shapes(pipe, bucket):
        (b, d_in), (_, width) = r["worker"]
        if (((1, b, d_in), "torch.float32"),
                ((d_in, width), "torch.float32")) not in seen_k2:
            raise AssertionError(f"K2 worker shape {r['worker']} never served")
        ob = width // plan.ell_b
        if (((plan.delta, plan.ell_b, b, ob), "torch.float32"),
                ((plan.delta * plan.ell_b,) * 2, "torch.float32")) not in seen_dec:
            raise AssertionError(f"K3 decode shape {r['decode']} never served")


def lm_requests(vocab: int) -> list[tuple[list[int], int]]:
    """``LM_REQUESTS`` (prompt, new tokens) pairs drawn from the seed."""
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(LM_REQUESTS):
        plen = int(rng.integers(LM_PROMPT_LEN[0], LM_PROMPT_LEN[1] + 1))
        gen = int(rng.integers(LM_GEN[0], LM_GEN[1] + 1))
        out.append((rng.integers(0, vocab, plen).tolist(), gen))
    return out


def lm_serving_phase(pipe, requests, counters, mode: str = "threads"):
    """Serve ``requests`` on ``CodedLMServer`` under ``LM_DELAYS``; the
    launch counts are zeroed just before and read just after.  All
    requests arrive together: they are submitted while the scheduler's
    condition is held, so the engine admits a full first group.  The
    logits row behind every served token is kept (a device copy).
    Returns (token streams, served logits rows per request, latencies,
    server, wall seconds, launches)."""
    from repro_torch.runtime import StragglerModel
    from repro_torch.serving import CodedLMServer

    rows: dict[int, list] = {}
    server = CodedLMServer(
        pipe, StragglerModel(np.array(LM_DELAYS)), mode=mode,
        max_prompt=LM_MAX_PROMPT, poll_interval_s=0.001,
        on_logits=lambda rid, row: rows.setdefault(rid, []).append(row.clone()))
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    with server:
        with server.scheduler.not_empty:
            handles = [server.submit(p, g) for p, g in requests]
        outs = [h.result(timeout=900.0) for h in handles]
    wall = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    if pipe.device.type == "cuda":  # the copies ran on the engine's stream
        torch.cuda.synchronize(pipe.device)
    for (p, g), toks in zip(requests, outs):
        if len(toks) != g:
            raise AssertionError(f"request of {g} tokens served {len(toks)}")
    served = [rows.get(h.request_id, []) for h in handles]
    return outs, served, [h.latency_s for h in handles], server, wall, launches


def check_lm_served(pipe, params, requests, outs, served, device) -> dict:
    """Hold the served logits rows against the undistributed
    ``transformer.prefill`` + ``decode_step``, teacher-forced on each served
    stream one request at a time: within ``TOL_LM`` relative to
    max|logit|, and every served token the argmax of its own row and an
    argmax of the undistributed row up to that tolerance.  Returns the
    worst error and the count of served tokens equal to the undistributed
    argmax outright."""
    from repro_torch.models import transformer as lm

    cfg = pipe.cfg
    worst, exact, total = 0.0, 0, 0
    for r, ((prompt, gen), toks, got) in enumerate(zip(requests, outs, served)):
        cache = lm.init_cache(cfg, 1, LM_MAX_LEN, device=device)
        logits, cache = lm.prefill(params, cfg, cache,
                                   torch.as_tensor([prompt], device=device))
        rows = [logits[0, -1]]
        for j in range(gen - 1):
            step, cache = lm.decode_step(
                params, cfg, cache,
                torch.as_tensor([[int(toks[j])]], device=device), len(prompt) + j)
            rows.append(step[0, 0])
        ref = torch.stack(rows)
        got = torch.stack(got) if got else ref.new_empty((0, cfg.vocab))
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"request {r}: served logits {tuple(got.shape)} "
                                 f"vs {tuple(ref.shape)} or non-finite")
        want = torch.as_tensor(np.asarray(toks, np.int64), device=device)
        if not torch.equal(got.argmax(dim=-1), want):
            raise AssertionError(f"request {r}: a served token is not the "
                                 f"argmax of its own served logits")
        scale = float(ref.abs().max(dim=-1).values.max())
        picked = ref[torch.arange(gen, device=device), want]
        gap = float((ref.max(dim=-1).values - picked).max())
        if not gap <= TOL_LM * scale:
            raise AssertionError(f"request {r}: a served token is {gap} below "
                                 f"the argmax logit (> {TOL_LM} * {scale})")
        exact += int((ref.argmax(dim=-1) == want).sum())
        total += gen
        worst = max(worst, _err(got, ref)[1])
    if not worst <= TOL_LM:
        raise AssertionError(f"served LM logits off the undistributed "
                             f"transformer: rel err {worst} > {TOL_LM}")
    return {"max_rel_err": worst, "tokens_equal": exact, "tokens": total}


def lm_kernel_summary(entries: list[dict]) -> dict:
    return _summarise([{**e, "library_rel_err": e.get("library_rel_err", 0.0)}
                       for e in entries])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this proof "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels.coded_gemm.kernel import launches as k3_launches
    from repro_torch.kernels.conv2d.kernel import launches as k1_launches
    from repro_torch.kernels.flash_attn.kernel import launches as k4_launches
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

    # -- the coded CNN path -------------------------------------------------
    server, params = build_server(device, HW)
    pipe = server.pipeline
    t0 = time.perf_counter()
    kernels = kernel_phase(pipe, BUCKET, device)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        print(f"  {k['name']}: {k['ms']:.4f} ms per pass of its serving shapes "
              f"with host issue, {k['device_ms']:.4f} ms device (plain "
              f"{k['plain_ms']:.4f}, library {k['library_ms']:.4f} / device "
              f"{k['library_device_ms']:.4f}, bound {k['bound_ms']:.4f} by "
              f"{k['bound_by']}), max rel err {k['max_rel_err']:.2e} <= "
              f"{k['tol']} vs plain, {k['library_rel_err']:.2e} vs library")
        for e in k["shapes"]:
            print(f"    {json.dumps(e)}")

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
    del server, pipe, params, outs
    torch.cuda.empty_cache()

    # -- the coded LM decode path -------------------------------------------
    t0 = time.perf_counter()
    lm_pipe, lm_params = build_lm(device)
    cfg = lm_pipe.cfg
    print(f"LM build: {cfg.name} ({cfg.layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab}) on n={LM_N} "
          f"workers, k_b={LM_KB}: {time.perf_counter() - t0:.1f} s, "
          f"{lm_pipe.weight_encode_calls} weight encodes")
    bucket = lm_pipe.max_batch
    t0 = time.perf_counter()
    lm_k = lm_kernel_phase(lm_pipe, bucket, device)
    print(f"LM kernel phase: {time.perf_counter() - t0:.1f} s")
    for name, entries in lm_k.items():
        sm = lm_kernel_summary(entries)
        print(f"  {name}: {sm['ms']:.4f} ms per decode step's shapes with "
              f"host issue, {sm['device_ms']:.4f} ms device (plain "
              f"{sm['plain_ms']:.4f}, library {sm['library_ms']:.4f} / device "
              f"{sm['library_device_ms']:.4f}, bound {sm['bound_ms']:.5f} by "
              f"{sm['bound_by']}), max rel err {sm['max_rel_err']:.2e}")
        for e in entries:
            print(f"    {json.dumps(e)}")

    requests = lm_requests(cfg.vocab)
    counters = (k2_launches, k3_launches, k4_launches)
    lm_outs, lm_rows, lat, lm_server, wall, lm_launches = lm_serving_phase(
        lm_pipe, requests, counters)
    for name, count in lm_launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched while serving the LM")
    check_lm_launched_shapes(lm_pipe, bucket)
    toks = sum(len(o) for o in lm_outs)
    print(f"served {len(lm_outs)} {cfg.name} requests ({toks} tokens) on "
          f"n={LM_N} workers (worker 2 +{STRAGGLER_DELAY_S * 1e3:.0f} ms, "
          f"worker 3 dead) on {card}: {toks / wall:.2f} tok/s over {wall:.2f} s "
          f"wall, {lm_server.tokens_per_second():.2f} tok/s over engine busy "
          f"time; e2e p50 {np.percentile(lat, 50) * 1e3:.1f} ms, p99 "
          f"{np.percentile(lat, 99) * 1e3:.1f} ms; {lm_server.decode_steps} "
          f"decode steps ({lm_server.decode_time_s:.3f} s), prefill "
          f"{lm_server.prefill_time_s:.3f} s; launches {lm_launches}")
    print(f"LM round phases over {lm_server.rounds} rounds (s): encode "
          f"{lm_server.round_encode_s:.4f}, to delta-th result "
          f"{lm_server.round_compute_s:.4f}, decode "
          f"{lm_server.round_decode_s:.4f}; glue and host between rounds "
          f"{lm_server.decode_time_s - lm_server.round_encode_s - lm_server.round_compute_s - lm_server.round_decode_s:.4f}")
    t0 = time.perf_counter()
    check = check_lm_served(lm_pipe, lm_params, requests, lm_outs, lm_rows,
                            device)
    assert not torch.backends.cuda.matmul.allow_tf32
    print(f"LM check: served logits vs undistributed transformer max rel err "
          f"{check['max_rel_err']:.2e} <= {TOL_LM}; {check['tokens_equal']} of "
          f"{check['tokens']} served tokens equal its argmax outright "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- the kernels line: K1-K4, launches from each path's serving run.
    # K2 runs on both paths, in two regimes: its top-level numbers stay
    # one pass of the CNN transition shapes; one LM decode step's worker
    # GEMMs are reported apart under paths.lm, never summed with them.
    k1e, k2e = kernels
    k1e["launches"] = launches["coded_worker"]
    k2e["launches"] = launches["matmul"]
    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "max_abs_err", "max_rel_err")
    k2_lm = lm_kernel_summary(lm_k["matmul"])
    k2e["paths"] = {"cnn": {**{key: k2e[key] for key in keys},
                            "launches": launches["matmul"]},
                    "lm": {**{key: k2_lm[key] for key in keys},
                           "launches": lm_launches["matmul"]}}
    k2e["lm_shapes"] = lm_k["matmul"]
    k3 = lm_kernel_summary(lm_k["coded_gemm"])
    k3e = {"name": "coded_gemm", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/coded_gemm.cu",
           "replaces": "src/repro/kernels/coded_gemm/kernel.py:57",
           "tpu_kernel": "coded_gemm_pallas_legacy / coded_gemm_pallas "
                         "(src/repro/kernels/coded_gemm/kernel.py:57, :27)",
           "tol": TOL_K3, "library": "torch.matmul",
           "launches": lm_launches["coded_gemm"], **k3,
           "build": lm_kernel_summary(lm_k["coded_gemm_encode"]),
           "shapes": lm_k["coded_gemm"] + lm_k["coded_gemm_encode"]}
    k4 = lm_kernel_summary(lm_k["flash_attention"])
    k4e = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
           "replaces": "src/repro/kernels/flash_attn/kernel.py:69",
           "tpu_kernel": "flash_attention_pallas / _flash_kernel "
                         "(src/repro/kernels/flash_attn/kernel.py:69, :24)",
           "tol": TOL_K4,
           "library": "F.scaled_dot_product_attention (K/V repeated)",
           "launches": lm_launches["flash_attention"], **k4,
           "bf16": lm_kernel_summary(lm_k["flash_attention_bf16"]),
           "shapes": lm_k["flash_attention"] + lm_k["flash_attention_bf16"]}
    print(json.dumps({"kernels": [k1e, k2e, k3e, k4e]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
