#!/usr/bin/env python3
"""Time K1-K4 of one source tree of the port at the serving shapes, so
that two trees (a parent commit and a change) can be compared in turns on
one card:

    python3 scripts/torch_kernel_turns.py --src PARENT/src --label parent
    python3 scripts/torch_kernel_turns.py --src src --label change

The port is imported from ``--src``, so its kernels build from that
tree's ``csrc``; the shapes and timers come from this checkout's
``chip_smoke.py``.  Only the wrappers' public calls are used
(``coded_worker(xe, ke, stride)``, ``matmul(a, b, relu=...)``,
``coded_gemm(code, feats)``, ``flash_attention(q, k, v, causal=, rep=)``),
each as that tree takes it: K3's code matrix on the host where the tree
has ``coded_gemm_plan`` (else on the card), and K4 in bf16 only where the
tree has ``flash_plan``.  Shapes: K1 at VGG-16 224x224 bucket 8, K2 at its
CNN transition shapes (bucket 8), at the SmolLM-135M worker GEMMs (bucket
4) and at the Qwen3-4B ones (batch 4), K3 at the SmolLM-135M decode
(bucket 4) and build-time encode shapes, K4 at the prefill (36 query heads
over 12 KV heads, S 16, D 64), at S 256 with rep 1 and 3, at the Qwen3-4B
prefill of 2 x 2,048 tokens (64 query heads over 16, D 128) and at the
Whisper-medium encoder (64 heads over 1,500 frames, D 64, no mask).  Each shape is checked against its plain
version, then timed with host issue (``ms``) and device only
(``device_ms``), beside the library call (``library_device_ms``), over 10
back-to-back calls (K3 over 200).  Beside K3's decode stands the floor of
back-to-back launches: the device microseconds a launch of K3 at one
column (a single thread) and of a PyTorch ``zero_`` of four floats, over
200 calls each.  Then the host cost of one K3 decode call and of each piece a wrapper may do
(a device switch, the output allocation, the stream lookup, the library
lookup, the bare entry-point call, the launch counter), each as the mean
of 1,000 calls by ``time.perf_counter_ns``.  Prints, as its last line, one
JSON object with every shape and the totals over one pass of each path;
with ``--out`` it also appends that object to a file.  Needs one CUDA
device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
# K3 calls timed back to back: its host issue (tens of us) is what a decode
# step's 120 calls pay, and 10 calls leave that to chance
K3_REPS = 200
# Qwen3-4B's coded worker GEMMs at batch 4, (K, N) of qkv, wo, gate-up and
# down, each launched once a layer of a decode step
QWEN3_GEMMS = [(2560, 3072), (4096, 1280), (2560, 9728), (9728, 1280)]
QWEN3_LAYERS = 36
# K4 at long sequences, (BH, S, D, rep, causal, launches): the Qwen3-4B
# prefill of 2 x 2,048 tokens (phase 15 of chip_smoke.py, one a layer) and
# the Whisper-medium encoder over 4 x 1,500 frames (no mask)
K4_LONG = ((64, 2048, 128, 4, True, 36), (64, 1500, 64, 1, False, 24))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", help="append the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_turns: needs a CUDA device", file=sys.stderr)
        return 1
    # the tree under test first: every repro_torch module resolves there,
    # including those chip_smoke imports later
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import native
    from repro_torch.kernels.coded_gemm import kernel as k3
    from repro_torch.kernels.conv2d.kernel import coded_worker, coded_worker_plain
    from repro_torch.kernels.flash_attn import kernel as k4
    from repro_torch.kernels.matmul.kernel import matmul, matmul_plain

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    gen = torch.Generator(device=device).manual_seed(cs.SEED)

    def entry(run, plain, library, tol, name, count, reps=10, **shape):
        got = run()
        _, rel = cs._err(got, plain())
        if not rel <= tol:
            raise AssertionError(f"{args.label} {name} {shape}: rel err {rel} > {tol}")
        return {**shape, "count": count, "max_rel_err": rel,
                "ms": cs.cuda_ms(run, reps), "device_ms": cs.device_ms(run, reps),
                "library_device_ms": cs.device_ms(library, reps)}

    server, _ = cs.build_server(device, cs.HW)
    pipe = server.pipeline
    k1: dict = {}
    for xs, ks, stride in cs.worker_shapes(pipe, cs.BUCKET):
        key = (xs, ks, stride)
        if key in k1:
            k1[key]["count"] += 1
            continue
        xe = torch.randn(xs, generator=gen, device=device)
        ke = torch.randn(ks, generator=gen, device=device) / np.sqrt(np.prod(ks[2:]))
        xin = xe.reshape(xs[0] * xs[1], *xs[2:])
        wcat = ke.reshape(ks[0] * ks[1], *ks[2:])
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            k1[key] = entry(lambda: coded_worker(xe, ke, stride),
                            lambda: coded_worker_plain(xe, ke, stride),
                            lambda: F.conv2d(xin, wcat, stride=stride),
                            cs.TOL_K1, "K1", 1, xe=list(xs), ke=list(ks))

    def gemms(shapes, tol):
        out: dict = {}
        for a_s, b_s, relu, count in shapes:
            key = (a_s, b_s, relu)
            if key in out:
                out[key]["count"] += count
                continue
            a = torch.randn(a_s, generator=gen, device=device)
            b = torch.randn(b_s, generator=gen, device=device)
            out[key] = entry(lambda: matmul(a, b, relu=relu),
                             lambda: matmul_plain(a, b, relu=relu),
                             lambda: torch.matmul(a, b), tol, "K2", count,
                             a=list(a_s), b=list(b_s), relu=relu)
        return list(out.values())

    k2_cnn = gemms([(a, b, r, 1) for a, b, r in cs.transition_shapes(pipe, cs.BUCKET)],
                   cs.TOL_K2)
    del server, pipe
    torch.cuda.empty_cache()
    lm_pipe, _ = cs.build_lm(device)
    rounds = cs.lm_round_shapes(lm_pipe, lm_pipe.max_batch)
    k2_lm = gemms([(*r["worker"], False, r["count"]) for r in rounds], cs.TOL_K2)
    k2_qwen3 = gemms([((4, kk), (kk, n), False, QWEN3_LAYERS)
                      for kk, n in QWEN3_GEMMS], cs.TOL_K2)

    host_code = hasattr(k3, "coded_gemm_plan")  # this tree takes host code

    def k3_shapes(phase):
        out = []
        for r in rounds:
            a_s, b_s = r[phase]
            a_dev = torch.randn(a_s, generator=gen, device=device)
            b = torch.randn(b_s, generator=gen, device=device)
            a = a_dev.cpu() if host_code else a_dev
            e = entry(lambda: k3.coded_gemm(a, b), lambda: k3.coded_gemm_plain(a, b),
                      lambda: torch.matmul(a_dev, b), cs.TOL_K3, "K3", r["count"],
                      K3_REPS, a=list(a_s), b=list(b_s), phase=phase)
            if host_code:
                e["plan"] = k3.coded_gemm_plan(*a_s, b_s[1])._asdict()
            out.append(e)
        return out

    k3_dec, k3_enc = k3_shapes("decode"), k3_shapes("encode")
    one = torch.randn((4, 1), generator=gen, device=device)
    code = torch.randn((4, 4), generator=gen, device=device)
    code = code.cpu() if host_code else code
    tiny = torch.empty(4, device=device)
    floor_us = {"k3_one_column": 1e3 * cs.device_ms(lambda: k3.coded_gemm(code, one), K3_REPS),
                "zero_4_floats": 1e3 * cs.device_ms(tiny.zero_, K3_REPS)}

    cfg = lm_pipe.cfg
    dtypes = [torch.float32] + ([torch.bfloat16] if hasattr(k4, "flash_plan") else [])
    k4_shapes = []
    for bh, s, d, rep, causal, count in (
            (lm_pipe.max_batch * cfg.n_heads, cs.LM_MAX_PROMPT, cfg.head_dim,
             cfg.n_heads // cfg.n_kv_heads, True, cfg.layers),
            (36, 256, cfg.head_dim, 1, True, 1), (36, 256, cfg.head_dim, 3, True, 1),
            *K4_LONG):
        for dtype in dtypes:
            q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
                       for shape in ((bh, s, d), (bh // rep, s, d), (bh // rep, s, d)))
            b = bh // rep
            q4 = q.view(b, rep, s, d)
            k4r, v4r = (t.view(b, 1, s, d).expand(q4.shape).contiguous()
                        for t in (k, v))
            tol = cs.TOL_K4 if dtype == torch.float32 else cs.TOL_K4_BF16
            k4_shapes.append(entry(
                lambda: k4.flash_attention(q, k, v, causal=causal, rep=rep),
                lambda: k4.flash_attention_plain(q, k, v, causal=causal, rep=rep),
                lambda: F.scaled_dot_product_attention(q4, k4r, v4r,
                                                       is_causal=causal),
                tol, "K4", count, q=[bh, s, d], rep=rep, causal=causal,
                dtype=str(dtype).removeprefix("torch.")))
            del q, k, v, q4, k4r, v4r

    wrapper = k3_wrapper_costs(k3, native, rounds[0]["decode"], host_code, device)

    def total(entries):
        keys = ["ms", "device_ms", "library_device_ms"]
        return {key: sum(e[key] * e["count"] for e in entries) for key in keys}

    result = {"label": args.label, "src": args.src, "card": card,
              "k1": {"total": total(list(k1.values())), "shapes": list(k1.values())},
              "k2_cnn": {"total": total(k2_cnn), "shapes": k2_cnn},
              "k2_lm": {"total": total(k2_lm), "shapes": k2_lm},
              "k2_qwen3": {"total": total(k2_qwen3), "shapes": k2_qwen3},
              "k3_decode": {"total": total(k3_dec), "shapes": k3_dec},
              "k3_encode": {"total": total(k3_enc), "shapes": k3_enc},
              "k4": {"shapes": k4_shapes},
              "k3_wrapper_us": wrapper, "launch_floor_us": floor_us}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(f"{args.label}: K1 {result['k1']['total']}, K2 CNN "
          f"{result['k2_cnn']['total']}, K2 LM {result['k2_lm']['total']}, K2 "
          f"Qwen3-4B {result['k2_qwen3']['total']}, K3 "
          f"decode {result['k3_decode']['total']}, K3 encode "
          f"{result['k3_encode']['total']} on {card}")
    for e in k2_qwen3:
        print(f"  K2 {e['a']} x {e['b']}: ms {e['ms']:.5f}, device_ms "
              f"{e['device_ms']:.5f}, torch.matmul device {e['library_device_ms']:.5f}")
    for e in k4_shapes:
        print(f"  K4 {e['q']} rep {e['rep']} {'causal' if e['causal'] else 'no mask'} "
              f"{e['dtype']}: ms {e['ms']:.5f}, "
              f"device_ms {e['device_ms']:.5f}, SDPA device "
              f"{e['library_device_ms']:.5f}")
    print(f"  K3 wrapper, us a call: {wrapper}")
    print(f"  back-to-back launch floor, device us a launch: {floor_us}")
    print(line)
    return 0


def k3_wrapper_costs(k3, native, shapes, host_code: bool, device,
                     calls: int = 1000) -> dict:
    """Host microseconds a call of the tree's public K3 call at one decode
    shape, and of each piece a wrapper may spend them on, each the mean of
    ``calls`` back-to-back calls (``time.perf_counter_ns``; the launches
    are left queued, and synchronised after each piece)."""
    (r_out, r_in), (_, f) = shapes
    code_dev = torch.randn((r_out, r_in), device=device)
    feats = torch.randn((r_in, f), device=device)
    code = code_dev.cpu() if host_code else code_dev
    out = torch.empty((r_out, f), device=device)
    lib = native.load_library()
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    if host_code:  # this tree's entry point: the plan's vec and threads
        plan = k3.coded_gemm_plan(r_out, r_in, f)
        entry_args = (code.data_ptr(), feats.data_ptr(), out.data_ptr(), r_out,
                      r_in, f, plan.vec, plan.threads, stream)
    else:
        entry_args = (code.data_ptr(), feats.data_ptr(), out.data_ptr(), r_out,
                      r_in, f, stream)
    def switch_device():
        with torch.cuda.device(index):
            pass

    pieces = {
        "public_call": lambda: k3.coded_gemm(code, feats),
        "torch.cuda.device": switch_device,
        "torch.cuda.current_device": torch.cuda.current_device,
        "torch.empty": lambda: torch.empty((r_out, f), dtype=torch.float32,
                                           device=device),
        "new_empty": lambda: feats.new_empty((r_out, f)),
        "current_stream_object": lambda: torch.cuda.current_stream(device).cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(index),
        "load_library": native.load_library,
        "entry_point_call": lambda: lib.coded_gemm_f32(*entry_args),
        "launch_counter": k3.launches.add,
    }
    costs = {}
    for name, fn in pieces.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        costs[name] = (time.perf_counter_ns() - t0) / calls / 1e3
        torch.cuda.synchronize()
    return costs


if __name__ == "__main__":
    sys.exit(main())
