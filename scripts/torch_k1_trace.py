#!/usr/bin/env python3
"""Where a stage of K1's tensor-core kernel spends its cycles, on one card:

    python3 scripts/torch_k1_trace.py [--block B] [--out FILE]

Builds ``coded_worker.cu`` once more with ``-DK1_TRACE`` (into the
kernels' git-ignored build directory), which makes thread 0 of each
warpgroup of one block (``--block`` along M, the first N-tile and K slice)
write ``clock64()`` stamps around each step of each stage.  At each of the
worker shapes of a bucket-8 VGG-16 pass (224x224, n = 8, (k_a, k_b) =
(2, 4)) that take the tensor-core route, it launches the design plan and
prints the median cycles a stage of each step:

  * consumers (warpgroups 0 and 1): waiting for the stage's copies, loading
    and splitting the A fragments, issuing the 12 ``wgmma``, waiting for
    them, and releasing the stage plus the fp32 promotion;
  * the producer (warpgroup 2): waiting for a free slot, and issuing the
    stage's patch gather and filter bulk copy;

and the block's life in cycles.  The traced build is a separate library:
the served kernel has no stamps.  Prints the card's name and power limit
first and, as its last line, one JSON object of every reading (appended
to ``--out`` too).  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

STEPS = {"consumer": ("wait", "load_split", "issue", "mma_wait", "release"),
         "producer": ("slot_wait", "issue")}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build() -> ctypes.CDLL:
    from repro_torch.kernels import native

    out = native.BUILD_ROOT / "trace"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libk1_trace.so"
    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-DK1_TRACE", "-shared",
                    "-o", str(lib), str(native.CSRC / "coded_worker.cu")],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.coded_worker_tc_f32.argtypes = native.SIGNATURES["coded_worker_tc_f32"]
    dll.coded_worker_tc_f32.restype = ctypes.c_int
    dll.coded_worker_tc_trace.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    dll.coded_worker_tc_trace.restype = ctypes.c_int
    return dll


def trace_shape(dll, k1, xs, ks, block: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(0)
    xe = torch.randn(xs, generator=gen, device=device)
    ke = torch.randn(ks, generator=gen, device=device)
    m, n, k = k1.gemm_shape(xs, ks, 1)
    plan = k1.worker_plan(m, n, k)
    ea, b, c, hh, wp = xs
    eb, nb, _, kh, kw = ks
    ws = torch.empty(-(-n // plan.bn) * -(-k // 32) * 2 * plan.bn * 32, device=device)
    out = torch.empty((ea * eb, b, nb, hh - kh + 1, wp - kw + 1), device=device)
    buf = torch.zeros(4 * 1024 * 8, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream().cuda_stream
    if dll.coded_worker_tc_trace(buf.data_ptr(), block) != 0:
        raise RuntimeError("coded_worker_tc_trace failed")
    for _ in range(3):  # the last launch's stamps stay
        rc = dll.coded_worker_tc_f32(xe.data_ptr(), ke.data_ptr(), ws.data_ptr(),
                                     out.data_ptr(), c, hh, wp, kh, kw, 1, ea * b,
                                     b, eb, nb, plan.bn, plan.splits, stream)
        if rc != 0:
            raise RuntimeError(f"coded_worker_tc_f32 returned {rc}")
    torch.cuda.synchronize()
    dll.coded_worker_tc_trace(None, -1)
    d = buf.view(4, 1024, 8).cpu().numpy()
    nst = int((d[0, :, 1] > 0).sum())
    row = {"mnk": [m, n, k], "plan": plan._asdict(), "block": block, "stages": nst}
    for wg in (0, 1):
        s = d[wg, :nst]
        row[f"consumer{wg}"] = {
            "stage": float(np.median(np.diff(s[:, 0]))),
            **{name: float(np.median(s[:, j + 1] - s[:, j]))
               for j, name in enumerate(STEPS["consumer"])}}
    p = d[2, :nst]
    row["producer"] = {
        "stage": float(np.median(np.diff(p[:, 0]))),
        **{name: float(np.median(p[:, j + 1] - p[:, j]))
           for j, name in enumerate(STEPS["producer"])}}
    row["block_cycles"] = int(d[3, 0, 1] - d[3, 0, 0])
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--block", type=int, default=5, help="the traced block along M")
    ap.add_argument("--out", help="append the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_trace: needs a CUDA device", file=sys.stderr)
        return 1
    cs = _smoke()
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    from repro_torch.kernels.conv2d import kernel as k1

    dll = build()
    server, _ = cs.build_server(torch.device("cpu"), cs.HW)
    shapes = cs.worker_shapes(server.pipeline, cs.BUCKET)
    del server
    rows, seen = [], set()
    for xs, ks, stride in shapes:
        m, n, k = k1.gemm_shape(xs, ks, stride)
        if (xs, ks) in seen or k1.worker_plan(m, n, k).route != "tc":
            continue
        seen.add((xs, ks))
        row = trace_shape(dll, k1, xs, ks, args.block, device)
        rows.append(row)
        c0, p = row["consumer0"], row["producer"]
        print(f"M {m} N {n} K {k} ({row['plan']['bn']}, {row['plan']['splits']}), "
              f"{row['stages']} stages, block {row['block_cycles']} cycles: consumer "
              f"stage {c0['stage']:.0f} (" + ", ".join(
                  f"{s} {c0[s]:.0f}" for s in STEPS["consumer"])
              + f"); producer stage {p['stage']:.0f} (" + ", ".join(
                  f"{s} {p[s]:.0f}" for s in STEPS["producer"]) + ")", flush=True)
    line = json.dumps({"card": card, "shapes": rows})
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
