#!/usr/bin/env python3
"""Time K1 and K2 of one source tree of the port at the serving shapes, so
that two trees (a parent commit and a change) can be compared in turns on
one card:

    python3 scripts/torch_kernel_turns.py --src PARENT/src --label parent
    python3 scripts/torch_kernel_turns.py --src src --label change

The port is imported from ``--src``, so its kernels build from that
tree's ``csrc``; the shapes and timers come from this checkout's
``chip_smoke.py``.  Only the wrappers' public calls are used
(``coded_worker(xe, ke, stride)``, ``matmul(a, b, relu=...)``), which
every tree of the port has.  Shapes: K1 at VGG-16 224x224 bucket 8, K2 at
its CNN transition shapes (bucket 8) and at the SmolLM-135M worker GEMMs
(bucket 4).  Each shape is checked against its plain version, then timed
with host issue (``ms``) and device only (``device_ms``), beside the
library call (``library_device_ms``).  Prints, as its last line, one JSON
object with every shape and the totals over one pass of each path; with
``--out`` it also appends that object to a file.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]


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
    from repro_torch.kernels.conv2d.kernel import coded_worker, coded_worker_plain
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

    def entry(run, plain, library, tol, name, count, **shape):
        got = run()
        _, rel = cs._err(got, plain())
        if not rel <= tol:
            raise AssertionError(f"{args.label} {name} {shape}: rel err {rel} > {tol}")
        return {**shape, "count": count, "max_rel_err": rel,
                "ms": cs.cuda_ms(run), "device_ms": cs.device_ms(run),
                "library_device_ms": cs.device_ms(library)}

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
    k2_lm = gemms([(*r["worker"], False, r["count"])
                   for r in cs.lm_round_shapes(lm_pipe, lm_pipe.max_batch)], cs.TOL_K2)

    def total(entries):
        return {key: sum(e[key] * e["count"] for e in entries)
                for key in ("ms", "device_ms", "library_device_ms")}

    result = {"label": args.label, "src": args.src, "card": card,
              "k1": {"total": total(list(k1.values())), "shapes": list(k1.values())},
              "k2_cnn": {"total": total(k2_cnn), "shapes": k2_cnn},
              "k2_lm": {"total": total(k2_lm), "shapes": k2_lm}}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(f"{args.label}: K1 {result['k1']['total']}, K2 CNN "
          f"{result['k2_cnn']['total']}, K2 LM {result['k2_lm']['total']} on {card}")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
