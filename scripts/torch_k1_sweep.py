#!/usr/bin/env python3
"""K1's two routes side by side on one card: the tensor-core kernel
(3xTF32 on ``wgmma``) and the FFMA kernel, at every launch plan the
autotune ledger would sweep, at the 13 worker shapes of a bucket-8 VGG-16
pass (224x224, n = 8, (k_a, k_b) = (2, 4)):

    python3 scripts/torch_k1_sweep.py [--out FILE] [--no-vgg]

First two probes pin the tensor-core kernel's operand layouts (one GEMM
tile with identity filters, then one with one-hot patches; values exact
in 3xTF32, so any wrong output names the element it came from), then the
edge cases of ``EDGES`` (ragged M, N and K, strides, every split) on the
tensor-core route's design plan.  Then, for each VGG-16 shape, every
candidate of ``autotune.worker_candidates`` is launched on the same
inputs (``launch_worker``), held to the plain version (``TOL_K1``), to a
second launch of itself (bit for bit) and, against the float64 plain
version, to ``K1_FP64_RATIO`` times the fp32 plain version's error
(cuBLAS, TF32 off), and timed in device ms (``chip_smoke.device_ms``)
beside cuDNN (``F.conv2d``, TF32 off) and the two bounds (FFMA at 67
TFLOP/s, 3xTF32 at 495/3).  ``nvidia-smi``'s SM clock and power are
sampled through the timings.

The VGG-16 sweep runs only where the probes and edge cases came out
right.  Prints the card's name and power limit first, one line a shape, a pass's
sums (each route's design plan and best plan) and the clock, and as its
last line one JSON object of every reading (appended to ``--out`` too).
Needs one CUDA device.
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
sys.path.insert(0, str(ROOT / "src"))

# (ell_a, B, C, h_hat, Wp, ell_b, N/k_b, KH, KW, stride): ragged M, N and
# K, strides, K = 27, N 32 / 64 / 256, M not a multiple of the tile, and
# depths that take every split count on the design plan
EDGES = [(2, 2, 3, 18, 32, 2, 4, 5, 5, 1), (2, 1, 1, 9, 9, 2, 2, 3, 3, 2),
         (3, 1, 2, 11, 13, 1, 4, 3, 5, 1), (2, 2, 8, 10, 16, 2, 4, 1, 1, 1),
         (2, 3, 5, 37, 70, 2, 33, 3, 3, 1), (2, 2, 64, 20, 30, 2, 70, 3, 3, 2),
         (2, 8, 3, 20, 30, 2, 16, 3, 3, 1), (2, 2, 64, 13, 17, 2, 32, 3, 3, 1),
         (2, 2, 128, 9, 12, 2, 128, 3, 3, 1), (2, 2, 512, 6, 6, 2, 128, 3, 3, 1),
         (2, 8, 256, 16, 30, 2, 64, 3, 3, 1), (1, 8, 512, 9, 16, 4, 64, 3, 3, 1)]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)


def probes(k1, device) -> list[dict]:
    """One 128 x 32 x 32 GEMM tile through the tensor-core kernel (1x1
    filters: K = C): (a) identity filters over patches ``c * 256 + m``,
    (b) one-hot patches (``c == m % 32``) under filters ``n * 64 + c``.
    Every value is exact in 3xTF32, so a wrong output decodes to the
    (c, m) or (n, c) it was taken from."""
    out = []
    c, hh, wp = 32, 8, 16  # M = 128
    m = torch.arange(hh * wp, device=device, dtype=torch.float32)
    cc = torch.arange(c, device=device, dtype=torch.float32)
    for name in ("a", "b"):
        if name == "a":
            x = (cc[:, None] * 256 + m[None, :]).reshape(1, 1, c, hh, wp)
            w = torch.eye(c, device=device).reshape(1, c, c, 1, 1)
            want = (cc[:, None] * 256 + m[None, :])
        else:
            x = (cc[:, None] == (m[None, :] % c)).float().reshape(1, 1, c, hh, wp)
            w = (cc[:, None] * 64 + cc[None, :]).reshape(1, c, c, 1, 1)
            want = cc[:, None] * 64 + (m[None, :] % c)
        plan = k1.route_plan("tc", hh * wp, c, c)
        got = k1.launch_worker(plan, x.contiguous(), w.contiguous(), 1)
        torch.cuda.synchronize()
        got = got.reshape(c, hh * wp)
        bad = (got != want).nonzero().tolist()
        rows = []
        for n_, m_ in bad[:24]:
            v = float(got[n_, m_])
            src = ((int(v) // 256, int(v) % 256) if name == "a"
                   else (int(v) // 64, int(v) % 64))
            rows.append({"n": n_, "m": m_, "got": v, "decoded": src})
        out.append({"probe": name, "wrong": len(bad), "of": got.numel(),
                    "first": rows})
        print(f"probe {name}: {len(bad)} of {got.numel()} outputs wrong"
              + "".join(f"\n  (n {r['n']}, m {r['m']}) = {r['got']:.0f} -> "
                        f"{r['decoded']}" for r in rows[:12]), flush=True)
    return out


def edges(cs, k1, device) -> list[dict]:
    rng = np.random.default_rng(cs.SEED)
    out = []
    for case in EDGES:
        ea, b, c, hh, wp, eb, nb, kh, kw, stride = case
        xe = torch.as_tensor(rng.standard_normal((ea, b, c, hh, wp)).astype(np.float32),
                             device=device)
        ke = torch.as_tensor(rng.standard_normal((eb, nb, c, kh, kw)).astype(np.float32),
                             device=device)
        m, n, k = k1.gemm_shape(xe.shape, ke.shape, stride)
        ref = k1.coded_worker_plain(xe, ke, stride)
        ref64 = k1.coded_worker_plain(xe.double(), ke.double(), stride)
        row = {"case": list(case), "mnk": [m, n, k]}
        for route in k1.ROUTES:
            plan = k1.route_plan(route, m, n, k)
            try:
                got = k1.launch_worker(plan, xe, ke, stride)
                again = k1.launch_worker(plan, xe, ke, stride)
                torch.cuda.synchronize()
                row[route] = {"plan": plan._asdict(), "rel_err": _rel(got, ref),
                              "rel_err_fp64": _rel(got, ref64),
                              "repeat": bool(torch.equal(got, again))}
            except Exception as exc:  # report every case, then fail below
                row[route] = {"plan": plan._asdict(), "error": repr(exc)}
        row["plain_rel_err_fp64"] = _rel(ref, ref64)
        print(f"edge {case} (M {m}, N {n}, K {k}): " + "; ".join(
            f"{r} {row[r].get('error') or 'err %.2e, fp64 %.2e, repeat %s' % (row[r]['rel_err'], row[r]['rel_err_fp64'], row[r]['repeat'])}"
            for r in k1.ROUTES) + f"; plain fp64 {row['plain_rel_err_fp64']:.2e}",
              flush=True)
        out.append(row)
    return out


def vgg(cs, k1, autotune, device) -> tuple[list[dict], dict]:
    server, _ = cs.build_server(torch.device("cpu"), cs.HW)
    shapes = cs.worker_shapes(server.pipeline, cs.BUCKET)
    del server
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    rows, seen = [], {}
    clock = cs.ClockSampler()
    with clock:
        for layer, (xs, ks, stride) in enumerate(shapes):
            if (xs, ks, stride) in seen:
                seen[(xs, ks, stride)]["layers"].append(layer + 1)
                continue
            xe = torch.randn(xs, generator=gen, device=device)
            ke = torch.randn(ks, generator=gen, device=device) / np.sqrt(np.prod(ks[2:]))
            m, n, k = k1.gemm_shape(xs, ks, stride)
            ref = k1.coded_worker_plain(xe, ke, stride)
            ref64 = k1.coded_worker_plain(xe.double(), ke.double(), stride)
            plain64 = _rel(ref, ref64)
            ea, b, c, hh, wp = xs
            eb, nb, _, kh, kw = ks
            xin, wcat = xe.reshape(ea * b, c, hh, wp), ke.reshape(eb * nb, c, kh, kw)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                cudnn = cs.device_ms(lambda: F.conv2d(xin, wcat, stride=stride))
            nbytes = 4.0 * (xe.numel() + ke.numel() + ref.numel())
            row = {"layers": [layer + 1], "xe": list(xs), "ke": list(ks),
                   "mnk": [m, n, k], "plain_rel_err_fp64": plain64,
                   "cudnn_ms": cudnn, "bounds": cs.k1_bounds(m, n, k, nbytes),
                   "design": {r: k1.plan_params(k1.route_plan(r, m, n, k))
                              for r in k1.ROUTES},
                   "plans": []}
            for cand in autotune.worker_candidates(xs, ks, stride):
                plan = k1.worker_plan_of(cand, m, n, k)

                def run(plan=plan):
                    return k1.launch_worker(plan, xe, ke, stride)

                entry = {"params": cand}
                try:
                    got = run()
                    entry.update(rel_err=_rel(got, ref), rel_err_fp64=_rel(got, ref64),
                                 repeat=bool(torch.equal(run(), got)),
                                 device_ms=cs.device_ms(run))
                    entry["ok"] = (entry["rel_err"] <= cs.TOL_K1 and entry["repeat"]
                                   and entry["rel_err_fp64"]
                                   <= cs.K1_FP64_RATIO * plain64)
                    del got
                except Exception as exc:  # report every plan
                    entry.update(error=repr(exc), ok=False)
                row["plans"].append(entry)
            for r in k1.ROUTES:
                mine = [p for p in row["plans"] if p["params"]["route"] == r and p["ok"]]
                row[f"best_{r}"] = min(mine, key=lambda p: p["device_ms"]) if mine else None
                design = next((p for p in row["plans"]
                               if p["params"] == row["design"][r]), None)
                row[f"design_{r}_ms"] = design.get("device_ms") if design else None
            seen[(xs, ks, stride)] = row
            rows.append(row)
            print(f"layer {layer + 1} M {m} N {n} K {k}: " + ", ".join(
                f"{p['params']['route']}/{p['params']['bn']}/{p['params']['splits']} "
                + (f"{p['device_ms']:.4f}{'' if p['ok'] else ' FAIL'}"
                   if "device_ms" in p else p.get("error", "?"))
                for p in row["plans"]) + f"; cuDNN {cudnn:.4f}; bounds FFMA "
                f"{row['bounds']['ffma_ms']:.4f}, 3xTF32 {row['bounds']['tf32x3_ms']:.4f};"
                f" fp64: plain {plain64:.2e}, tc best "
                f"{(row['best_tc'] or {}).get('rel_err_fp64', float('nan')):.2e}",
                  flush=True)
            del xe, ke, ref, ref64, xin, wcat
            torch.cuda.empty_cache()
    sums = {}
    for key in ["cudnn_ms"] + [f"design_{r}_ms" for r in k1.ROUTES]:
        vals = [r[key] for r in rows]
        sums[key] = (None if any(v is None for v in vals) else
                     sum(v * len(r["layers"]) for v, r in zip(vals, rows)))
    for r in k1.ROUTES:
        best = [row[f"best_{r}"] for row in rows]
        sums[f"best_{r}_ms"] = (None if any(b is None for b in best) else
                                sum(b["device_ms"] * len(row["layers"])
                                    for b, row in zip(best, rows)))
    sums["best_any_ms"] = sum(
        min(b["device_ms"] for b in (row[f"best_{r}"] for r in k1.ROUTES) if b)
        * len(row["layers"]) for row in rows)
    for key in ("ffma_ms", "tf32x3_ms"):
        sums[f"bound_{key}"] = sum(r["bounds"][key] * len(r["layers"]) for r in rows)
    sums["sm_clock"] = clock.summary()
    print("pass: " + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()
                               if isinstance(v, float)), flush=True)
    print(cs.clock_line("the VGG-16 sweep", sums["sm_clock"]), flush=True)
    return rows, sums


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="append the JSON object to this file")
    ap.add_argument("--no-vgg", action="store_true",
                    help="the probes and edge cases only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    cs = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    from repro_torch.kernels import autotune
    from repro_torch.kernels.conv2d import kernel as k1
    from repro_torch.kernels.native import build_library

    _, log = build_library()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("==") \
                or "error" in line or "warning" in line:
            print("  " + line.strip())
    result = {"card": card, "probes": probes(k1, device),
              "edges": edges(cs, k1, device)}
    wrong = [p["probe"] for p in result["probes"] if p["wrong"]] + [
        e["case"] for e in result["edges"] for r in k1.ROUTES
        if "error" in e[r] or not (e[r]["rel_err"] <= cs.TOL_K1
                                   and e[r]["repeat"])]
    if wrong:
        print(f"the VGG-16 sweep is skipped: wrong at {wrong}", flush=True)
    elif not args.no_vgg:
        result["vgg"], result["pass"] = vgg(cs, k1, autotune, device)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
