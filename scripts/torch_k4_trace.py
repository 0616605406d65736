#!/usr/bin/env python3
"""Where a key-tile iteration of K4's bf16 wgmma kernel spends its cycles,
on one card:

    python3 scripts/torch_k4_trace.py [--out FILE]

Builds ``flash_attn.cu`` once more with ``-DK4_TRACE`` (into the kernels'
git-ignored build directory), which makes thread 0 of each consumer
warpgroup of block 0 write ``clock64()`` stamps around each step of each
key-tile iteration of the block's first query tile (the longest, causal).
At each shape of ``SHAPES`` it launches the kernel three times (the last
launch's stamps stay) and prints, for each warpgroup, the median cycles of
each step over the iterations from the third on:

  * ``data``: waiting for the K and V tiles of the iteration;
  * ``turn``: O's rescale and waiting for the warpgroup's turn to issue;
  * ``issue``: issuing Q.K^T of tile t and P.V of tile t - 1;
  * ``qk_wait``: waiting for Q.K^T(t);
  * ``softmax``: the online softmax of tile t, under P.V(t - 1);
  * ``pv_wait``: waiting for P.V(t - 1) after it;
  * ``pack``: rounding p to bf16;

and the iteration's cycles, beside the tensor cores' own share (the two
warpgroups' GEMMs of one iteration at 2,048 dense bf16 multiply-adds a
cycle an SM) and the SM clock.  The traced build
is a separate library: the served kernel has no stamps.  Prints the card's
name and power limit first and, as its last line, one JSON object of every
reading (appended to ``--out`` too).  Needs one CUDA device.
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

STEPS = ("data", "turn", "issue", "qk_wait", "softmax", "pv_wait", "pack")
# (BH, S, D, rep, causal): phase 15's Qwen3-4B prefill and the
# Whisper-medium encoder
SHAPES = [(64, 2048, 128, 4, True), (64, 1500, 64, 1, False)]
MACS_PER_CYCLE = 2048  # dense bf16 multiply-adds a cycle an SM (989 TFLOP/s at 1,830 MHz over 132 SMs)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build() -> ctypes.CDLL:
    from repro_torch.kernels import native

    out = native.BUILD_ROOT / "trace"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libk4_trace.so"
    subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-DK4_TRACE", "-shared",
                    "-o", str(lib), str(native.CSRC / "flash_attn.cu")],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.flash_attn_tiled.argtypes = native.SIGNATURES["flash_attn_tiled"]
    dll.flash_attn_tiled.restype = ctypes.c_int
    dll.flash_attn_tiled_trace.argtypes = [ctypes.c_void_p]
    dll.flash_attn_tiled_trace.restype = ctypes.c_int
    return dll


def trace_shape(dll, k4, bh, s, d, rep, causal, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=device).bfloat16()
               for shape in ((bh, s, d), (bh // rep, s, d), (bh // rep, s, d)))
    out = torch.empty_like(q)
    plan = k4.tiled_plan(bh, s, d, rep, True, kernel="wgmma")
    buf = torch.zeros(2 * 256 * 8, dtype=torch.int64, device=device)
    if dll.flash_attn_tiled_trace(buf.data_ptr()) != 0:
        raise RuntimeError("flash_attn_tiled_trace failed")
    for _ in range(3):  # the last launch's stamps stay
        rc = dll.flash_attn_tiled(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), None, bh, s, s, d, rep, d ** -0.5,
                                  int(causal), 1, plan.heads, plan.rows, plan.warps,
                                  torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_attn_tiled returned {rc}")
    torch.cuda.synchronize()
    dll.flash_attn_tiled_trace(None)
    st = buf.view(2, 256, 8).cpu().numpy()
    n = int((st[0, :, 7] > 0).sum()) + 1  # iterations 1 .. n - 1 carry stamps
    macs = 2 * 2 * 64 * 128 * d  # both warpgroups' Q.K^T and P.V of one key tile
    row = {"bh": bh, "s": s, "d": d, "rep": rep, "causal": causal, "key_tiles": n,
           "tensor_cycles": macs / MACS_PER_CYCLE}
    for w in (0, 1):
        x = st[w, 2:n]  # from the third iteration on
        row[f"wg{w}"] = {
            "iteration": float(np.median(np.diff(x[:, 0]))),
            **{name: float(np.median(x[:, j + 1] - x[:, j]))
               for j, name in enumerate(STEPS)}}
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="append the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k4_trace: needs a CUDA device", file=sys.stderr)
        return 1
    cs = _smoke()
    from repro_torch.kernels.flash_attn import kernel as k4

    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    dll = build()
    rows = []
    clock = cs.ClockSampler()
    with clock:
        for shape in SHAPES:
            row = trace_shape(dll, k4, *shape, device)
            rows.append(row)
            for w in (0, 1):
                r = row[f"wg{w}"]
                print(f"K4 wgmma {shape} warpgroup {w}: iteration {r['iteration']:.0f} "
                      "cycles (" + ", ".join(f"{k} {r[k]:.0f}" for k in STEPS)
                      + f"); both warpgroups' GEMMs {row['tensor_cycles']:.0f} at the "
                      f"tensor cores' rate", flush=True)
    clk = clock.summary()
    print(cs.clock_line("the traced launches", clk), flush=True)
    line = json.dumps({"card": card, "sm_clock": clk, "shapes": rows})
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
