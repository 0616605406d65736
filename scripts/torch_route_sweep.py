#!/usr/bin/env python3
"""K4's two routes and K2's split counts side by side on one card, at the
shapes where the plans choose between them:

    python3 scripts/torch_route_sweep.py [--out FILE]

K4 (``flash_attention``): for each ``(BH, Sq, Sk, D, rep, causal)`` of
``K4_SHAPES`` in fp32 and bf16, the rows route (``rows_plan``) and each
tiled kernel of the type (``tiled_plan(kernel=)``: fp32 ``tf32x3`` at D 64
and 128 and the ``ffma`` one at every D; bf16 ``wgmma`` at D 64 and 128
and the ``mma`` one at every D) are launched on the same inputs
(``launch_plan``), each checked against
``flash_attention_plain`` (fp32 within 2e-5 of max|plain|, bf16 within
2^-7) and against a second launch of itself (bit for bit), then timed in
device ms (``chip_smoke.device_ms``, 10 calls) beside SDPA in the same
type (K/V repeated outside the timed call).  The prompt lengths of
``CROSSOVER_S`` at the zoo's prefill heads give the row at which
``flash_plan`` should leave the rows route (``tiled_route``), and where
each tiled kernel of a type is the faster (``WGMMA_MIN_ROWS``,
``TF32X3_MIN_ROWS``); ``CROSS_SHAPES`` (few queries over many unmasked keys) where
it should leave it whatever the query rows.  Each line
names the fastest kernel and whether ``flash_plan`` picked it; the JSON's
``k4_missed`` lists the cells where it did not.

K2 (``matmul``): for each Qwen3-4B coded worker GEMM (batch 4) and the
SmolLM-135M ones, the column kernel and the split kernel at 1, 2, 4 and 8
slices, each checked against ``matmul_plain`` (1e-5 of max|plain|) and
timed beside ``torch.matmul``; ``*`` marks ``matmul_plan``'s choice.

Prints one line a shape, the card's name and power limit first, and as its
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

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# the prompt lengths between which the routes cross, at the prefill heads
# of the zoo: (BH, D, rep) of SmolLM-135M (4 x 9 over 3), Qwen3-4B (4 x 32
# over 8), Hymba-1.5B (4 x 25 over 5) and Whisper-medium's decoder (4 x 16)
CROSSOVER_S = (16, 32, 48, 64, 96, 128, 256, 512)
CROSSOVER_HEADS = ((36, 64, 3), (128, 128, 4), (100, 64, 5), (64, 64, 1))
# cross-attention, no mask: 16 and 32 queries over 256-4,096 keys at
# Whisper-medium's decoder heads (4 x 16, D 64), the one model of the zoo
# that attends without the mask
CROSS_SHAPES = [(64, sq, sk, 64, 1, False) for sq in (16, 32)
                for sk in (256, 512, 1500, 4096)]
K4_SHAPES = ([(bh, s, s, d, rep, True) for bh, d, rep in CROSSOVER_HEADS
              for s in CROSSOVER_S]
             + [(64, 2048, 2048, 128, 4, True), (64, 1500, 1500, 64, 1, False),
                (32, 1500, 1500, 64, 1, False), (32, 511, 511, 128, 4, True)]
             + CROSS_SHAPES)
# (M, K, N): Qwen3-4B's coded worker GEMMs at batch 4 (qkv, wo, gate-up,
# down) and SmolLM-135M's
K2_SHAPES = [(4, 2560, 3072), (4, 4096, 1280), (4, 2560, 9728), (4, 9728, 1280),
             (4, 576, 480), (4, 576, 288), (4, 576, 1536), (4, 1536, 288)]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def k4_sweep(cs, device) -> list[dict]:
    from repro_torch.kernels.flash_attn import kernel as k4

    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    out = []
    for bh, sq, sk, d, rep, causal in K4_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
                       for shape in ((bh, sq, d), (bh // rep, sk, d),
                                     (bh // rep, sk, d)))
            want = k4.flash_attention_plain(q, k, v, causal=causal, rep=rep)
            b = bh // rep
            q4 = q.view(b, rep, sq, d)
            k4r, v4r = (t.view(b, 1, sk, d).expand(b, rep, sk, d).contiguous()
                        for t in (k, v))
            row = {"bh": bh, "sq": sq, "sk": sk, "d": d, "rep": rep,
                   "causal": causal, "dtype": str(dtype).removeprefix("torch."),
                   "sdpa_ms": cs.device_ms(lambda: F.scaled_dot_product_attention(
                       q4, k4r, v4r, is_causal=causal))}
            wide = d in k4.WGMMA_HEAD_DIMS
            kernels = (["wgmma", "mma"] if wide else ["mma"]) if bf16 else (
                ["tf32x3", "ffma"] if wide else ["ffma"])
            plans = [k4.rows_plan(bh, sq, d, rep)] + [
                k4.tiled_plan(bh, sq, d, rep, bf16, kernel=kern) for kern in kernels]
            row["plan"] = k4.flash_plan(bh, sq, sk, d, rep, bf16, causal).kernel
            for plan in plans:
                def run(plan=plan):
                    return k4.launch_plan(plan, q, k, v, scale=None,
                                          causal=causal, rep=rep)

                got = run()
                rel = _rel(got, want)
                if not rel <= TOL[dtype]:
                    raise AssertionError(f"K4 {plan.kernel} {row}: rel err {rel}")
                if not torch.equal(run(), got):
                    raise AssertionError(f"K4 {plan.kernel} {row}: two launches differ")
                row[f"{plan.kernel}_ms"] = cs.device_ms(run)
                row[f"{plan.kernel}_rel_err"] = rel
            row["bound_ms"], row["bound_by"] = cs.flash_bound(
                bh, bh // rep, sq, sk, d, dtype, causal)
            if not bf16:
                row["bound_tf32x3_ms"] = cs.flash_bound(
                    bh, bh // rep, sq, sk, d, dtype, causal, tf32x3=True)[0]
            row["fastest"] = min((p.kernel for p in plans),
                                 key=lambda kern: row[kern + "_ms"])
            row["plan_over_fastest"] = (row[row["plan"] + "_ms"]
                                        / row[row["fastest"] + "_ms"])
            print(f"K4 {bh} x {sq} x {sk} D {d} rep {rep} "
                  f"{'causal' if causal else 'full'} {row['dtype']}: "
                  + ", ".join(f"{'*' if p.kernel == row['plan'] else ''}{p.kernel} "
                              f"{row[p.kernel + '_ms']:.5f}" for p in plans)
                  + f" ms, SDPA {row['sdpa_ms']:.5f}, bound {row['bound_ms']:.5f} "
                  f"({row['bound_by']}); fastest {row['fastest']}"
                  + ("" if row["fastest"] == row["plan"] else
                     f" (plan MISSED by {row['plan_over_fastest'] - 1:.1%})"),
                  flush=True)
            out.append(row)
            del q, k, v, want, q4, k4r, v4r
    return out


def k2_sweep(cs, device) -> list[dict]:
    from repro_torch.kernels.matmul import kernel as k2

    gen = torch.Generator(device=device).manual_seed(cs.SEED + 1)
    out = []
    for m, kk, n in K2_SHAPES:
        a = torch.randn((m, kk), generator=gen, device=device)
        b = torch.randn((kk, n), generator=gen, device=device)
        want = k2.matmul_plain(a, b)
        chosen = k2.matmul_plan(m, n, kk)
        row = {"m": m, "k": kk, "n": n, "plan": chosen._asdict(),
               "library_ms": cs.device_ms(lambda: torch.matmul(a, b)),
               "bound_ms": cs.bound_ms(2.0 * m * n * kk,
                                       4.0 * (m * kk + kk * n + m * n))[0],
               "ms": {}}
        strips = -(-n // k2.SPLIT_STRIP)
        plans = [k2.MatmulPlan("column", 0, kk, 0)] + [
            k2.MatmulPlan("split", s, -(-kk // s), strips * s)
            for s in k2.SPLIT_CHOICES]
        for plan in plans:
            def run(plan=plan):
                return k2.launch_plan(plan, a, b)

            got = run()
            rel = _rel(got, want)
            if not rel <= cs.TOL_K2:
                raise AssertionError(f"K2 {plan} at {m, kk, n}: rel err {rel}")
            if not torch.equal(run(), got):
                raise AssertionError(f"K2 {plan} at {m, kk, n}: launches differ")
            row["ms"][f"{plan.kernel}{plan.splits or ''}"] = cs.device_ms(run)
        key = f"{chosen.kernel}{chosen.splits or ''}"
        print(f"K2 ({m} x {kk}) . ({kk} x {n}): " + ", ".join(
            f"{'*' if name == key else ''}{name} {t:.5f}"
            for name, t in row["ms"].items())
              + f" ms; torch.matmul {row['library_ms']:.5f}, bound "
              f"{row['bound_ms']:.5f}", flush=True)
        out.append(row)
        del a, b, want
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="append the JSON object to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_route_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    cs = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    from repro_torch.kernels.native import build_library

    _, log = build_library()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
    k4_rows = k4_sweep(cs, device)
    missed = [{key: r[key] for key in ("bh", "sq", "sk", "d", "rep", "causal",
                                         "dtype", "plan", "fastest",
                                         "plan_over_fastest")}
              for r in k4_rows if r["plan"] != r["fastest"]]
    print(f"K4: flash_plan picked the fastest kernel in "
          f"{len(k4_rows) - len(missed)} of {len(k4_rows)} cells", flush=True)
    result = {"card": card, "k4": k4_rows, "k4_missed": missed,
              "k2": k2_sweep(cs, device)}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
