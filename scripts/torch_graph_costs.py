#!/usr/bin/env python3
"""What one replayed program costs the host, piece by piece, on one card:

    python3 scripts/torch_graph_costs.py [--reps 300]

For a K2 worker GEMM at the served LM shape (bucket 4: (4, 576) @ (576,
480)) and for K1 at VGG-16's conv3_1 worker shape (bucket 8), prints the
host microseconds a call of:

  * ``eager``: the K2 / K1 wrapper called directly;
  * ``program``: ``GraphSet.run`` (copy-in, replay, clone-out and the
    bookkeeping around them), the path a served round takes;
  * ``replay``: ``CUDAGraph.replay()`` alone;
  * ``copy_in`` / ``clone_out``: the static input's ``copy_`` and the
    output's ``clone`` alone;
  * ``stream`` / ``event``: ``torch.cuda.current_stream()`` and an event
    made and recorded.

Each is the mean over ``--reps`` back-to-back calls (a third of them for
K1), timed on the host clock with the stream held by ``torch.cuda._sleep``
so the card never stalls the host (the reps stay under the launch queue's
depth); then one JSON line.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def host_us(fn, reps: int) -> float:
    """Mean host microseconds of ``fn`` over ``reps`` calls, issued while
    the stream is held, so a full launch queue never blocks the host."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))  # ~1 s of device time: the issue stays ahead
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def costs(name: str, raw, args, reps: int, resident=(1,)) -> dict:
    from repro_torch.core.graphs import GraphSet
    from repro_torch.core.pipeline import Program

    dev = args[0].device
    stream = torch.cuda.Stream(dev)
    out = {"case": name}
    with torch.cuda.stream(stream):
        gs = GraphSet("costs", dev)
        prog = Program(raw, name=name, resident=resident, graphs=gs)
        prog(*args, slot="s")
        g = next(iter(gs._graphs.values()))
        static = g.copied[0][1]
        y = g.outs[0]
        out["eager_us"] = host_us(lambda: raw(*args), reps)
        out["program_us"] = host_us(lambda: prog(*args, slot="s"), reps)
        out["replay_us"] = host_us(g.graph.replay, reps)
        out["copy_in_us"] = host_us(lambda: static.copy_(args[0]), reps)
        out["clone_out_us"] = host_us(y.clone, reps)
        out["stream_us"] = host_us(lambda: torch.cuda.current_stream(dev), reps)

        def event():
            torch.cuda.Event().record(stream)

        out["event_us"] = host_us(event, reps)
        out["kernels_held"] = {c.name: k for c, k in g.held.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_graph_costs: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.conv2d.kernel import coded_worker
    from repro_torch.kernels.matmul.kernel import matmul

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((4, 576), generator=g, device=dev)
    w = torch.randn((576, 480), generator=g, device=dev)
    # VGG-16 conv3_1 at 224, n=8, (2, 4), bucket 8: one worker's shares
    # (ell_a, B, C, h_hat, Wp) and filter groups (ell_b, N/k_b, C, 3, 3)
    xe = torch.randn((2, 8, 128, 30, 58), generator=g, device=dev)
    ke = torch.randn((2, 64, 128, 3, 3), generator=g, device=dev) / 34.0
    rows = [costs("k2_lm", matmul, (x, w), args.reps),
            costs("k1_conv3_1", lambda a, b: coded_worker(a, b, 1), (xe, ke),
                  max(args.reps // 3, 50))]
    for r in rows:
        print(f"{r['case']:12s} host us a call: eager {r['eager_us']:.1f}, "
              f"program {r['program_us']:.1f} (replay {r['replay_us']:.1f}, "
              f"copy-in {r['copy_in_us']:.1f}, clone-out "
              f"{r['clone_out_us']:.1f}), current_stream {r['stream_us']:.1f}, "
              f"event {r['event_us']:.1f}; kernels held {r['kernels_held']}")
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
