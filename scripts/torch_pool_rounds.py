#!/usr/bin/env python3
"""Where the LM round's host time goes on each worker pool, in turns on one
card:

    python3 scripts/torch_pool_rounds.py [--turns 2] [--src SRC --label NAME]

``--src`` imports the port from another tree (a parent commit unpacked
with ``git archive``), so two trees can run in turns in one call.

Serves ``chip_smoke.py``'s 8 SmolLM-135M requests (full width and depth,
random weights from its seed, exp13's plan n=4, k_b=4) on
``CodedLMServer`` once per variant and turn, variants in order and then
in reverse (A B C ... C B A):

  * ``threads`` / ``device``: the thread pool and the device pool under
    ``chip_smoke.py``'s stragglers (worker 2 at +50 ms, worker 3 dead);
  * ``device-nospin``: the device pool without its spin on ``query()``;
  * ``threads-nodelay`` / ``device-nodelay``: worker 2 undelayed (worker
    3 still dead), so no round starts a straggler's sleep or timer.

Each run prints tok/s, the decode seconds, the round-phase sums (master
encode, to the delta-th result, decode), the glue between rounds, the
seconds spent inside the pool's ``submit`` (the master's dispatch) and
the K2 launches (the device pool's delayed dispatches all fire), then one
JSON line per run.  Needs one CUDA device.
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

ROOT = Path(__file__).resolve().parents[1]


def _load_chip_smoke(src: str):
    """This checkout's ``chip_smoke.py`` over the port of ``src``: the
    package is imported from ``src`` first, so every later
    ``repro_torch`` import resolves there."""
    sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch  # noqa: F401

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


LM_DELAYS = (0.0, 0.0, 0.05, float("inf"))  # chip_smoke.py's LM stragglers

VARIANTS = {
    "threads": ("threads", LM_DELAYS, None),
    "device": ("device", LM_DELAYS, None),
    "device-nospin": ("device", LM_DELAYS, 0.0),
    "threads-nodelay": ("threads", (0.0, 0.0, 0.0, float("inf")), None),
    "device-nodelay": ("device", (0.0, 0.0, 0.0, float("inf")), None),
}


def serve(cs, pipe, requests, pool: str, delays, spin_s) -> dict:
    from repro_torch.kernels.matmul.kernel import launches as k2
    from repro_torch.runtime import StragglerModel
    from repro_torch.serving import CodedLMServer

    server = CodedLMServer(pipe, StragglerModel(np.array(delays)),
                           mode="threads", max_prompt=cs.LM_MAX_PROMPT,
                           poll_interval_s=0.001, pool=pool)
    impl = server.cluster._pool_impl()
    if spin_s is not None:
        impl.spin_s = spin_s
    submit_s = [0.0]
    submit = impl.submit

    def timed_submit(fn, xe, ke):
        t = time.perf_counter()
        try:
            return submit(fn, xe, ke)
        finally:
            submit_s[0] += time.perf_counter() - t

    impl.submit = timed_submit
    k2.reset()
    t0 = time.perf_counter()
    with server:
        with server.scheduler.not_empty:
            handles = [server.submit(p, g) for p, g in requests]
        outs = [h.result(timeout=900.0) for h in handles]
    wall = time.perf_counter() - t0
    toks = sum(len(o) for o in outs)
    return {
        "tok_s": toks / wall, "wall_s": wall, "tokens": toks,
        "decode_s": server.decode_time_s, "rounds": server.rounds,
        "encode_s": server.round_encode_s,
        "to_delta_s": server.round_compute_s,
        "decode_round_s": server.round_decode_s,
        "glue_s": (server.decode_time_s - server.round_encode_s
                   - server.round_compute_s - server.round_decode_s),
        "submit_s": submit_s[0], "k2_launches": k2.count,
        "streams": [list(o) for o in outs],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory of the tree to run")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pool_rounds: needs a CUDA device", file=sys.stderr)
        return 1
    cs = _load_chip_smoke(args.src)
    if cs.LM_DELAYS != LM_DELAYS:
        raise AssertionError("chip_smoke.py's LM stragglers changed")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    device = torch.device("cuda")
    pipe, _ = cs.build_lm(device)
    requests = cs.lm_requests(pipe.cfg.vocab)
    names = args.variants.split(",")
    order = []
    for t in range(args.turns):
        order += names if t % 2 == 0 else names[::-1]
    forced = None  # the streams of the runs that decode from workers 0, 1
    for name in order:
        pool, delays, spin = VARIANTS[name]
        r = serve(cs, pipe, requests, pool, delays, spin)
        streams = r.pop("streams")
        if delays == LM_DELAYS:
            forced = forced or streams
            if streams != forced:
                raise AssertionError(f"{name}: served tokens differ from the "
                                     f"other forced-survivor runs'")
        per = 1e3 / r["rounds"]
        print(f"{args.label} {name:16s} {r['tok_s']:6.2f} tok/s, decode {r['decode_s']:.3f} s; "
              f"ms a round: encode {r['encode_s'] * per:.3f}, to delta-th "
              f"{r['to_delta_s'] * per:.3f} (submit {r['submit_s'] * per:.3f}), "
              f"decode {r['decode_round_s'] * per:.3f}, glue "
              f"{r['glue_s'] * per:.3f}; K2 launches {r['k2_launches']}",
              flush=True)
        print(json.dumps({"label": args.label, "variant": name, "card": card,
                          **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
