#!/usr/bin/env python3
"""Where the LM round's (and the CNN round's) host time goes on each worker
pool, eager and replayed from CUDA graphs, in turns on one card:

    python3 scripts/torch_pool_rounds.py [--turns 2] [--variants A,B,...]
        [--src SRC --label NAME]

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
    3 still dead), so no round starts a straggler's sleep or timer;
  * ``device-eager`` / ``threads-eager``: as ``device`` / ``threads`` with
    ``graphs=False``, every program op by op (the others replay the
    master's programs from CUDA graphs, captured by the server's warmup
    before the timed run; worker rounds eager, the pipeline's default);
  * ``device-workers``: as ``device``, with the worker rounds replayed
    too (``set_graphs(True, workers=True)``);
  * ``cnn-device`` / ``cnn-device-eager`` / ``cnn-device-workers`` /
    ``cnn-threads`` / ``cnn-threads-eager``: ``chip_smoke.py``'s 16
    VGG-16 224x224 requests (2 stragglers at +50 ms, 1 dead, fused
    transitions, depth 2) on ``CodedServer``, replayed (master, or master
    and workers) or eager.

Each LM run prints tok/s, the decode seconds, the round-phase sums (master
encode, to the delta-th result, decode), the glue between rounds, the
seconds spent inside the pool's ``submit`` (the master's dispatch) and
the K2 launches (the device pool's delayed dispatches all fire); each CNN
run img/s and dispatch, worker, collect and transition a round; both the
capture seconds and the graph pools' bytes; then one JSON line per run.
``--profile`` runs each variant once more under ``cProfile`` on the
engine thread (the master: dispatch, reap, transition or glue) and prints
the functions that took the most time of their own there.  Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import gc
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

# name -> (pool, delays, spin, graphs): graphs None leaves the tree's
# default (a tree before compiled programs has no such switch), False is
# eager, "workers" replays the worker rounds too
VARIANTS = {
    "threads": ("threads", LM_DELAYS, None, None),
    "device": ("device", LM_DELAYS, None, None),
    "device-nospin": ("device", LM_DELAYS, 0.0, None),
    "threads-nodelay": ("threads", (0.0, 0.0, 0.0, float("inf")), None, None),
    "device-nodelay": ("device", (0.0, 0.0, 0.0, float("inf")), None, None),
    "device-eager": ("device", LM_DELAYS, None, False),
    "threads-eager": ("threads", LM_DELAYS, None, False),
    "device-workers": ("device", LM_DELAYS, None, "workers"),
}
CNN_VARIANTS = {
    "cnn-device": ("device", None),
    "cnn-device-eager": ("device", False),
    "cnn-device-workers": ("device", "workers"),
    "cnn-threads": ("threads", None),
    "cnn-threads-eager": ("threads", False),
}


def graph_totals(pipe, impl) -> dict:
    """Capture seconds, graph count and the graph pools' bytes of the
    master and (device pool) the workers; zeros where nothing was
    captured or the tree has no compiled programs."""
    sets = [getattr(pipe, "master_graphs", None)]
    if hasattr(impl, "graph_sets"):
        sets += impl.graph_sets()
    sets = [s for s in sets if s is not None]
    if not sets:
        return {"graphs": 0, "capture_s": 0.0, "pool_bytes": 0}
    from repro_torch.core.graphs import merge_stats

    st = merge_stats(sets)
    return {"graphs": st["graphs"], "capture_s": st["capture_s"],
            "pool_bytes": st["pool_bytes"]}


def set_graphs(pipe, graphs) -> None:
    """Put ``pipe``'s switch where a variant's ``graphs`` says (None: the
    default, master programs replayed and worker rounds eager)."""
    if graphs is None and not hasattr(pipe, "set_graphs"):
        return  # a tree before compiled programs
    pipe.set_graphs(graphs is not False, workers=graphs == "workers")


def serve(cs, pipe, requests, pool: str, delays, spin_s, graphs,
          profile: bool = False) -> dict:
    from repro_torch.kernels.matmul.kernel import launches as k2
    from repro_torch.runtime import StragglerModel
    from repro_torch.serving import CodedLMServer

    set_graphs(pipe, graphs)
    server = CodedLMServer(pipe, StragglerModel(np.array(delays)),
                           mode="threads", max_prompt=cs.LM_MAX_PROMPT,
                           poll_interval_s=0.001, pool=pool)
    if hasattr(server, "warmup"):
        server.warmup()
    impl = server.cluster._pool_impl()
    if spin_s is not None:
        impl.spin_s = spin_s
    submit_s = [0.0]
    submit = impl.submit

    def timed_submit(*args):
        t = time.perf_counter()
        try:
            return submit(*args)
        finally:
            submit_s[0] += time.perf_counter() - t

    impl.submit = timed_submit
    report = profiled(server) if profile else None
    k2.reset()
    t0 = time.perf_counter()
    with server:
        with server.scheduler.not_empty:
            handles = [server.submit(p, g) for p, g in requests]
        outs = [h.result(timeout=900.0) for h in handles]
        wall = time.perf_counter() - t0
        graphs_st = graph_totals(pipe, impl)
    toks = sum(len(o) for o in outs)
    if report is not None:
        print(report(), flush=True)
    return {**graphs_st,
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


def profiled(server, top: int = 25) -> list[str]:
    """Run ``server``'s engine loop under ``cProfile`` (the engine thread
    only); returns a callable that formats the ``top`` functions by their
    own time."""
    import cProfile
    import io
    import pstats

    prof = cProfile.Profile()
    loop = server._engine_loop

    def run():
        prof.enable()
        try:
            loop()
        finally:
            prof.disable()

    server._engine_loop = run

    def report() -> str:
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
        return out.getvalue()

    return report


def serve_cnn(cs, xs, pool: str, graphs, profile: bool = False) -> dict:
    """``chip_smoke.py``'s VGG-16 requests on ``CodedServer``: warmup
    (captures) outside the timed run, then img/s and ms a round for each
    phase."""
    server, _ = cs.build_server(torch.device("cuda"), cs.HW, pool=pool)
    set_graphs(server.pipeline, graphs)
    server.warmup()
    impl = server.cluster._pool_impl()
    submit_s = [0.0]
    submit = impl.submit

    def timed_submit(*args):
        t = time.perf_counter()
        try:
            return submit(*args)
        finally:
            submit_s[0] += time.perf_counter() - t

    impl.submit = timed_submit
    report = profiled(server) if profile else None
    t0 = time.perf_counter()
    with server:
        handles = server.submit_many(xs)
        for h in handles:
            h.result(timeout=600.0)
        wall = time.perf_counter() - t0
        graphs_st = graph_totals(server.pipeline, server.cluster._pool_impl())
    st, ov = server.stats(), server.overlap_stats()
    per = 1e3 / ov.rounds
    out = {**graphs_st, "img_s": st.images_per_s, "wall_s": wall,
           "rounds": ov.rounds, "dispatch_ms": ov.dispatch_s * per,
           "worker_ms": ov.worker_s * per, "collect_ms": ov.collect_s * per,
           "transition_ms": ov.transition_s * per,
           "submit_ms": submit_s[0] * per,
           "e2e_p50_ms": st.e2e_p50_s * 1e3, "e2e_p99_ms": st.e2e_p99_s * 1e3}
    if report is not None:
        print(report(), flush=True)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory of the tree to run")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--profile", action="store_true",
                    help="then one profiled run of each variant")
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
    names = args.variants.split(",")
    order = []
    for t in range(args.turns):
        order += names if t % 2 == 0 else names[::-1]
    xs = np.random.default_rng(cs.SEED).standard_normal(
        (cs.N_REQUESTS, 3, cs.HW, cs.HW)).astype(np.float32)
    pipe = requests = None
    forced = None  # the streams of the runs that decode from workers 0, 1
    for name, profile in [(n, False) for n in order] + \
            [(n, True) for n in (names if args.profile else ())]:
        if profile:
            print(f"== profile of {name} (engine thread, cProfile)", flush=True)
        if name in CNN_VARIANTS:
            r = serve_cnn(cs, xs, *CNN_VARIANTS[name], profile=profile)
            print(f"{args.label} {name:18s} {r['img_s']:6.2f} img/s; ms a round: "
                  f"dispatch {r['dispatch_ms']:.3f} (submit {r['submit_ms']:.3f}), "
                  f"worker {r['worker_ms']:.3f}, "
                  f"collect {r['collect_ms']:.3f}, transition "
                  f"{r['transition_ms']:.3f}; {r['graphs']} graphs captured in "
                  f"{r['capture_s']:.2f} s, pools {r['pool_bytes']} bytes",
                  flush=True)
            print(json.dumps({"label": args.label, "variant": name,
                              "card": card, **r}), flush=True)
            continue
        if pipe is None:
            pipe, _ = cs.build_lm(device)
            requests = cs.lm_requests(pipe.cfg.vocab)
        pool, delays, spin, graphs = VARIANTS[name]
        r = serve(cs, pipe, requests, pool, delays, spin, graphs, profile)
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
              f"{r['glue_s'] * per:.3f}; K2 launches {r['k2_launches']}; "
              f"{r['graphs']} graphs captured in {r['capture_s']:.2f} s, "
              f"pools {r['pool_bytes']} bytes",
              flush=True)
        print(json.dumps({"label": args.label, "variant": name, "card": card,
                          **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
