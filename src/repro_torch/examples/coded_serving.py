"""Coded serving engine in ~40 lines: LeNet-5 behind a CodedServer.

Starts a continuous-batching server over one resident coded pipeline on
n=8 simulated workers (one of them a straggler), fires a burst of
concurrent requests from client threads, and prints each request's
queue-wait / execute / end-to-end latency.  The straggler never shows up
in the latencies — the coded cluster decodes from the fastest delta
workers, and late arrivals join the next layer boundary instead of
waiting for the batch ahead.  Each result is held against the uncoded
stack.

  python -m repro_torch.examples.coded_serving [--requests 12] [--device cpu]
"""
import argparse
import threading

import numpy as np
import torch

from repro_torch.devices import resolve_device
from repro_torch.models.cnn import init_cnn, run_convls
from repro_torch.runtime import StragglerModel
from repro_torch.serving import CodedServer

N_WORKERS = 8
# each result against the uncoded stack, relative to max|uncoded|
TOL = 1e-4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    requests = args.requests

    rng = np.random.default_rng(0)
    params = init_cnn("lenet5", torch.Generator().manual_seed(0), dev)

    delays = np.zeros(N_WORKERS)
    delays[3] = 0.25  # one injected straggler (+250 ms per subtask)
    server = CodedServer.from_cnn(
        "lenet5", params, N_WORKERS, default_kab=(2, 4),
        straggler=StragglerModel(delays), mode="threads",
        bucket_sizes=(1, 2, 4), device=dev,
    )
    server.warmup()  # capture every (layer, bucket) program

    xs = rng.standard_normal((requests, 1, 32, 32)).astype(np.float32)
    handles = [None] * requests
    outs = [None] * requests

    def client(i):  # each request arrives on its own client thread
        handles[i] = server.submit(xs[i])

    with server:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, h in enumerate(handles):
            y = outs[i] = h.result(timeout=60.0)
            rec = next(r for r in server.metrics.records()
                       if r.request_id == h.request_id)
            print(
                f"request {h.request_id:2d}: queue {rec.queue_wait_s*1e3:6.1f} ms  "
                f"execute {rec.execute_s*1e3:6.1f} ms  "
                f"e2e {rec.e2e_s*1e3:6.1f} ms  "
                f"(batch {rec.batch_real}/{rec.bucket}, out {tuple(y.shape)})"
            )
    stats = server.stats()
    print(f"\n{stats.summary_line()}")
    print(f"worker programs: {server.pipeline.worker_program_traces} traces "
          f"for buckets {server.pipeline.bucket_sizes} — bounded by bucket "
          f"count, despite the straggler on worker 3.")
    got = torch.stack([torch.as_tensor(y, device=dev) for y in outs])
    ref = run_convls("lenet5", params, torch.as_tensor(xs, device=dev))
    rel_err = float((got - ref).abs().max() / ref.abs().max())
    print(f"max |err| vs the uncoded stack = {rel_err:.2e} of max|uncoded|")
    if not rel_err <= TOL:
        raise AssertionError(f"served LeNet-5 off the uncoded stack: {rel_err}")
    return {"requests": requests, "completed": stats.completed,
            "images_per_s": stats.images_per_s, "e2e_p50_s": stats.e2e_p50_s,
            "e2e_p99_s": stats.e2e_p99_s,
            "program_signatures": server.pipeline.worker_program_traces,
            "rel_err": rel_err, "output": got}


if __name__ == "__main__":
    main()
