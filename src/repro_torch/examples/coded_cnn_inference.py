"""Coded CNN inference under stragglers (the paper's deployment story).

Compiles AlexNet's ConvL stack into a ``CodedPipeline`` — layer-wise optimal
(k_A, k_B) from the cost model, every layer's filters encoded ONCE and
resident on the workers — then streams a batch of images through the
simulated master/worker cluster with injected stragglers and a dead node,
reporting the per-layer timing breakdown of the batched steady-state run,
and holds the result against the uncoded stack.

  python -m repro_torch.examples.coded_cnn_inference [--batch 4] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.cost import CostWeights
from repro_torch.core.fcdcc import FcdccPlan
from repro_torch.core.pipeline import CodedPipeline, plan_layers
from repro_torch.devices import resolve_device
from repro_torch.models.cnn import CNN_SPECS, init_cnn, run_convls
from repro_torch.runtime import FcdccCluster, StragglerModel

N_WORKERS = 12
Q = 16  # subtasks -> delta = Q/4 = 4, gamma = 8
W = CostWeights(comm=0.09, store=0.023, comp=0.0)
# the coded output against the uncoded stack, relative to max|uncoded|
TOL = 1e-4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch = args.batch

    rng = np.random.default_rng(0)
    _, layers = CNN_SPECS["alexnet"]
    hw0 = 113  # reduced spatial size for the CPU demo

    # 2 stragglers (+1s) and one dead worker; gamma covers all of them
    delays = np.zeros(N_WORKERS)
    delays[[1, 7]] = 1.0
    delays[3] = np.inf
    straggler = StragglerModel(delays)

    params = init_cnn("alexnet", torch.Generator().manual_seed(0), dev)

    # compile once: per-layer cost-optimal (k_A, k_B), filters encoded once
    specs = plan_layers(layers, hw0, N_WORKERS, q=Q, weights=W)
    pipeline = CodedPipeline(specs, params, device=dev)
    if pipeline.filter_encode_calls != len(layers):  # encode-once contract
        raise AssertionError(f"{pipeline.filter_encode_calls} filter encodes "
                             f"for {len(layers)} layers")

    cluster = FcdccCluster(FcdccPlan(n=N_WORKERS, k_a=2, k_b=Q // 2),
                           straggler, mode="simulated", device=dev)
    try:
        cluster.load_pipeline(pipeline)
        x = torch.as_tensor(rng.standard_normal((batch, 3, hw0, hw0)),
                            dtype=torch.float32, device=dev)
        print(f"{N_WORKERS} workers, Q={Q} subtasks, batch={batch}, "
              f"2 stragglers + 1 dead node\n")
        y, timings = cluster.run_pipeline(x)
    finally:
        cluster.shutdown()
    for spec, t in zip(pipeline.specs, timings):
        print(
            f"{spec.name:6s} (k_A,k_B)=({spec.plan.k_a:2d},{spec.plan.k_b:2d}) "
            f"encode {t.encode_s*1e3:6.1f} ms  compute {t.compute_s*1e3:6.1f} ms "
            f"decode {t.decode_s*1e3:6.1f} ms  used workers {t.used_workers}"
        )
    ref = run_convls("alexnet", params, x)
    rel_err = float((y - ref).abs().max() / ref.abs().max())
    print(f"\noutput {tuple(y.shape)}; batched inference completed despite "
          f"stragglers and a dead node.")
    print(f"max |err| vs the uncoded stack = {rel_err:.2e} of max|uncoded|")
    if not rel_err <= TOL:
        raise AssertionError(f"coded AlexNet off the uncoded stack: {rel_err}")
    return {"batch": batch, "rel_err": rel_err,
            "layers": [{"name": s.name, "k_a": s.plan.k_a, "k_b": s.plan.k_b,
                        "encode_s": t.encode_s, "compute_s": t.compute_s,
                        "decode_s": t.decode_s,
                        "used_workers": list(t.used_workers)}
                       for s, t in zip(pipeline.specs, timings)],
            "output": y}


if __name__ == "__main__":
    main()
