"""Quickstart: one FCDCC-coded convolution, end to end.

Shows the paper's full pipeline on a single layer: APCP/KCCP partitioning,
CRME encoding, per-worker coded subtasks, straggler-tolerant decode —
and checks the result against the plain convolution.

  python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import CodedConv2d, ConvGeometry, FcdccPlan
from repro_torch.devices import fp32_products, resolve_device

TOL = 1e-3  # max |coded - plain conv|, as the reference example holds it


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # 6 workers; input split in 2 (spatial), filters in 4 (channels);
    # recovery threshold delta = 2*4/4 = 2 -> tolerates gamma = 4 stragglers.
    plan = FcdccPlan(n=6, k_a=2, k_b=4)
    geo = ConvGeometry(
        in_channels=3, out_channels=8, height=32, width=32,
        kernel_h=3, kernel_w=3, stride=1, padding=1, k_a=2, k_b=4,
    )
    layer = CodedConv2d(plan, geo)

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((3, 32, 32)), dtype=torch.float32,
                        device=dev)
    k = torch.as_tensor(rng.standard_normal((8, 3, 3, 3)), dtype=torch.float32,
                        device=dev)

    print(f"n={plan.n} workers, delta={plan.delta}, tolerates gamma={plan.gamma}")

    # master: encode (filters would be pre-distributed once in deployment)
    xe = layer.encode_inputs(x)   # (n, 2, C, h_hat, W+2p)
    ke = layer.encode_filters(k)  # (n, 2, N/k_b, C, 3, 3)

    # workers: each computes its coded subtask
    outs = torch.stack([layer.worker_compute(xe[i], ke[i])
                        for i in range(plan.n)])

    # master: decode from ANY delta workers — pretend 4 of 6 straggled
    survivors = [5, 2]
    y = layer.decode(survivors, outs[survivors])

    with fp32_products():
        ref = F.conv2d(x[None], k, padding=1)[0]
    err = float((y - ref).abs().max())
    print("output", tuple(y.shape), "max |err| =", err)
    if not err < TOL:
        raise AssertionError(f"coded conv off the plain conv by {err}")
    print("coded result matches the plain convolution — straggler-proof.")
    return {"n": plan.n, "delta": plan.delta, "gamma": plan.gamma,
            "max_abs_err": err, "output": y}


if __name__ == "__main__":
    main()
