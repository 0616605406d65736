"""FCDCC on a transformer FFN layer (the LM-integration of the paper).

A dense layer is the 1x1-conv case of the paper's scheme: KCCP codes the
weight's output dim, degenerate APCP splits the token rows.  Here a SwiGLU
FFN block of the qwen3-4b (reduced) config runs with coded matmuls and
survives gamma stragglers.

  python -m repro_torch.examples.coded_lm_layer [--device cpu]
"""
import argparse

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.coded_linear import CodedLinear
from repro_torch.core.fcdcc import FcdccPlan
from repro_torch.devices import fp32_products, resolve_device

T, D, FF = 64, 256, 512
TOL = 1e-3  # max |coded - uncoded FFN|, as the reference example holds it


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    plan = FcdccPlan(n=8, k_a=2, k_b=8)  # delta=4, tolerates gamma=4

    rng = np.random.default_rng(0)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    x = f32(rng.standard_normal((T, D)))
    w_gate = f32(rng.standard_normal((D, FF)) / np.sqrt(D))
    w_up = f32(rng.standard_normal((D, FF)) / np.sqrt(D))
    w_down = f32(rng.standard_normal((FF, D)) / np.sqrt(FF))

    up_layer = CodedLinear(plan, T, D, FF)
    down_layer = CodedLinear(plan, T, FF, D)

    survivors = [7, 5, 2, 0]  # any delta=4 of the 8 workers
    g = up_layer.run_simulated(x, w_gate, survivors)
    u = up_layer.run_simulated(x, w_up, survivors)
    h = F.silu(g) * u  # nonlinearity on the master side of the code
    y = down_layer.run_simulated(h, w_down, survivors)

    with fp32_products():
        ref = (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
    err = float((y - ref).abs().max())
    print(f"coded SwiGLU FFN: n={plan.n}, delta={plan.delta}, gamma={plan.gamma}")
    print(f"max |err| vs uncoded = {err:.2e}")
    if not err < TOL:
        raise AssertionError(f"coded FFN off the uncoded one by {err}")
    print("LM layer survives", plan.gamma, "stragglers with exact reconstruction.")
    return {"n": plan.n, "delta": plan.delta, "gamma": plan.gamma,
            "max_abs_err": err, "output": y}


if __name__ == "__main__":
    main()
