"""Rank body of ``tests/test_torch_dryrun.py``: the train step over a batch
whose rows do not split over the data ranks (a smoke-scaled dry-run cell's
case), spawned on 2 gloo CPU ranks by ``launch.mesh.run_ranks``.  Imports
no jax."""
from __future__ import annotations

import torch

from repro_torch.configs import get_bundle
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models.common import params_from_numpy
from repro_torch.optim import init_state
from repro_torch.sharding import gather_tree, shard_tree

TRAIN_KW = dict(warmup=2, total_steps=5)


def replicated_rows(rank: int, p_np: dict, batches: list) -> dict:
    """Train steps of SmolLM's smoke config over (data 2, model 1), FSDP
    on, each global batch of 3 rows held whole by both ranks: the losses,
    gradient norms and gathered params; and a step of DeepSeek-V2's smoke
    MoE on such a batch (its dispatch group counts each row once): its
    loss and gradient norm."""
    torch.set_num_threads(1)
    mesh = make_process_mesh((2, 1), ("data", "model"), device="cpu")
    bundle = get_bundle("smollm-135m", smoke=True)
    step = steps.build_train_step(bundle, steps.TrainConfig(**TRAIN_KW), mesh)
    params = shard_tree(params_from_numpy(p_np, "cpu"), step.param_shardings)
    opt = init_state(params)
    out = {"losses": [], "norms": []}
    for b in batches:
        params, opt, met = step(params, opt, {k: torch.from_numpy(v)
                                              for k, v in b.items()})
        out["losses"].append(float(met["loss"]))
        out["norms"].append(float(met["grad_norm"]))
    out["params"] = gather_tree(params, step.param_shardings)
    moe = get_bundle("deepseek-v2-236b", smoke=True)
    step = steps.build_train_step(moe, steps.TrainConfig(**TRAIN_KW), mesh)
    params = shard_tree(moe.init(torch.Generator().manual_seed(0),
                                 device="cpu"), step.param_shardings)
    try:
        _, _, met = step(params, init_state(params),
                         {k: torch.from_numpy(v) for k, v in batches[0].items()})
        out["moe"] = "ran"
        out["moe_loss"], out["moe_norm"] = (float(met["loss"]),
                                            float(met["grad_norm"]))
    except NotImplementedError as e:
        out["moe"] = str(e)
    return out
