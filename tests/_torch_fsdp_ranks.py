"""Rank body of ``tests/test_torch_dryrun_fsdp.py``: run in a process that
``repro_torch.launch.mesh.run_ranks`` spawned (gloo on the CPU); imports
torch and the port only, so a rank starts quickly."""
from __future__ import annotations

import torch

from _torch_ranks import TRAIN_KW, _global_batches
from repro_torch.configs import get_bundle
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.optim import init_state
from repro_torch.sharding import gather_tree, shard_tree
from repro_torch.tree import tree_items

ARCH, MICROBATCHES = "smollm-135m", 2


def train_config() -> steps.TrainConfig:
    return steps.TrainConfig(microbatches=MICROBATCHES, fsdp=True, **TRAIN_KW)


def init_params(bundle) -> dict:
    return bundle.init(torch.Generator().manual_seed(0), device="cpu")


def fsdp_rank(rank: int, sizes: tuple) -> dict:
    """The FSDP train step over (data, model) = ``sizes`` with
    ``MICROBATCHES`` slices, ``TRAIN_STEPS`` steps from the seed's weights:
    the losses, gradient norms and gathered params, and a step's data-axis
    all-gathers (output bytes, calls) beside one layer's shard bytes."""
    mesh = make_process_mesh(sizes, ("data", "model"), device="cpu")
    bundle = get_bundle(ARCH, smoke=True)
    step = steps.build_train_step(bundle, train_config(), mesh)
    params = shard_tree(init_params(bundle), step.param_shardings)
    opt = init_state(params)
    out = {"losses": [], "norms": [], "gather_bytes": [], "gathers": []}
    for batch in _global_batches():
        mesh.trace = []
        params, opt, met = step(params, opt, batch)
        out["losses"].append(float(met["loss"]))
        out["norms"].append(float(met["grad_norm"]))
        gathers = [c.nbytes * c.group for c in mesh.trace
                   if c.kind == "all_gather" and c.axes == "data"]
        out["gather_bytes"].append(max(gathers, default=0))
        out["gathers"].append(len(gathers))
    mesh.trace = None
    # this rank's FSDP shards of one layer, by stack, and of every layer
    layer: dict = {}
    for path, p in tree_items(params):
        if path in step.per_layer:
            layer[path[0]] = (layer.get(path[0], 0)
                              + p.numel() // p.shape[0] * p.element_size())
    out["layer_shard_bytes"] = max(layer.values())
    out["tree_shard_bytes"] = sum(p.numel() * p.element_size()
                                  for path, p in tree_items(params)
                                  if path in step.per_layer)
    out["data_ranks"] = step.ranks
    out["layers"] = bundle.cfg.layers
    out["params"] = gather_tree(params, step.param_shardings)
    return out
