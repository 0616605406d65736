"""Rank bodies of ``tests/test_torch_distributed.py``: each runs in a
process that ``repro_torch.launch.mesh.run_ranks`` spawned, with the
default process group up over gloo on the CPU, and returns numpy arrays
and plain values.  This module imports torch and the port only (never
jax), so a rank starts quickly."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_bundle
from repro_torch.core.fcdcc import CodedConv2d, FcdccPlan
from repro_torch.core.partition import ConvGeometry
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_process_mesh, use_mesh
from repro_torch.launch.serve import serve_lm
from repro_torch.launch.train import train
from repro_torch.models.common import params_from_numpy, schema_shardings
from repro_torch.models.moe import moe_ffn
from repro_torch.models.registry import make_lm_bundle, make_rwkv_bundle
from repro_torch.optim import init_state
from repro_torch.sharding import gather_tree, shard_hint, shard_tree
from repro_torch.tree import tree_items

# run_sharded: the reference test's geometry and plan
GEO = ConvGeometry(3, 8, 12, 10, 3, 3, 1, 1, 2, 4)
PLAN = FcdccPlan(n=4, k_a=2, k_b=4)
# (label, survivors, batch or None)
SHARDED_CASES = (("ids-3-1", [3, 1], None), ("ids-0-2", [0, 2], None),
                 ("batched-ids-0-2", [0, 2], 2))
HINT_MESHES = {"data2": ((2,), ("data",)), "pod2-data2": ((2, 2), ("pod", "data")),
               "data2-model2": ((2, 2), ("data", "model"))}
# the train step: SmolLM smoke, batch 8 x 32 tokens, 3 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 32, 3
TRAIN_KW = dict(warmup=2, total_steps=5)
SERVE = dict(batch=4, prompt_len=8, gen=8)
# the MoE under data parallelism: DeepSeek-V2's smoke config, its
# dispatch groups set to MOE_GROUPS (each rank's rows whole groups; the
# smoke's own 1 spans the ranks, held by moe_ranks' one-group step);
# MOE_TOKENS tokens into one MoE layer, a MOE_BATCH x MOE_SEQ train step
MOE_ARCH, MOE_GROUPS, MOE_TOKENS = "deepseek-v2-236b", (2, 4), 256
MOE_BATCH, MOE_SEQ = 4, 16


def moe_config(groups: int):
    """DeepSeek-V2's smoke ``LMConfig`` with ``groups`` dispatch groups."""
    cfg = get_bundle(MOE_ARCH, smoke=True).cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_groups=groups))


def moe_batch() -> dict:
    data = SyntheticTokens(DataConfig(vocab=256, seq_len=MOE_SEQ,
                                      global_batch=MOE_BATCH))
    return {k: torch.from_numpy(v) for k, v in data.batch(0).items()}


def sharded_input(batch):
    rng = np.random.default_rng(0)
    shape = (3, 12, 10) if batch is None else (batch, 3, 12, 10)
    x = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((8, 3, 3, 3)).astype(np.float32)
    return x, k


def hint_sites():
    """Each of the nine call sites of ``shard_hint`` in the models, as
    ``(site, local shape, axes)``, the axes computed as the site does."""
    def seq_or_data(shape):
        return ("BATCH", "data" if shape[0] == 1 else None, None)

    return [("transformer._layer", (2, 16, 64), ("BATCH", "model", None)),
            ("transformer._embed", (1, 16, 64), seq_or_data((1, 16, 64))),
            ("moe._grouped", (4, 8, 64), ("BATCH", None, None)),
            ("moe.buf", (4, 8, 8, 64), ("BATCH", "model", None, None)),
            ("moe.out_buf", (4, 8, 8, 64), ("BATCH", "model", None, None)),
            ("rwkv6._run", (2, 16, 64), seq_or_data((2, 16, 64))),
            ("hymba.forward", (1, 16, 64), seq_or_data((1, 16, 64))),
            ("whisper.encode", (2, 30, 64), ("BATCH", None, None)),
            ("whisper.decode", (2, 8, 64), ("BATCH", None, None))]


def hints(out: dict, world: int) -> dict:
    """``shard_hint`` at every site under each of ``HINT_MESHES`` that has
    ``world`` ranks: ``"same"`` where it returned its argument, else what
    it raised, into ``out["hints"]``; returns the meshes."""
    meshes = {name: make_process_mesh(sizes, names, device="cpu")
              for name, (sizes, names) in HINT_MESHES.items()
              if int(np.prod(sizes)) == world}
    for name, m in meshes.items():
        got = {}
        with use_mesh(m):
            for site, shape, axes in hint_sites():
                x = torch.zeros(shape)
                try:
                    got[site] = "same" if shard_hint(x, *real_axes(axes)) is x \
                        else "other"
                except NotImplementedError as e:
                    got[site] = f"raised: {e}"
        out.setdefault("hints", {})[name] = got
    return meshes


def real_axes(axes):
    from repro_torch.sharding import BATCH

    return tuple(BATCH if a == "BATCH" else a for a in axes)


def four_ranks(rank: int, p_np: dict) -> dict:
    """``run_sharded`` on the workers axis; ``shard_hint`` at every site
    under three meshes; the FSDP shardings cut and gathered on (pod 2,
    data 2); the train step over (data 2, model 2) from the reference's
    weights, FSDP on, and with int8 compression over (pod 2, data 1,
    model 2); RWKV6 of 3 heads refused over a model axis of 2."""
    out = {"sharded": {}}
    mesh = make_process_mesh((4,), ("workers",), device="cpu")
    for label, ids, batch in SHARDED_CASES:
        x, k = sharded_input(batch)
        layer = CodedConv2d(PLAN, GEO)
        x, k = torch.from_numpy(x), torch.from_numpy(k)
        out["sharded"][label] = {
            "y": layer.run_sharded(mesh, "workers", x, k, worker_ids=ids),
            "simulated": layer.run_simulated(x, k, worker_ids=ids)}
    meshes = hints(out, 4)
    pod = make_process_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    bundle = get_bundle("smollm-135m", smoke=True)
    full = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    sh = schema_shardings(bundle.schema, pod, fsdp=True)
    local = shard_tree(full, sh)
    back = gather_tree(local, sh)
    out["round_trip"] = {
        "equal": all(torch.equal(a, b) for (_, a), (_, b)
                     in zip(tree_items(full), tree_items(back))),
        "local_shapes": {"/".join(p): tuple(t.shape) for p, t in tree_items(local)},
        "full_shapes": {"/".join(p): tuple(t.shape) for p, t in tree_items(full)}}
    out["model_axis"], *_ = _run_step(meshes["data2-model2"], p_np,
                                      steps.TrainConfig(fsdp=True, **TRAIN_KW))
    pod_model = make_process_mesh((2, 1, 2), ("pod", "data", "model"),
                                  device="cpu")
    out["int8_model_axis"], *_ = _run_step(
        pod_model, p_np, steps.TrainConfig(grad_compression="int8", **TRAIN_KW))
    # RWKV6 over model 2 with 3 heads of 16: its 48 columns are cut inside
    # a head, so every rank scans every head
    rwkv = make_rwkv_bundle(rwkv48_config())
    try:
        step = steps.build_train_step(rwkv, steps.TrainConfig(**TRAIN_KW),
                                      meshes["data2-model2"])
        params = rwkv.init(torch.Generator().manual_seed(0), device="cpu",
                           shardings=step.param_shardings)
        toks = torch.zeros((4, 8), dtype=torch.long)
        _, _, met = step(params, init_state(params),
                         {"tokens": toks, "labels": toks})
        out["rwkv6_model_axis"] = "ran"
        out["rwkv6_model_axis_loss"] = float(met["loss"])
        out["rwkv6_model_axis_norm"] = float(met["grad_norm"])
    except NotImplementedError as e:
        out["rwkv6_model_axis"] = str(e)
    return out


def rwkv48_config():
    """RWKV6's smoke config at d_model 48: 3 heads of 16."""
    return dataclasses.replace(get_bundle("rwkv6-1.6b", smoke=True).cfg,
                               d_model=48)


def _global_batches():
    data = SyntheticTokens(DataConfig(vocab=256, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
    return [{k: torch.from_numpy(v) for k, v in data.batch(s).items()}
            for s in range(TRAIN_STEPS)]


def _run_step(mesh, p_np, tcfg):
    """``TRAIN_STEPS`` data-parallel steps from the reference's weights:
    the losses, the gathered params and moments, the step object and its
    state as this rank holds it."""
    bundle = get_bundle("smollm-135m", smoke=True)
    step = steps.build_train_step(bundle, tcfg, mesh)
    params = shard_tree(params_from_numpy(p_np, "cpu"), step.param_shardings)
    opt = init_state(params)
    losses, norms = [], []
    for b in _global_batches():
        params, opt, met = step(params, opt, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    state = {"params": params, "opt": opt}
    shardings = {"params": step.param_shardings, "opt": step.opt_shardings}
    return {"losses": losses, "norms": norms,
            "full": gather_tree(state, shardings)}, step, state, shardings


def moe_ranks(mesh, rank: int, moe_np: dict) -> dict:
    """DeepSeek-V2's MoE on this rank's half of the tokens: one layer's
    output for each of ``MOE_GROUPS``; the first step's loss and gradient
    norm of the data-parallel train step with 2 groups; and that step with
    the smoke's single group, which spans both ranks (each gathers the
    group's rows): its loss and gradient norm."""
    out = {}
    x = torch.from_numpy(moe_np["x"]).chunk(2)[rank]
    with use_mesh(mesh):
        for g in MOE_GROUPS:
            out[f"groups-{g}"] = moe_ffn(params_from_numpy(moe_np["w"], "cpu"),
                                         x, moe_config(g).moe)
    tcfg = steps.TrainConfig(**TRAIN_KW)
    step = steps.build_train_step(make_lm_bundle(moe_config(2)), tcfg, mesh)
    params = shard_tree(params_from_numpy(moe_np["params"], "cpu"),
                        step.param_shardings)
    _, _, met = step(params, init_state(params), moe_batch())
    out["loss"], out["grad_norm"] = float(met["loss"]), float(met["grad_norm"])
    bundle = get_bundle(MOE_ARCH, smoke=True)
    step = steps.build_train_step(bundle, tcfg, mesh)
    params = shard_tree(bundle.init(torch.Generator().manual_seed(0),
                                    device="cpu"), step.param_shardings)
    try:
        _, _, met = step(params, init_state(params), moe_batch())
        out["one_group"] = "ran"
        out["one_group_loss"] = float(met["loss"])
        out["one_group_norm"] = float(met["grad_norm"])
    except NotImplementedError as e:
        out["one_group"] = str(e)
    return out


def two_ranks(rank: int, p_np: dict, ref_ckpt_dir: str, ckpt_dir: str,
              train_dir: str, moe_np: dict) -> dict:
    """The data-parallel train step with FSDP on and off (data 2) and with
    int8 compression (pod 2, data 1); restores of the FSDP run's
    checkpoint and of the reference's; ``train`` and ``serve_lm`` over
    the mesh; DeepSeek-V2's MoE over the mesh (``moe_ranks``)."""
    import torch.distributed as dist

    data = make_process_mesh((2, 1), ("data", "model"), device="cpu")
    pod = make_process_mesh((2, 1, 1), ("pod", "data", "model"), device="cpu")
    out = {}
    hints(out, 2)
    fsdp, step, state, shardings = _run_step(
        data, p_np, steps.TrainConfig(fsdp=True, **TRAIN_KW))
    out["fsdp"] = fsdp
    out["fsdp"]["local_shapes"] = {"/".join(p): tuple(t.shape)
                                   for p, t in tree_items(state["params"])}
    try:
        steps.compiled_train_step(step, graphs=object())
        out["captured"] = "built"
    except NotImplementedError as e:
        out["captured"] = str(e)
    out["replicated"], *_ = _run_step(
        data, p_np, steps.TrainConfig(fsdp=False, **TRAIN_KW))
    out["int8"], *_ = _run_step(
        pod, p_np, steps.TrainConfig(grad_compression="int8", **TRAIN_KW))
    # the FSDP run's state, gathered and written by rank 0, restored here
    # into this rank's shards
    if rank == 0:
        save(ckpt_dir, TRAIN_STEPS, fsdp["full"])
    dist.barrier()
    back = restore(ckpt_dir, TRAIN_STEPS, state, shardings=shardings)
    out["restored_equal"] = all(
        torch.equal(a, b) for (_, a), (_, b)
        in zip(tree_items(back), tree_items(state)))
    # the reference's checkpoint (params and AdamW state at step 0) into
    # the sharded tree, against the port's own cut of the same weights
    like = {"params": shard_tree(params_from_numpy(p_np, "cpu"),
                                 step.param_shardings),
            "opt": init_state(shard_tree(params_from_numpy(p_np, "cpu"),
                                         step.param_shardings))}
    ref = restore(ref_ckpt_dir, 0, like, shardings=shardings)
    out["ref_restored_equal"] = all(
        torch.equal(a, b) for (_, a), (_, b)
        in zip(tree_items(ref), tree_items(like)))
    out["train"] = train("smollm-135m", steps=4, batch=TRAIN_BATCH,
                         seq=TRAIN_SEQ, smoke=True, device="cpu", mesh=data,
                         ckpt_dir=train_dir, ckpt_every=2, log_every=100)
    out["serve"] = serve_lm("smollm-135m", smoke=True, device="cpu",
                            mesh=data, **SERVE)
    out["moe"] = moe_ranks(data, rank, moe_np)
    return out


def failing(rank: int) -> None:
    if rank == 1:
        raise ValueError("planted failure on rank 1")
    torch.distributed.barrier()  # rank 0 waits here for rank 1


def hanging(rank: int) -> None:
    if rank == 1:
        import time

        time.sleep(3600)
