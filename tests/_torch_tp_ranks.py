"""Rank bodies of ``tests/test_torch_tensor_parallel.py``: each runs in a
process that ``repro_torch.launch.mesh.run_ranks`` spawned, with the
default process group up over gloo on the CPU, and returns numpy arrays
and plain values.  Like ``tests/_torch_ranks.py`` it imports torch and the
port only (never jax), so a rank starts quickly."""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_bundle
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.launch.serve import serve_lm
from repro_torch.models import moe
from repro_torch.models import transformer as lm
from repro_torch.models.common import params_from_numpy, schema_shardings
from repro_torch.models.registry import make_lm_bundle
from repro_torch.optim import init_state
from repro_torch.sharding import (BATCH, MODEL, gather_tree, shard_hint,
                                  shard_tree, use_mesh)
from repro_torch.tree import tree_items, tree_leaves, tree_map

# the forward cases: the arch ids of the dense GQA family and DeepSeek-V2
# (MLA + MoE) at their smoke sizes, and a config whose 16 KV heads put
# the cache's heads over model (every other one cuts the sequence)
ARCHS = ("smollm-135m", "qwen3-4b", "gemma2-9b", "paligemma-3b",
         "deepseek-v2-236b", "heads16")
MOE_ARCH = "deepseek-v2-236b"
# batch, tokens, the prompt of the teacher-forced prefill, the cache
B, S, P, MAX_LEN, PREFIX = 4, 16, 8, 16, 8
SERVE = dict(batch=4, prompt_len=8, gen=8)
MESHES = {"model2": ((2,), ("model",)), "data2-model2": ((2, 2), ("data", "model"))}
# the train step: DeepSeek-V2 smoke with 2 dispatch groups, 3 steps
TRAIN_STEPS = 3
TRAIN_KW = dict(warmup=2, total_steps=5)
MOE_TOKENS = 64


def port_config(arch: str):
    """The port's ``LMConfig`` of a case: the smoke config (DeepSeek-V2's
    with 2 dispatch groups, so that a group never spans the data ranks),
    or ``heads16``'s."""
    if arch == "heads16":
        return lm.LMConfig(name="heads16-smoke", layers=2, d_model=64,
                           n_heads=16, n_kv_heads=16, head_dim=4, d_ff=128,
                           vocab=256, max_seq=128)
    cfg = get_bundle(arch, smoke=True).cfg
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=2))
    return cfg


def port_bundle(arch: str):
    family = "vlm" if arch == "paligemma-3b" else "lm"
    return make_lm_bundle(port_config(arch), family)


def _rows(mesh, x):
    """This rank's rows of a global batch leaf (over the data axis)."""
    k = mesh.shape.get("data", 1)
    return x.chunk(k)[mesh.coordinate.get("data", 0)] if k > 1 else x


def _model_trace(mesh, fn):
    """``fn()`` with the mesh's collectives recorded: its result and the
    (kind, operand shape, storage address) of each collective over
    ``model``."""
    mesh.trace = []
    try:
        out = fn()
    finally:
        trace, mesh.trace = mesh.trace, None
    return out, [(c.kind, c.shape, c.address) for c in trace
                 if c.axes == MODEL]


def _violations(trace, rows: int, leaves) -> list:
    """The recorded collectives whose operand lies in the storage of one
    of ``leaves`` (a parameter or cache leaf, or a view of one), or is not
    a multiple of ``rows``, the pass's batch rows (an activation or logit
    holds one row a token or more)."""
    held = {t.untyped_storage().data_ptr() for _, t in tree_items(leaves)}
    return [(kind, shape) for kind, shape, ptr in trace
            if ptr in held or math.prod(shape) % rows]


def forward_cases(mesh, inputs: dict) -> dict:
    """Each case's forward logits and loss on this rank's rows, the
    teacher-forced prefill and decode logits, and the collectives over
    ``model`` that broke the no-gather rule in the forward and the decode
    steps."""
    out = {}
    for arch, a in inputs.items():
        bundle = port_bundle(arch)
        sh = schema_shardings(bundle.schema, mesh)
        params = shard_tree(params_from_numpy(a["params"], "cpu"), sh)
        toks = _rows(mesh, torch.from_numpy(a["tokens"]))
        batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
        if a.get("prefix") is not None:
            batch["prefix"] = _rows(mesh, torch.from_numpy(a["prefix"]))
        b = toks.shape[0]
        with use_mesh(mesh):
            logits, fwd_trace = _model_trace(
                mesh, lambda: bundle.prefill_fn(params, batch))
            loss, loss_trace = _model_trace(
                mesh, lambda: bundle.loss_fn(params, batch))
            cache = bundle.make_cache(b, MAX_LEN, device="cpu")
            pre, _ = bundle.prefill_cache_fn(params, cache,
                                             {"tokens": toks[:, :P]})
            dec, dec_trace = [], []
            for t in range(P, S):
                (lg, _), tr = _model_trace(mesh, lambda t=t: bundle.decode_fn(
                    params, cache, {"tokens": toks[:, t:t + 1], "pos": t}))
                dec.append(lg)
                dec_trace += tr
        out[arch] = {
            "logits": logits, "loss": float(loss), "prefill": pre,
            "decode": torch.cat(dec, dim=1),
            "cache_shapes": {"/".join(p): tuple(t.shape)
                             for p, t in tree_items(cache)},
            "n_model_collectives": len(fwd_trace) + len(dec_trace),
            "forward_violations": _violations(fwd_trace + loss_trace, b,
                                              params),
            "decode_violations": _violations(dec_trace, b,
                                             {"p": params, "c": cache})}
    return out


def serve_cases(mesh, inputs: dict) -> dict:
    """``serve_lm`` over the mesh from the cases' weights, each rank its
    cut; DeepSeek-V2 serves its smoke config (one dispatch group), which
    spans the data ranks where there are two."""
    out = {}
    for arch, a in inputs.items():
        if arch == "heads16":  # no arch id: prefill and decode hold it
            continue
        bundle = get_bundle(arch, smoke=True)
        params = shard_tree(params_from_numpy(a["params"], "cpu"),
                            schema_shardings(bundle.schema, mesh))
        try:
            out[arch] = serve_lm(arch, smoke=True, device="cpu", mesh=mesh,
                                 params=params, graphs=False, **SERVE)
        except NotImplementedError as e:
            out[arch] = f"raised: {e}"
    return out


def refusals(mesh) -> dict:
    """What still raises over ``model``: each entry the message or what
    ran instead."""
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = "ran"
        except NotImplementedError as e:
            out[name] = str(e)

    bundle = get_bundle("smollm-135m", smoke=True)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu",
                         shardings=schema_shardings(bundle.schema, mesh))
    toks = torch.zeros((2, 8), dtype=torch.long)

    def seq_parallel():
        os.environ["REPRO_SEQ_PARALLEL"] = "1"
        try:
            with use_mesh(mesh):
                bundle.prefill_fn(params, {"tokens": toks})
        finally:
            del os.environ["REPRO_SEQ_PARALLEL"]

    attempt("seq_parallel", seq_parallel)
    attempt("serve_captured", lambda: serve_lm(
        "smollm-135m", smoke=True, device="cpu", mesh=mesh,
        graphs=_NoGraph, **SERVE))
    attempt("train_captured", lambda: steps.compiled_train_step(
        steps.build_train_step(bundle, steps.TrainConfig(**TRAIN_KW), mesh),
        graphs=object()))

    def uneven_cache():
        with use_mesh(mesh):
            bundle.make_cache(2, 15, device="cpu")

    attempt("uneven_cache", uneven_cache)

    def bare_hint():
        with use_mesh(mesh):
            shard_hint(torch.zeros(2, 4, 8, 16), BATCH, MODEL, None, None)

    attempt("bare_model_hint", bare_hint)

    def held_hint():
        with use_mesh(mesh):
            x = torch.zeros(2, 4, 8, 16)
            if shard_hint(x, BATCH, MODEL, None, None, model_dim=1) is not x:
                raise AssertionError("a held placement is not the identity")

    attempt("held_model_hint", held_hint)
    moe_cfg = get_bundle(MOE_ARCH, smoke=True).cfg.moe
    mw = shard_tree(moe_weights(moe_cfg, 0), schema_shardings(
        moe.moe_schema(moe_cfg), mesh))

    def plain_moe():
        with use_mesh(mesh):
            moe.moe_ffn_plain(mw, torch.zeros(16, moe_cfg.d_model), moe_cfg)

    attempt("moe_plain", plain_moe)
    if mesh.shape.get("data", 1) > 1:
        attempt("batch1_over_data", lambda: serve_lm(
            "smollm-135m", smoke=True, device="cpu", mesh=mesh, batch=1,
            prompt_len=8, gen=8))
    return out


class _NoGraph:
    """Stands for a graph class: ``serve_lm`` refuses one over model
    before it builds anything."""


def moe_weights(cfg, seed: int) -> dict:
    """numpy-drawn weights of one MoE layer, as torch tensors."""
    rng = np.random.default_rng(seed)

    def draw(schema):
        return {k: draw(v) if isinstance(v, dict) else torch.from_numpy(
            (rng.standard_normal(v.shape) / np.sqrt(v.shape[-2])).astype(
                np.float32)) for k, v in schema.items()}

    return draw(moe.moe_schema(cfg))


def moe_case(mesh, x: np.ndarray) -> dict:
    """One MoE layer (DeepSeek-V2 smoke: 8 experts, 4 a rank, 2 shared)
    on every token: its output and each rank's routing."""
    cfg = get_bundle(MOE_ARCH, smoke=True).cfg.moe
    w = shard_tree(moe_weights(cfg, 0), schema_shardings(moe.moe_schema(cfg),
                                                         mesh))
    xt = torch.from_numpy(x)
    with use_mesh(mesh):
        y = moe.moe_ffn(w, xt, cfg)
        r = moe.route(w, xt.reshape(1, *xt.shape), cfg)
    return {"y": y, "gate_e": r.gate_e, "keep": r.keep,
            "local_experts": tuple(w["w_gate"].shape)}


def train_cases(mesh, rank: int, p_np: dict, batches: list, ckpt_dir: str
                ) -> dict:
    """DeepSeek-V2 smoke (2 dispatch groups) over the mesh, FSDP on and
    off: the losses, gradient norms and gathered params after
    ``TRAIN_STEPS`` steps; the FSDP run's gathered state written by rank
    0 and restored into this mesh's shards and into a (model 4) mesh's."""
    import torch.distributed as dist

    bundle = port_bundle(MOE_ARCH)
    out = {}
    state = shardings = None
    for fsdp in (True, False):
        step = steps.build_train_step(
            bundle, steps.TrainConfig(fsdp=fsdp, **TRAIN_KW), mesh)
        params = shard_tree(params_from_numpy(p_np, "cpu"), step.param_shardings)
        opt = init_state(params)
        losses, norms = [], []
        for b in batches:
            params, opt, met = step(params, opt,
                                    {k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        label = "fsdp" if fsdp else "replicated"
        sh = {"params": step.param_shardings, "opt": step.opt_shardings}
        out[label] = {"losses": losses, "norms": norms,
                      "local_shapes": {"/".join(p): tuple(t.shape)
                                       for p, t in tree_items(params)},
                      "full": gather_tree({"params": params, "opt": opt}, sh)}
        if fsdp:
            state, shardings = {"params": params, "opt": opt}, sh
    # the FSDP run's full state, written by rank 0, restored into this
    # mesh's shards and into the shards of another mesh shape
    if rank == 0:
        save(ckpt_dir, TRAIN_STEPS, out["fsdp"]["full"])
    dist.barrier()
    back = restore(ckpt_dir, TRAIN_STEPS, state, shardings=shardings)
    out["restored_equal"] = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back), tree_leaves(state)))
    other = make_process_mesh((1, 4), ("data", "model"), device="cpu")
    step4 = steps.build_train_step(bundle, steps.TrainConfig(**TRAIN_KW), other)
    sh4 = {"params": step4.param_shardings, "opt": step4.opt_shardings}
    full = {"params": params_from_numpy(out["fsdp"]["full"]["params"], "cpu"),
            "opt": params_from_numpy(out["fsdp"]["full"]["opt"], "cpu")}
    want = shard_tree(full, sh4)
    like = tree_map(torch.zeros_like, want)
    got = restore(ckpt_dir, TRAIN_STEPS, like, shardings=sh4)
    out["restored_model4_equal"] = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(got), tree_leaves(want)))
    out["model4_cut"] = any(tuple(a.shape) != tuple(b.shape) for a, b in zip(
        tree_leaves(want["params"]), tree_leaves(full["params"])))
    return out


def model2(rank: int, inputs: dict, moe_x: np.ndarray) -> dict:
    """Over (model 2): the forward cases, ``serve_lm``, one MoE layer, the
    refusals, the model axis's collective counts."""
    torch.set_num_threads(1)  # small ops; the ranks share the host's cores
    mesh = make_process_mesh(*MESHES["model2"], device="cpu")
    out = {"forward": forward_cases(mesh, inputs),
           "serve": serve_cases(mesh, inputs),
           "moe": moe_case(mesh, moe_x),
           "refusals": refusals(mesh)}
    out["by_axis"] = {k: dict(v) for k, v in mesh.stats["by_axis"].items()}
    # the check catches a parameter leaf (a layer's view of a stacked leaf)
    # all-gathered as it is
    bundle = port_bundle("qwen3-4b")
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu",
                         shardings=schema_shardings(bundle.schema, mesh))
    _, planted = _model_trace(mesh, lambda: mesh.all_gather(
        params["dense_layers"]["wq"][0], MODEL, dim=1))
    out["planted_violations"] = _violations(planted, 1, params)
    return out


def data2_model2(rank: int, inputs: dict, p_np: dict, batches: list,
                 ckpt_dir: str) -> dict:
    """Over (data 2, model 2): the forward cases, ``serve_lm``, the train
    step FSDP on and off with its checkpoint, the refusals."""
    torch.set_num_threads(1)
    mesh = make_process_mesh(*MESHES["data2-model2"], device="cpu")
    out = {"forward": forward_cases(mesh, inputs),
           "serve": serve_cases(mesh, inputs),
           "train": train_cases(mesh, rank, p_np, batches, ckpt_dir),
           "refusals": refusals(mesh)}
    out["by_axis"] = {k: dict(v) for k, v in mesh.stats["by_axis"].items()}
    return out
