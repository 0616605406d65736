"""Rank bodies of ``tests/test_torch_seq_data.py`` and
``tests/test_torch_seq_parallel.py``: each runs in a process that
``repro_torch.launch.mesh.run_ranks`` spawned, with the default process
group up over gloo on the CPU, one thread a rank, and returns numpy arrays
and plain values.  It imports torch and the port only (never jax)."""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import get_bundle
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.launch.serve import serve_lm
from repro_torch.models.common import (greedy, next_token_nll,
                                       params_from_numpy, schema_shardings,
                                       vocab_logits)
from repro_torch.models.registry import (make_hymba_bundle, make_lm_bundle,
                                         make_rwkv_bundle)
from repro_torch.optim import init_state
from repro_torch.sharding import (gather_tree, hold_sequence, keep_vocab_cut,
                                  model_ranks, shard_tree, use_mesh)
from repro_torch.tree import tree_items, tree_map

# the batch-1 cases: a dense GQA model, MLA + MoE (2 dispatch groups, a
# multiple of the data ranks), windows and softcaps, a stub prefix, and
# the two recurrent families (RWKV6 in float64)
SEQ_ARCHS = ("smollm-135m", "deepseek-v2-236b", "gemma2-9b", "paligemma-3b",
             "rwkv6-1.6b", "hymba-1.5b")
# the sequence-parallel cases: whole heads (qk-norm), a cut inside a head,
# sandwich norms and softcaps, MLA + MoE
SP_ARCHS = ("smollm-135m", "qwen3-4b", "gemma2-9b", "deepseek-v2-236b")
FLOAT64 = ("rwkv6-1.6b",)
SERVED = ("smollm-135m", "gemma2-9b")
S, PREFIX = 16, 8  # the batch-1 sequence; PaliGemma's prefix
SP_B = 4  # the sequence-parallel cases' rows
SERVE = dict(batch=1, prompt_len=8, gen=8)
TRAIN_STEPS = 2
TRAIN_KW = dict(warmup=1, total_steps=4)


def bundle_of(arch: str):
    """The case's bundle: the smoke config, DeepSeek-V2's with 2 dispatch
    groups."""
    b = get_bundle(arch, smoke=True)
    cfg = b.cfg
    if b.family == "ssm":
        return make_rwkv_bundle(cfg)
    if b.family == "hybrid":
        return make_hymba_bundle(cfg)
    if getattr(cfg, "moe", None) is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=2))
    return make_lm_bundle(cfg, b.family)


def dtype_of(arch: str):
    return torch.float64 if arch in FLOAT64 else torch.float32


def batch_of(a: dict, dtype) -> dict:
    out = {"tokens": torch.from_numpy(a["tokens"]),
           "labels": torch.from_numpy(a["labels"])}
    if a.get("prefix") is not None:
        out["prefix"] = torch.from_numpy(a["prefix"]).to(dtype)
    return out


def _mesh(sizes):
    torch.set_num_threads(1)
    names = ("model",) if len(sizes) == 1 else ("data", "model")
    return make_process_mesh(sizes, names, device="cpu")


def train(bundle, mesh, p_np, batch, dtype, **kw) -> dict:
    """``TRAIN_STEPS`` train steps over ``mesh`` (or one process) from
    ``p_np`` on the same global batch: losses, gradient norms and the
    whole params after."""
    step = steps.build_train_step(bundle, steps.TrainConfig(**TRAIN_KW, **kw),
                                  mesh)
    params = tree_map(lambda t: t.to(dtype), params_from_numpy(p_np, "cpu"))
    par = isinstance(step, steps.ParallelStep)
    if par:
        params = shard_tree(params, step.param_shardings)
    opt = init_state(params)
    losses, norms = [], []
    for _ in range(TRAIN_STEPS):
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    if par:
        params = gather_tree(params, step.param_shardings)
    return {"losses": losses, "norms": norms, "params": params}


def _block(mesh, t: torch.Tensor) -> torch.Tensor:
    """This data rank's block of a batch-1 leaf's sequence."""
    k = mesh.shape.get("data", 1)
    return t.chunk(k, dim=1)[mesh.coordinate["data"]] if k > 1 else t


def seq_data(rank: int, sizes: tuple, inputs: dict) -> dict:
    """The batch-1 cases over (data, model) = ``sizes``: each arch's
    ``prefill_fn`` logits of its sequence held over data (the blocks
    gathered), its train steps through ``ParallelStep``, and, for the
    served ones, ``serve_lm(batch=1)``'s tokens and the logits of every
    call; and each transformer's batch-1 cache shapes under the held
    sequence."""
    mesh = _mesh(sizes)
    out = {"cache_shapes": {}}
    for arch, a in inputs.items():
        bundle, dt = bundle_of(arch), dtype_of(arch)
        if bundle.family in ("lm", "vlm"):
            with use_mesh(mesh), hold_sequence("data"):
                cache = bundle.make_cache(1, S, device="cpu")
            out["cache_shapes"][arch] = {"/".join(p): tuple(t.shape)
                                         for p, t in tree_items(cache)}
        batch = batch_of(a, dt)
        sh = schema_shardings(bundle.schema, mesh)
        params = shard_tree(tree_map(lambda t: t.to(dt), params_from_numpy(
            a["params"], "cpu")), sh)
        fwd = {k: _block(mesh, v) for k, v in batch.items() if k != "labels"}
        with use_mesh(mesh), hold_sequence("data"), torch.no_grad():
            logits = bundle.prefill_fn(params, fwd)
        # the blocks in sequence order: a prefix's blocks, then the tokens'
        n = fwd["prefix"].shape[1] if "prefix" in fwd else 0
        logits = torch.cat([mesh.all_gather(logits[:, :n], "data", dim=1),
                            mesh.all_gather(logits[:, n:], "data", dim=1)], 1)
        res = {"logits": logits, **train(bundle, mesh, a["params"], batch, dt)}
        if arch in SERVED:
            calls = []
            res["served"] = serve_lm(arch, smoke=True, device="cpu", mesh=mesh,
                                     params=params, graphs=False,
                                     on_logits=calls.append, **SERVE)
            res["serve_logits"] = torch.cat([c[:, -1] for c in calls])
        out[arch] = res
    return out


def seq_parallel(rank: int, sizes: tuple, inputs: dict) -> dict:
    """The sequence-parallel cases over ``sizes``: each arch's train steps
    with ``REPRO_SEQ_PARALLEL=1`` and without, the collective bytes by
    axis of each, and the forward logits under the flag."""
    mesh = _mesh(sizes)
    out = {}
    for arch, a in inputs.items():
        bundle = bundle_of(arch)
        batch = batch_of(a, torch.float32)
        res = {}
        for flag in ("0", "1"):
            os.environ["REPRO_SEQ_PARALLEL"] = flag
            try:
                mesh.stats["by_axis"] = {}
                res[flag] = train(bundle, mesh, a["params"], batch,
                                  torch.float32)
                res[flag]["by_axis"] = {k: v["bytes"] for k, v in
                                        mesh.stats["by_axis"].items()}
            finally:
                del os.environ["REPRO_SEQ_PARALLEL"]
        out[arch] = res
    return out


def vocab_cases(rank: int, sizes: tuple, logits: np.ndarray,
                targets: np.ndarray, ties: np.ndarray) -> dict:
    """Over (model 2): the vocab-parallel loss and its gradient from this
    rank's block of ``logits`` (with and without a softcap), the gathered
    version's, and the greedy pick of ``ties`` across the blocks."""
    mesh = _mesh(sizes)
    vocab = logits.shape[-1]
    out = {}
    with use_mesh(mesh):
        tp = model_ranks()
        blk = tp.block(vocab)
        for cap in (None, 30.0):
            x = torch.from_numpy(logits)

            def finish(t, cap=cap):
                return t if cap is None else cap * torch.tanh(t / cap)

            got, want = [], []
            for cut in (True, False):
                leaf = x.clone().requires_grad_(True)
                head = torch.eye(vocab, dtype=x.dtype)[:, blk]
                with contextlib.ExitStack() as kept:
                    if cut:
                        kept.enter_context(keep_vocab_cut())
                    lg = vocab_logits(leaf, head, vocab, finish)
                loss = next_token_nll(lg, torch.from_numpy(targets), vocab)
                (g,) = torch.autograd.grad(loss, leaf)
                (got if cut else want).append((float(loss), g))
            out[f"cap{cap}"] = {"cut": got[0], "gathered": want[0]}
        t = torch.from_numpy(ties)
        out["greedy"] = greedy(t[:, blk], vocab)
    return out


# the held sequence's edge cases (tests/test_torch_seq_edges.py): each
# case's arch, sequence length, meshes and runs, over 4 ranks
EDGE_MESHES = {"data4": (4, 1), "data2-model2": (2, 2)}
EDGE_CASES = {
    # 15 positions divide neither 2 nor 4: the row is held whole
    "whole": ("qwen3-4b", 15, ("data4", "data2-model2"), ("train", "serve")),
    # 4 positions over data 4: blocks of one position
    "one": ("qwen3-4b", 4, ("data4",), ("train", "prefill", "serve")),
    "hymba-one": ("hymba-1.5b", 4, ("data4",), ("train", "prefill")),
    "rwkv6-one": ("rwkv6-1.6b", 4, ("data4",), ("train", "prefill")),
    # REPRO_SEQ_PARALLEL=1 on a sequence held over data
    "sp": ("qwen3-4b", 16, ("data2-model2",), ("train", "train_sp")),
}
# served at batch 1: a prompt of 15 whole on every rank into a cache of 24
# cut over data; a prompt of 4 in blocks of one into a cache of 8
EDGE_SERVE = {"whole": dict(batch=1, prompt_len=15, gen=9),
              "one": dict(batch=1, prompt_len=4, gen=4)}


def seq_edges(rank: int, inputs: dict) -> dict:
    """Each case of ``EDGE_CASES`` on each of its meshes: its train steps
    through ``ParallelStep`` at a global batch of one row, ``prefill_fn``'s
    logits of the rank's block (the blocks gathered), ``serve_lm(batch=1)``'s
    tokens and every call's logits, and with ``REPRO_SEQ_PARALLEL=1`` its
    train steps again."""
    out = {}
    for name, sizes in EDGE_MESHES.items():
        mesh = _mesh(sizes)
        for case, (arch, _, meshes, runs) in EDGE_CASES.items():
            if name not in meshes:
                continue
            a = inputs[case]
            bundle, dt = bundle_of(arch), dtype_of(arch)
            batch = batch_of(a, dt)
            res = {}
            if "train" in runs:
                res["train"] = train(bundle, mesh, a["params"], batch, dt)
            if "train_sp" in runs:
                os.environ["REPRO_SEQ_PARALLEL"] = "1"
                try:
                    res["train_sp"] = train(bundle, mesh, a["params"], batch,
                                            dt)
                finally:
                    del os.environ["REPRO_SEQ_PARALLEL"]
            params = shard_tree(tree_map(lambda t: t.to(dt), params_from_numpy(
                a["params"], "cpu")), schema_shardings(bundle.schema, mesh))
            if "prefill" in runs:
                with use_mesh(mesh), hold_sequence("data"), torch.no_grad():
                    logits = bundle.prefill_fn(
                        params, {"tokens": _block(mesh, batch["tokens"])})
                res["logits"] = mesh.all_gather(logits, "data", dim=1)
            if "serve" in runs:
                calls = []
                res["served"] = serve_lm(arch, smoke=True, device="cpu",
                                         mesh=mesh, params=params,
                                         graphs=False, on_logits=calls.append,
                                         **EDGE_SERVE[case])
                res["serve_logits"] = torch.cat([c[:, -1] for c in calls])
            out[f"{case} {name}"] = res
    return out
