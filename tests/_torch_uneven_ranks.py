"""Rank bodies of ``tests/test_torch_moe_ranks.py`` and
``tests/test_torch_uneven.py``: each runs in a process that
``repro_torch.launch.mesh.run_ranks`` spawned, with the default process
group up over gloo on the CPU, builds its meshes one after another and
returns numpy arrays and plain values.  Like ``tests/_torch_ranks.py`` it
imports torch and the port only (never jax), so a rank starts quickly.

The placements held here are the uneven ones: MoE dispatch groups that
span the data ranks, experts that do not divide over ``model`` (whole, or
each expert's ``ff`` cut), heads, widths, vocabularies and caches that do
not divide over ``model``, each held whole where the reference replicates
it."""
from __future__ import annotations

import contextlib
import math
import os

import torch

from repro_torch.configs import get_bundle
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.launch.serve import serve_lm
from repro_torch.launch.train import train
from repro_torch.models import moe
from repro_torch.models import transformer as lm
from repro_torch.models.common import params_from_numpy, schema_shardings
from repro_torch.models.registry import make_lm_bundle
from repro_torch.sharding import row_axes, shard_tree, use_mesh
from repro_torch.tree import tree_items

# the MoE layer's meshes, by world size: (sizes, names)
MOE_MESHES = {
    2: {"data2": ((2, 1), ("data", "model"))},
    3: {"model3": ((1, 3), ("data", "model"))},
    4: {"data2-model2": ((2, 2), ("data", "model")),
        "pod2-data2": ((2, 2, 1), ("pod", "data", "model")),
        "model4": ((1, 4), ("data", "model"))}}
# the model cases' meshes
UNEVEN_MESHES = {3: ((1, 3), ("data", "model")), 4: ((2, 2), ("data", "model"))}
# the arch ids held over (data 1, model 3): none of the smoke widths (4
# heads, 64, ff 128, vocab 256) divides 3
ARCHS = ("qwen3-4b", "deepseek-v2-236b", "rwkv6-1.6b", "hymba-1.5b",
         "whisper-medium")
# batch, tokens; serve_lm's batch, prompt and generated tokens
B, S = 2, 16
SERVE = dict(batch=4, prompt_len=8, gen=8)
# a cache whose 15 positions do not divide over model 2: a prompt of P
# tokens, then decode steps to its end
UNEVEN_LEN, P = 15, 8
# the train runs
TRAIN = dict(steps=3, batch=4, seq=16, log_every=100)


def moe_config(case: dict) -> moe.MoEConfig:
    return moe.MoEConfig(**case["cfg"])


def mla3_config() -> lm.LMConfig:
    """An MLA model of 3 heads: over model 2 each of ``wq`` (72 columns),
    ``wkv_b`` (96) and ``wo`` (48 rows) is cut inside a head, so every
    rank computes every head; its 16-position cache is cut on positions,
    so a decode step takes the absorbed form over cut columns."""
    return lm.LMConfig(name="mla3-smoke", layers=2, d_model=64, n_heads=3,
                       n_kv_heads=3, head_dim=16, d_ff=128, vocab=256,
                       attn="mla", mla=lm.MLAConfig(
                           q_lora=0, kv_lora=32, qk_nope_dim=16,
                           qk_rope_dim=8, v_dim=16), max_seq=128)


def kv16_config() -> lm.LMConfig:
    """A GQA model of 16 KV heads of 16: its cache's heads go over model
    (they divide the production degree 16), 8 a rank over model 2."""
    return lm.LMConfig(name="kv16-smoke", layers=2, d_model=64, n_heads=16,
                       n_kv_heads=16, head_dim=16, d_ff=128, vocab=256,
                       max_seq=128)


CONFIGS = {"mla3": mla3_config, "kv16": kv16_config}


def port_bundle(arch: str):
    if arch in CONFIGS:
        return make_lm_bundle(CONFIGS[arch]())
    return get_bundle(arch, smoke=True)


def _rows(mesh, x):
    """This rank's rows of a global leaf: cut over the pod and data axes
    in group order."""
    k = mesh.group_size(("pod", "data"))
    return x.chunk(k)[mesh.group_rank(("pod", "data"))] if k > 1 else x


@contextlib.contextmanager
def _env(name: str, value: str):
    os.environ[name] = value
    try:
        yield
    finally:
        del os.environ[name]


def _moe_cases(mesh, cases: dict) -> dict:
    """Each MoE case (its config, numpy weights and global tokens) on this
    rank's rows through ``moe_ffn``, ``moe_ffn_plain`` and ``moe_ffn``
    under ``REPRO_BASELINE=1``; with the local shape of ``w_gate`` and the
    axes holding distinct rows."""
    out = {}
    for name, case in cases.items():
        cfg = moe_config(case)
        w = shard_tree(params_from_numpy(case["w"], "cpu"),
                       schema_shardings(moe.moe_schema(cfg), mesh))
        x = _rows(mesh, torch.from_numpy(case["x"]))
        with use_mesh(mesh):
            got = {"y": moe.moe_ffn(w, x, cfg),
                   "plain": moe.moe_ffn_plain(w, x, cfg)}
            with _env("REPRO_BASELINE", "1"):
                got["baseline"] = moe.moe_ffn(w, x, cfg)
            got["row_axes"] = row_axes()
        got["w_gate"] = tuple(w["w_gate"].shape)
        got["router"] = tuple(w["router"].shape)
        out[name] = got
    return out


def moe_ranks(rank: int, cases: dict, params: dict | None = None) -> dict:
    """The MoE layer over each mesh of this world size; over (data 2) also
    DeepSeek-V2 smoke trained with its one dispatch group (FSDP on), over
    (data 2, model 2) also served at batch 4 from ``params``."""
    torch.set_num_threads(1)  # small ops; the ranks share the host's cores
    world = torch.distributed.get_world_size()
    out = {}
    for name, (sizes, names) in MOE_MESHES[world].items():
        mesh = make_process_mesh(sizes, names, device="cpu")
        out[name] = {"moe": _moe_cases(mesh, cases)}
        if name == "data2":
            out[name]["train"] = train("deepseek-v2-236b", smoke=True,
                                       device="cpu", graphs=False, mesh=mesh,
                                       **TRAIN)
        if name == "data2-model2":
            bundle = get_bundle("deepseek-v2-236b", smoke=True)
            p = shard_tree(params_from_numpy(params, "cpu"),
                           schema_shardings(bundle.schema, mesh))
            out[name]["serve"] = serve_lm(
                "deepseek-v2-236b", smoke=True, device="cpu", mesh=mesh,
                params=p, graphs=False, **SERVE)
            out[name]["by_axis"] = {k: dict(v) for k, v in
                                    mesh.stats["by_axis"].items()}
    return out


def _prefill(bundle, params, mesh, a: dict):
    batch = {"tokens": _rows(mesh, torch.from_numpy(a["tokens"]))}
    if a.get("frames") is not None:
        batch["frames"] = _rows(mesh, torch.from_numpy(a["frames"]))
    with use_mesh(mesh):
        return bundle.prefill_fn(params, batch)


def _decoded(bundle, params, mesh, toks, max_len: int, prefill: int) -> dict:
    """``toks`` (this rank's rows) through a cache of ``max_len``
    positions made under the mesh: a cache-filling prefill of ``prefill``
    tokens, then one decode step a token, teacher-forced; every call's
    logits and the cache's local shapes."""
    with use_mesh(mesh):
        cache = bundle.make_cache(toks.shape[0], max_len, device="cpu")
        logits, _ = bundle.prefill_cache_fn(params, cache,
                                            {"tokens": toks[:, :prefill]})
        steps = [logits]
        for t in range(prefill, toks.shape[1]):
            lg, _ = bundle.decode_fn(params, cache, {
                "tokens": toks[:, t:t + 1], "pos": t})
            steps.append(lg)
    return {"logits": torch.cat(steps, dim=1),
            "cache": {"/".join(p): tuple(t.shape)
                      for p, t in tree_items(cache)}}


def _whisper_decoded(bundle, params, mesh, toks, max_len: int) -> dict:
    """Whisper's decode steps over ``toks`` from a self cache of
    ``max_len`` positions (its zero cross K/V, as ``serve_lm`` decodes)."""
    with use_mesh(mesh):
        cache = bundle.make_cache(toks.shape[0], max_len, device="cpu")
        steps = []
        for t in range(toks.shape[1]):
            lg, _ = bundle.decode_fn(params, cache, {
                "tokens": toks[:, t:t + 1], "pos": t})
            steps.append(lg)
    return {"logits": torch.cat(steps, dim=1),
            "cache": {"/".join(p): tuple(t.shape)
                      for p, t in tree_items(cache)}}


def uneven_ranks(rank: int, inputs: dict, whisper_len: int) -> dict:
    """The model cases over this world size's mesh: each case's prefill
    logits (whole) and ``serve_lm`` tokens; over (data 1, model 3) also a
    train run of Qwen3-4B and of RWKV6 in float64 and a Whisper self cache
    of ``whisper_len`` positions decoded; over (data 2, model 2) the
    15-position caches and the 3-head MLA model's decode."""
    torch.set_num_threads(1)
    world = torch.distributed.get_world_size()
    mesh = make_process_mesh(*UNEVEN_MESHES[world], device="cpu")
    out = {"prefill": {}, "serve": {}, "decode": {}, "local": {}}
    for case, a in inputs.items():
        bundle = port_bundle(case)
        params = shard_tree(params_from_numpy(a["params"], "cpu"),
                            schema_shardings(bundle.schema, mesh))
        out["local"][case] = {"/".join(p): tuple(t.shape)
                              for p, t in tree_items(params)}
        out["prefill"][case] = _prefill(bundle, params, mesh, a)
        toks = _rows(mesh, torch.from_numpy(a["tokens"]))
        if a.get("serve"):
            out["serve"][case] = serve_lm(case, smoke=True, device="cpu",
                                          mesh=mesh, params=params,
                                          param_dtype=param_dtype(a),
                                          graphs=False, **SERVE)
        if a.get("decode_len"):
            out["decode"][case] = _decoded(bundle, params, mesh, toks,
                                           a["decode_len"], P)
        if case == "whisper-medium" and world == 3:
            out["decode"][case] = _whisper_decoded(bundle, params, mesh,
                                                   toks, whisper_len)
    if world == 3:
        out["train"] = {
            "qwen3-4b": train("qwen3-4b", smoke=True, device="cpu",
                              graphs=False, mesh=mesh, **TRAIN),
            "rwkv6-1.6b": train("rwkv6-1.6b", smoke=True, device="cpu",
                                graphs=False, mesh=mesh,
                                param_dtype=torch.float64, **TRAIN)}
    out["by_axis"] = {k: dict(v) for k, v in mesh.stats["by_axis"].items()}
    return out


def param_dtype(a: dict) -> torch.dtype:
    """A case's param dtype (and its cache's): float32 unless it says."""
    return getattr(torch, a.get("param_dtype", "float32"))


# the microbatch cases: DeepSeek-V2's smoke MoE with one dispatch group
# and a capacity factor that drops entries, trained MICRO_STEPS steps at
# MICRO_BATCH x MICRO_SEQ over each mesh of MICRO_MESHES with its number
# of microbatches (over data 4, slices of 2 rows: held whole on each rank)
MICRO_MESHES = {"data2": ((2, 1), ("data", "model"), 2),
                "pod2-data2": ((2, 2, 1), ("pod", "data", "model"), 2),
                "data4-whole": ((4, 1), ("data", "model"), 4)}
MICRO_BATCH, MICRO_SEQ, MICRO_STEPS = 8, 8, 2
MICRO_KW = dict(warmup=1, total_steps=4)


def micro_bundle():
    """DeepSeek-V2's smoke config, one dispatch group, capacity factor 0.5:
    which entries drop depends on every token of a microbatch."""
    import dataclasses

    cfg = get_bundle("deepseek-v2-236b", smoke=True).cfg
    return make_lm_bundle(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_groups=1, capacity_factor=0.5)))


def microbatch_ranks(rank: int, params: dict, batches: list) -> dict:
    """``micro_bundle`` trained ``len(batches)`` steps over each mesh of
    ``MICRO_MESHES`` with this world size, with its microbatches, FSDP
    on: the losses, gradient norms and the whole params after."""
    from repro_torch.launch import steps
    from repro_torch.optim import init_state
    from repro_torch.sharding import gather_tree

    torch.set_num_threads(1)
    world = torch.distributed.get_world_size()
    bundle = micro_bundle()
    out = {}
    for name, (sizes, names, micro) in MICRO_MESHES.items():
        if math.prod(sizes) != world:
            continue
        mesh = make_process_mesh(sizes, names, device="cpu")
        step = steps.build_train_step(bundle, steps.TrainConfig(
            microbatches=micro, **MICRO_KW), mesh)
        p = shard_tree(params_from_numpy(params, "cpu"), step.param_shardings)
        opt = init_state(p)
        losses, norms = [], []
        for b in batches:
            p, opt, met = step(p, opt, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        out[name] = {"losses": losses, "norms": norms,
                     "params": gather_tree(p, step.param_shardings)}
    return out


# REPRO_BASELINE=1's caches over (data 1, model 2): a head dim cut
# (SmolLM's one KV head of 16), heads cut (Qwen3-4B's 2 KV heads) and MLA's
# latent widths cut (DeepSeek-V2's 32 and 8), served at BASELINE_SERVE
BASELINE_ARCHS = ("smollm-135m", "qwen3-4b", "deepseek-v2-236b")
BASELINE_SERVE = dict(batch=2, prompt_len=8, gen=8)


def baseline_ranks(rank: int, inputs: dict) -> dict:
    """Each arch of ``BASELINE_ARCHS`` served over (data 1, model 2) under
    ``REPRO_BASELINE=1`` from its numpy weights: the tokens, every call's
    logits, the local shapes of its cache's leaves and the collective
    bytes by axis."""
    torch.set_num_threads(1)
    mesh = make_process_mesh((1, 2), ("data", "model"), device="cpu")
    out = {}
    with _env("REPRO_BASELINE", "1"):
        for arch in BASELINE_ARCHS:
            bundle = get_bundle(arch, smoke=True)
            p = shard_tree(params_from_numpy(inputs[arch], "cpu"),
                           schema_shardings(bundle.schema, mesh))
            mesh.stats["by_axis"].clear()
            calls = []
            toks = serve_lm(arch, smoke=True, device="cpu", mesh=mesh,
                            params=p, graphs=False, on_logits=calls.append,
                            **BASELINE_SERVE)
            with use_mesh(mesh):
                cache = bundle.make_cache(BASELINE_SERVE["batch"], 16,
                                          device="meta")
            out[arch] = {"tokens": toks,
                         "logits": torch.cat([c[:, -1] for c in calls]),
                         "cache": {"/".join(k): tuple(t.shape)
                                   for k, t in tree_items(cache)},
                         "by_axis": {k: dict(v) for k, v in
                                     mesh.stats["by_axis"].items()}}
    return out
