"""Rank bodies of ``tests/test_torch_tp_recurrent.py``: each runs in a
process that ``repro_torch.launch.mesh.run_ranks`` spawned, with the
default process group up over gloo on the CPU, and returns numpy arrays
and plain values.  Like ``tests/_torch_tp_ranks.py`` it imports torch and
the port only (never jax), so a rank starts quickly."""
from __future__ import annotations

import dataclasses

import torch

from _torch_tp_ranks import MESHES, _model_trace, _rows, _violations
from repro_torch.configs import get_bundle
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.launch.serve import serve_lm
from repro_torch.models import hymba
from repro_torch.models.common import params_from_numpy, schema_shardings
from repro_torch.models.registry import make_hymba_bundle
from repro_torch.optim import init_state
from repro_torch.sharding import MODEL, gather_tree, shard_tree, use_mesh
from repro_torch.tree import tree_items

# the cases: the three families' smoke configs and a Hymba whose cuts at
# model 2 are full width's awkward ones (5 heads and 5 KV heads of 16 cut
# inside a head, the KV ring on head_dim, 5 SSM heads, so the SSM state
# on head_dim too, and an odd vocab, whole)
CASES = ("rwkv6-1.6b", "hymba-1.5b", "hymba-uneven", "whisper-medium")
ARCH = {"rwkv6-1.6b": "rwkv6-1.6b", "hymba-1.5b": "hymba-1.5b",
        "hymba-uneven": None, "whisper-medium": "whisper-medium"}
# batch, tokens, the prompt stepped before the compared decode steps, the
# cache length
B, S, P, MAX_LEN = 4, 16, 8, 16
SERVE = dict(batch=4, prompt_len=8, gen=8)
TRAIN_STEPS = 2
TRAIN_KW = dict(warmup=1, total_steps=4)
# the shift carries RWKV6's decode gathers (cut along d by the reference)
CARRIES = ("xa", "xf")


def port_bundle(case: str):
    if case == "hymba-uneven":
        cfg = dataclasses.replace(get_bundle("hymba-1.5b", smoke=True).cfg,
                                  name="hymba-uneven-smoke", d_model=40,
                                  n_heads=5, n_kv_heads=5, head_dim=16,
                                  vocab=257)
        return make_hymba_bundle(cfg)
    return get_bundle(ARCH[case], smoke=True)


def _batch(bundle, a: dict, mesh) -> dict:
    toks = _rows(mesh, torch.from_numpy(a["tokens"]))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    if a.get("frames") is not None:
        batch["frames"] = _rows(mesh, torch.from_numpy(a["frames"]))
    return batch


def _decode_all(bundle, params, batch, cache, mesh):
    """Every position's logits, teacher-forced, one decode step a token
    (Whisper's over ``precompute_cross_kv`` of the encoder's output), and
    the collectives over ``model`` of the steps after the first ``P``."""
    from repro_torch.models import whisper

    toks = batch["tokens"]
    if bundle.family == "encdec":
        enc = whisper.encode(params, bundle.cfg, batch["frames"])
        cache = whisper.precompute_cross_kv(params, bundle.cfg, enc, cache)
    out, trace = [], []
    for t in range(S):
        (lg, cache), tr = _model_trace(
            mesh, lambda t=t, c=cache: bundle.decode_fn(
                params, c, {"tokens": toks[:, t:t + 1], "pos": t}))
        out.append(lg)
        if t >= P:
            trace += tr
    return torch.cat(out, dim=1), trace, cache


def _carry_gathers(trace, cache, b: int, d: int, ranks: int) -> list:
    """The collectives over ``model`` whose operand lies in a shift
    carry's storage and is not an all-gather of one layer's (B, d / ranks)
    rows of it."""
    held = {t.untyped_storage().data_ptr() for p, t in tree_items(cache)
            if p[0] in CARRIES}
    return [(kind, shape) for kind, shape, ptr in trace if ptr in held
            and (kind != "all_gather" or shape != (b, d // ranks))]


def forward_cases(mesh, inputs: dict) -> dict:
    """Each case's forward logits and loss on this rank's rows, every
    teacher-forced decode step's logits, the cache shapes, the collectives
    over ``model`` that broke the no-gather rule, and Hymba's first-layer
    [u | z] blocks (trap 3)."""
    out = {}
    for case, a in inputs.items():
        bundle = port_bundle(case)
        params = shard_tree(params_from_numpy(a["params"], "cpu"),
                            schema_shardings(bundle.schema, mesh))
        batch = _batch(bundle, a, mesh)
        b = batch["tokens"].shape[0]
        uz, real = [], hymba._uz_blocks
        if bundle.family == "hybrid":
            def spy(*args):
                res = real(*args)
                uz.append(res[1:])
                return res
            hymba._uz_blocks = spy
        try:
            with use_mesh(mesh), torch.no_grad():
                logits, fwd_trace = _model_trace(
                    mesh, lambda: bundle.prefill_fn(params, batch))
        finally:
            hymba._uz_blocks = real
        with use_mesh(mesh):
            loss, loss_trace = _model_trace(
                mesh, lambda: bundle.loss_fn(params, batch))
            cache = bundle.make_cache(b, MAX_LEN, device="cpu")
            dec, dec_trace, cache = _decode_all(bundle, params, batch, cache,
                                                mesh)
        held = {"p": params, "c": {k: v for k, v in cache.items()
                                   if k not in CARRIES}}
        out[case] = {
            "logits": logits, "loss": float(loss), "decode": dec,
            "cache_shapes": {"/".join(p): tuple(t.shape)
                             for p, t in tree_items(cache)},
            "n_model_collectives": len(fwd_trace) + len(dec_trace),
            "forward_violations": _violations(fwd_trace + loss_trace, b,
                                              params),
            "decode_violations": _violations(dec_trace, b, held),
            "carry_violations": _carry_gathers(
                dec_trace, cache, b, bundle.cfg.d_model, mesh.shape[MODEL]),
            "uz_blocks": [t for pair in uz[:1] for t in pair]}
    return out


def serve_cases(mesh, inputs: dict) -> dict:
    """``serve_lm`` over the mesh from the cases' weights, each rank its
    cut (the cases with an arch id, at their smoke configs)."""
    out = {}
    for case, a in inputs.items():
        if ARCH[case] is None:
            continue
        bundle = port_bundle(case)
        params = shard_tree(params_from_numpy(a["params"], "cpu"),
                            schema_shardings(bundle.schema, mesh))
        out[case] = serve_lm(ARCH[case], smoke=True, device="cpu", mesh=mesh,
                             params=params, graphs=False, **SERVE)
    return out


def train_cases(mesh, inputs: dict, batches: dict) -> dict:
    """Each case's ``TRAIN_STEPS`` train steps over the mesh, FSDP on (a
    ``ParallelStep``, as ``train(mesh=)`` builds it): the losses, gradient
    norms and gathered params."""
    out = {}
    for case, a in inputs.items():
        bundle = port_bundle(case)
        step = steps.build_train_step(bundle, steps.TrainConfig(**TRAIN_KW),
                                      mesh)
        params = shard_tree(params_from_numpy(a["params"], "cpu"),
                            step.param_shardings)
        opt = init_state(params)
        losses, norms = [], []
        for bt in batches[case]:
            params, opt, met = step(params, opt, {k: torch.from_numpy(v)
                                                  for k, v in bt.items()})
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        out[case] = {"losses": losses, "norms": norms,
                     "params": gather_tree(params, step.param_shardings)}
    return out


def model2(rank: int, inputs: dict) -> dict:
    """Over (model 2): the forward cases and ``serve_lm``."""
    torch.set_num_threads(1)  # small ops; the ranks share the host's cores
    mesh = make_process_mesh(*MESHES["model2"], device="cpu")
    return {"forward": forward_cases(mesh, inputs),
            "serve": serve_cases(mesh, inputs)}


def data2_model2(rank: int, inputs: dict, batches: dict) -> dict:
    """Over (data 2, model 2): the forward cases, ``serve_lm`` and the
    train steps."""
    torch.set_num_threads(1)
    mesh = make_process_mesh(*MESHES["data2-model2"], device="cpu")
    return {"forward": forward_cases(mesh, inputs),
            "serve": serve_cases(mesh, inputs),
            "train": train_cases(mesh, inputs, batches)}
