"""Tensor and expert parallelism over the mesh's ``model`` axis against the
reference on one device, on the CPU with gloo: ranks spawned by
``launch.mesh.run_ranks`` over (model 2) and (data 2, model 2), each
holding its cut of every leaf (``schema_shardings``) and of the caches.
The rank bodies are in ``tests/_torch_tp_ranks.py``; each spawn runs once
a module and the tests read its results.

The weights are drawn with numpy in the reference's schema (the norm
gains non-zero, so every ``1 + gamma`` scale is exercised) and handed to
both packages; the tokens are numpy-seeded.  The cases: SmolLM (3 query heads of
16 cut at 24 columns, inside a head; its one KV head too), Qwen3 (qk-norm,
whole heads), Gemma2 (softcaps, windows, sandwich norms), PaliGemma (a
stub prefix; its one KV head gathered for each rank's query heads),
DeepSeek-V2 (MLA and the MoE, 2 dispatch groups) at their smoke sizes, and
a config of 16 KV heads of 4, whose cache goes over ``model`` by heads
(every other one cuts the sequence).

Tolerances (fp32, the ranks' partial sums added in another order):
logits within 1e-4 of max|logit| (a decode step over a sequence-cut cache
merges the ranks' partial softmaxes by log-sum-exp, MLA's in the absorbed
form), the loss within 1e-5 relative; the train step's losses within 1e-5
relative and every param leaf within 1e-4 of its max after 3 steps; one
MoE layer within 1e-5 of max|y|, its expert choices and drops equal.
Greedy tokens and checkpoints are held exactly.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from repro.configs import get_bundle as ref_get_bundle
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import moe as ref_moe
from repro.models import transformer as ref_lm
from repro.models.registry import make_lm_bundle as ref_make_lm_bundle
from repro.optim import init_state as ref_init_state
from repro_torch.checkpoint import restore
from repro_torch.launch import steps
from repro_torch.launch.mesh import joint_group_ranks, run_ranks
from repro_torch.tree import tree_items, tree_leaves, tree_map

TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "300"))
RANK_TIMEOUT_S = min(150, TIMEOUT_S // 2) if TIMEOUT_S > 0 else 150
REL, REL_LOSS, REL_MOE, REL_LEAF = 1e-4, 1e-5, 1e-5, 1e-4
B, S, P = ranks.B, ranks.S, ranks.P


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = rel * float(np.abs(want).max())
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


def _ref_config(arch: str):
    """The reference's ``LMConfig`` with every field of the port's case."""
    cfg = ranks.port_config(arch)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if kw["mla"] is not None:
        kw["mla"] = ref_lm.MLAConfig(**dataclasses.asdict(kw["mla"]))
    if kw["moe"] is not None:
        kw["moe"] = ref_moe.MoEConfig(**dataclasses.asdict(kw["moe"]))
    return ref_lm.LMConfig(**kw)


def _ref_bundle(arch: str):
    family = "vlm" if arch == "paligemma-3b" else "lm"
    return ref_make_lm_bundle(_ref_config(arch), family)


def _greedy(prefill, decode, params, prompts: np.ndarray, gen: int,
            cache) -> np.ndarray:
    """The reference's greedy loop (its ``serve_lm``'s): a cache-filling
    prefill, then ``gen`` decode steps, each step's argmax fed back."""
    p = prompts.shape[1]
    logits, cache = prefill(params, cache, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    out = []
    for t in range(p, p + gen):
        out.append(tok)
        logits, cache = decode(params, cache, {"tokens": tok, "pos": jnp.int32(t)})
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    return np.asarray(jnp.concatenate(out, axis=1))


def _draw(schema, rng) -> dict:
    """numpy weights in the reference's schema: its fan-in-scaled normals
    (its own scale where a leaf has one), the norm gains drawn non-zero
    (0.1 normals), so that every ``1 + gamma`` scale is exercised."""
    if isinstance(schema, dict):
        return {k: _draw(schema[k], rng) for k in sorted(schema)}
    shape, scale = schema.shape, schema.scale
    std = (0.1 if scale == 0.0 else scale if scale is not None
           else 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1]))
    return (std * rng.standard_normal(shape)).astype(np.float32)


def _serve_prompts(vocab: int) -> np.ndarray:
    """The prompts ``serve_lm(seed=0)`` draws."""
    return torch.randint(0, vocab, (ranks.SERVE["batch"], ranks.SERVE["prompt_len"]),
                         generator=torch.Generator().manual_seed(1)).numpy()


@pytest.fixture(scope="module")
def cases():
    """Each case's inputs for the ranks (numpy weights, tokens, prefix)
    and the reference's values on one device: forward logits and loss,
    the teacher-forced prefill and decode logits, and greedy tokens."""
    inputs, ref = {}, {}
    for i, arch in enumerate(ranks.ARCHS):
        rb = _ref_bundle(arch)
        rng = np.random.default_rng(i)
        p = _draw(rb.schema, rng)
        toks = rng.integers(0, rb.cfg.vocab, (B, S)).astype(np.int32)
        prefix = (rng.standard_normal((B, ranks.PREFIX, rb.cfg.d_model)).astype(
            np.float32) if rb.family == "vlm" else None)
        pj = jax.tree.map(jnp.asarray, p)
        batch = {"tokens": jnp.asarray(toks),
                 "labels": jnp.asarray(np.roll(toks, -1, axis=1))}
        if prefix is not None:
            batch["prefix"] = jnp.asarray(prefix)
        cache = rb.make_cache(B, ranks.MAX_LEN, jnp.float32)
        prefill, decode, dec = jax.jit(rb.prefill_cache_fn), jax.jit(rb.decode_fn), []
        pre, cache = prefill(pj, cache, {"tokens": batch["tokens"][:, :P]})
        for t in range(P, S):
            lg, cache = decode(pj, cache, {"tokens": batch["tokens"][:, t:t + 1],
                                           "pos": jnp.int32(t)})
            dec.append(np.asarray(lg))
        ref[arch] = {"logits": np.asarray(rb.prefill_fn(pj, batch)),
                     "loss": float(rb.loss_fn(pj, batch)),
                     "prefill": np.asarray(pre), "decode": np.concatenate(dec, 1)}
        if arch != "heads16":  # serve_lm takes an arch id: its smoke config
            if arch == ranks.MOE_ARCH:  # one dispatch group there
                sb = ref_get_bundle(arch, smoke=True)
                prefill, decode = jax.jit(sb.prefill_cache_fn), jax.jit(sb.decode_fn)
            assert ranks.SERVE["prompt_len"] + ranks.SERVE["gen"] == ranks.MAX_LEN
            ref[arch]["serve"] = _greedy(
                prefill, decode, pj, _serve_prompts(rb.cfg.vocab),
                ranks.SERVE["gen"], rb.make_cache(B, ranks.MAX_LEN, jnp.float32))
        inputs[arch] = {"params": p, "tokens": toks, "prefix": prefix}
    return inputs, ref


def _moe_x() -> np.ndarray:
    cfg = ref_get_bundle(ranks.MOE_ARCH, smoke=True).cfg.moe
    return np.random.default_rng(7).standard_normal(
        (ranks.MOE_TOKENS, cfg.d_model)).astype(np.float32)


def _train_batches(vocab: int) -> list:
    rng = np.random.default_rng(11)
    out = []
    for _ in range(ranks.TRAIN_STEPS):
        t = rng.integers(0, vocab, (B, S)).astype(np.int32)
        out.append({"tokens": t, "labels": np.roll(t, -1, axis=1)})
    return out


@pytest.fixture(scope="module")
def ref_train(cases):
    """The reference's train step on one device from DeepSeek-V2's case
    weights: the losses, gradient norms and final params."""
    inputs, _ = cases
    rb = _ref_bundle(ranks.MOE_ARCH)
    fn, _, _ = ref_steps.build_train_step(rb, ref_host_mesh(),
                                          ref_steps.TrainConfig(**ranks.TRAIN_KW))
    with jax.set_mesh(ref_host_mesh()):
        step = jax.jit(fn)
        params = jax.tree.map(jnp.asarray, inputs[ranks.MOE_ARCH]["params"])
        opt = ref_init_state(params)
        losses, norms = [], []
        for b in _train_batches(rb.cfg.vocab):
            params, opt, met = step(params, opt,
                                    {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def model2(tmp_path_factory, cases):
    inputs, _ = cases
    return run_ranks(ranks.model2, 2, inputs, _moe_x(),
                     store_path=str(tmp_path_factory.mktemp("tp2") / "store"),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_ckpt")


@pytest.fixture(scope="module")
def data2_model2(tmp_path_factory, cases, ckpt_dir):
    inputs, _ = cases
    batches = _train_batches(_ref_bundle(ranks.MOE_ARCH).cfg.vocab)
    return run_ranks(ranks.data2_model2, 4, inputs,
                     inputs[ranks.MOE_ARCH]["params"], batches, str(ckpt_dir),
                     store_path=str(tmp_path_factory.mktemp("tp4") / "store"),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)


def _runs(request, mesh_name):
    return request.getfixturevalue(mesh_name.replace("-", "_"))


def _data_rows(runs, mesh_name, key, arch):
    """The global batch's rows from the ranks of model coordinate 0, in
    data order (rank = data * model + model index)."""
    model = dict(zip(*reversed(ranks.MESHES[mesh_name])))["model"]
    return np.concatenate([runs[r]["forward"][arch][key]
                           for r in range(0, len(runs), model)])


MESH_NAMES = list(ranks.MESHES)


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_forward_matches_reference(request, cases, mesh_name, arch):
    runs = _runs(request, mesh_name)
    _, ref = cases
    _close(_data_rows(runs, mesh_name, "logits", arch), ref[arch]["logits"], REL,
           "logits")
    data = len(runs) // dict(zip(*reversed(ranks.MESHES[mesh_name])))["model"]
    losses = [r["forward"][arch]["loss"] for r in runs]
    # each data rank's mean over its rows; equal rows, so their mean
    loss = float(np.mean(losses[::len(runs) // data]))
    assert abs(loss - ref[arch]["loss"]) <= REL_LOSS * abs(ref[arch]["loss"])
    per = len(runs) // data
    for i, r in enumerate(runs):  # the model ranks of a data rank agree
        assert np.array_equal(r["forward"][arch]["logits"],
                              runs[i // per * per]["forward"][arch]["logits"])


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_prefill_and_decode_match_reference(request, cases, mesh_name, arch):
    """A cache-filling prefill over the first P tokens, then a decode step
    a token, teacher-forced, over the cache cut as ``cache_pspecs``
    places it."""
    runs = _runs(request, mesh_name)
    _, ref = cases
    _close(_data_rows(runs, mesh_name, "prefill", arch), ref[arch]["prefill"],
           REL, "prefill")
    _close(_data_rows(runs, mesh_name, "decode", arch), ref[arch]["decode"], REL,
           "decode")


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_cache_is_the_cut_cache_pspecs_gives(request, mesh_name, arch):
    """Each rank's cache leaves have the shapes of its cut of the global
    cache under ``steps.cache_pspecs``: KV heads over model for 16 KV
    heads, the sequence for the rest (MLA's latents too)."""
    from repro_torch.launch.mesh import Mesh

    runs = _runs(request, mesh_name)
    sizes, names = ranks.MESHES[mesh_name]
    shape = dict(zip(names, sizes))
    bundle = ranks.port_bundle(arch)
    full = bundle.make_cache(B, ranks.MAX_LEN, device="meta")
    specs = steps.cache_pspecs(bundle, full, Mesh(names, sizes))
    cut = {}
    for path, leaf in tree_items(full):
        spec = dict(tree_items(specs))[path]
        dims = list(leaf.shape)
        for d, entry in enumerate(spec):
            for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                dims[d] //= shape[a]
        cut["/".join(path)] = tuple(dims)
    heads = arch == "heads16"
    for path, leaf in tree_items(full):
        spec = tuple(dict(tree_items(specs))[path])
        assert ("model" in spec) and (spec.index("model") == (3 if heads else 2))
    for r in runs:
        assert r["forward"][arch]["cache_shapes"] == cut


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_no_parameter_or_cache_leaf_crosses_the_model_axis(request, mesh_name,
                                                           arch):
    """Every collective over ``model`` in the forward (serving and
    training routes) and in the decode steps has an activation or logit
    operand: no parameter leaf, and in a decode step no cache leaf."""
    runs = _runs(request, mesh_name)
    for r in runs:
        f = r["forward"][arch]
        assert f["n_model_collectives"] > 0
        assert f["forward_violations"] == [], f["forward_violations"]
        assert f["decode_violations"] == [], f["decode_violations"]


def test_the_no_gather_check_catches_a_parameter(model2):
    for r in model2:
        assert len(r["planted_violations"]) == 1, r["planted_violations"]


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", [a for a in ranks.ARCHS if a != "heads16"])
def test_serve_lm_tokens_equal_reference(request, cases, mesh_name, arch):
    """Every arch's greedy tokens over the mesh equal the reference's;
    over (data 2, model 2) DeepSeek-V2's smoke config (one dispatch group)
    has each group span both data ranks, which gather its rows."""
    runs = _runs(request, mesh_name)
    _, ref = cases
    for r in runs:
        assert np.array_equal(r["serve"][arch], ref[arch]["serve"]), arch


def test_moe_matches_reference_with_equal_choices(model2):
    """One MoE layer over (model 2), 4 of the 8 experts a rank: the output
    against the reference's ``moe_ffn``, the routing (the top-k experts and
    which entries fit) against the reference's, on every rank."""
    cfg = ref_get_bundle(ranks.MOE_ARCH, smoke=True).cfg.moe
    w = {k: v.numpy() if hasattr(v, "numpy") else
         {kk: vv.numpy() for kk, vv in v.items()}
         for k, v in ranks.moe_weights(cfg, 0).items()}
    x = _moe_x()
    want = np.asarray(ref_moe.moe_ffn(jax.tree.map(jnp.asarray, w),
                                      jnp.asarray(x), cfg))
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w["router"]), axis=-1)
    _, top = jax.lax.top_k(probs, cfg.top_k)
    for r in model2:
        assert r["moe"]["local_experts"][0] == cfg.n_routed // 2
        _close(r["moe"]["y"], want, REL_MOE, "moe")
        assert np.array_equal(r["moe"]["gate_e"][0], np.asarray(top))
        assert np.array_equal(r["moe"]["keep"], model2[0]["moe"]["keep"])


def test_train_step_matches_reference(data2_model2, ref_train):
    """DeepSeek-V2 smoke (MLA + MoE, 2 dispatch groups) over (data 2,
    model 2), FSDP on and off: 3 steps' losses and gradient norms, and
    the params after, against the reference's one-device step."""
    losses, norms, params = ref_train
    leaves = jax.tree.leaves(params)
    for run in ("fsdp", "replicated"):
        for r in data2_model2:
            got = r["train"][run]
            _close(got["losses"], losses, REL_LOSS, f"{run} losses")
            _close(got["norms"], norms, REL_LOSS, f"{run} gradient norms")
        full = tree_leaves(data2_model2[0]["train"][run]["full"]["params"])
        assert len(full) == len(leaves)
        for g, w in zip(full, leaves):
            _close(g, w, REL_LEAF, f"{run} params")
        for r in data2_model2[1:]:
            for a, b in zip(tree_leaves(r["train"][run]["full"]), tree_leaves(
                    data2_model2[0]["train"][run]["full"])):
                assert np.array_equal(a, b)


def test_train_step_holds_model_and_data_cuts(data2_model2):
    """FSDP over (data 2, model 2) cuts some leaf over both axes (a
    quarter), the replicated run over model alone."""
    full = {"/".join(p): tuple(a.shape) for p, a in tree_items(
        data2_model2[0]["train"]["fsdp"]["full"]["params"])}
    for run, least in (("fsdp", 4), ("replicated", 2)):
        local = data2_model2[0]["train"][run]["local_shapes"]
        ratios = {k: math.prod(full[k]) // math.prod(local[k]) for k in full}
        assert max(ratios.values()) == least, (run, ratios)
        assert ratios["ln_f"] == 1  # a whole leaf


def test_checkpoint_restores_across_mesh_shapes(data2_model2, ckpt_dir):
    """The FSDP run's gathered state, written by rank 0: restored into the
    (data 2, model 2) shards, into a (data 1, model 4) mesh's shards and
    in one process, each ``torch.equal``."""
    for r in data2_model2:
        assert r["train"]["restored_equal"]
        assert r["train"]["restored_model4_equal"] and r["train"]["model4_cut"]
    full = data2_model2[0]["train"]["fsdp"]["full"]

    def t(tree):
        if isinstance(tree, dict):
            return {k: t(v) for k, v in tree.items()}
        return torch.as_tensor(np.asarray(tree))

    like = t(full)
    got = restore(str(ckpt_dir), ranks.TRAIN_STEPS, tree_map(torch.zeros_like,
                                                             like))
    for (_, a), (_, b) in zip(tree_items(got), tree_items(like)):
        assert torch.equal(a, b)


REFUSED = ("serve_captured", "train_captured", "bare_model_hint")


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
def test_unexecuted_placements_still_raise(request, mesh_name):
    """The placements the port does not execute raise naming ROADMAP
    Queue A item 3(c); a held model placement is the identity, and the
    sequence-parallel stream (``REPRO_SEQ_PARALLEL=1``), a batch of one
    over the data ranks, a cache whose 15 positions do not divide over
    model 2 and ``moe_ffn_plain`` over model ranks now run
    (``tests/test_torch_seq_parallel.py``, ``tests/test_torch_seq_data.py``,
    ``tests/test_torch_uneven.py`` and ``tests/test_torch_moe_ranks.py``
    hold their values)."""
    runs = _runs(request, mesh_name)
    ran = ("held_model_hint", "seq_parallel", "uneven_cache", "moe_plain") + (
        ("batch1_over_data",) if mesh_name == "data2-model2" else ())
    for r in runs:
        got = r["refusals"]
        for name in REFUSED:
            assert "3(c)" in got[name], (name, got[name])
        for name in ran:
            assert got[name] == "ran", (name, got[name])


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
def test_collectives_are_counted_by_axis(request, mesh_name):
    runs = _runs(request, mesh_name)
    for r in runs:
        model = r["by_axis"]["model"]
        assert model["calls"] > 0 and model["bytes"] > 0 and model["s"] > 0
        if mesh_name == "data2-model2":
            assert r["by_axis"]["data"]["calls"] > 0


def test_joint_groups_of_a_three_axis_mesh():
    """The groups a (pod 2, data 2, model 2) mesh makes for two axes at a
    time: one a coordinate of the third axis, each in row-major order of
    its two; none where the live axes are the whole job or one axis."""
    got = joint_group_ranks(("pod", "data", "model"), (2, 2, 2))
    assert got == {("pod", "data"): [[0, 2, 4, 6], [1, 3, 5, 7]],
                   ("pod", "model"): [[0, 1, 4, 5], [2, 3, 6, 7]],
                   ("data", "model"): [[0, 1, 2, 3], [4, 5, 6, 7]]}
    assert joint_group_ranks(("data", "model"), (2, 2)) == {}
    assert joint_group_ranks(("pod", "data", "model"), (2, 1, 2)) == {}
