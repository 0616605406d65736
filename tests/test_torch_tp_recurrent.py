"""Tensor parallelism over the mesh's ``model`` axis for the recurrent and
encoder-decoder families against the reference on one device, on the CPU
with gloo: ranks spawned by ``launch.mesh.run_ranks`` over (model 2) and
(data 2, model 2), each holding its cut of every leaf
(``schema_shardings``) and of the cache (``cache_pspecs``).  The rank
bodies are in ``tests/_torch_tp_recurrent_ranks.py``; each spawn runs
once a module and the tests read its results.

The cases: RWKV6, Hymba and Whisper at their smoke configs, and a Hymba of
d_model 40 whose cuts at model 2 are full width's awkward ones: 5 heads
and 5 KV heads of 16, so ``wq``/``wk`` are cut inside a head and the KV
ring on head_dim; 5 SSM heads, so the SSM state is cut on head_dim and a
rank's channel block is not its state's channels (traps 3 and 4 of
``models/hymba.py``); an odd vocab (257), whole.  The weights are drawn
with numpy in the reference's schema (the norm gains non-zero), the
tokens and Whisper's frames numpy-seeded.

Tolerances (fp32, the ranks' partial sums added in another order): the
forward's logits within 1e-5 of max|logit| and the loss within 1e-5
relative; every teacher-forced decode step's logits within 1e-4 (a step
over a sequence-cut cache merges the ranks' partial softmaxes by
log-sum-exp; over Hymba's head_dim-cut ring the ranks' partial logits are
summed); the train steps' losses and gradient norms within 1e-5 relative
and every param leaf within 1e-4 of its max.  The train steps run over
(data 2, model 2) and are held to the reference's step with
``microbatches=2``, whose gradient is the mean of the two halves' as the
data ranks' is: Whisper's ``pos_dec`` rows are rounded to bf16 before
they are added, as the reference rounds them, so their gradient is a bf16
sum over the rows a pass holds, and the whole batch in one pass rounds
it elsewhere (4.9e-5 of the gradient norm apart on this case).  Greedy
tokens are held exactly.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_recurrent_ranks as ranks
from repro.configs import get_bundle as ref_get_bundle
from repro.launch import steps as ref_steps
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import hymba as ref_hymba
from repro.models import whisper as ref_whisper
from repro.models.common import rms_norm as ref_rms_norm
from repro.models.registry import make_hymba_bundle as ref_make_hymba_bundle
from repro.optim import init_state as ref_init_state
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.tree import tree_items
from test_torch_tensor_parallel import _close, _draw

TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "300"))
RANK_TIMEOUT_S = min(150, TIMEOUT_S // 2) if TIMEOUT_S > 0 else 150
REL_FWD, REL_DEC, REL_LOSS, REL_LEAF = 1e-5, 1e-4, 1e-5, 1e-4
B, S, P = ranks.B, ranks.S, ranks.P
CASES = ranks.CASES
MESH_NAMES = list(ranks.MESHES)


def _ref_bundle(case: str):
    if case == "hymba-uneven":
        cfg = ranks.port_bundle(case).cfg
        return ref_make_hymba_bundle(ref_hymba.HymbaConfig(
            **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))
    return ref_get_bundle(ranks.ARCH[case], smoke=True)


def _ref_decode(rb, pj, toks: np.ndarray, frames, gen: int = 0):
    """The reference's decode steps over ``toks`` (B, T), teacher-forced,
    then ``gen`` greedy steps (each step's argmax fed back), from a zero
    cache (Whisper's cross K/V from ``frames`` where given): every step's
    logits and the greedy tokens."""
    decode = jax.jit(rb.decode_fn)
    t = toks.shape[1]
    cache = rb.make_cache(B, t + gen, jnp.float32)
    if frames is not None:
        cache = ref_whisper.precompute_cross_kv(
            pj, rb.cfg, ref_whisper.encode(pj, rb.cfg, jnp.asarray(frames)), cache)
    logits, out = [], []
    for i in range(t):
        lg, cache = decode(pj, cache, {"tokens": jnp.asarray(toks[:, i:i + 1]),
                                       "pos": jnp.int32(i)})
        logits.append(np.asarray(lg))
    tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None]
    for i in range(t, t + gen):
        out.append(tok)
        lg, cache = decode(pj, cache, {"tokens": tok, "pos": jnp.int32(i)})
        tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None]
    return (np.concatenate(logits, 1),
            np.asarray(jnp.concatenate(out, 1)) if out else None)


def _serve_prompts(vocab: int) -> np.ndarray:
    """The prompts ``serve_lm(seed=0)`` draws."""
    return torch.randint(0, vocab, (ranks.SERVE["batch"], ranks.SERVE["prompt_len"]),
                         generator=torch.Generator().manual_seed(1)).numpy()


def _train_batches(case: str, vocab: int, frames) -> list:
    rng = np.random.default_rng(11)
    out = []
    for _ in range(ranks.TRAIN_STEPS):
        t = rng.integers(0, vocab, (B, S)).astype(np.int32)
        b = {"tokens": t, "labels": np.roll(t, -1, axis=1)}
        if frames is not None:
            b["frames"] = frames
        out.append(b)
    return out


@pytest.fixture(scope="module")
def cases():
    """Each case's inputs for the ranks (numpy weights, tokens, frames)
    and the reference's values on one device: forward logits and loss,
    the teacher-forced decode logits, greedy tokens, Hymba's first-layer
    [u | z]."""
    inputs, ref = {}, {}
    for i, case in enumerate(CASES):
        rb = _ref_bundle(case)
        rng = np.random.default_rng(i)
        p = _draw(rb.schema, rng)
        toks = rng.integers(0, rb.cfg.vocab, (B, S)).astype(np.int32)
        frames = (rng.standard_normal((B, rb.cfg.enc_len, rb.cfg.d_model)).astype(
            np.float32) if rb.family == "encdec" else None)
        pj = jax.tree.map(jnp.asarray, p)
        batch = {"tokens": jnp.asarray(toks),
                 "labels": jnp.asarray(np.roll(toks, -1, axis=1))}
        if frames is not None:
            batch["frames"] = jnp.asarray(frames)
        ref[case] = {"logits": np.asarray(rb.prefill_fn(pj, batch)),
                     "loss": float(rb.loss_fn(pj, batch)),
                     "decode": _ref_decode(rb, pj, toks, frames)[0]}
        if ranks.ARCH[case] is not None:  # serve_lm: zero cross K/V
            ref[case]["serve"] = _ref_decode(
                rb, pj, _serve_prompts(rb.cfg.vocab), None,
                ranks.SERVE["gen"])[1]
        if rb.family == "hybrid":
            w = jax.tree.map(lambda a: a[0], pj["layers"])
            h = ref_rms_norm(pj["embed"][jnp.asarray(toks)], w["ln"])
            ref[case]["uz"] = np.asarray(h @ w["w_in"])
        inputs[case] = {"params": p, "tokens": toks, "frames": frames}
    return inputs, ref


@pytest.fixture(scope="module")
def batches(cases):
    inputs, _ = cases
    return {c: _train_batches(c, _ref_bundle(c).cfg.vocab, inputs[c]["frames"])
            for c in CASES}


@pytest.fixture(scope="module")
def ref_train(cases, batches):
    """The reference's train steps on one device from each case's
    weights, the gradient the mean of the two halves of the batch
    (``microbatches=2``, the split of the data ranks): the losses,
    gradient norms and final params."""
    inputs, _ = cases
    out = {}
    with jax.set_mesh(ref_host_mesh()):
        for case in CASES:
            rb = _ref_bundle(case)
            fn, _, _ = ref_steps.build_train_step(
                rb, ref_host_mesh(), ref_steps.TrainConfig(
                    microbatches=2, **ranks.TRAIN_KW))
            step = jax.jit(fn)
            params = jax.tree.map(jnp.asarray, inputs[case]["params"])
            opt = ref_init_state(params)
            losses, norms = [], []
            for b in batches[case]:
                params, opt, met = step(params, opt,
                                        {k: jnp.asarray(v) for k, v in b.items()})
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
            out[case] = (losses, norms, jax.tree.map(np.asarray, params))
    return out


@pytest.fixture(scope="module")
def model2(tmp_path_factory, cases):
    inputs, _ = cases
    return run_ranks(ranks.model2, 2, inputs,
                     store_path=str(tmp_path_factory.mktemp("tpr2") / "store"),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def data2_model2(tmp_path_factory, cases, batches):
    inputs, _ = cases
    return run_ranks(ranks.data2_model2, 4, inputs, batches,
                     store_path=str(tmp_path_factory.mktemp("tpr4") / "store"),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)


def _runs(request, mesh_name):
    return request.getfixturevalue(mesh_name.replace("-", "_"))


def _model(mesh_name) -> int:
    return dict(zip(*reversed(ranks.MESHES[mesh_name])))["model"]


def _data_rows(runs, mesh_name, key, case):
    """The global batch's rows from the ranks of model coordinate 0, in
    data order (rank = data * model + model index)."""
    return np.concatenate([runs[r]["forward"][case][key]
                           for r in range(0, len(runs), _model(mesh_name))])


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_reference(request, cases, mesh_name, case):
    runs = _runs(request, mesh_name)
    _, ref = cases
    _close(_data_rows(runs, mesh_name, "logits", case), ref[case]["logits"],
           REL_FWD, "logits")
    m = _model(mesh_name)
    # each data rank's mean over its rows; equal rows, so their mean
    loss = float(np.mean([r["forward"][case]["loss"] for r in runs[::m]]))
    assert abs(loss - ref[case]["loss"]) <= REL_LOSS * abs(ref[case]["loss"])
    for i, r in enumerate(runs):  # the model ranks of a data rank agree
        assert np.array_equal(r["forward"][case]["logits"],
                              runs[i // m * m]["forward"][case]["logits"])


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", CASES)
def test_decode_matches_reference(request, cases, mesh_name, case):
    """Decode steps over all S tokens, teacher-forced, over the cache cut
    as ``cache_pspecs`` places it: the first P step the prompt as the
    serving loop does, the rest compared likewise (Whisper's cross K/V
    from ``precompute_cross_kv`` of the encoder's output)."""
    runs = _runs(request, mesh_name)
    _, ref = cases
    _close(_data_rows(runs, mesh_name, "decode", case), ref[case]["decode"],
           REL_DEC, "decode")


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", CASES)
def test_cache_is_the_cut_cache_pspecs_gives(request, mesh_name, case):
    """Each rank's cache leaves have the shapes of its cut of the global
    cache under ``steps.cache_pspecs``: RWKV6's state by head and its
    carries along d; Hymba's ring by KV head (smoke) or head_dim (5 KV
    heads), its SSM state by head or head_dim, its conv tail whole (the
    rows of every data rank); Whisper's self and cross caches on the
    sequence."""
    runs = _runs(request, mesh_name)
    sizes, names = ranks.MESHES[mesh_name]
    shape = dict(zip(names, sizes))
    bundle = ranks.port_bundle(case)
    full = bundle.make_cache(B, ranks.MAX_LEN, device="meta")
    specs = dict(tree_items(steps.cache_pspecs(bundle, full, Mesh(names, sizes))))
    cut = {}
    for path, leaf in tree_items(full):
        dims = list(leaf.shape)
        for d, entry in enumerate(specs[path]):
            for a in ((entry,) if isinstance(entry, str) else (entry or ())):
                dims[d] //= shape[a]
        cut["/".join(path)] = tuple(dims)
    assert any(s != tuple(leaf.shape) for (_, leaf), s in
               zip(tree_items(full), cut.values()))
    for r in runs:
        assert r["forward"][case]["cache_shapes"] == cut


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", CASES)
def test_no_parameter_or_cache_leaf_crosses_the_model_axis(request, mesh_name,
                                                           case):
    """Every collective over ``model`` in the forward (serving and
    training routes) and in the decode steps has an activation or logit
    operand: no parameter leaf, and in a decode step no cache leaf.  The
    one exception is RWKV6's two shift carries, which the reference cuts
    along d: a decode step gathers one layer's (B, d / 2) rows of each,
    and nothing else of them."""
    runs = _runs(request, mesh_name)
    for r in runs:
        f = r["forward"][case]
        assert f["n_model_collectives"] > 0
        assert f["forward_violations"] == [], f["forward_violations"]
        assert f["decode_violations"] == [], f["decode_violations"]
        assert f["carry_violations"] == [], f["carry_violations"]


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", ["hymba-1.5b", "hymba-uneven"])
def test_hymba_takes_its_block_of_u_and_z(request, cases, mesh_name, case):
    """Trap 3: ``w_in`` is the column-cut [u | z]; at model 2 rank 0 holds
    all of u and rank 1 all of z.  Each rank's first-layer channel block
    of u and of z equals the reference's slice of its rows."""
    runs = _runs(request, mesh_name)
    _, ref = cases
    m = _model(mesh_name)
    di = ranks.port_bundle(case).cfg.d_inner
    c = di // m
    for i, r in enumerate(runs):
        u, z = r["forward"][case]["uz_blocks"]
        rows = slice(i // m * u.shape[0], (i // m + 1) * u.shape[0])
        want = ref[case]["uz"][rows]
        k = i % m
        _close(u, want[..., k * c:(k + 1) * c], REL_FWD, "u")
        _close(z, want[..., di + k * c:di + (k + 1) * c], REL_FWD, "z")


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("case", [c for c in CASES if ranks.ARCH[c]])
def test_serve_lm_tokens_equal_reference(request, cases, mesh_name, case):
    runs = _runs(request, mesh_name)
    _, ref = cases
    for r in runs:
        assert np.array_equal(r["serve"][case], ref[case]["serve"]), case


@pytest.mark.parametrize("case", CASES)
def test_train_step_matches_reference(data2_model2, ref_train, case):
    """``ranks.TRAIN_STEPS`` train steps over (data 2, model 2), FSDP on:
    the losses, gradient norms and the params after, against the
    reference's one-device step over the two halves."""
    losses, norms, params = ref_train[case]
    for r in data2_model2:
        got = r["train"][case]
        _close(got["losses"], losses, REL_LOSS, "losses")
        _close(got["norms"], norms, REL_LOSS, "gradient norms")
    want = dict(tree_items(params))
    got = dict(tree_items(data2_model2[0]["train"][case]["params"]))
    assert set(got) == set(want)
    for path, w in want.items():
        _close(got[path], w, REL_LEAF, "/".join(path))
    for r in data2_model2[1:]:
        for path, a in tree_items(r["train"][case]["params"]):
            assert np.array_equal(a, got[path])
