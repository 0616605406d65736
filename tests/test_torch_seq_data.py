"""A batch of one whose sequence is cut over the data ranks (the
reference's batch-1 fallback, ``shard_hint(x, BATCH, "data", None)``)
against the reference on one device and the port in one process, on the
CPU with gloo: ranks spawned by ``launch.mesh.run_ranks`` over (data 2,
model 1) and (data 2, model 2).  The rank bodies are in
``tests/_torch_seq_ranks.py``.

The cases, at their smoke sizes, each one sequence of 16 tokens (each
data rank a block of 8): SmolLM (dense GQA), DeepSeek-V2 (MLA and the
MoE, 2 dispatch groups: a multiple of the data ranks), Gemma2 (windows,
softcaps), PaliGemma (a stub prefix of 8, cut as the tokens), RWKV6 (its
ranks and one process in float64) and Hymba (windowed attention, the
causal conv's and the scan's carries across the blocks).  The weights are
drawn with numpy (the norm gains non-zero) and handed to both packages.

Tolerances: ``prefill_fn``'s logits (the ranks' blocks gathered) within
1e-4 of max|logit| of the reference's ``forward`` and 1e-5 of one
process's; each train step's loss and gradient norm within 1e-5 relative
of one process's and the first step's loss of the reference's
``lm_loss``; every param leaf within 1e-4 of its max after the steps;
``serve_lm(batch=1)``'s tokens equal to the reference's greedy loop and
to one process's, every call's logits within 1e-4 of max|logit|.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_seq_ranks as ranks
from repro.configs import get_bundle as ref_get_bundle
from repro.models import moe as ref_moe
from repro.models import transformer as ref_lm
from repro.models.registry import make_lm_bundle as ref_make_lm_bundle
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh, run_ranks
from repro_torch.launch.serve import serve_lm
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import _kv_cache_axes
from repro_torch.sharding import resolve_pspec, spec_axes
from repro_torch.tree import tree_items, tree_map
from test_torch_tensor_parallel import _close, _draw, _greedy

TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "300"))
RANK_TIMEOUT_S = min(150, TIMEOUT_S // 2) if TIMEOUT_S > 0 else 150
REL_REF, REL_ONE, REL_LOSS, REL_LEAF = 1e-4, 1e-5, 1e-5, 1e-4
MESHES = {"data2": (2, 1), "data2-model2": (2, 2)}
CASES = [(a, m) for m in MESHES for a in ranks.SEQ_ARCHS]


def ref_bundle(arch: str):
    """The reference's bundle with every field of the port's case."""
    port = ranks.bundle_of(arch)
    if port.family in ("ssm", "hybrid"):
        return ref_get_bundle(arch, smoke=True)
    kw = {f.name: getattr(port.cfg, f.name)
          for f in dataclasses.fields(port.cfg)}
    if kw["mla"] is not None:
        kw["mla"] = ref_lm.MLAConfig(**dataclasses.asdict(kw["mla"]))
    if kw["moe"] is not None:
        kw["moe"] = ref_moe.MoEConfig(**dataclasses.asdict(kw["moe"]))
    return ref_make_lm_bundle(ref_lm.LMConfig(**kw), port.family)


def _prompts(vocab: int) -> np.ndarray:
    """The prompt ``serve_lm(seed=0, batch=1)`` draws."""
    return torch.randint(0, vocab, (1, ranks.SERVE["prompt_len"]),
                         generator=torch.Generator().manual_seed(1)).numpy()


@pytest.fixture(scope="module")
def cases():
    """Each case's numpy inputs and the reference's values on one device:
    ``forward``'s logits, ``lm_loss`` and, for the served ones, the greedy
    tokens of its prefill and ``decode_step`` loop."""
    inputs, ref = {}, {}
    for i, arch in enumerate(ranks.SEQ_ARCHS):
        rb = ref_bundle(arch)
        rng = np.random.default_rng(100 + i)
        p = _draw(rb.schema, rng)
        toks = rng.integers(0, rb.cfg.vocab, (1, ranks.S)).astype(np.int32)
        a = {"params": p, "tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        if rb.family == "vlm":
            a["prefix"] = (0.1 * rng.standard_normal(
                (1, ranks.PREFIX, rb.cfg.d_model))).astype(np.float32)
        pj = jax.tree.map(jnp.asarray, p)
        batch = {k: jnp.asarray(v) for k, v in a.items() if k != "params"}
        ref[arch] = {"logits": np.asarray(rb.prefill_fn(pj, batch)),
                     "loss": float(rb.loss_fn(pj, batch))}
        if arch in ranks.SERVED:
            max_len = ranks.SERVE["prompt_len"] + ranks.SERVE["gen"]
            ref[arch]["served"] = _greedy(
                jax.jit(rb.prefill_cache_fn), jax.jit(rb.decode_fn), pj,
                _prompts(rb.cfg.vocab), ranks.SERVE["gen"],
                rb.make_cache(1, max_len, jnp.float32))
        inputs[arch] = a
    return inputs, ref


@pytest.fixture(scope="module")
def one(cases):
    """The port in one process: ``prefill_fn``'s logits, the train steps,
    and ``serve_lm``'s tokens and every call's logits."""
    inputs, _ = cases
    out = {}
    for arch, a in inputs.items():
        bundle, dt = ranks.bundle_of(arch), ranks.dtype_of(arch)
        batch = ranks.batch_of(a, dt)
        params = tree_map(lambda t: t.to(dt), params_from_numpy(a["params"],
                                                                "cpu"))
        with torch.no_grad():
            logits = bundle.prefill_fn(params, {k: v for k, v in batch.items()
                                                if k != "labels"})
        res = {"logits": logits.numpy(),
               **ranks.train(bundle, None, a["params"], batch, dt)}
        if arch in ranks.SERVED:
            calls = []
            res["served"] = serve_lm(arch, smoke=True, device="cpu",
                                     params=params, graphs=False,
                                     on_logits=calls.append,
                                     **ranks.SERVE).numpy()
            res["serve_logits"] = torch.cat([c[:, -1] for c in calls]).numpy()
        out[arch] = res
    return out


def _spawn(tmp_path_factory, inputs, name):
    sizes = MESHES[name]
    return run_ranks(ranks.seq_data, sizes[0] * sizes[1], sizes, inputs,
                     store_path=str(tmp_path_factory.mktemp(name) / "store"),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def data2(tmp_path_factory, cases):
    return _spawn(tmp_path_factory, cases[0], "data2")


@pytest.fixture(scope="module")
def data2_model2(tmp_path_factory, cases):
    return _spawn(tmp_path_factory, cases[0], "data2-model2")


def _runs(request, mesh_name):
    return request.getfixturevalue(mesh_name.replace("-", "_"))


def _leaves_close(got, want, rel):
    for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
        _close(g, w.detach().numpy(), rel, "/".join(path))


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_prefill_matches_reference_and_one_process(request, cases, one, arch,
                                                   mesh_name):
    _, ref = cases
    for r in _runs(request, mesh_name):
        got = r[arch]["logits"]
        _close(got, ref[arch]["logits"], REL_REF, f"{arch} vs reference")
        _close(got, one[arch]["logits"], REL_ONE, f"{arch} vs one process")


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_train_steps_match_one_process(request, cases, one, arch, mesh_name):
    """``ParallelStep`` at a global batch of one row: each rank's loss the
    mean over its block, averaged over the data ranks."""
    _, ref = cases
    want = one[arch]
    for r in _runs(request, mesh_name):
        got = r[arch]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL_LOSS)
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=REL_LOSS)
        np.testing.assert_allclose(got["losses"][0], ref[arch]["loss"],
                                   rtol=REL_LOSS)
        _leaves_close(got["params"], want["params"], REL_LEAF)


@pytest.mark.parametrize("arch,mesh_name",
                         [(a, m) for m in MESHES for a in ranks.SERVED])
def test_serve_batch1_tokens_equal_reference(request, cases, one, arch,
                                             mesh_name):
    """The prompt cut over the data ranks into their blocks of the cache,
    each decode step merged over the blocks (and ``model`` where it cuts
    the cache's sequence too)."""
    _, ref = cases
    for r in _runs(request, mesh_name):
        np.testing.assert_array_equal(r[arch]["served"], ref[arch]["served"])
        np.testing.assert_array_equal(r[arch]["served"], one[arch]["served"])
        _close(r[arch]["serve_logits"], one[arch]["serve_logits"], REL_REF,
               f"{arch} served logits")


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_held_cache_is_cut_as_the_reference_places_it(request, mesh_name):
    """A batch-1 cache under a held sequence: each leaf this rank's cut as
    the reference's ``_kv_cache_axes`` resolve on the mesh (the ring
    layout's sequence over data and model jointly)."""
    sizes = MESHES[mesh_name]
    mesh = Mesh(("data", "model"), sizes)
    for r in _runs(request, mesh_name):
        for arch, shapes in r["cache_shapes"].items():
            bundle = ranks.bundle_of(arch)
            full = bundle.make_cache(1, ranks.S, device="meta")
            for (path, leaf), (_, ax) in zip(tree_items(full),
                                             tree_items(_kv_cache_axes(full))):
                spec = resolve_pspec(leaf.shape, ax, mesh.shape)
                want = tuple(n // int(np.prod([sizes[("data", "model").index(a)]
                                               for a in spec_axes(e)]))
                             for n, e in zip(leaf.shape, spec))
                assert tuple(shapes["/".join(path)]) == want, (arch, path)
