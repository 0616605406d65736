"""A held sequence's edge cases (ROADMAP Queue A 3(c)1) against the
reference on one device and the port in one process, on the CPU with
gloo: 4 ranks spawned by ``launch.mesh.run_ranks`` over (data 4, model 1)
and (data 2, model 2).  The rank bodies are in ``tests/_torch_seq_ranks.py``.

Each leaf is placed by its own shape, as the reference's ``resolve_pspec``
places it:

* a batch-1 sequence of 15 positions, which divides neither 2 nor 4
  data ranks, is held whole on every data rank (a row held alike):
  Qwen3-4B's smoke config trained, and served with a prompt of 15 whole
  on every rank into a cache of 24 that is cut over data (the prefill
  writes this rank's positions of the whole pass, each decode step merges
  over the ranks' blocks);
* 4 positions over 4 data ranks are blocks of one position: Qwen3-4B
  trained, prefilled and served (a prompt of 4, a cache of 8), and
  Hymba (its causal conv's tail of 3 rows taken from up to 3 ranks back)
  and RWKV6 (its token shift across every block; float64 on both sides
  of the one-process comparison, as ``tests/test_torch_seq_data.py``)
  trained and prefilled;
* ``REPRO_SEQ_PARALLEL=1`` on a sequence of 16 held over (data 2, model
  2): each data rank's block of the residual stream cut further over
  ``model``.

Tolerances: train losses and gradient norms within 1e-5 relative of one
process's on the same batch (the flag's of the flag off's on the same
mesh), and the first step's loss of the reference's ``lm_loss``; every
param leaf within 1e-4 of its largest magnitude after the steps;
``prefill_fn``'s logits (the blocks gathered) within 1e-4 of max|logit|
of the reference's ``forward``; ``serve_lm(batch=1)``'s tokens equal to
the reference's greedy loop and every call's logits within 1e-4 of
max|logit| of one process's.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_seq_ranks as ranks
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.serve import serve_lm
from repro_torch.models.common import params_from_numpy
from repro_torch.tree import tree_items, tree_map
from test_torch_seq_data import ref_bundle
from test_torch_tensor_parallel import _close, _draw, _greedy

TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "300"))
RANK_TIMEOUT_S = min(150, TIMEOUT_S // 2) if TIMEOUT_S > 0 else 150
REL_REF, REL_LOSS, REL_LEAF = 1e-4, 1e-5, 1e-4
RUNS = [(case, mesh) for case, (_, _, meshes, _) in ranks.EDGE_CASES.items()
        for mesh in meshes]


def _prompts(vocab: int, case: str) -> np.ndarray:
    """The prompt ``serve_lm(seed=0, batch=1)`` draws."""
    return torch.randint(0, vocab, (1, ranks.EDGE_SERVE[case]["prompt_len"]),
                         generator=torch.Generator().manual_seed(1)).numpy()


@pytest.fixture(scope="module")
def cases():
    """Each case's numpy inputs and the reference's values on one device:
    ``forward``'s logits, ``lm_loss`` and, where served, the greedy
    tokens of its prefill and ``decode_step`` loop."""
    inputs, ref = {}, {}
    for i, (case, (arch, s, _, runs)) in enumerate(ranks.EDGE_CASES.items()):
        rb = ref_bundle(arch)
        rng = np.random.default_rng(200 + i)
        p = _draw(rb.schema, rng)
        toks = rng.integers(0, rb.cfg.vocab, (1, s)).astype(np.int32)
        a = {"params": p, "tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        pj = jax.tree.map(jnp.asarray, p)
        batch = {k: jnp.asarray(v) for k, v in a.items() if k != "params"}
        ref[case] = {"logits": np.asarray(rb.prefill_fn(pj, batch)),
                     "loss": float(rb.loss_fn(pj, batch))}
        if "serve" in runs:
            lens = ranks.EDGE_SERVE[case]
            ref[case]["served"] = _greedy(
                jax.jit(rb.prefill_cache_fn), jax.jit(rb.decode_fn), pj,
                _prompts(rb.cfg.vocab, case), lens["gen"],
                rb.make_cache(1, lens["prompt_len"] + lens["gen"],
                              jnp.float32))
        inputs[case] = a
    return inputs, ref


@pytest.fixture(scope="module")
def one(cases):
    """The port in one process: the train steps and, where served,
    ``serve_lm``'s tokens and every call's logits."""
    inputs, _ = cases
    out = {}
    for case, (arch, _, _, runs) in ranks.EDGE_CASES.items():
        a = inputs[case]
        bundle, dt = ranks.bundle_of(arch), ranks.dtype_of(arch)
        res = {"train": ranks.train(bundle, None, a["params"],
                                    ranks.batch_of(a, dt), dt)}
        if "serve" in runs:
            params = tree_map(lambda t: t.to(dt),
                              params_from_numpy(a["params"], "cpu"))
            calls = []
            res["served"] = serve_lm(arch, smoke=True, device="cpu",
                                     params=params, graphs=False,
                                     on_logits=calls.append,
                                     **ranks.EDGE_SERVE[case]).numpy()
            res["serve_logits"] = torch.cat([c[:, -1] for c in calls]).numpy()
        out[case] = res
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cases):
    return run_ranks(ranks.seq_edges, 4, cases[0],
                     store_path=str(tmp_path_factory.mktemp("edges") / "store"),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)


def _held(got, want, ref_loss):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=REL_LOSS)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=REL_LOSS)
    np.testing.assert_allclose(got["losses"][0], ref_loss, rtol=REL_LOSS)
    for (path, g), (_, w) in zip(tree_items(got["params"]),
                                 tree_items(want["params"])):
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else w
        _close(g, w, REL_LEAF, "/".join(path))


@pytest.mark.parametrize("case,mesh_name", RUNS)
def test_train_steps_match_one_process(cases, one, runs, case, mesh_name):
    _, ref = cases
    for r in runs:
        got = r[f"{case} {mesh_name}"]
        _held(got["train"], one[case]["train"], ref[case]["loss"])
        if "train_sp" in got:  # the flag's steps against the flag off's
            _held(got["train_sp"], got["train"], ref[case]["loss"])


@pytest.mark.parametrize("case,mesh_name", [
    r for r in RUNS if "prefill" in ranks.EDGE_CASES[r[0]][3]])
def test_prefill_in_blocks_of_one_matches_reference(cases, runs, case,
                                                    mesh_name):
    _, ref = cases
    for r in runs:
        _close(r[f"{case} {mesh_name}"]["logits"], ref[case]["logits"],
               REL_REF, f"{case} over {mesh_name}")


@pytest.mark.parametrize("case,mesh_name", [
    r for r in RUNS if "serve" in ranks.EDGE_CASES[r[0]][3]])
def test_serve_batch1_tokens_equal_reference(cases, one, runs, case,
                                             mesh_name):
    _, ref = cases
    for r in runs:
        got = r[f"{case} {mesh_name}"]
        np.testing.assert_array_equal(got["served"], ref[case]["served"])
        np.testing.assert_array_equal(got["served"], one[case]["served"])
        _close(got["serve_logits"], one[case]["serve_logits"], REL_REF,
               f"{case} over {mesh_name} served logits")
