"""The sequence-parallel residual stream (``REPRO_SEQ_PARALLEL=1``, the
reference's ``src/repro/models/transformer.py:438-444``) and the
vocab-parallel logits, on the CPU with gloo: ranks spawned by
``launch.mesh.run_ranks``; the rank bodies are in
``tests/_torch_seq_ranks.py``.

Sequence parallelism over (data 1, model 2) and (data 2, model 2), 4 rows
of 16 tokens, on SmolLM (a head cut inside), Qwen3 (whole heads,
qk-norm), Gemma2 (sandwich norms, softcaps, windows) and DeepSeek-V2 (MLA
and the MoE, gathered in and cut out) at their smoke sizes: the flag
changes placement only, so each train step's loss and gradient norm lie
within 1e-5 relative of the flag off's and of one process's, and every
param leaf within 1e-4 of its max; the first loss within 1e-5 of the
reference's ``lm_loss``; the flag moves more bytes over ``model``.

The vocab-parallel loss over (model 2): ``next_token_nll`` from each
rank's block of the logits (Megatron's cross-entropy) and its gradient
within 1e-6 of the gathered version's, with and without a softcap
(Gemma2's, applied before the cut reductions); the greedy pick across the
blocks equal to ``argmax`` of the whole row, ties across the blocks
included (the lowest index wins).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_seq_ranks as ranks
from repro_torch.launch.mesh import run_ranks
from test_torch_seq_data import ref_bundle
from test_torch_tensor_parallel import _close, _draw

TIMEOUT_S = int(os.environ.get("REPRO_TEST_TIMEOUT", "300"))
RANK_TIMEOUT_S = min(150, TIMEOUT_S // 2) if TIMEOUT_S > 0 else 150
REL_LOSS, REL_LEAF, REL_VOCAB = 1e-5, 1e-4, 1e-6
MESHES = {"model2": (2,), "data2-model2": (2, 2)}
CASES = [(a, m) for m in MESHES for a in ranks.SP_ARCHS]
VOCAB, ROWS = 64, 12


@pytest.fixture(scope="module")
def cases():
    """Each case's numpy inputs (4 rows of 16 tokens) and the reference's
    ``lm_loss`` on one device."""
    inputs, ref = {}, {}
    for i, arch in enumerate(ranks.SP_ARCHS):
        rb = ref_bundle(arch)
        rng = np.random.default_rng(200 + i)
        p = _draw(rb.schema, rng)
        toks = rng.integers(0, rb.cfg.vocab, (ranks.SP_B, ranks.S)).astype(
            np.int32)
        a = {"params": p, "tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        batch = {k: jnp.asarray(v) for k, v in a.items() if k != "params"}
        ref[arch] = float(rb.loss_fn(jax.tree.map(jnp.asarray, p), batch))
        inputs[arch] = a
    return inputs, ref


@pytest.fixture(scope="module")
def one(cases):
    inputs, _ = cases
    return {arch: ranks.train(ranks.bundle_of(arch), None, a["params"],
                              ranks.batch_of(a, ranks.dtype_of(arch)),
                              ranks.dtype_of(arch))
            for arch, a in inputs.items()}


def _spawn(tmp_path_factory, fn, name, *args):
    sizes = MESHES[name]
    return run_ranks(fn, int(np.prod(sizes)), sizes, *args,
                     store_path=str(tmp_path_factory.mktemp(name) / "store"),
                     device="cpu", timeout_s=RANK_TIMEOUT_S)


@pytest.fixture(scope="module")
def model2(tmp_path_factory, cases):
    return _spawn(tmp_path_factory, ranks.seq_parallel, "model2", cases[0])


@pytest.fixture(scope="module")
def data2_model2(tmp_path_factory, cases):
    return _spawn(tmp_path_factory, ranks.seq_parallel, "data2-model2",
                  cases[0])


def _vocab_inputs():
    rng = np.random.default_rng(5)
    logits = (4.0 * rng.standard_normal((2, ROWS // 2, VOCAB))).astype(
        np.float32)
    targets = rng.integers(0, VOCAB, (2, ROWS // 2)).astype(np.int64)
    ties = rng.standard_normal((ROWS, VOCAB)).astype(np.float32)
    # row r ties its maximum at r % 3 places: within one block, across the
    # two blocks (the lower block's index must win), and across with a
    # higher value later
    for r in range(ROWS):
        top = float(ties[r].max()) + 1.0
        if r % 3 == 0:
            ties[r, [5, 9]] = top
        elif r % 3 == 1:
            ties[r, [VOCAB // 2 - 1, VOCAB // 2 + 3]] = top
        else:
            ties[r, [2, VOCAB - 1]] = top
            ties[r, VOCAB // 2] = top + 1.0
    return logits, targets, ties


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return _spawn(tmp_path_factory, ranks.vocab_cases, "model2",
                  *_vocab_inputs())


def _runs(request, mesh_name):
    return request.getfixturevalue(mesh_name.replace("-", "_"))


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_seq_parallel_equals_the_flag_off(request, cases, one, arch,
                                          mesh_name):
    _, ref = cases
    for r in _runs(request, mesh_name):
        on, off = r[arch]["1"], r[arch]["0"]
        for got in (on, off):
            np.testing.assert_allclose(got["losses"], one[arch]["losses"],
                                       rtol=REL_LOSS)
            np.testing.assert_allclose(got["norms"], one[arch]["norms"],
                                       rtol=REL_LOSS)
        np.testing.assert_allclose(on["losses"], off["losses"], rtol=REL_LOSS)
        np.testing.assert_allclose(on["losses"][0], ref[arch], rtol=REL_LOSS)
        _tree_close(on["params"], off["params"])


def _tree_close(got, want, path=""):
    if isinstance(want, dict):
        for k in want:
            _tree_close(got[k], want[k], f"{path}/{k}")
        return
    _close(got, want, REL_LEAF, path)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_seq_parallel_moves_more_over_model(request, mesh_name):
    """Megatron's trade: each sublayer's input gathered over ``model`` and
    its output reduce-scattered, where the flag off all-reduces it."""
    for r in _runs(request, mesh_name):
        for arch in ranks.SP_ARCHS:
            assert (r[arch]["1"]["by_axis"]["model"]
                    > r[arch]["0"]["by_axis"]["model"]), arch


@pytest.mark.parametrize("cap", ["capNone", "cap30.0"])
def test_vocab_parallel_loss_and_gradient_equal_the_gathered(vocab, cap):
    for r in vocab:
        (loss, grad), (want_loss, want_grad) = (r[cap]["cut"],
                                                r[cap]["gathered"])
        np.testing.assert_allclose(loss, want_loss, rtol=REL_VOCAB)
        _close(grad, want_grad, REL_VOCAB, f"{cap} gradient")


def test_greedy_across_vocab_blocks_is_argmax_with_ties(vocab):
    _, _, ties = _vocab_inputs()
    want = ties.argmax(axis=-1)
    for r in vocab:
        np.testing.assert_array_equal(r["greedy"], want)
