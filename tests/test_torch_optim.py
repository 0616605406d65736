"""The port's optimizer, schedule, gradient compression and synthetic data
against the reference's, on the same inputs (numpy, from a seed).

Tolerances: the schedule within 1e-6 (float32 cos and pow may differ by
an ulp); AdamW params, moments and the grad norm within 1e-6 relative to
each leaf's max (float32, op for op, the norm's sums in another order);
bf16 params within one bf16 rounding of max|p| (an fp32 difference of an
ulp may flip a rounding), their fp32 moments within 1e-2 (the gradients
are bf16 there, and a flipped rounding moves a moment by 2^-8 of it);
compression exact (the same float32 ops in the same order; top-k on
inputs without ties, which the two libraries order differently);
synthetic batches bit-identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as ref_data
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro.optim import schedule as ref_sched
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.optim import adamw, compression, schedule
from repro_torch.tree import tree_leaves, tree_map

RNG = np.random.default_rng(7)
SHAPES = {"dense_layers": {"wq": (2, 6, 4), "ln": (2, 6)}, "embed": (10, 6),
          "ln_f": (6,)}


def _draw(shapes, rng, scale):
    if isinstance(shapes, dict):
        return {k: _draw(v, rng, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("warmup,total,min_ratio", [(10, 100, 0.1), (0, 40, 0.0),
                                                    (4, 30, 0.1), (30, 30, 0.5)])
def test_cosine_with_warmup_matches_reference(warmup, total, min_ratio):
    steps = np.arange(total + 3, dtype=np.int32)
    want = ref_sched.cosine_with_warmup(jnp.asarray(steps), warmup=warmup,
                                        total=total, min_ratio=min_ratio)
    got = schedule.cosine_with_warmup(torch.as_tensor(steps), warmup=warmup,
                                      total=total, min_ratio=min_ratio)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    one = schedule.cosine_with_warmup(3, warmup=warmup, total=total,
                                      min_ratio=min_ratio)
    assert abs(float(one) - float(want[3])) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("n_steps", [1, 5])
def test_apply_updates_matches_reference(n_steps, clip, dtype):
    """``n_steps`` AdamW steps from one state, the same gradients each
    step, the schedule's scale as ``lr_scale``; with clipping on, the
    gradients are scaled so the clip binds."""
    rng = np.random.default_rng(n_steps * 10 + (clip is None))
    p0 = _draw(SHAPES, rng, 1.0)
    grads = [_draw(SHAPES, rng, 3.0) for _ in range(n_steps)]
    cfg_r = ref_adamw.AdamWConfig(clip_norm=clip, lr=1e-2)
    cfg = adamw.AdamWConfig(clip_norm=clip, lr=1e-2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    params_r = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
    state_r = ref_adamw.init_state(params_r)
    params = tree_map(lambda a: torch.tensor(a).to(tdt), p0)
    state = adamw.init_state(params)
    for i, g in enumerate(grads):
        scale_r = ref_sched.cosine_with_warmup(state_r["step"], warmup=2, total=8)
        scale = schedule.cosine_with_warmup(state["step"], warmup=2, total=8)
        params_r, state_r, met_r = ref_adamw.apply_updates(
            params_r, jax.tree.map(lambda a: jnp.asarray(a, jdt), g), state_r,
            cfg_r, scale_r + 0.5)
        params, state, met = adamw.apply_updates(
            params, tree_map(lambda a: torch.tensor(a).to(tdt), g), state, cfg,
            scale + 0.5)
        _close(_np(met["grad_norm"]), np.asarray(met_r["grad_norm"]), 1e-6)
    assert int(state["step"]) == int(state_r["step"]) == n_steps
    assert state["step"].dtype == torch.int32
    rel = 1e-6 if dtype == "float32" else 2.0 ** -8
    for got, want in zip(tree_leaves(params), jax.tree.leaves(params_r)):
        assert got.dtype == tdt
        _close(_np(got), _np(want), rel)
    for key in ("m", "v"):
        for got, want in zip(tree_leaves(state[key]), jax.tree.leaves(state_r[key])):
            assert got.dtype == torch.float32
            _close(_np(got), np.asarray(want), 1e-6 if dtype == "float32" else 1e-2)


def test_apply_updates_writes_in_place_and_global_norm():
    rng = np.random.default_rng(3)
    p0, g0 = _draw(SHAPES, rng, 1.0), _draw(SHAPES, rng, 1.0)
    params = tree_map(torch.tensor, p0)
    before = [p.data_ptr() for p in tree_leaves(params)]
    state = adamw.init_state(params)
    m_ptrs = [m.data_ptr() for m in tree_leaves(state["m"])]
    step = state["step"]
    out, state, _ = adamw.apply_updates(params, tree_map(torch.tensor, g0), state,
                                        adamw.AdamWConfig())
    assert out is params and [p.data_ptr() for p in tree_leaves(out)] == before
    assert [m.data_ptr() for m in tree_leaves(state["m"])] == m_ptrs
    assert state["step"] is step and int(step) == 1
    want = ref_adamw.global_norm(jax.tree.map(jnp.asarray, g0))
    _close(_np(adamw.global_norm(tree_map(torch.tensor, g0))), np.asarray(want), 1e-6)


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compress_tree_matches_reference(scheme):
    """Two rounds of error feedback: from no residual, then carrying the
    residual each package returned."""
    rng = np.random.default_rng(5)
    g1, g2 = _draw(SHAPES, rng, 1.0), _draw(SHAPES, rng, 1.0)
    res_r = res = None
    for g in (g1, g2):
        dec_r, res_r = ref_comp.compress_tree(jax.tree.map(jnp.asarray, g), res_r,
                                              scheme, topk_frac=0.2)
        dec, res = compression.compress_tree(tree_map(torch.tensor, g), res,
                                             scheme, topk_frac=0.2)
        for tree, tree_r in ((dec, dec_r), (res, res_r)):
            for got, want in zip(tree_leaves(tree), jax.tree.leaves(tree_r)):
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert compression.compressed_bytes(dec, scheme, 0.2) == \
        ref_comp.compressed_bytes(dec_r, scheme, 0.2)


def test_int8_and_topk_primitives_match_reference():
    x = RNG.standard_normal((7, 9)).astype(np.float32)
    q_r, s_r = ref_comp.int8_compress(jnp.asarray(x))
    q, s = compression.int8_compress(torch.tensor(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    assert float(s) == float(s_r)
    np.testing.assert_array_equal(compression.int8_decompress(q, s).numpy(),
                                  np.asarray(ref_comp.int8_decompress(q_r, s_r)))
    kept_r, idx_r, size_r = ref_comp.topk_compress(jnp.asarray(x), 0.1)
    kept, idx, size = compression.topk_compress(torch.tensor(x), 0.1)
    assert size == size_r == 63 and len(idx) == len(idx_r) == 6
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(kept_r))
    np.testing.assert_array_equal(
        compression.topk_decompress(kept, idx, size, x.shape).numpy(),
        np.asarray(ref_comp.topk_decompress(kept_r, idx_r, size_r, x.shape)))
    with pytest.raises(ValueError):
        compression.compress_tree({"a": torch.zeros(3)}, None, "fp4")


@pytest.mark.parametrize("seed,vocab,seq,batch,shards", [
    (0, 256, 32, 4, 1), (0, 49152, 256, 8, 1), (3, 97, 17, 6, 3),
    (11, 256, 64, 8, 2)])
def test_synthetic_tokens_bit_identical(seed, vocab, seq, batch, shards):
    for shard in range(shards):
        ref = ref_data.SyntheticTokens(
            ref_data.DataConfig(vocab, seq, batch, seed), shards, shard)
        port = SyntheticTokens(DataConfig(vocab, seq, batch, seed), shards, shard)
        for step in (0, 1, 17):
            got, want = port.batch(step), ref.batch(step)
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in want:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
