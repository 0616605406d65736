"""The port's dense GQA transformer against the reference's, on the same
weights (the reference's ``bundle.init``, carried across as numpy by
``lm_params_from_numpy``) and the same tokens.

Covers ``forward`` / ``prefill`` / ``decode_step`` on smollm-135m-smoke,
the batched prefill against the port's own step loop, the config flags the
coded decoder branches on (qk-norm, sandwich norms, embedding scale,
softcaps, sliding windows, GeGLU, untied head), the shared numerics of
``models/common.py`` and the init schema.

Tolerance: logits within 1e-5 of the reference relative to max|logit|
(fp32 sums in another order; on the CPU the prefill's attention is K4's
plain version).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smollm_135m as ref_smollm
from repro.models import common as ref_common
from repro.models import transformer as ref_lm
from repro.models.common import schema_init
from repro_torch.configs import smollm_135m
from repro_torch.models import common
from repro_torch.models import transformer as lm

REL = 1e-5
MAX_LEN = 32
PROMPTS = np.array([[5, 9, 2, 7, 1], [3, 3, 4, 8, 2]], np.int32)
RNG = np.random.default_rng(21)


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def smoke():
    bundle = ref_smollm.smoke()
    params = bundle.init(jax.random.PRNGKey(0), jnp.float32)
    port = lm.lm_params_from_numpy(_np_tree(params), "cpu")
    return bundle.cfg, params, smollm_135m.smoke(), port


def _toks(a):
    return torch.as_tensor(np.asarray(a)).long()


def test_config_numbers_match_reference():
    for name in ("full", "smoke"):
        ref = getattr(ref_smollm, name)().cfg
        port = getattr(smollm_135m, name)()
        for field in ("name", "layers", "d_model", "n_heads", "n_kv_heads",
                      "head_dim", "d_ff", "vocab", "act", "attn", "qk_norm",
                      "attn_softcap", "logit_softcap", "window",
                      "window_pattern", "rope_base", "tie_embeddings",
                      "embed_scale", "sandwich_norms", "max_seq"):
            assert getattr(port, field) == getattr(ref, field), (name, field)


def test_forward_matches_reference(smoke):
    cfg_r, params, cfg, port = smoke
    want = ref_lm.forward(params, cfg_r, jnp.asarray(PROMPTS))
    got = lm.forward(port, cfg, _toks(PROMPTS))
    _close(got, want)


def test_prefill_and_decode_match_reference(smoke):
    """Prefill logits and the filled K/V cache, then three decode steps."""
    cfg_r, params, cfg, port = smoke
    b, p = PROMPTS.shape
    cr = ref_lm.init_cache(cfg_r, b, MAX_LEN, jnp.float32)
    lr, cr = ref_lm.prefill(params, cfg_r, cr, jnp.asarray(PROMPTS))
    cp = lm.init_cache(cfg, b, MAX_LEN, device="cpu")
    lp, cp = lm.prefill(port, cfg, cp, _toks(PROMPTS))
    _close(lp, lr)
    for leaf in ("k", "v"):
        _close(cp["dense"][leaf], cr["dense"][leaf])
    nxt = np.argmax(np.asarray(lr)[:, -1], -1).astype(np.int32)[:, None]
    for t in range(p, p + 3):
        lr, cr = ref_lm.decode_step(params, cfg_r, cr, jnp.asarray(nxt),
                                    jnp.int32(t))
        lp, cp = lm.decode_step(port, cfg, cp, _toks(nxt), t)
        _close(lp, lr)
        nxt = np.argmax(np.asarray(lr)[:, -1], -1).astype(np.int32)[:, None]
        assert np.array_equal(lp[:, -1].argmax(-1).numpy(), nxt[:, 0])
    _close(cp["dense"]["k"], cr["dense"]["k"])


def test_prefill_matches_step_loop(smoke):
    """One batched prefill == stepping the port's decoder over the prompt
    (the reference's own invariant, ``tests/test_coded_decoder.py``)."""
    _, _, cfg, port = smoke
    b, p = PROMPTS.shape
    logits_pf, cache_pf = lm.prefill(port, cfg, lm.init_cache(cfg, b, MAX_LEN, device="cpu"),
                                     _toks(PROMPTS))
    cache_st = lm.init_cache(cfg, b, MAX_LEN, device="cpu")
    steps = []
    for t in range(p):
        lg, cache_st = lm.decode_step(port, cfg, cache_st, _toks(PROMPTS[:, t:t + 1]), t)
        steps.append(lg[:, 0])
    _close(logits_pf, torch.stack(steps, 1), rel=1e-4)
    _close(cache_pf["dense"]["k"][:, :, :p], cache_st["dense"]["k"][:, :, :p],
           rel=1e-4)


# config flags the coded decoder branches on, each on a 2-layer stack
VARIANTS = {
    "qk_norm": dict(qk_norm=True),
    "gemma_like": dict(sandwich_norms=True, embed_scale=True,
                       logit_softcap=30.0, attn_softcap=20.0),
    "alternate_window": dict(window=3, window_pattern="alternate"),
    "all_window": dict(window=4, window_pattern="all"),
    "gelu_untied": dict(act="gelu", tie_embeddings=False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_config_variants_match_reference(variant):
    kw = dict(name="v", layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              head_dim=8, d_ff=48, vocab=64, max_seq=64, **VARIANTS[variant])
    cfg_r = ref_lm.LMConfig(**kw)
    cfg = lm.LMConfig(**kw)
    params = schema_init(ref_lm.lm_schema(cfg_r), jax.random.PRNGKey(3), jnp.float32)
    # non-zero norm gains, so every (1 + gamma) scale is exercised
    params = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(4), a.shape)
        if a.ndim <= 2 and a.shape[-1] <= 32 else a, params)
    port = lm.lm_params_from_numpy(_np_tree(params), "cpu")
    toks = RNG.integers(0, 64, (2, 7)).astype(np.int32)
    _close(lm.forward(port, cfg, _toks(toks)),
           ref_lm.forward(params, cfg_r, jnp.asarray(toks)))
    cr = ref_lm.init_cache(cfg_r, 2, 16, jnp.float32)
    lr, cr = ref_lm.prefill(params, cfg_r, cr, jnp.asarray(toks))
    cp = lm.init_cache(cfg, 2, 16, device="cpu")
    lp, cp = lm.prefill(port, cfg, cp, _toks(toks))
    _close(lp, lr)
    nxt = toks[:, :1]
    lr, _ = ref_lm.decode_step(params, cfg_r, cr, jnp.asarray(nxt), jnp.int32(7))
    lp, _ = lm.decode_step(port, cfg, cp, _toks(nxt), 7)
    _close(lp, lr)


def test_unported_families_raise():
    """A config the transformer cannot build is refused when it is made."""
    base = dict(name="x", layers=1, d_model=8, n_heads=2, n_kv_heads=1,
                head_dim=4, d_ff=8, vocab=16)
    with pytest.raises(ValueError, match="MLAConfig"):
        lm.LMConfig(**base, attn="mla")
    with pytest.raises(ValueError, match="attn"):
        lm.LMConfig(**base, attn="linear")
    with pytest.raises(ValueError, match="MoEConfig"):
        lm.LMConfig(**base, moe=object())
    with pytest.raises(ValueError, match="window_pattern"):
        lm.LMConfig(**base, window_pattern="ring")


def test_init_lm_follows_reference_schema():
    """Same tree, shapes and init scales as the reference's schema (the
    jax PRNG itself is not re-implemented, so values differ)."""
    cfg_r = ref_smollm.smoke().cfg
    shapes = jax.tree.map(lambda s: s.shape, ref_smollm.smoke().param_shapes())
    params = lm.init_lm(smollm_135m.smoke(), torch.Generator().manual_seed(0), "cpu")
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    got = jax.tree.map(lambda t: tuple(t.shape), params)
    assert dict(jax.tree_util.tree_flatten_with_path(got)[0]) == flat_ref
    dl = params["dense_layers"]
    assert float(dl["ln_attn"].abs().max()) == 0.0
    assert float(params["ln_f"].abs().max()) == 0.0
    std = float(dl["wq"].std())
    assert abs(std - cfg_r.d_model ** -0.5) < 0.1 * cfg_r.d_model ** -0.5
    assert abs(float(params["embed"].std()) - 0.02) < 0.002
    again = lm.init_lm(smollm_135m.smoke(), torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["dense_layers"]["wq"], dl["wq"])


def test_common_numerics_match_reference():
    x = RNG.standard_normal((2, 5, 3, 8)).astype(np.float32)
    gamma = RNG.standard_normal(8).astype(np.float32)
    _close(common.rms_norm(torch.as_tensor(x), torch.as_tensor(gamma)),
           ref_common.rms_norm(jnp.asarray(x), jnp.asarray(gamma)))
    inv = common.rope_inv_freq(8, 10000.0)
    _close(inv, ref_common.rope_inv_freq(8, 10000.0))
    pos = RNG.integers(0, 40, (2, 5)).astype(np.int32)
    _close(common.apply_rope(torch.as_tensor(x), inv, torch.as_tensor(pos)),
           ref_common.apply_rope(jnp.asarray(x), ref_common.rope_inv_freq(8),
                                 jnp.asarray(pos)))
    kp = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    for window in (None, 3):
        got = common.make_attn_mask(torch.as_tensor(pos), torch.as_tensor(kp), window)
        want = ref_common.make_attn_mask(jnp.asarray(pos), jnp.asarray(kp), window)
        assert np.array_equal(got.numpy(), np.asarray(want))
    k = RNG.standard_normal((2, 9, 1, 8)).astype(np.float32)
    v = RNG.standard_normal((2, 9, 1, 8)).astype(np.float32)
    mask = ref_common.make_attn_mask(jnp.asarray(pos), jnp.asarray(kp))
    for cap in (None, 5.0):
        _close(common.attention(torch.as_tensor(x), torch.as_tensor(k),
                                torch.as_tensor(v), torch.as_tensor(np.array(mask)),
                                attn_softcap=cap),
               ref_common.attention(jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
                                    mask, attn_softcap=cap))
