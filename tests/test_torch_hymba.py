"""Hymba through the port (``repro_torch.models.hymba`` and its bundle)
against the JAX package's ``repro.models.hymba`` at the smoke config (2
layers, d_model 64, 4 / 2 heads of 16, 8 SSM heads of state 8, window 16,
chunks of 8), on the reference's ``schema_init`` weights carried across by
``params_from_numpy`` and numpy-seeded tokens.

Covers the shapes, ``forward`` over 13 tokens (K4's route, a padded scan
tail) and 20 (past the window: the plain masked route), ``decode_step``
over 14 tokens against the reference's, the reference's 20-step ring wrap
(window 8) token by token and against ``forward`` once both layers'
rings are clean, the
port's decode against the reference's from a random full ring, the ring
slots not written yet (zero keys in both decodes), the SSM carry,
softplus, ``lm_loss`` with every gradient leaf against
``jax.value_and_grad``, and the bundle's four functions.

Tolerances (fp32, sums in another order): logits and states within 1e-5
of their max, the loss within 1e-6 relative, each gradient leaf within
1e-5 of its max|g| (against a float64 run of the port both fp32 runs are
near 1e-6 off).  Decode against forward sums attention and the scan
another way through two layers: 1e-4 of max|logit|, as the reference's
own decode-consistency test allows more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (both, check_loss_and_grads, close, port_scales,
                             port_shapes, reference_params, rel_err,
                             schema_scales, schema_shapes, t)
from repro.configs import get_bundle as ref_get_bundle
from repro.models import hymba as ref_hymba
from repro.models.common import count_params
from repro_torch.configs import get_bundle
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import hymba, transformer
from repro_torch.models.registry import with_layers

REL, LOSS_REL, GRAD_REL, DECODE_REL = 1e-5, 1e-6, 1e-5, 1e-4
B, STEPS = 2, 14
ARCH = "hymba-1.5b"
# the reference's own ring-wrap case (tests/test_decode_consistency.py)
WRAP = dict(name="h", layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab=101, ssm_state=8, window=8, chunk=8)


@pytest.fixture(scope="module")
def setup():
    rb = ref_get_bundle(ARCH, smoke=True)
    pb = get_bundle(ARCH, smoke=True)
    p_np = reference_params(rb.schema, 0)
    toks = np.random.default_rng(2).integers(0, pb.cfg.vocab, (B, 20)).astype(np.int32)
    return rb, pb, p_np, toks


@pytest.fixture(scope="module")
def wrap():
    cfg_r = ref_hymba.HymbaConfig(**WRAP)
    p_np = reference_params(ref_hymba.hymba_schema(cfg_r), 3)
    toks = np.random.default_rng(3).integers(0, 101, (1, 28)).astype(np.int32)
    return cfg_r, hymba.HymbaConfig(**WRAP), p_np, toks


def test_config_and_shapes_are_the_references():
    for smoke in (False, True):
        rb, pb = ref_get_bundle(ARCH, smoke=smoke), get_bundle(ARCH, smoke=smoke)
        assert (pb.name, pb.family, pb.sub_quadratic, pb.has_decoder) == (
            rb.name, rb.family, rb.sub_quadratic, rb.has_decoder) == (
            pb.name, "hybrid", True, True)
        assert pb.prefill_cache_fn is None and rb.prefill_cache_fn is None
        assert port_shapes(pb.shapes) == schema_shapes(rb.schema)
        assert port_scales(pb.shapes) == schema_scales(rb.schema)
        assert pb.cfg.ssm_heads == rb.cfg.ssm_heads
    # several SSM heads at the smoke size, where jnp.repeat and a tiling differ
    assert get_bundle(ARCH, smoke=True).cfg.ssm_heads == 128 // 16 == 8
    full = get_bundle(ARCH).cfg
    assert (full.layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.ssm_heads, full.window) == (32, 1600, 25, 5, 64, 50, 1024)
    n = sum(int(np.prod(s)) for s in port_shapes(get_bundle(ARCH).shapes).values())
    assert n == count_params(ref_get_bundle(ARCH).schema)


@pytest.mark.parametrize("s,route", [(13, "k4"), (20, "plain")])
def test_forward_matches_reference(setup, monkeypatch, s, route):
    """13 tokens fit the window of 16 (K4's route; on the CPU its plain
    version), 20 do not (the masked route with the window)."""
    rb, pb, p_np, toks = setup
    pj, pt = both(p_np)
    seen = []
    real = transformer.flash_attention
    monkeypatch.setattr(transformer, "flash_attention",
                        lambda *a, **kw: seen.append(kw["rep"]) or real(*a, **kw))
    assert transformer.attend_route(s, s, 16, 16, window=pb.cfg.window,
                                    start=0) == route
    got = hymba.forward(pt, pb.cfg, t(toks[:, :s]))
    assert seen == ([2, 2] if route == "k4" else [])
    close(got.numpy(), ref_hymba.forward(pj, rb.cfg, jnp.asarray(toks[:, :s])), REL)


def test_decode_steps_match_reference(setup):
    """14 steps from ``init_state`` (a ring of 16 slots, never full): each
    step's logits against the reference's ``decode_step``, then the whole
    state, KV ring, conv tails and SSM states."""
    rb, pb, p_np, toks = setup
    pj, pt = both(p_np)
    st = hymba.init_state(pb.cfg, B, 32, torch.float32, "cpu")
    sr = ref_hymba.init_state(rb.cfg, B, 32, jnp.float32)
    for i in range(STEPS):
        lg, st = hymba.decode_step(pt, pb.cfg, st, t(toks[:, i:i + 1]), i)
        lr, sr = ref_hymba.decode_step(pj, rb.cfg, sr, jnp.asarray(toks[:, i:i + 1]),
                                       jnp.int32(i))
        close(lg.numpy(), lr, REL)
    close(st["kv"]["k"].numpy(), sr["kv"]["k"], REL)
    close(st["kv"]["v"].numpy(), sr["kv"]["v"], REL)
    close(st["conv"].numpy(), sr["conv"], REL)
    close(st["s"].numpy(), sr["s"], REL)


def test_ring_wrap_over_20_steps(wrap):
    """The reference's case: window 8, a cache of 64 positions (a ring of
    8 slots), 20 steps.  Each step's logits against the reference's
    ``decode_step``, token by token; from step 14 on also against the
    reference's ``forward``: both decodes attend over zero keys in the
    unwritten slots until step 7, and the second layer's ring holds keys
    written from those steps until step 2 x 7 = 14.  The final state
    against the reference's."""
    cfg_r, cfg, p_np, toks = wrap
    pj, pt = both(p_np)
    want = ref_hymba.forward(pj, cfg_r, jnp.asarray(toks[:, :20]))
    st = hymba.init_state(cfg, 1, 64, torch.float32, "cpu")
    sr = ref_hymba.init_state(cfg_r, 1, 64, jnp.float32)
    assert st["kv"]["k"].shape[2] == sr["kv"]["k"].shape[2] == 8
    for i in range(20):
        lg, st = hymba.decode_step(pt, cfg, st, t(toks[:, i:i + 1]), i)
        lr, sr = ref_hymba.decode_step(pj, cfg_r, sr, jnp.asarray(toks[:, i:i + 1]),
                                       jnp.int32(i))
        close(lg.numpy(), lr, REL)
        if i >= 14:
            close(lg[:, 0].numpy(), want[:, i], DECODE_REL)
    close(st["kv"]["k"].numpy(), sr["kv"]["k"], REL)
    close(st["s"].numpy(), sr["s"], REL)


def test_decode_from_a_full_ring_matches_reference_token_by_token(wrap):
    """From one random state with every ring slot written (position 8 on
    a ring of 8), 20 steps (the ring wraps twice): every step's logits and
    the final state, KV ring included, against the reference's
    ``decode_step``."""
    cfg_r, cfg, p_np, toks = wrap
    pj, pt = both(p_np)
    rng = np.random.default_rng(4)
    sr = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                      jax.tree.map(np.asarray, ref_hymba.init_state(
                          cfg_r, 1, 64, jnp.float32)))
    st = {"kv": {k: t(v).clone() for k, v in sr["kv"].items()},
          "conv": t(sr["conv"]).clone(), "s": t(sr["s"]).clone()}
    sr = jax.tree.map(jnp.asarray, sr)
    for pos in range(8, 28):
        lg, st = hymba.decode_step(pt, cfg, st, t(toks[:, pos:pos + 1]), pos)
        lr, sr = ref_hymba.decode_step(pj, cfg_r, sr, jnp.asarray(toks[:, pos:pos + 1]),
                                       jnp.int32(pos))
        close(lg.numpy(), lr, REL)
    close(st["kv"]["k"].numpy(), sr["kv"]["k"], REL)
    close(st["kv"]["v"].numpy(), sr["kv"]["v"], REL)
    close(st["conv"].numpy(), sr["conv"], REL)
    close(st["s"].numpy(), sr["s"], REL)


def test_unwritten_ring_slots_are_zero_keys(wrap):
    """The reference rebuilds an unwritten slot's position below zero and
    its window keeps it, so its early steps attend over zero keys that its
    own ``forward`` never sees (step 2 of the wrap case reads well off
    it).  The port does the same: its step 2 is the reference's, off
    ``forward`` as far."""
    cfg_r, cfg, p_np, toks = wrap
    pj, pt = both(p_np)
    assert hymba.ring_key_positions(2, 8, "cpu").tolist() == [0, 1, 2, -5, -4, -3,
                                                              -2, -1]
    want = ref_hymba.forward(pj, cfg_r, jnp.asarray(toks[:, :3]))
    st = hymba.init_state(cfg, 1, 64, torch.float32, "cpu")
    sr = ref_hymba.init_state(cfg_r, 1, 64, jnp.float32)
    for i in range(3):
        lg, st = hymba.decode_step(pt, cfg, st, t(toks[:, i:i + 1]), i)
        lr, sr = ref_hymba.decode_step(pj, cfg_r, sr, jnp.asarray(toks[:, i:i + 1]),
                                       jnp.int32(i))
    assert rel_err(lr[:, 0], want[:, 2]) > 1e-2
    assert rel_err(lg[:, 0].numpy(), want[:, 2]) > 1e-2
    close(lg.numpy(), lr, REL)


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; the port's agrees past
    ``F.softplus``'s threshold of 20 too."""
    x = np.linspace(-40.0, 60.0, 1001).astype(np.float32)
    close(hymba._softplus(t(x)).numpy(), jax.nn.softplus(jnp.asarray(x)), 1e-7)


def test_loss_and_every_gradient_leaf_match_reference(setup):
    rb, pb, p_np, toks = setup
    batch = {"tokens": toks[:, :13], "labels": np.roll(toks[:, :13], -1, axis=1)}
    n = check_loss_and_grads(rb.loss_fn, pb.loss_fn, p_np, batch, LOSS_REL, GRAD_REL)
    assert n == 2 + 18


def test_bundle_functions_match_reference(setup):
    """``prefill_fn`` and ``loss_fn`` against the reference bundle's;
    ``make_cache``'s ring of ``min(max_len, window)`` slots; ``decode_fn``
    over 12 steps against the reference's; a bundle cut to one layer."""
    rb, pb, p_np, toks = setup
    pj, pt = both(p_np)
    want = rb.prefill_fn(pj, {"tokens": jnp.asarray(toks[:, :12])})
    close(pb.prefill_fn(pt, {"tokens": t(toks[:, :12])}).numpy(), want, REL)
    for max_len, ring in ((12, 12), (64, 16)):
        cache = pb.make_cache(B, max_len, torch.float32, "cpu")
        cr = rb.make_cache(B, max_len, jnp.float32)
        assert jax.tree.map(lambda a: tuple(a.shape), cr) == {
            "kv": {k: tuple(v.shape) for k, v in cache["kv"].items()},
            "conv": tuple(cache["conv"].shape), "s": tuple(cache["s"].shape)}
        assert cache["kv"]["k"].shape[2] == ring
    for i in range(12):
        lg, cache = pb.decode_fn(pt, cache, {"tokens": t(toks[:, i:i + 1]), "pos": i})
        lr, cr = rb.decode_fn(pj, cr, {"tokens": jnp.asarray(toks[:, i:i + 1]),
                                       "pos": jnp.int32(i)})
        close(lg.numpy(), lr, REL)
    batch = {"tokens": toks[:, :12], "labels": toks[:, 1:13]}
    close(float(pb.loss_fn(pt, {k: t(v) for k, v in batch.items()})),
          float(rb.loss_fn(pj, {k: jnp.asarray(v) for k, v in batch.items()})),
          LOSS_REL)
    one = with_layers(pb, 1)
    assert one.family == "hybrid" and one.cfg.layers == 1
    assert port_shapes(one.shapes)[("layers", "wq")] == (1, 64, 64)
    with pytest.raises(ValueError, match="has 2 layers"):
        with_layers(pb, 3)


def test_entry_points_run_on_cpu(capsys):
    """The serve CLI (``serve_lm``: the prompt stepped through
    ``decode_fn``) and the train CLI on the smoke config."""
    serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "5", "--gen", "3"])
    train_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                    "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out
    assert f"{ARCH}: prefill 5 toks" in out and "first loss" in out
