"""RWKV6 through the port (``repro_torch.models.rwkv6`` and its bundle)
against the JAX package's ``repro.models.rwkv6`` at the smoke config (2
layers, d_model 64, 4 heads of 16, chunks of 8), on the reference's
``schema_init`` weights carried across by ``params_from_numpy`` and
numpy-seeded tokens.

Covers the shapes, ``forward`` over 13 tokens (a chunk carry and a padded
tail), ``decode_step`` over 14 tokens (logits and state), decode against
forward (also in float64, to 1e-12), the decay's clip at both ends, the shift carry (the normed
input, not the residual), ``lm_loss`` with every gradient leaf against
``jax.value_and_grad``, and the bundle's four functions.

Tolerances (fp32, sums in another order): logits and states within 1e-5
of their max, the loss within 1e-6 relative, each gradient leaf within
1e-4 of its max|g| (against a float64 run of the port, the reference's
fp32 gradients are 2e-6 to 3e-5 of max|g| off and the port's 2e-6 to
6e-5: rounding of the two fp32 runs, not a difference of function).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import (both, check_loss_and_grads, close, port_scales,
                             port_shapes, reference_params, schema_scales,
                             schema_shapes, t)
from repro.configs import get_bundle as ref_get_bundle
from repro.models import rwkv6 as ref_rwkv
from repro.models.common import count_params
from repro_torch.configs import get_bundle
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import rwkv6
from repro_torch.models.common import rms_norm

REL, LOSS_REL, GRAD_REL = 1e-5, 1e-6, 1e-4
B, T, STEPS = 2, 13, 14
ARCH = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def setup():
    rb = ref_get_bundle(ARCH, smoke=True)
    pb = get_bundle(ARCH, smoke=True)
    p_np = reference_params(rb.schema, 0)
    toks = np.random.default_rng(1).integers(0, pb.cfg.vocab, (B, STEPS)).astype(np.int32)
    return rb, pb, p_np, toks


def test_config_and_shapes_are_the_references():
    for smoke in (False, True):
        rb, pb = ref_get_bundle(ARCH, smoke=smoke), get_bundle(ARCH, smoke=smoke)
        assert (pb.name, pb.family, pb.sub_quadratic, pb.has_decoder) == (
            rb.name, rb.family, rb.sub_quadratic, rb.has_decoder) == (
            pb.name, "ssm", True, True)
        assert pb.prefill_cache_fn is None and rb.prefill_cache_fn is None
        assert port_shapes(pb.schema) == schema_shapes(rb.schema)
        assert port_scales(pb.schema) == schema_scales(rb.schema)
    full = get_bundle(ARCH).cfg
    assert (full.layers, full.d_model, full.n_heads, full.d_ff, full.vocab) == (
        24, 2048, 32, 7168, 65536)
    n = sum(int(np.prod(s)) for s in port_shapes(get_bundle(ARCH).schema).values())
    assert n == count_params(ref_get_bundle(ARCH).schema) == 1_449_723_904


def test_forward_matches_reference(setup):
    rb, pb, p_np, toks = setup
    pj, pt = both(p_np)
    got = rwkv6.forward(pt, pb.cfg, t(toks[:, :T]))
    want = ref_rwkv.forward(pj, rb.cfg, jnp.asarray(toks[:, :T]))
    assert got.dtype == torch.float32 and got.shape == (B, T, pb.cfg.vocab)
    close(got.numpy(), want, REL)


def test_decode_steps_match_reference(setup):
    """14 steps from the zero state: each step's logits, and the final
    state leaf by leaf, against the reference's ``decode_step``."""
    rb, pb, p_np, toks = setup
    pj, pt = both(p_np)
    st = rwkv6.init_state(pb.cfg, B, torch.float32, "cpu")
    sr = ref_rwkv.init_state(rb.cfg, B, jnp.float32)
    for i in range(STEPS):
        lg, st = rwkv6.decode_step(pt, pb.cfg, st, t(toks[:, i:i + 1]), i)
        lr, sr = ref_rwkv.decode_step(pj, rb.cfg, sr, jnp.asarray(toks[:, i:i + 1]),
                                      jnp.int32(i))
        close(lg.numpy(), lr, REL)
    for key in ("xa", "xf", "s"):
        close(st[key].numpy(), sr[key], REL)


def test_decode_agrees_with_forward(setup):
    """Stepping the recurrence reproduces the chunked forward position by
    position (13 = one chunk of 8 carried into a padded one)."""
    _, pb, p_np, toks = setup
    _, pt = both(p_np)
    full = rwkv6.forward(pt, pb.cfg, t(toks[:, :T]))
    st = rwkv6.init_state(pb.cfg, B, torch.float32, "cpu")
    for i in range(T):
        lg, st = rwkv6.decode_step(pt, pb.cfg, st, t(toks[:, i:i + 1]), i)
        close(lg[:, 0].numpy(), full[:, i].numpy(), REL)


def test_float64_params_stay_float64_and_decode_agrees_with_forward(setup):
    """Float64 params compute in float64 throughout (the norms, gates, the
    scan and its state, the logits), as ``chip_smoke.py``'s full-depth
    witness needs; there stepping the recurrence reproduces the chunked
    forward over 21 steps (two chunk carries, a padded tail) within
    1e-12 of max|logit|, where fp32 rounding would read near 1e-7."""
    _, pb, p_np, _ = setup
    pt = {k: v for k, v in both(p_np)[1].items()}
    p64 = {**pt, "embed": pt["embed"].double(), "ln_f": pt["ln_f"].double(),
           "layers": {k: v.double() for k, v in pt["layers"].items()}}
    toks = np.random.default_rng(5).integers(0, pb.cfg.vocab, (B, 21))
    full = rwkv6.forward(p64, pb.cfg, t(toks))
    st = rwkv6.init_state(pb.cfg, B, torch.float64, "cpu")
    assert full.dtype == st["s"].dtype == torch.float64
    rows = []
    for i in range(21):
        lg, st = rwkv6.decode_step(p64, pb.cfg, st, t(toks[:, i:i + 1]), i)
        rows.append(lg[:, 0])
    assert st["s"].dtype == torch.float64
    close(torch.stack(rows, 1).numpy(), full.numpy(), 1e-12)


def test_shift_carry_is_the_normed_input(setup):
    """After one step the first layer's time-mix carry is
    ``rms_norm(embed[token], ln_att)``, not the embedding itself."""
    _, pb, p_np, toks = setup
    _, pt = both(p_np)
    st = rwkv6.init_state(pb.cfg, B, torch.float32, "cpu")
    _, st = rwkv6.decode_step(pt, pb.cfg, st, t(toks[:, :1]), 0)
    x = pt["embed"][t(toks[:, 0]).long()]
    normed = rms_norm(x, pt["layers"]["ln_att"][0])
    close(st["xa"][0].numpy(), normed.numpy(), 1e-7)
    assert not torch.allclose(st["xa"][0], x)


def test_decay_clips_at_both_ends(setup):
    """``w0`` pushed far past the clip (+30 on some channels, -30 on
    others): the decay is ``-exp(clip(., -8, 4))`` in fp32, as the
    reference's, over forward and decode."""
    rb, pb, p_np, toks = setup
    p2 = jax.tree.map(np.copy, p_np)
    w0 = p2["layers"]["w0"]
    w0[:, ::3] = 30.0
    w0[:, 1::3] = -30.0
    pj, pt = both(p2)
    close(rwkv6.forward(pt, pb.cfg, t(toks[:, :T])).numpy(),
          ref_rwkv.forward(pj, rb.cfg, jnp.asarray(toks[:, :T])), REL)
    st = rwkv6.init_state(pb.cfg, B, torch.float32, "cpu")
    sr = ref_rwkv.init_state(rb.cfg, B, jnp.float32)
    for i in range(3):
        lg, st = rwkv6.decode_step(pt, pb.cfg, st, t(toks[:, i:i + 1]), i)
        lr, sr = ref_rwkv.decode_step(pj, rb.cfg, sr, jnp.asarray(toks[:, i:i + 1]),
                                      jnp.int32(i))
    close(lg.numpy(), lr, REL)
    close(st["s"].numpy(), sr["s"], REL)


def test_loss_and_every_gradient_leaf_match_reference(setup):
    rb, pb, p_np, toks = setup
    batch = {"tokens": toks[:, :T], "labels": np.roll(toks[:, :T], -1, axis=1)}
    n = check_loss_and_grads(rb.loss_fn, pb.loss_fn, p_np, batch, LOSS_REL, GRAD_REL)
    assert n == 2 + 22  # embed, ln_f and the 22 stacked layer leaves


def test_bundle_functions_match_reference(setup):
    """``prefill_fn``, ``decode_fn`` (12 steps from ``make_cache``),
    ``loss_fn`` and ``make_cache`` against the reference bundle's."""
    rb, pb, p_np, toks = setup
    pj, pt = both(p_np)
    close(pb.prefill_fn(pt, {"tokens": t(toks[:, :T])}).numpy(),
          rb.prefill_fn(pj, {"tokens": jnp.asarray(toks[:, :T])}), REL)
    cache = pb.make_cache(B, 32, torch.float32, "cpu")
    cr = rb.make_cache(B, 32, jnp.float32)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (v.shape, {jnp.float32: torch.float32}[v.dtype.type])
        for k, v in cr.items()}
    for i in range(12):
        lg, cache = pb.decode_fn(pt, cache, {"tokens": t(toks[:, i:i + 1]), "pos": i})
        lr, cr = rb.decode_fn(pj, cr, {"tokens": jnp.asarray(toks[:, i:i + 1]),
                                       "pos": jnp.int32(i)})
        close(lg.numpy(), lr, REL)
    batch = {"tokens": toks[:, :T], "labels": toks[:, 1:T + 1]}
    close(float(pb.loss_fn(pt, {k: t(v) for k, v in batch.items()})),
          float(rb.loss_fn(pj, {k: jnp.asarray(v) for k, v in batch.items()})),
          LOSS_REL)


def test_entry_points_run_on_cpu(capsys):
    """The serve CLI (``serve_lm``: the prompt stepped through
    ``decode_fn``) and the train CLI on the smoke config."""
    serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "5", "--gen", "3"])
    train_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                    "--batch", "2", "--seq", "8"])
    out = capsys.readouterr().out
    assert f"{ARCH}: prefill 5 toks" in out and "first loss" in out
