"""Whisper through the port (``repro_torch.models.whisper`` and its bundle)
against the JAX package's ``repro.models.whisper`` at the smoke config
(2 + 2 layers, d_model 64, 4 heads of 16, 12 encoder frames), on the
reference's ``schema_init`` weights carried across by
``params_from_numpy``, numpy-seeded frames and tokens.

Covers the shapes, ``encode``, ``decode`` and ``forward``,
``precompute_cross_kv``, ``decode_step`` over 14 tokens from a cache with
the encoder's cross K/V (logits and cache), the decoder's K4 route,
``lm_loss`` with every gradient leaf against ``jax.value_and_grad``, the
bundle's four functions and ``with_layers``, and two planted faults the
comparison must catch: an erf GELU for the tanh one, and the decoder's
positional embedding added without its bf16 rounding.

Tolerances (fp32, sums in another order): values within 1e-5 of their
max, the loss within 1e-6 relative, each gradient leaf within 1e-5 of its
max|g| (both fp32 runs are near 1e-6 off a float64 run of the port).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_families import (both, check_loss_and_grads, close, port_scales,
                             port_shapes, reference_params, rel_err,
                             schema_scales, schema_shapes, t)
from repro.configs import get_bundle as ref_get_bundle
from repro.models import whisper as ref_whisper
from repro.models.common import count_params
from repro_torch.configs import get_bundle
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer, whisper
from repro_torch.models.registry import with_layers

REL, LOSS_REL, GRAD_REL = 1e-5, 1e-6, 1e-5
B, S, STEPS = 2, 10, 14
ARCH = "whisper-medium"


@pytest.fixture(scope="module")
def setup():
    rb = ref_get_bundle(ARCH, smoke=True)
    pb = get_bundle(ARCH, smoke=True)
    p_np = reference_params(rb.schema, 0)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, pb.cfg.vocab, (B, STEPS + 1)).astype(np.int32)
    frames = rng.standard_normal((B, pb.cfg.enc_len, pb.cfg.d_model)).astype(np.float32)
    return rb, pb, p_np, toks, frames


def test_config_and_shapes_are_the_references():
    for smoke in (False, True):
        rb, pb = ref_get_bundle(ARCH, smoke=smoke), get_bundle(ARCH, smoke=smoke)
        assert (pb.name, pb.family, pb.sub_quadratic, pb.has_decoder) == (
            rb.name, rb.family, rb.sub_quadratic, rb.has_decoder) == (
            pb.name, "encdec", False, True)
        assert pb.prefill_cache_fn is None and rb.prefill_cache_fn is None
        assert port_shapes(pb.schema) == schema_shapes(rb.schema)
        assert port_scales(pb.schema) == schema_scales(rb.schema)
    full = get_bundle(ARCH).cfg
    assert (full.enc_layers, full.dec_layers, full.d_model, full.head_dim,
            full.enc_len, full.vocab) == (24, 24, 1024, 64, 1500, 51865)
    n = sum(int(np.prod(s)) for s in port_shapes(get_bundle(ARCH).schema).values())
    assert n == count_params(ref_get_bundle(ARCH).schema)


def test_encode_decode_and_forward_match_reference(setup, monkeypatch):
    """``encode`` (bidirectional), ``decode`` over the encoder's states
    (causal self-attention on K4's route, each decoder layer one launch;
    on the CPU its plain version) and ``forward``."""
    rb, pb, p_np, toks, frames = setup
    pj, pt = both(p_np)
    enc = whisper.encode(pt, pb.cfg, t(frames))
    enc_r = ref_whisper.encode(pj, rb.cfg, jnp.asarray(frames))
    close(enc.numpy(), enc_r, REL)
    seen = []
    real = transformer.flash_attention
    monkeypatch.setattr(transformer, "flash_attention",
                        lambda *a, **kw: seen.append(a[0].shape) or real(*a, **kw))
    dec = whisper.decode(pt, pb.cfg, t(toks[:, :S]), enc)
    assert seen == [(B * 4, S, 16)] * 2
    close(dec.numpy(), ref_whisper.decode(pj, rb.cfg, jnp.asarray(toks[:, :S]), enc_r),
          REL)
    close(whisper.forward(pt, pb.cfg, t(frames), t(toks[:, :S])).numpy(),
          ref_whisper.forward(pj, rb.cfg, jnp.asarray(frames), jnp.asarray(toks[:, :S])),
          REL)


def test_precompute_cross_kv_matches_reference(setup):
    rb, pb, p_np, toks, frames = setup
    pj, pt = both(p_np)
    enc = whisper.encode(pt, pb.cfg, t(frames))
    cache = whisper.precompute_cross_kv(
        pt, pb.cfg, enc, whisper.init_cache(pb.cfg, B, 16, torch.float32, "cpu"))
    cr = ref_whisper.precompute_cross_kv(
        pj, rb.cfg, ref_whisper.encode(pj, rb.cfg, jnp.asarray(frames)),
        ref_whisper.init_cache(rb.cfg, B, 16, jnp.float32))
    for key in ("ck", "cv"):
        close(cache[key].numpy(), cr[key], REL)
    assert not cache["k"].any() and not cache["v"].any()


def test_decode_steps_match_reference(setup):
    """14 decode steps from a cache with the encoder's cross K/V: each
    step's logits and the final self-KV cache against the reference's
    ``decode_step``, and the logits against the teacher-forced
    ``decode``."""
    rb, pb, p_np, toks, frames = setup
    pj, pt = both(p_np)
    enc = whisper.encode(pt, pb.cfg, t(frames))
    enc_r = ref_whisper.encode(pj, rb.cfg, jnp.asarray(frames))
    cache = whisper.precompute_cross_kv(
        pt, pb.cfg, enc, whisper.init_cache(pb.cfg, B, 16, torch.float32, "cpu"))
    cr = ref_whisper.precompute_cross_kv(
        pj, rb.cfg, enc_r, ref_whisper.init_cache(rb.cfg, B, 16, jnp.float32))
    teacher = whisper.decode(pt, pb.cfg, t(toks[:, :STEPS]), enc)
    for i in range(STEPS):
        lg, cache = whisper.decode_step(pt, pb.cfg, cache, t(toks[:, i:i + 1]), i)
        lr, cr = ref_whisper.decode_step(pj, rb.cfg, cr, jnp.asarray(toks[:, i:i + 1]),
                                         jnp.int32(i))
        close(lg.numpy(), lr, REL)
        close(lg[:, 0].numpy(), teacher[:, i].numpy(), 1e-4)
    close(cache["k"].numpy(), cr["k"], REL)
    close(cache["v"].numpy(), cr["v"], REL)


def _erf_gelu(x):
    return F.gelu(x)


def _unrounded_pos_dec(params, start, s):
    return params["pos_dec"][start:start + s][None]


@pytest.mark.parametrize("fault,fn", [("_gelu", _erf_gelu),
                                      ("_pos_dec", _unrounded_pos_dec)],
                         ids=["erf_gelu", "pos_dec_not_rounded"])
def test_planted_fault_is_caught(setup, monkeypatch, fault, fn):
    """With the fault planted the forward leaves the reference's by more
    than the tolerance the port is held to; without it, it is inside."""
    rb, pb, p_np, toks, frames = setup
    pj, pt = both(p_np)
    want = ref_whisper.forward(pj, rb.cfg, jnp.asarray(frames), jnp.asarray(toks[:, :S]))
    assert rel_err(whisper.forward(pt, pb.cfg, t(frames), t(toks[:, :S])), want) <= REL
    monkeypatch.setattr(whisper, fault, fn)
    assert rel_err(whisper.forward(pt, pb.cfg, t(frames), t(toks[:, :S])), want) > 10 * REL


def test_loss_and_every_gradient_leaf_match_reference(setup):
    rb, pb, p_np, toks, frames = setup
    batch = {"frames": frames, "tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    n = check_loss_and_grads(rb.loss_fn, pb.loss_fn, p_np, batch, LOSS_REL, GRAD_REL)
    assert n == 5 + 8 + 13  # top level, encoder layer, decoder layer leaves


def test_bundle_functions_match_reference(setup):
    """``prefill_fn``, ``loss_fn``, ``make_cache`` (zero cross K/V, as the
    reference's serve loop decodes over) and ``decode_fn`` over 12 steps
    against the reference bundle's; ``with_layers`` cuts both stacks."""
    rb, pb, p_np, toks, frames = setup
    pj, pt = both(p_np)
    bt = {"frames": t(frames), "tokens": t(toks[:, :S]), "labels": t(toks[:, 1:S + 1])}
    br = {k: jnp.asarray(v.numpy()) for k, v in bt.items()}
    close(pb.prefill_fn(pt, bt).numpy(), rb.prefill_fn(pj, br), REL)
    close(float(pb.loss_fn(pt, bt)), float(rb.loss_fn(pj, br)), LOSS_REL)
    cache = pb.make_cache(B, 16, torch.float32, "cpu")
    cr = rb.make_cache(B, 16, jnp.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in cr.items()}
    assert not any(v.any() for v in cache.values())
    for i in range(12):
        lg, cache = pb.decode_fn(pt, cache, {"tokens": t(toks[:, i:i + 1]), "pos": i})
        lr, cr = rb.decode_fn(pj, cr, {"tokens": jnp.asarray(toks[:, i:i + 1]),
                                       "pos": jnp.int32(i)})
        close(lg.numpy(), lr, REL)
    cut = with_layers(pb, 1)
    assert (cut.family, cut.cfg.enc_layers, cut.cfg.dec_layers) == ("encdec", 1, 1)
    assert port_shapes(cut.schema)[("enc_layers", "w_up")] == (1, 64, 128)
    with pytest.raises(ValueError, match="encoder has 2 layers"):
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


def test_train_draws_seeded_frames(monkeypatch):
    """``train`` gives an encoder-decoder batch its frames (batch, enc_len,
    d_model) in the param dtype, drawn from a CPU generator seeded with
    ``seed + 1 + step``."""
    bundle = get_bundle(ARCH, smoke=True)
    seen = []
    real = bundle.loss_fn

    def loss_fn(params, batch):
        seen.append(batch["frames"].clone())
        return real(params, batch)

    bundle.loss_fn = loss_fn
    monkeypatch.setattr(train_mod, "get_bundle", lambda arch, smoke: bundle)
    losses = train_mod.train(ARCH, steps=2, batch=2, seq=8, smoke=True, seed=5,
                             device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    for step, frames in enumerate(seen):
        want = torch.randn((2, 12, 64), generator=torch.Generator().manual_seed(6 + step))
        assert frames.dtype == torch.float32 and torch.equal(frames, want)
