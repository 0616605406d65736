"""The reference's transformer archs through the port: DeepSeek-V2/V3 (MLA
+ MoE), Qwen3-4B, CodeQwen1.5-7B, Gemma2-9B and PaliGemma-3B at their
smoke sizes, on the reference's own ``bundle.init`` weights (carried
across as numpy by ``lm_params_from_numpy``) and numpy-seeded tokens.

Covers each bundle's ``prefill_fn`` (PaliGemma's with its stub prefix),
``prefill_cache_fn``, ``decode_fn`` over 12 steps and ``loss_fn``; the
reference's decode-consistency cases; the cache writes the reference picks
between (``_ring_write``'s select and its dynamic-update-slice); the
serving route's attention choice by shape; ``init_lm``'s per-leaf draw;
``get_bundle`` with keyword arguments; the entry points on every id; and
the coded decoder's refusals.

Tolerances (fp32, sums in another order): logits within 1e-4 of
max|logit|, the loss within 1e-5 relative, caches within 1e-5 of their
max.
"""
import dataclasses
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as ref_get_bundle
from repro.core.decoder_pipeline import build_lm_decoder_pipeline as ref_build_decoder
from repro.models import transformer as ref_lm
from repro.models.common import ParamSpec, schema_init
from repro_torch.configs import ARCH_IDS, get_bundle
from repro_torch.core.decoder_pipeline import build_lm_decoder_pipeline
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import moe, whisper
from repro_torch.models import transformer as lm
from repro_torch.tree import tree_items

REL, LOSS_REL, CACHE_REL = 1e-4, 1e-5, 1e-5
# the transformer archs beside SmolLM (RWKV6, Hymba and Whisper have files
# of their own)
NEW_ARCHS = [a for a in ARCH_IDS if a != "smollm-135m"
             and get_bundle(a, smoke=True).family in ("lm", "vlm")]
B, S, STEPS, MAX_LEN, PREFIX = 2, 12, 12, 16, 8


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _port_cfg(ref_cfg) -> lm.LMConfig:
    """The port's ``LMConfig`` with every field of a reference one."""
    kw = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
    if kw["mla"] is not None:
        kw["mla"] = lm.MLAConfig(**dataclasses.asdict(kw["mla"]))
    if kw["moe"] is not None:
        kw["moe"] = moe.MoEConfig(**dataclasses.asdict(kw["moe"]))
    return lm.LMConfig(**kw)


_SETUPS: dict = {}


def _setup(arch):
    """(reference bundle, its params as jax arrays, port bundle, port
    params, tokens, prefix or None) of ``arch``'s smoke config, made once."""
    if arch not in _SETUPS:
        rb = ref_get_bundle(arch, smoke=True)
        p_np = _np(rb.init(jax.random.PRNGKey(0), jnp.float32))
        rng = np.random.default_rng(len(arch))
        # non-zero norm gains, so every (1 + gamma) scale is exercised
        p_np = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(
            np.float32) if not a.any() else a, p_np)
        pb = get_bundle(arch, smoke=True)
        toks = rng.integers(0, pb.cfg.vocab, (B, S)).astype(np.int32)
        prefix = (rng.standard_normal((B, PREFIX, pb.cfg.d_model)).astype(np.float32)
                  if pb.family == "vlm" else None)
        _SETUPS[arch] = (rb, _j(p_np), pb, lm.lm_params_from_numpy(p_np, "cpu"),
                         toks, prefix)
    return _SETUPS[arch]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_fn_matches_reference(arch):
    rb, pr, pb, pp, toks, prefix = _setup(arch)
    batch_r = {"tokens": jnp.asarray(toks)}
    batch_p = {"tokens": _t(toks)}
    if prefix is not None:  # the VLM's stub image prefix
        batch_r["prefix"], batch_p["prefix"] = jnp.asarray(prefix), _t(prefix)
    want = rb.prefill_fn(pr, batch_r)
    got = pb.prefill_fn(pp, batch_p)
    assert got.shape == (B, S + (PREFIX if prefix is not None else 0), pb.cfg.vocab)
    _close(got.numpy(), want)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_cache_fn_matches_reference(arch):
    rb, pr, pb, pp, toks, _ = _setup(arch)
    lr, cr = rb.prefill_cache_fn(pr, rb.make_cache(B, MAX_LEN, jnp.float32),
                                 {"tokens": jnp.asarray(toks)})
    lp, cp = pb.prefill_cache_fn(pp, pb.make_cache(B, MAX_LEN, device="cpu"),
                                 {"tokens": _t(toks)})
    _close(lp.numpy(), lr)
    want = dict((tuple(k.key for k in path), leaf) for path, leaf in
                jax.tree_util.tree_flatten_with_path(cr)[0])
    got = dict(tree_items(cp))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        _close(leaf.numpy(), want[path], CACHE_REL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_fn_matches_reference_over_12_steps(arch):
    rb, pr, pb, pp, toks, _ = _setup(arch)
    cr = rb.make_cache(B, MAX_LEN, jnp.float32)
    cp = pb.make_cache(B, MAX_LEN, device="cpu")
    for t in range(STEPS):
        col = toks[:, t:t + 1]
        lr, cr = rb.decode_fn(pr, cr, {"tokens": jnp.asarray(col),
                                       "pos": jnp.int32(t)})
        lp, cp = pb.decode_fn(pp, cp, {"tokens": _t(col), "pos": t})
        _close(lp.numpy(), lr)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_fn_matches_reference(arch):
    rb, pr, pb, pp, toks, prefix = _setup(arch)
    labels = np.roll(toks, -1, axis=1)
    batch_r = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch_p = {"tokens": _t(toks), "labels": _t(labels)}
    if prefix is not None:
        batch_r["prefix"], batch_p["prefix"] = jnp.asarray(prefix), _t(prefix)
    want = float(rb.loss_fn(pr, batch_r))
    got = float(pb.loss_fn(pp, batch_p))
    assert abs(got - want) <= LOSS_REL * abs(want)


def _ref_decode_cases():
    """The reference's ``tests/test_decode_consistency.py`` CASES."""
    path = os.path.join(os.path.dirname(__file__), "test_decode_consistency.py")
    spec = importlib.util.spec_from_file_location("_ref_decode_consistency", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES


REF_CASES = _ref_decode_cases()


@pytest.mark.parametrize("case", list(REF_CASES))
def test_reference_decode_consistency_cases(case):
    """The reference's cases (GQA with qk-norm, an all-layers window, a
    Gemma2-like stack, MLA + MoE) on its weights: the port's 12 decode
    steps give the reference's teacher-forced ``forward`` logits, and the
    port's own ``forward`` gives them too."""
    cfg_r = REF_CASES[case]
    cfg = _port_cfg(cfg_r)
    params = schema_init(ref_lm.lm_schema(cfg_r), jax.random.PRNGKey(0), jnp.float32)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                         cfg_r.vocab)).astype(np.int32)
    want = np.asarray(ref_lm.forward(params, cfg_r, jnp.asarray(toks)))
    port = lm.lm_params_from_numpy(_np(params), "cpu")
    _close(lm.forward(port, cfg, _t(toks)).numpy(), want)
    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    outs = []
    for t in range(12):
        lg, cache = lm.decode_step(port, cfg, cache, _t(toks[:, t:t + 1]), t)
        outs.append(lg[:, 0])
    _close(torch.stack(outs, 1).numpy(), want)


# kv heads that cannot shard the reference's model axis of 16 take its
# ring (select) write, kv heads that can take its dynamic-update-slice
RING_CASES = {"ring": 2, "dus": 16}


@pytest.mark.parametrize("label", list(RING_CASES))
def test_cache_write_matches_reference_ring_and_dus(label):
    """On one device the port's indexed cache write holds the values of
    whichever write the reference picks: a 5-token prefill, then 6 decode
    steps, every step's logits and the whole cache against the
    reference's."""
    kv = RING_CASES[label]
    assert ref_lm._use_ring_cache(kv) == (label == "ring")
    kw = dict(name=label, layers=2, d_model=32, n_heads=16, n_kv_heads=kv,
              head_dim=4, d_ff=48, vocab=64, qk_norm=True)
    cfg_r, cfg = ref_lm.LMConfig(**kw), lm.LMConfig(**kw)
    params = schema_init(ref_lm.lm_schema(cfg_r), jax.random.PRNGKey(5), jnp.float32)
    port = lm.lm_params_from_numpy(_np(params), "cpu")
    toks = np.random.default_rng(kv).integers(0, 64, (2, 11)).astype(np.int32)
    cr = ref_lm.init_cache(cfg_r, 2, 12, jnp.float32)
    lr, cr = ref_lm.prefill(params, cfg_r, cr, jnp.asarray(toks[:, :5]))
    cp = lm.init_cache(cfg, 2, 12, device="cpu")
    lp, cp = lm.prefill(port, cfg, cp, _t(toks[:, :5]))
    _close(lp.numpy(), lr)
    for t in range(5, 11):
        lr, cr = ref_lm.decode_step(params, cfg_r, cr, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.int32(t))
        lp, cp = lm.decode_step(port, cfg, cp, _t(toks[:, t:t + 1]), t)
        _close(lp.numpy(), lr)
    for leaf in ("k", "v"):
        _close(cp["dense"][leaf].numpy(), cr["dense"][leaf], CACHE_REL)


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, q, k, v, **kw):
        self.calls.append((tuple(q.shape), tuple(v.shape)))
        return self.fn(q, k, v, **kw)


@pytest.fixture
def k4_spy(monkeypatch):
    spy = _Spy(lm.flash_attention)
    monkeypatch.setattr(lm, "flash_attention", spy)
    return spy


# (label, q/k dim, v dim, heads, kv heads, reaches K4): PaliGemma's head
# dim 256 and MLA's 192 / 128 take the plain route; 128 (Qwen3, rep 4 and
# CodeQwen, rep 1) reaches K4
ROUTE_CASES = [("d256", 256, 256, 8, 1, False), ("mla_192_128", 192, 128, 4, 4, False),
               ("d128_rep4", 128, 128, 8, 2, True), ("d128_rep1", 128, 128, 4, 4, True)]


@pytest.mark.parametrize("label,d,dv,h,hkv,k4", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_attend_routes_by_shape(k4_spy, label, d, dv, h, hkv, k4):
    cfg = lm.LMConfig(name="r", layers=1, d_model=32, n_heads=h, n_kv_heads=hkv,
                      head_dim=d, d_ff=32, vocab=16)
    rng = np.random.default_rng(d + dv)
    q = _t(rng.standard_normal((2, 6, h, d)).astype(np.float32))
    k = _t(rng.standard_normal((2, 6, hkv, d)).astype(np.float32))
    v = _t(rng.standard_normal((2, 6, hkv, dv)).astype(np.float32))
    pos = lm._positions(2, 0, 6, "cpu")
    assert lm.attend_route(6, 6, d, dv, start=0) == ("k4" if k4 else "plain")
    got = lm._attend(q, k, v, pos, pos, cfg, None, start=0)
    assert len(k4_spy.calls) == int(k4)
    want = lm.attention(q, k, v, lm.make_attn_mask(pos, pos), scale=1 / math.sqrt(d))
    _close(got.numpy(), want.numpy(), 1e-5)
    # a window shorter than the queries, a softcap, a single query or
    # attention without the causal mask never reaches K4 either; a window
    # of at least the queries masks nothing the causal mask keeps
    assert lm.attend_route(6, 6, d, dv, window=3, start=0) != "k4"
    assert lm.attend_route(6, 6, d, dv, window=6, start=0) == ("k4" if k4 else "plain")
    assert lm.attend_route(6, 6, d, dv, attn_softcap=50.0, start=0) != "k4"
    assert lm.attend_route(1, 6, d, dv, start=5) != "k4"
    assert lm.attend_route(6, 6, d, dv, start=0, causal=False) == "plain"
    if k4:
        got = lm._attend(q, k, v, pos, pos, cfg, 6, start=0)
        assert len(k4_spy.calls) == 2
        _close(got.numpy(), want.numpy(), 1e-5)


def test_model_prefill_routes_mla_and_d256_off_k4(k4_spy):
    """Through the whole model: an MLA stack at DeepSeek's 128 + 64 / 128
    head dims and a head-dim-256 stack run their prefill without K4; a
    head-dim-128 stack sends every layer's prefill to it."""
    mla = lm.LMConfig(name="m", layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                      head_dim=128, d_ff=32, vocab=32, attn="mla",
                      mla=lm.MLAConfig(0, 16, 128, 64, 128))
    d256 = lm.LMConfig(name="p", layers=2, d_model=32, n_heads=2, n_kv_heads=1,
                       head_dim=256, d_ff=32, vocab=32)
    d128 = dataclasses.replace(d256, head_dim=128)
    toks = torch.randint(0, 32, (2, 5), generator=torch.Generator().manual_seed(0))
    for cfg, launches in ((mla, 0), (d256, 0), (d128, 2)):
        k4_spy.calls.clear()
        params = lm.init_lm(cfg, torch.Generator().manual_seed(1), "cpu")
        cache = lm.init_cache(cfg, 2, 8, device="cpu")
        logits, _ = lm.prefill(params, cfg, cache, toks)
        assert torch.isfinite(logits).all()
        assert len(k4_spy.calls) == launches, cfg.name


def _old_init_lm(cfg, generator):
    """``init_lm`` as the port drew a dense stack before it drew per leaf:
    every leaf on the CPU in the order dense_layers (sorted), embed, ln_f,
    lm_head, then the tree moved."""
    def leaf(shape, scale):
        if scale == 0.0:
            return torch.zeros(shape)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        return torch.randn(shape, generator=generator) * std

    layer = lm._layer_schema(cfg)
    tree = {"dense_layers": {name: leaf((cfg.layers,) + spec.shape, spec.scale)
                             for name, spec in sorted(layer.items())},
            "embed": leaf((cfg.vocab, cfg.d_model), 0.02),
            "ln_f": leaf((cfg.d_model,), 0.0)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = leaf((cfg.d_model, cfg.vocab), 0.02)
    return tree


@pytest.mark.parametrize("arch", ["smollm-135m", "codeqwen1.5-7b", "gemma2-9b"])
def test_init_lm_cpu_draws_unchanged(arch):
    cfg = get_bundle(arch, smoke=True).cfg
    got = dict(tree_items(lm.init_lm(cfg, torch.Generator().manual_seed(3), "cpu")))
    want = dict(tree_items(_old_init_lm(cfg, torch.Generator().manual_seed(3))))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert torch.equal(leaf, want[path]), path


def test_init_lm_draws_per_leaf_on_the_generator_device(monkeypatch):
    """One draw a random leaf, in sorted-key order (nested MoE leaves
    included), each on the generator's device and moved before the next
    draw."""
    cfg = get_bundle("deepseek-v2-236b", smoke=True).cfg
    draws, real = [], torch.randn

    def randn(*shape, **kw):
        assert not draws or draws[-1][2] == "moved", "a leaf drawn before the last moved"
        draws.append([tuple(shape[0]), kw["device"], "drawn"])
        out = real(*shape, **kw)
        to = out.to

        def moved(dev):
            draws[-1][2] = "moved"
            return to(dev)

        out.to = moved
        return out

    monkeypatch.setattr(torch, "randn", randn)
    gen = torch.Generator().manual_seed(0)
    params = lm.init_lm(cfg, gen, "cpu")
    random_leaves = [(path, spec.shape) for path, spec
                     in tree_items(lm.lm_schema(cfg)) if spec.scale != 0.0]
    assert [d[0] for d in draws] == [s for _, s in random_leaves]
    assert all(d[1] == gen.device for d in draws)
    assert draws[-1][2] == "moved"
    assert tuple(params["moe_layers"]["moe"]["shared"]["w_up"].shape) == (2, 64, 64)
    assert [p for p, _ in tree_items(params)] == [p for p, _ in
                                                  tree_items(lm.lm_schema(cfg))]


def test_lm_shapes_follow_reference_schema():
    """The port's shapes (MLA names, nested moe/shared, both stacks) are the
    reference's ``lm_schema`` shapes for every new arch, smoke and full."""
    for arch in NEW_ARCHS:
        for smoke in (True, False):
            want = {tuple(k.key for k in path): spec.shape for path, spec in
                    jax.tree_util.tree_flatten_with_path(
                        ref_get_bundle(arch, smoke=smoke).schema,
                        is_leaf=lambda x: isinstance(x, ParamSpec))[0]}
            got = {path: spec.shape for path, spec in
                   tree_items(lm.lm_schema(get_bundle(arch, smoke=smoke).cfg))}
            assert got == want, (arch, smoke)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_get_bundle_passes_keywords(arch):
    got = get_bundle(arch, dispatch_groups=4).cfg.moe
    want = ref_get_bundle(arch, dispatch_groups=4).cfg.moe
    assert got.dispatch_groups == 4
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert get_bundle(arch).cfg.moe.dispatch_groups == 16


def test_train_cli_runs_deepseek_v2_smoke_on_cpu(capsys):
    train_mod.main(["--arch", "deepseek-v2-236b", "--smoke", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "first loss" in out and "last loss" in out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_lm_on_every_arch(arch, capsys):
    """``serve_lm`` on the CPU (the families without a cache-filling
    prefill step ``decode_fn`` over the prompt).  Without MoE layers the
    greedy tokens are the argmax of the port's full forward over the
    prompt and the tokens before them (Whisper's over a zero encoder
    output; Hymba's of the reference's decode, whose ring of unwritten
    slots no forward has).  An MoE layer's capacity depends on the tokens of one
    call (the reference's semantics), so a forward over more tokens than
    a decode step may drop entries the step keeps: there the tokens are
    only checked to be tokens."""
    timings = {}
    toks = serve_mod.serve_lm(arch, batch=2, prompt_len=6, gen=4, smoke=True,
                              device="cpu", timings=timings)
    assert toks.shape == (2, 4)
    assert set(timings) == {"init_s", "prefill_s", "decode_s", "tok_s"}
    bundle = get_bundle(arch, smoke=True)
    assert int(toks.min()) >= 0 and int(toks.max()) < bundle.cfg.vocab
    if getattr(bundle.cfg, "moe", None) is None:
        params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
        prompts = torch.randint(0, bundle.cfg.vocab, (2, 6),
                                generator=torch.Generator().manual_seed(1))
        seq = torch.cat([prompts, toks[:, :-1]], 1)
        if bundle.family == "encdec":
            # serve_lm decodes over the zero cross K/V of make_cache, which
            # is cross-attention over a zero encoder output
            logits = whisper.decode(params, bundle.cfg, seq, torch.zeros(
                2, bundle.cfg.enc_len, bundle.cfg.d_model))
        elif bundle.family == "hybrid":
            # a ring of 10 slots, never full: the decode attends over the
            # unwritten slots as zero keys, so the reference's decode_fn
            # (not a forward) over the same tokens gives the tokens
            rb = ref_get_bundle(arch, smoke=True)
            pj = jax.tree.map(lambda a: jnp.asarray(a.numpy()), params)
            cache, rows = rb.make_cache(2, 10, jnp.float32), []
            for i in range(9):
                lg, cache = rb.decode_fn(pj, cache, {
                    "tokens": jnp.asarray(seq[:, i:i + 1].numpy()), "pos": jnp.int32(i)})
                rows.append(torch.tensor(np.asarray(lg[:, 0])))
            logits = torch.stack(rows, 1)
        else:
            logits = bundle.prefill_fn(params, {"tokens": seq})
        assert torch.equal(logits[:, 5:].argmax(-1), toks)
    assert f"{arch}: prefill 6 toks" in capsys.readouterr().out


def test_serve_cli_runs_a_new_arch_on_cpu(capsys, monkeypatch):
    """The serve CLI on a new arch, and ``--layers`` cutting its depth (the
    dense-first layers first) at full width."""
    serve_mod.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert "qwen3-4b: prefill 4 toks" in capsys.readouterr().out
    seen = []
    real = serve_mod.with_layers
    monkeypatch.setattr(serve_mod, "with_layers",
                        lambda b, n: seen.append(real(b, n)) or seen[-1])
    serve_mod.main(["--arch", "deepseek-v2-236b", "--smoke", "--device", "cpu",
                    "--batch", "1", "--prompt-len", "3", "--gen", "2",
                    "--layers", "2"])
    cfg = seen[0].cfg
    assert (cfg.layers, cfg.n_dense_layers, cfg.d_model) == (2, 1, 64)
    assert [k for k, *_ in lm._stacks(cfg)] == ["dense_layers", "moe_layers"]
    with pytest.raises(ValueError, match="has 3 layers"):
        real(get_bundle("deepseek-v2-236b", smoke=True), 4)


@pytest.mark.parametrize("label", ["mla", "moe"])
def test_coded_decoder_refuses_mla_and_moe(label):
    """``build_lm_decoder_pipeline`` refuses MLA and MoE stacks with the
    reference's own messages."""
    if label == "mla":
        cfg_r = ref_get_bundle("deepseek-v2-236b", smoke=True).cfg
    else:
        cfg_r = ref_lm.LMConfig(
            name="x", layers=2, d_model=16, n_heads=2, n_kv_heads=1, head_dim=8,
            d_ff=16, vocab=32, moe=ref_lm.MoEConfig(4, 2, 16, 8), n_dense_layers=1)
    with pytest.raises(ValueError) as want:
        ref_build_decoder(cfg_r, {}, 4, k_b=4)
    with pytest.raises(ValueError) as got:
        build_lm_decoder_pipeline(_port_cfg(cfg_r), {}, 4, k_b=4, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b", "whisper-medium"])
def test_coded_decoder_refuses_the_other_families(arch):
    """Coded decode is the transformer's alone: the reference's
    ``build_lm_decoder_pipeline`` has no path for RWKV6, Hymba or Whisper
    (their configs have no ``attn``, and it fails reading it); the port
    refuses them with the reference's ``ValueError`` for a non-GQA
    attention."""
    with pytest.raises(AttributeError):
        ref_build_decoder(ref_get_bundle(arch, smoke=True).cfg, {}, 4, k_b=4)
    with pytest.raises(ValueError, match="coded decode supports attn='gqa', got None"):
        build_lm_decoder_pipeline(get_bundle(arch, smoke=True).cfg, {}, 4, k_b=4,
                                  device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bundle_init_draws_its_own_shapes(arch):
    """``ModelBundle.init`` draws the bundle's own schema: every leaf of
    the tree at its shape, the zero-scale leaves zeros; a transformer
    bundle's draws are ``init_lm``'s value for value."""
    bundle = get_bundle(arch, smoke=True)
    params = bundle.init(torch.Generator().manual_seed(3), device="cpu")
    specs = dict(tree_items(bundle.schema))
    got = dict(tree_items(params))
    assert sorted(got) == sorted(specs)
    for path, leaf in got.items():
        spec = specs[path]
        assert tuple(leaf.shape) == spec.shape and leaf.dtype == torch.float32, path
        assert bool(leaf.any()) == (spec.scale != 0.0), path
    if bundle.family in ("lm", "vlm"):
        want = dict(tree_items(lm.init_lm(bundle.cfg, torch.Generator().manual_seed(3),
                                          "cpu")))
        assert all(torch.equal(got[p], want[p]) for p in want)


def test_chip_smoke_zoo_phase_rehearses_on_the_cpu(capsys):
    """``chip_smoke.py``'s arch-zoo phase at the smoke configs on the CPU:
    every arch served and checked (cache and decode agreement, the MoE
    against its plain version and a float64 loop, the VLM prefix, RWKV6's
    decode over 141 tokens on 2 layers and, in float64, at full depth,
    Hymba's with its window cut to 4,
    Whisper's over the encoder's cross K/V), Qwen3
    served coded on the device pool with its logits held to the
    undistributed model, K2-K4 at its shapes against their plain
    versions; no launch is counted on the CPU."""
    from repro_torch.kernels.coded_gemm.kernel import launches as k3
    from repro_torch.kernels.conv2d.kernel import launches as k1
    from repro_torch.kernels.flash_attn.kernel import launches as k4
    from repro_torch.kernels.matmul.kernel import launches as k2

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    zoo = cs.zoo_phase(torch.device("cpu"), (k1, k2, k3, k4), "cpu", smoke=True)
    assert [z["arch"] for z in zoo["archs"]] == [a for a, _ in cs.ZOO]
    routes = {z["arch"]: z["routes"] for z in zoo["archs"]}
    assert routes["deepseek-v2-236b"] == {"plain": 3}
    assert routes["gemma2-9b"] == {"plain": 4}
    assert routes["qwen3-4b"] == {"k4": 2}
    assert routes["rwkv6-1.6b"] == {}
    assert routes["hymba-1.5b"] == {"k4": 2}
    assert routes["whisper-medium"] == {"k4": 2, "plain": 4}
    checks = {z["arch"]: z["checks"] for z in zoo["archs"]}
    assert checks["rwkv6-1.6b"]["tokens"] == checks["hymba-1.5b"]["tokens"] == 141
    assert checks["rwkv6-1.6b"]["layers_cut"] == 2
    assert checks["rwkv6-1.6b"]["float64"]["decode_rel_err"] <= 1e-12
    assert (checks["hymba-1.5b"]["window"], checks["hymba-1.5b"]["start"]) == (4, 96)
    assert checks["whisper-medium"]["frames"] == [4, 12, 64]
    moe_z = zoo["archs"][0]["moe"]
    assert moe_z["dropped"] == 0 and moe_z["groups"] == 16
    assert zoo["qwen3_coded"]["tokens"] == sum(g for _, g in cs.lm_requests(256))
    assert all(c == 0 for counts in zoo["by_path"].values() for c in counts.values())
    assert [(e["arch"], e.get("rep")) for e in zoo["kernels"]["flash_attention"]] == [
        ("qwen3-4b-smoke", None), ("qwen3-4b", 2), ("codeqwen1.5-7b", 1),
        ("hymba-1.5b", 2), ("whisper-medium", 1)]
    assert "stub prefix" in capsys.readouterr().out
