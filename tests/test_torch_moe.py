"""The port's MoE FFN (``models/moe.py``) against the reference's, and the
MoE+MLA transformer's loss gradients against ``jax.value_and_grad``.

Inputs and weights are drawn with numpy from a seed and handed to both
packages.  Tolerances: MoE outputs within 1e-5 of max|y| (fp32 sums in
another order); the expert choices and the drop masks *equal* (ties
included: tied experts go to the lower index, as ``jax.lax.top_k``, and a
stable sort decides which entries of one expert overflow its capacity);
gradients within 1e-4 of each leaf's max|g|, the loss within 1e-5
relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as ref_get_bundle
from repro.models import moe as ref_moe
from repro.models import transformer as ref_lm
from repro_torch.configs import get_bundle
from repro_torch.launch import steps
from repro_torch.models import moe
from repro_torch.models import transformer as lm
from repro_torch.tree import tree_items

REL, GRAD_REL = 1e-5, 1e-4


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def _weights(cfg: moe.MoEConfig, seed: int, tie: bool = False) -> dict:
    """numpy weights of one MoE layer; ``tie`` duplicates the router's first
    half of columns into its second half (tied experts, distinct FFNs)."""
    rng = np.random.default_rng(seed)

    def draw(schema):
        return {k: draw(v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape) / np.sqrt(v.shape[-2])).astype(np.float32)
                for k, v in schema.items()}

    w = draw(moe.moe_schema(cfg))
    if tie:
        half = cfg.n_routed // 2
        w["router"][:, half:2 * half] = w["router"][:, :half]
    return w


def _t(tree):
    return lm.lm_params_from_numpy(tree, "cpu")


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ref_routing(w, x, cfg):
    """The reference's routing of ``x`` (T, d), lines ``:71`` and
    ``:93-113`` of its ``moe.py`` (it returns only ``y``): the chosen
    experts (G, T, K) and, per (token, k) entry in token-major order,
    whether it fits its expert's capacity."""
    t, d = x.shape
    g = cfg.dispatch_groups if t % cfg.dispatch_groups == 0 else 1
    xg = jnp.asarray(x).reshape(g, t // g, d)
    e, k = cfg.n_routed, cfg.top_k
    tg = t // g
    cap = max(int(cfg.capacity_factor * k * tg / e), 8)
    cap = -(-cap // 8) * 8
    probs = jax.nn.softmax(
        jnp.einsum("gtd,de->gte", xg, jnp.asarray(w["router"])).astype(jnp.float32),
        axis=-1)
    _, gate_e = jax.lax.top_k(probs, k)
    flat_e = gate_e.reshape(g, tg * k)
    order = jnp.argsort(flat_e, axis=-1)
    se = jnp.take_along_axis(flat_e, order, axis=-1)
    starts = jax.vmap(lambda s: jnp.searchsorted(s, jnp.arange(e)))(se)
    pos = jnp.arange(tg * k)[None] - jnp.take_along_axis(starts, se, axis=-1)
    keep = pos < cap
    entry_keep = jnp.take_along_axis(keep, jnp.argsort(order, axis=-1), axis=-1)
    return np.asarray(gate_e), np.asarray(entry_keep), cap


def _port_routing(w, x, cfg):
    xg = moe._grouped(torch.as_tensor(x), cfg)
    r = moe.route(_t(w), xg, cfg)
    inv = torch.argsort(r.order, dim=-1)
    return r.gate_e.numpy(), torch.gather(r.keep, 1, inv).numpy(), r.cap


# (label, config, tokens, tied router): the reference's own MoE test
# config (tests/test_models_smoke.py), dispatch groups 1, 4 and 5 (5 does
# not divide 64 tokens: one group), a capacity factor of 0.25 that drops
# entries (top-1 and, in groups, top-2), a capacity between multiples of 8
# (int truncation, then rounding up), and tied experts with drops
CASES = [
    ("reference", moe.MoEConfig(8, 2, 32, 16, n_shared=1, capacity_factor=4.0,
                                dispatch_groups=4), 64, False),
    ("groups1", moe.MoEConfig(8, 2, 32, 16, n_shared=2), 48, False),
    ("groups4", moe.MoEConfig(8, 2, 32, 16, dispatch_groups=4), 64, False),
    ("groups5_not_dividing", moe.MoEConfig(8, 2, 32, 16, n_shared=1,
                                           dispatch_groups=5), 64, False),
    ("drops_top1", moe.MoEConfig(4, 1, 16, 8, capacity_factor=0.25), 64, False),
    ("drops_groups", moe.MoEConfig(4, 2, 16, 8, capacity_factor=0.25,
                                   dispatch_groups=2), 96, False),
    ("cap_truncated", moe.MoEConfig(3, 2, 16, 8, capacity_factor=0.9), 44, False),
    ("tied_experts", moe.MoEConfig(8, 2, 32, 16, n_shared=1,
                                   capacity_factor=0.5), 64, True),
]


@pytest.mark.parametrize("label,cfg,t,tie", CASES, ids=[c[0] for c in CASES])
def test_moe_ffn_matches_reference(label, cfg, t, tie):
    w = _weights(cfg, seed=t, tie=tie)
    x = np.random.default_rng(t + 1).standard_normal((t, cfg.d_model)).astype(np.float32)
    rcfg = ref_moe.MoEConfig(**dataclasses.asdict(cfg))
    want = np.asarray(ref_moe.moe_ffn(_j(w), jnp.asarray(x), rcfg))
    got = moe.moe_ffn(_t(w), torch.as_tensor(x), cfg)
    _close(got.numpy(), want)
    e_r, keep_r, cap_r = _ref_routing(w, x, cfg)
    e_p, keep_p, cap_p = _port_routing(w, x, cfg)
    assert cap_p == cap_r
    np.testing.assert_array_equal(e_p, e_r)
    np.testing.assert_array_equal(keep_p, keep_r)
    if label.startswith(("drops", "tied")):
        assert not keep_p.all(), "the case must drop entries"
    if tie:  # some token chose both of a tied pair, the lower index first
        half = cfg.n_routed // 2
        pair = (e_p[..., 1] == e_p[..., 0] + half)
        assert pair.any()


@pytest.mark.parametrize("label,cfg,t,tie", CASES, ids=[c[0] for c in CASES])
def test_moe_ffn_plain_matches_moe_ffn(label, cfg, t, tie):
    """The float-scatter formulation against the gather dispatch, drops
    and ties included."""
    w = _t(_weights(cfg, seed=t + 7, tie=tie))
    x = torch.as_tensor(np.random.default_rng(t + 8).standard_normal(
        (t, cfg.d_model)).astype(np.float32))
    _close(moe.moe_ffn_plain(w, x, cfg).numpy(), moe.moe_ffn(w, x, cfg).numpy())


def test_topk_ties_go_to_the_lower_index():
    """Exact ties in the router probabilities: the port's top-k picks them
    in index order, as ``jax.lax.top_k``."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 3)
    _, idx = torch.sort(torch.as_tensor(probs), dim=-1, descending=True,
                        stable=True)
    np.testing.assert_array_equal(idx[:, :3].numpy(), np.asarray(want))
    # route() itself, on a router whose columns all tie
    cfg = moe.MoEConfig(4, 3, 8, 4)
    w = {"router": torch.ones((8, 4))}
    r = moe.route(w, torch.randn(1, 5, 8), cfg)
    assert r.gate_e.tolist() == [[[0, 1, 2]] * 5]


def test_capacity_and_groups_arithmetic():
    """``cap`` and the dispatch groups against the reference's expressions
    (``:71``, ``:95-96``) over a grid, truncation and the floor of 8
    included."""
    for e in (3, 8, 160):
        for k in (1, 2, 6):
            for t in (4, 13, 44, 64, 100):
                for cf in (0.25, 0.9, 1.0, 1.25, 4.0):
                    cfg = moe.MoEConfig(e, k, 8, 4, capacity_factor=cf)
                    c = max(int(cf * k * t / e), 8)
                    assert moe.capacity(cfg, t) == -(-c // 8) * 8
    for g, t, want in ((16, 64, 16), (16, 4, 1), (5, 64, 1), (4, 64, 4)):
        assert moe.dispatch_groups(moe.MoEConfig(8, 2, 8, 4, dispatch_groups=g),
                                   t) == want


# (arch, flash_chunk, seq): DeepSeek-V2's smoke config (direct wq, two
# shared experts) and V3's (q_lora, one shared), both on the plain route;
# V2's on the chunked scan route too, where MLA's v (16) is narrower than
# its q/k (24)
GRAD_CASES = [("deepseek-v2-236b", 1024, 12), ("deepseek-v3-671b", 1024, 12),
              ("deepseek-v2-236b", 8, 16)]


@pytest.mark.parametrize("arch,chunk,seq", GRAD_CASES,
                         ids=[f"{a}-chunk{c}" for a, c, _ in GRAD_CASES])
def test_lm_loss_grads_match_reference_mla_moe(arch, chunk, seq):
    rb = ref_get_bundle(arch, smoke=True)
    cfg_r = dataclasses.replace(rb.cfg, flash_chunk=chunk)
    cfg = dataclasses.replace(get_bundle(arch, smoke=True).cfg, flash_chunk=chunk)
    p_np = jax.tree.map(np.asarray, rb.init(jax.random.PRNGKey(2), jnp.float32))
    rng = np.random.default_rng(seq)
    # non-zero norm gains, so every (1 + gamma) and its gradient is exercised
    p_np = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(
        np.float32) if not a.any() else a, p_np)
    toks = rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab, (2, seq)).astype(np.int32)
    loss_r, g_r = jax.jit(jax.value_and_grad(ref_lm.lm_loss), static_argnums=1)(
        _j(p_np), cfg_r, jnp.asarray(toks), jnp.asarray(tgts))
    loss, g = steps.value_and_grad(
        lambda p, b: lm.lm_loss(p, cfg, b["tokens"], b["labels"]),
        _t(p_np), {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(tgts)})
    _close(float(loss), float(loss_r))
    want = dict(jax.tree_util.tree_flatten_with_path(g_r)[0])
    got = tree_items(g)
    assert len(got) == len(want)
    for (path, leaf), (rpath, rleaf) in zip(got, want.items()):
        assert tuple(k.key for k in rpath) == path
        assert torch.isfinite(leaf).all(), path
        _close(leaf.numpy(), np.asarray(rleaf), GRAD_REL)
    moe_grads = [leaf for path, leaf in got if "moe" in path]
    assert moe_grads and all(float(l.abs().max()) > 0 for l in moe_grads)
