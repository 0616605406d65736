"""The port's chunked linear scan (``repro_torch.models.linear_scan``)
against the JAX package's ``repro.models.linear_scan`` on the same
numpy-seeded inputs, and against a step-by-step ``linear_step`` loop.

Covers both modes (inclusive, RWKV's shifted query decay with the bonus
on the diagonal), a padded tail (T = 13 in chunks of 8) with a carried
state in and out, decays steep enough that an exp-then-mask would
overflow, and the per-chunk remat's values and gradients.

Tolerances: fp32 sums in another order, within 1e-5 of the largest
magnitude of the value compared (outputs and states alike).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import linear_scan as ref_scan
from repro_torch.models import linear_scan as scan

REL = 1e-5
B, T, H, DK, DV, CHUNK = 2, 13, 3, 4, 5, 8


def _close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def _inputs(seed, t=T, decay_scale=1.0, state=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    out = {"r": f(B, t, H, DK), "k": f(B, t, H, DK), "v": f(B, t, H, DV),
           "log_decay": (-decay_scale * np.exp(f(B, t, H, DK))).astype(np.float32),
           "u": f(H, DK), "state": f(B, H, DK, DV) if state else None}
    return out


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _step_loop(x, rwkv):
    """The recurrence one step at a time through the port's
    ``linear_step``: (y (B, T, H, dv), final state)."""
    s = _t(x["state"]) if x["state"] is not None else torch.zeros(B, H, DK, DV)
    ys = []
    for i in range(x["r"].shape[1]):
        y, s = scan.linear_step(_t(x["r"][:, i]), _t(x["k"][:, i]), _t(x["v"][:, i]),
                                _t(x["log_decay"][:, i]), s,
                                bonus_u=_t(x["u"]) if rwkv else None)
        ys.append(y)
    return torch.stack(ys, 1), s


def _port(x, rwkv, chunk=CHUNK, remat=False):
    return scan.chunked_linear_attention(
        _t(x["r"]), _t(x["k"]), _t(x["v"]), _t(x["log_decay"]),
        bonus_u=_t(x["u"]) if rwkv else None, chunk=chunk, state=_t(x["state"]),
        remat=remat)


def _ref(x, rwkv, chunk=CHUNK):
    return ref_scan.chunked_linear_attention(
        _j(x["r"]), _j(x["k"]), _j(x["v"]), _j(x["log_decay"]),
        bonus_u=_j(x["u"]) if rwkv else None, chunk=chunk, state=_j(x["state"]))


MODES = [("inclusive", False), ("rwkv", True)]


@pytest.mark.parametrize("label,rwkv", MODES, ids=[m[0] for m in MODES])
@pytest.mark.parametrize("carried", [False, True], ids=["zero_state", "carried_state"])
def test_chunked_matches_reference_and_step_loop(label, rwkv, carried):
    """T = 13 in chunks of 8 (a padded tail of 3): the output and the final
    state against the reference's chunked scan and against the step loop."""
    x = _inputs(1 + rwkv, state=carried)
    y, s = _port(x, rwkv)
    yr, sr = _ref(x, rwkv)
    _close(y.numpy(), yr)
    _close(s.numpy(), sr)
    yl, sl = _step_loop(x, rwkv)
    _close(y.numpy(), yl.numpy())
    _close(s.numpy(), sl.numpy())


@pytest.mark.parametrize("label,rwkv", MODES, ids=[m[0] for m in MODES])
def test_linear_step_matches_reference(label, rwkv):
    x = _inputs(3 + rwkv)
    y, s = scan.linear_step(_t(x["r"][:, 0]), _t(x["k"][:, 0]), _t(x["v"][:, 0]),
                            _t(x["log_decay"][:, 0]), _t(x["state"]),
                            bonus_u=_t(x["u"]) if rwkv else None)
    yr, sr = ref_scan.linear_step(_j(x["r"][:, 0]), _j(x["k"][:, 0]),
                                  _j(x["v"][:, 0]), _j(x["log_decay"][:, 0]),
                                  _j(x["state"]), bonus_u=_j(x["u"]) if rwkv else None)
    _close(y.numpy(), yr)
    _close(s.numpy(), sr)


@pytest.mark.parametrize("label,rwkv", MODES, ids=[m[0] for m in MODES])
def test_tail_pad_adds_nothing_and_decays_nothing(label, rwkv):
    """The 13-step scan carries its state on: 13 steps then 7 more equal
    20 steps at once, and the 13-step state equals the step loop's (the 3
    padded steps neither added to it nor decayed it)."""
    x = _inputs(5 + rwkv, t=20)
    head = {k: (v[:, :13] if k not in ("u", "state") else v) for k, v in x.items()}
    y13, s13 = _port(head, rwkv)
    _, sl = _step_loop(head, rwkv)
    _close(s13.numpy(), sl.numpy())
    tail = {k: (v[:, 13:] if k not in ("u", "state") else v) for k, v in x.items()}
    tail["state"] = s13.numpy()
    y7, s20 = _port(tail, rwkv)
    y, s = _port(x, rwkv)
    _close(torch.cat([y13, y7], 1).numpy(), y.numpy())
    _close(s20.numpy(), s.numpy())


@pytest.mark.parametrize("label,rwkv", MODES, ids=[m[0] for m in MODES])
def test_steep_decays_stay_finite(label, rwkv):
    """Decays at the clip's floor (log w = -exp(4) = -54.6 a step): the
    cumulative sums reach -437 a chunk of 8, so the pairs above the
    diagonal are exp(+437) before the mask.  They must be masked before
    exp, and the result equal the step loop's and the reference's."""
    x = _inputs(7 + rwkv)
    x["log_decay"] = np.full_like(x["log_decay"], -float(np.exp(4.0)))
    y, s = _port(x, rwkv)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yl, sl = _step_loop(x, rwkv)
    _close(y.numpy(), yl.numpy())
    yr, sr = _ref(x, rwkv)
    _close(y.numpy(), yr)
    _close(s.numpy(), sr)


def test_remat_gives_the_same_values_and_gradients():
    """``remat=True`` (each chunk under ``torch.utils.checkpoint``): the same
    output, state and input gradients as the plain run."""
    x = _inputs(9)
    outs = []
    for remat in (False, True):
        leaves = {k: _t(x[k]).clone().requires_grad_(True)
                  for k in ("r", "k", "v", "log_decay", "u", "state")}
        y, s = scan.chunked_linear_attention(
            leaves["r"], leaves["k"], leaves["v"], leaves["log_decay"],
            bonus_u=leaves["u"], chunk=CHUNK, state=leaves["state"], remat=remat)
        (y.square().sum() + s.sum()).backward()
        outs.append((y.detach(), s.detach(),
                     {k: t.grad for k, t in leaves.items()}))
    (y0, s0, g0), (y1, s1, g1) = outs
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    for k in g0:
        _close(g1[k].numpy(), g0[k].numpy())
