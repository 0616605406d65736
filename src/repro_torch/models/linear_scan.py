"""Chunked linear attention / selective-SSM scan: the JAX package's
``models/linear_scan.py`` on tensors.

The recurrence, per head, with state ``S`` in ``R^{dk x dv}``:

    S_t = S_{t-1} * w_t + k_t (x) v_t            (w_t: per-channel decay)
    y_t = r_t . S_t                              (inclusive, Mamba2-style)

or, in RWKV mode (a bonus ``u`` on the current token):

    y_t = r_t . (S_{t-1} + (u * k_t) (x) v_t)
    S_t = S_{t-1} * w_t + k_t (x) v_t

Within a chunk of ``C`` steps the pairs factor through the cumulative
log-decays ``lp``: the pair (t, tau) weighs ``exp(lp_q[t] - lp[tau]) <= 1``
and the carried state ``exp(lp[last] - lp[tau])``.  A Python loop carries
the state across chunks (the reference's ``lax.scan``), so the pair
tensors are ``(B, C, C, H, dk)`` a chunk, not ``O(T^2)``.  These are plain
PyTorch, as the reference's are plain ``jnp``: no kernel takes them.

Over ranks that each hold a block of the sequence (a batch of one cut
over ``data``), ``scan_over_ranks`` composes the scan across them: the
recurrence is linear in the state, so each rank scans its block from a
zero state, and the state its block would have started from is the
earlier blocks' final states carried through the later blocks' total
decays; its outputs gain ``r_t . (decay to t (x) state in)``.  The bonus
touches only the current token, never the carried state, so it needs no
correction.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import at_least_fp32, checkpointed

__all__ = ["chunked_linear_attention", "linear_step", "scan_over_ranks"]


def _pad_steps(a: torch.Tensor, pad: int) -> torch.Tensor:
    """``a`` (B, T, H, d) with ``pad`` zero steps after its last."""
    return F.pad(a, (0, 0, 0, 0, 0, pad))


def _chunk_step(s, rb, kb, vb, lpb, mask, bonus_u, out_dtype):
    """One chunk: ``s`` (B, H, dk, dv) in, ``(s', y (B, C, H, dv))`` out."""
    lp = torch.cumsum(at_least_fp32(lpb), dim=1)  # (B, C, H, dk)
    # the query at t sees the carried state through the decay up to t; in
    # RWKV mode it sees S_{t-1}, so its decay stops at t - 1
    lp_q = lp
    if bonus_u is not None:
        lp_q = F.pad(lp, (0, 0, 0, 0, 1, 0))[:, :-1]
    rf, kf, vf = at_least_fp32(rb), at_least_fp32(kb), at_least_fp32(vb)
    y_inter = torch.einsum("bthk,bhkv->bthv", rf * torch.exp(lp_q), s)
    # the masked pairs become -inf before exp: above the diagonal diff is
    # positive and large, and exp of it would overflow
    diff = lp_q[:, :, None] - lp[:, None, :]  # (B, C, C, H, dk)
    pair = torch.exp(torch.where(mask[None, :, :, None, None], diff,
                                 torch.full_like(diff, -torch.inf)))
    a = torch.einsum("bthk,bshk,btshk->bths", rf, kf, pair)
    y_intra = torch.einsum("bths,bshv->bthv", a, vf)
    if bonus_u is not None:
        # r . u . k as a product over k with u, a head a batch, as the
        # reference's einsum contracts it (its u-gradient a product too)
        diag = torch.einsum("bthk,hk->bth", rf * kf, bonus_u)
        y_intra = y_intra + diag[..., None] * vf
    # S' = S * P_last + sum_tau exp(lp_last - lp_tau) k_tau v_tau
    k_dec = kf * torch.exp(lp[:, -1][:, None] - lp)
    s_new = s * torch.exp(lp[:, -1])[..., None] + torch.einsum(
        "bthk,bthv->bhkv", k_dec, vf)
    return s_new, (y_inter + y_intra).to(out_dtype)


def chunked_linear_attention(r, k, v, log_decay, *, bonus_u=None,
                             chunk: int = 64, state=None, remat: bool = False):
    """``r``/``k`` (B, T, H, dk), ``v`` (B, T, H, dv), ``log_decay`` (B, T, H,
    dk) (log w_t <= 0).  ``bonus_u`` (H, dk) enables RWKV mode; ``state``
    (B, H, dk, dv) fp32 is the carry in (zeros when None).  Returns ``(y
    (B, T, H, dv) in r's dtype, final fp32 state)``; float64 inputs
    compute, and carry the state, in float64.

    A tail of ``T % chunk`` steps is padded with ``k = 0`` (no state
    update) and ``log_decay = 0`` (no decay), so it adds nothing to the
    state and decays nothing.  ``remat`` runs each chunk under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``):
    backward recomputes the chunk's pair tensors; the values are the
    same."""
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    c = min(chunk, t)
    t0 = t
    if t % c:
        pad = c - t % c
        r, k, v, log_decay = (_pad_steps(a, pad) for a in (r, k, v, log_decay))
        t += pad
    n = t // c
    acc = torch.promote_types(r.dtype, torch.float32)
    state = (torch.zeros((b, h, dk, dv), dtype=acc, device=r.device)
             if state is None else state.to(acc))
    ones = torch.ones((c, c), dtype=torch.bool, device=r.device)
    # tau <= t, or tau < t in RWKV mode (the bonus takes the diagonal)
    mask = torch.tril(ones, diagonal=-1 if bonus_u is not None else 0)
    ys = []
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        args = (state, r[:, sl], k[:, sl], v[:, sl], log_decay[:, sl], mask,
                bonus_u, r.dtype)
        if remat:
            state, y = checkpointed(_chunk_step, *args)
        else:
            state, y = _chunk_step(*args)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :t0], state


def linear_step(r, k, v, log_decay, state, *, bonus_u=None):
    """One decode step: ``r``/``k`` (B, H, dk), ``v`` (B, H, dv), ``state``
    (B, H, dk, dv) fp32 (float64 for float64 inputs).  Returns ``(y (B, H,
    dv) in r's dtype, state')``."""
    w = torch.exp(at_least_fp32(log_decay))[..., None]  # (B, H, dk, 1)
    kv = torch.einsum("bhk,bhv->bhkv", at_least_fp32(k), at_least_fp32(v))
    if bonus_u is not None:
        att = state + bonus_u[None, :, :, None] * kv
        y = torch.einsum("bhk,bhkv->bhv", at_least_fp32(r), att)
        state = state * w + kv
    else:
        state = state * w + kv
        y = torch.einsum("bhk,bhkv->bhv", at_least_fp32(r), state)
    return y.to(r.dtype), state


def scan_over_ranks(seq, r, k, v, log_decay, *, bonus_u=None, chunk: int = 64,
                    remat: bool = False) -> torch.Tensor:
    """``chunked_linear_attention`` of a sequence whose blocks lie on the
    ranks ``seq`` (``sharding.SequenceRanks``, group order = sequence
    order), each rank holding ``r``/``k``/``v``/``log_decay`` of its block
    and every block starting from the zero state: returns this rank's
    block of ``y``, the whole scan's function (its sums reordered).

    Each rank scans its block from zero, keeping its final state and its
    block's summed log-decay; both are gathered over ``seq`` (backward,
    the ranks' gradients summed: ``SequenceRanks.gather``), rank ``i``
    composes ``state_in = sum_{j<i} S_j * prod_{j<l<i} exp(L_l)``, and its
    outputs gain ``r_t * exp(lp_t)`` contracted with it, ``lp_t`` the
    cumulative log-decay to ``t`` (to ``t - 1`` in RWKV mode, whose query
    sees the state before its own step)."""
    y, state = chunked_linear_attention(r, k, v, log_decay, bonus_u=bonus_u,
                                        chunk=chunk, remat=remat)
    lw = at_least_fp32(log_decay)
    total = lw.sum(dim=1)  # (B, H, dk) the block's log-decay
    # one gather of both: (R, B, H, dk, dv + 1)
    packed = seq.gather(torch.cat([state, total[..., None]], dim=-1)[None], 0)
    states, totals = packed[..., :-1], packed[..., -1]
    # every rank reads the gather (rank 0 as zeros), so every rank's
    # backward runs its collective
    s_in = states[0] * (1.0 if seq.rank > 0 else 0.0)
    for j in range(1, seq.rank):
        s_in = s_in * torch.exp(totals[j])[..., None] + states[j]
    lp = torch.cumsum(lw, dim=1)
    if bonus_u is not None:
        lp = F.pad(lp, (0, 0, 0, 0, 1, 0))[:, :-1]
    corr = torch.einsum("bthk,bhkv->bthv", at_least_fp32(r) * torch.exp(lp),
                        s_in)
    return (y.to(corr.dtype) + corr).to(y.dtype)
