"""Hymba-style hybrid, the JAX package's ``models/hymba.py``: parallel
attention and SSM heads inside every layer.

Each layer feeds its normed input to an attention branch (GQA, RoPE, a
sliding window) and to a Mamba-style selective-SSM branch (a depthwise
causal conv, data-dependent dt / B / C, a scalar decay per head: the
Mamba-2 simplification), then fuses the two normed branch outputs by
their mean.  Meta-tokens are omitted, as in the reference.

The SSM branch runs on ``models.linear_scan`` with ``k = B`` (dk = the
state size), ``r = C`` and ``v = dt * u`` per head (dv = head_dim).  The
attention branch asks ``transformer.attend`` for its route: ``forward``
sends a prompt of at most ``window`` positions to K4; ``decode_step``
attends over a KV ring of ``min(max_len, window)`` slots with the plain
masked ``attention``.

As in the reference, the ring slots not written yet take part in
``decode_step``'s attention: their rebuilt positions fall below zero but
inside the window, so the first ``kv_len - 1`` steps attend over zero keys
(score 0, value 0) that ``forward`` never sees.  Those steps' outputs
feed the next layer's keys, so decode agrees with ``forward`` only where
the ring holds ``window`` slots and every layer's ring holds keys written
after that: from step ``layers * (window - 1)`` on (the SSM states still
carry what the earlier steps left, decaying).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..tree import tree_map
from .common import (ParamSpec, apply_rope, attention, make_attn_mask,
                     next_token_nll, position_index, rms_norm, rope_inv_freq,
                     stack_schema)
from .linear_scan import chunked_linear_attention, linear_step
from .transformer import attend

__all__ = ["HymbaConfig", "hymba_schema", "init_state", "forward",
           "decode_step", "lm_loss", "ring_key_positions"]


@dataclasses.dataclass(frozen=True)
class HymbaConfig:
    """The reference's ``HymbaConfig``."""

    name: str
    layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    ssm_state: int = 16
    ssm_expand: int = 2
    conv_width: int = 4
    window: int = 1024
    rope_base: float = 10000.0
    chunk: int = 64
    flash_chunk: int = 1024

    @property
    def d_inner(self):
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self):
        return self.d_inner // self.head_dim


def _layer_schema(cfg: HymbaConfig) -> dict:
    """One layer's schema (the reference's ``_layer_schema``)."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    di, ns, hm = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "ln": ParamSpec((d,), ("embed",), scale=0.0),
        # attention branch
        "wq": ParamSpec((d, h * hd), ("embed", "heads")),
        "wk": ParamSpec((d, hkv * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, hkv * hd), ("embed", "kv_heads")),
        "wo_attn": ParamSpec((h * hd, d), ("heads", "embed")),
        "ln_attn_out": ParamSpec((d,), ("embed",), scale=0.0),
        # SSM branch
        "w_in": ParamSpec((d, 2 * di), ("embed", "ff")),  # u and the gate z
        "conv": ParamSpec((cfg.conv_width, di), (None, "ff"), scale=0.02),
        "w_bc": ParamSpec((di, 2 * ns), ("ff", None)),
        "w_dt": ParamSpec((di, hm), ("ff", "heads")),
        "a_log": ParamSpec((hm,), ("heads",), scale=0.02),
        "d_skip": ParamSpec((hm,), ("heads",), scale=0.02),
        "wo_ssm": ParamSpec((di, d), ("ff", "embed")),
        "ln_ssm_out": ParamSpec((d,), ("embed",), scale=0.0),
        # FFN
        "ln_ffn": ParamSpec((d,), ("embed",), scale=0.0),
        "w_gate": ParamSpec((d, cfg.d_ff), ("embed", "ff")),
        "w_up": ParamSpec((d, cfg.d_ff), ("embed", "ff")),
        "w_down": ParamSpec((cfg.d_ff, d), ("ff", "embed")),
    }


def hymba_schema(cfg: HymbaConfig) -> dict:
    """The params' schema (the reference's ``hymba_schema``)."""
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           scale=0.02),
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), scale=0.0),
        "layers": stack_schema(_layer_schema(cfg), cfg.layers),
    }


def _qkv(w, x, cfg: HymbaConfig, rope, q_pos):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = apply_rope((x @ w["wq"]).reshape(b, s, h, hd), rope, q_pos)
    k = apply_rope((x @ w["wk"]).reshape(b, s, hkv, hd), rope, q_pos)
    v = (x @ w["wv"]).reshape(b, s, hkv, hd)
    return q, k, v


def _causal_conv(u, kernel, tail):
    """Depthwise causal conv.  ``u`` (B, T, di), ``kernel`` (W, di), ``tail``
    (B, W - 1, di): the last W - 1 rows of ``[tail, u]`` carry into the
    next call."""
    w = kernel.shape[0]
    up = torch.cat([tail.to(u.dtype), u], dim=1)
    out = sum(up[:, i:i + u.shape[1]] * kernel[i] for i in range(w))
    return out, up[:, -(w - 1):]


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0); F.softplus turns into the
    # identity above its threshold
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_branch(w, x, cfg: HymbaConfig, conv_tail, s, decode: bool,
                remat: bool = False):
    """The SSM branch: ``(out, conv tail', s')``."""
    b, t, _ = x.shape
    di, ns, hm, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.head_dim
    u, z = (x @ w["w_in"]).chunk(2, dim=-1)
    u, conv_tail = _causal_conv(u, w["conv"], conv_tail)
    u = F.silu(u.float()).to(x.dtype)
    b_in, c_out = (u @ w["w_bc"]).chunk(2, dim=-1)  # (B, T, ns) each
    dt = _softplus((u @ w["w_dt"]).float())  # (B, T, hm)
    a = -torch.exp(w["a_log"].float())  # (hm,) < 0
    log_decay = dt * a
    # linear attention with k = B, r = C, v = dt * u per head; each head's
    # dt repeats over its hd channels in place (jnp.repeat, not a tiling)
    kh = b_in[:, :, None, :].expand(b, t, hm, ns)
    rh = c_out[:, :, None, :].expand(b, t, hm, ns)
    vh = (u * dt.repeat_interleave(hd, dim=-1).to(u.dtype)).reshape(b, t, hm, hd)
    lw = log_decay[..., None].expand(b, t, hm, ns)
    if decode:
        y, s = linear_step(rh[:, 0], kh[:, 0], vh[:, 0], lw[:, 0], s)
        y = y[:, None]
    else:
        y, s = chunked_linear_attention(rh, kh, vh, lw, chunk=cfg.chunk,
                                        state=s, remat=remat)
    y = y.reshape(b, t, di) + u * w["d_skip"].repeat_interleave(hd).to(u.dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    return y @ w["wo_ssm"], conv_tail, s


def _fuse_and_ffn(w, x, attn_out, ssm_out):
    fused = 0.5 * (rms_norm(attn_out, w["ln_attn_out"])
                   + rms_norm(ssm_out, w["ln_ssm_out"]))
    x = x + fused
    h2 = rms_norm(x, w["ln_ffn"])
    g = h2 @ w["w_gate"]
    up = h2 @ w["w_up"]
    return x + (F.silu(g.float()).to(up.dtype) * up) @ w["w_down"]


def _layers(params, cfg: HymbaConfig):
    """Each layer's weights, the stacked leaves unbound once."""
    layers = tree_map(lambda leaf: leaf.unbind(0), params["layers"])
    return [tree_map(lambda leaves: leaves[l], layers) for l in range(cfg.layers)]


def _unembed(params, x):
    x = rms_norm(x, params["ln_f"])
    return (x @ params["embed"].t()).float()


def forward(params, cfg: HymbaConfig, tokens: torch.Tensor, *,
            autograd: bool = False) -> torch.Tensor:
    """``tokens`` (B, T) -> logits (B, T, V) from a zero SSM state (the conv
    tail bf16 zeros, as the reference's).  ``autograd=False`` is the
    serving route (attention on K4 where ``attend_route`` says so);
    ``autograd=True`` the training route, which backward differentiates
    (each scan chunk recomputed in backward, as the reference's)."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    rope = rope_inv_freq(cfg.head_dim, cfg.rope_base, x.device)
    hd = cfg.head_dim
    tail = torch.zeros((b, cfg.conv_width - 1, cfg.d_inner), dtype=torch.bfloat16,
                       device=x.device)
    s0 = torch.zeros((b, cfg.ssm_heads, cfg.ssm_state, hd), dtype=torch.float32,
                     device=x.device)
    for w in _layers(params, cfg):
        h_in = rms_norm(x, w["ln"])
        q, k, v = _qkv(w, h_in, cfg, rope, pos)
        attn = attend(q, k, v, pos, pos, scale=1.0 / math.sqrt(hd),
                      window=cfg.window, start=0, flash_chunk=cfg.flash_chunk,
                      autograd=autograd)
        attn_out = attn.reshape(b, s, cfg.n_heads * hd) @ w["wo_attn"]
        ssm_out, _, _ = _ssm_branch(w, h_in, cfg, tail, s0, False, autograd)
        x = _fuse_and_ffn(w, x, attn_out, ssm_out)
    return _unembed(params, x)


def init_state(cfg: HymbaConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    """The decode cache: a KV ring of ``min(max_len, window)`` slots (L, B,
    kv_len, hkv, hd) and the conv tail (L, B, W - 1, d_inner) in
    ``dtype``; the SSM state (L, B, ssm_heads, ssm_state, hd) in fp32."""
    dev = resolve_device(device)
    kv_len = min(max_len, cfg.window)
    kv = (cfg.layers, batch, kv_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "kv": {"k": torch.zeros(kv, dtype=dtype, device=dev),
               "v": torch.zeros(kv, dtype=dtype, device=dev)},
        "conv": torch.zeros((cfg.layers, batch, cfg.conv_width - 1, cfg.d_inner),
                            dtype=dtype, device=dev),
        "s": torch.zeros((cfg.layers, batch, cfg.ssm_heads, cfg.ssm_state,
                          cfg.head_dim), dtype=torch.float32, device=dev),
    }


def ring_key_positions(pos, kv_len: int, device) -> torch.Tensor:
    """The position each of ``kv_len`` ring slots holds when the token at
    ``pos`` (an int, or an integer tensor of one element on ``device``)
    sits in slot ``pos % kv_len`` (the reference's rebuild); a slot not
    written yet reads a position below zero, which the window keeps (a
    zero key, as in the reference)."""
    slot = pos % kv_len
    idx = torch.arange(kv_len, dtype=torch.int32, device=device)
    return torch.where(idx <= slot, pos - (slot - idx), pos - (slot + kv_len - idx))


def decode_step(params, cfg: HymbaConfig, state: dict, tokens: torch.Tensor,
                pos):
    """One token ``tokens`` (B, 1) at absolute position ``pos`` (a Python
    int, or a 0-d integer tensor on the state's device): its K/V go to
    ring slot ``pos % kv_len``.  Returns ``(logits (B, 1, V), state)``,
    the state written in place in its own dtypes."""
    b = tokens.shape[0]
    x = params["embed"][tokens]
    dev = x.device
    h, hd = cfg.n_heads, cfg.head_dim
    kv_len = state["kv"]["k"].shape[2]
    at = position_index(pos, dev)
    slot = at % kv_len
    q_pos = at.expand(b, 1)
    k_pos = ring_key_positions(at, kv_len, dev).expand(b, kv_len)
    mask = make_attn_mask(q_pos, k_pos, cfg.window)
    rope = rope_inv_freq(hd, cfg.rope_base, dev)
    for l, w in enumerate(_layers(params, cfg)):
        h_in = rms_norm(x, w["ln"])
        q, k, v = _qkv(w, h_in, cfg, rope, q_pos)
        ck, cv = state["kv"]["k"][l], state["kv"]["v"][l]
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        attn = attention(q, ck, cv, mask, scale=1.0 / math.sqrt(hd))
        attn_out = attn.reshape(b, 1, h * hd) @ w["wo_attn"]
        ssm_out, tail, s = _ssm_branch(w, h_in, cfg, state["conv"][l],
                                       state["s"][l], True)
        state["conv"][l] = tail
        state["s"][l] = s
        x = _fuse_and_ffn(w, x, attn_out, ssm_out)
    return _unembed(params, x), state


def lm_loss(params, cfg: HymbaConfig, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``targets`` (B, T),
    through the training route."""
    return next_token_nll(forward(params, cfg, tokens, autograd=True), targets)
