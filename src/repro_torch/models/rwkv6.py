"""RWKV-6 "Finch", the JAX package's ``models/rwkv6.py``: an attention-free
LM with data-dependent per-channel decay.

Token-shift mixing, the LoRA-produced decay ``w_t = exp(-exp(w0 +
tanh(x_w A_w) B_w))``, a bonus ``u`` on the current token, a per-head
norm, a gated output and a squared-ReLU channel mix; static token-shift
mix coefficients (RWKV-5 style), as in the reference.  The embedding is
tied.

``forward`` runs the chunked linear scan (``models.linear_scan``);
``decode_step`` is the O(1)-state recurrent step.  No kernel is on this
path: the reference computes it with ``jnp`` einsums, not in Pallas.
Layers are a Python loop over the stacked ``layers`` leaves, so the
reference's params carry across unchanged.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..sharding import BATCH, shard_hint
from ..tree import tree_map
from .common import (ParamSpec, at_least_fp32, checkpointed, next_token_nll,
                     rms_norm, stack_schema)
from .linear_scan import chunked_linear_attention, linear_step

__all__ = ["RwkvConfig", "rwkv_schema", "init_state", "forward", "decode_step",
           "lm_loss"]


@dataclasses.dataclass(frozen=True)
class RwkvConfig:
    """The reference's ``RwkvConfig``."""

    name: str
    layers: int
    d_model: int
    d_ff: int
    vocab: int
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 64

    @property
    def n_heads(self):
        return self.d_model // self.head_dim


def _layer_schema(cfg: RwkvConfig) -> dict:
    """One layer's schema (the reference's ``_layer_schema``)."""
    d, f, lora = cfg.d_model, cfg.d_ff, cfg.decay_lora
    h, hd = cfg.n_heads, cfg.head_dim

    def mix():
        return ParamSpec((d,), ("embed",), scale=0.02)

    return {
        "ln_att": ParamSpec((d,), ("embed",), scale=0.0),
        "mix_r": mix(), "mix_k": mix(), "mix_v": mix(),
        "mix_w": mix(), "mix_g": mix(),
        "w0": ParamSpec((d,), ("embed",), scale=0.02),
        "w_lora_a": ParamSpec((d, lora), ("embed", None)),
        "w_lora_b": ParamSpec((lora, d), (None, "embed"), scale=0.02),
        "wr": ParamSpec((d, d), ("embed", "heads")),
        "wk": ParamSpec((d, d), ("embed", "heads")),
        "wv": ParamSpec((d, d), ("embed", "heads")),
        "wg": ParamSpec((d, d), ("embed", "heads")),
        "wo": ParamSpec((d, d), ("heads", "embed")),
        "u": ParamSpec((h, hd), ("heads", None), scale=0.02),
        "ln_head": ParamSpec((h, hd), ("heads", None), scale=0.0),
        "ln_ffn": ParamSpec((d,), ("embed",), scale=0.0),
        "mix_fk": mix(), "mix_fr": mix(),
        "wk_ffn": ParamSpec((d, f), ("embed", "ff")),
        "wv_ffn": ParamSpec((f, d), ("ff", "embed")),
        "wr_ffn": ParamSpec((d, d), ("embed", "heads")),
    }


def rwkv_schema(cfg: RwkvConfig) -> dict:
    """The params' schema (the reference's ``rwkv_schema``)."""
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           scale=0.02),
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), scale=0.0),
        "layers": stack_schema(_layer_schema(cfg), cfg.layers),
    }


def _shift(x, x_prev):
    """The token shift: the stream of x_{t-1}.  ``x`` (B, T, d), ``x_prev``
    (B, d) the carry."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _time_mix(w, x, cfg: RwkvConfig, x_prev, state, decode: bool,
              remat: bool):
    """The time mix of the normed input ``x``: ``(out, the shift carry
    x[:, -1], the scan state)``."""
    b, t = x.shape[:2]
    h, hd = cfg.n_heads, cfg.head_dim
    xs = x_prev[:, None] if decode else _shift(x, x_prev)
    r = _mix(x, xs, w["mix_r"]) @ w["wr"]
    k = _mix(x, xs, w["mix_k"]) @ w["wk"]
    v = _mix(x, xs, w["mix_v"]) @ w["wv"]
    g = _mix(x, xs, w["mix_g"]) @ w["wg"]
    xw = _mix(x, xs, w["mix_w"])
    dd = torch.tanh(xw @ w["w_lora_a"]) @ w["w_lora_b"]
    log_w = -torch.exp(torch.clamp(at_least_fp32(w["w0"]) + at_least_fp32(dd),
                                   -8.0, 4.0))
    rh, kh, vh, lw = (a.reshape(b, t, h, hd) for a in (r, k, v, log_w))
    u = at_least_fp32(w["u"])
    if decode:
        y, state = linear_step(rh[:, 0], kh[:, 0], vh[:, 0], lw[:, 0], state,
                               bonus_u=u)
        y = y[:, None]
    else:
        y, state = chunked_linear_attention(rh, kh, vh, lw, bonus_u=u,
                                            chunk=cfg.chunk, state=state,
                                            remat=remat)
    y = rms_norm(y, w["ln_head"])  # per head, with the (h, hd) gain
    y = y.reshape(b, t, h * hd) * F.silu(at_least_fp32(g)).to(y.dtype)
    return y @ w["wo"], x[:, -1], state


def _channel_mix(w, x, x_prev, decode: bool):
    xs = x_prev[:, None] if decode else _shift(x, x_prev)
    k = _mix(x, xs, w["mix_fk"]) @ w["wk_ffn"]
    k = torch.square(torch.relu(at_least_fp32(k))).to(x.dtype)
    r = torch.sigmoid(at_least_fp32(_mix(x, xs, w["mix_fr"]) @ w["wr_ffn"]))
    return (k @ w["wv_ffn"]) * r.to(x.dtype), x[:, -1]


def _layer(w, x, cfg: RwkvConfig, xa, xf, s, decode: bool, remat: bool):
    """One layer: ``(x', xa', xf', s')``.  The shift carries are the
    normed inputs of the two mixes, not the residual stream."""
    h_in = rms_norm(x, w["ln_att"])
    att, xa, s = _time_mix(w, h_in, cfg, xa, s, decode, remat)
    x = x + att
    h2 = rms_norm(x, w["ln_ffn"])
    ffn, xf = _channel_mix(w, h2, xf, decode)
    return x + ffn, xa, xf, s


def init_state(cfg: RwkvConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    """The recurrent state (the cache of an attention-free model), O(1) in
    T: the two shift carries ``xa``/``xf`` (L, B, d) in ``dtype`` and the
    scan state ``s`` (L, B, H, hd, hd) in fp32 (float64 for float64)."""
    dev = resolve_device(device)
    return {
        "xa": torch.zeros((cfg.layers, batch, cfg.d_model), dtype=dtype, device=dev),
        "xf": torch.zeros((cfg.layers, batch, cfg.d_model), dtype=dtype, device=dev),
        "s": torch.zeros((cfg.layers, batch, cfg.n_heads, cfg.head_dim,
                          cfg.head_dim), device=dev,
                         dtype=torch.promote_types(dtype, torch.float32)),
    }


def _run(params, cfg: RwkvConfig, tokens, state, decode: bool,
         autograd: bool = False):
    """Every layer in order; returns ``(logits (B, T, V) fp32, float64 for
    float64 params, the new state's leaves per layer)``.  ``autograd`` runs
    each layer, and each chunk of its scan, under
    ``torch.utils.checkpoint`` (the reference's per-layer and per-chunk
    remat)."""
    x = params["embed"][tokens]
    x = shard_hint(x, BATCH, "data" if x.shape[0] == 1 else None, None)
    layers = tree_map(lambda leaf: leaf.unbind(0), params["layers"])
    new = []
    for l in range(cfg.layers):
        w = tree_map(lambda leaves: leaves[l], layers)
        args = (w, x, cfg, state["xa"][l], state["xf"][l], state["s"][l],
                decode, autograd)
        if autograd:
            x, *st = checkpointed(_layer, *args)
        else:
            x, *st = _layer(*args)
        new.append(st)
    x = rms_norm(x, params["ln_f"])
    return at_least_fp32(x @ params["embed"].t()), new


def forward(params, cfg: RwkvConfig, tokens: torch.Tensor, *,
            autograd: bool = False) -> torch.Tensor:
    """``tokens`` (B, T) -> logits (B, T, V), from a zero state built in
    bf16 as the reference's (its zeros are exact in any dtype).
    ``autograd`` is the training route (remat per layer and per chunk);
    the values are the same."""
    state = init_state(cfg, tokens.shape[0], torch.bfloat16, tokens.device)
    logits, _ = _run(params, cfg, tokens, state, decode=False, autograd=autograd)
    return logits


def decode_step(params, cfg: RwkvConfig, state: dict, tokens: torch.Tensor, pos):
    """One recurrent step: ``tokens`` (B, 1); the state is position-free
    (``pos`` is taken for the bundle's uniform call).  Returns ``(logits
    (B, 1, V), state)``, the state written in place in its own dtypes."""
    del pos
    logits, new = _run(params, cfg, tokens, state, decode=True)
    for l, (xa, xf, s) in enumerate(new):
        state["xa"][l] = xa
        state["xf"][l] = xf
        state["s"][l] = s
    return logits, state


def lm_loss(params, cfg: RwkvConfig, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``targets`` (B, T),
    through the training route."""
    return next_token_nll(forward(params, cfg, tokens, autograd=True), targets)
