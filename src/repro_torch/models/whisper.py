"""Whisper-style encoder-decoder backbone, the JAX package's
``models/whisper.py``.

The conv / mel frontend is a stub, as in the reference: ``encode`` takes
precomputed frame embeddings (B, enc_len, d).  The encoder's
self-attention is bidirectional; the decoder has causal self-attention
and cross-attention to the encoder's output, with a self-KV cache and
cross K/V precomputed for decode.  Norms are RMS; the FFN's GELU is the
tanh approximation (``jax.nn.gelu``'s default).

Attention asks ``transformer.attend`` for its route: the decoder's causal
self-attention over a prompt runs on K4; the encoder, the
cross-attention (an all-zero mask) and every decode step take the plain
masked ``attention``.  The decoder's positional embedding is rounded to
bf16 before it is added, in ``decode`` and ``decode_step`` alike, as the
reference rounds it, whatever the params' dtype.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..tree import tree_map
from .common import (ParamSpec, attention, checkpointed, make_attn_mask,
                     next_token_nll, position_index, rms_norm, stack_schema)
from .transformer import attend

__all__ = ["WhisperConfig", "whisper_schema", "encode", "decode", "forward",
           "init_cache", "precompute_cross_kv", "decode_step", "lm_loss"]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """The reference's ``WhisperConfig``."""

    name: str
    enc_layers: int
    dec_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    enc_len: int = 1500
    max_dec_len: int = 32768
    flash_chunk: int = 1024

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


def _attn_schema(d: int, axes=("embed", "heads")) -> dict:
    return {"wq": ParamSpec((d, d), axes), "wk": ParamSpec((d, d), axes),
            "wv": ParamSpec((d, d), axes),
            "wo": ParamSpec((d, d), (axes[1], axes[0]))}


def _enc_layer_schema(cfg: WhisperConfig) -> dict:
    d = cfg.d_model
    return {"ln1": ParamSpec((d,), ("embed",), scale=0.0),
            "self": _attn_schema(d),
            "ln2": ParamSpec((d,), ("embed",), scale=0.0),
            "w_up": ParamSpec((d, cfg.d_ff), ("embed", "ff")),
            "w_down": ParamSpec((cfg.d_ff, d), ("ff", "embed"))}


def _dec_layer_schema(cfg: WhisperConfig) -> dict:
    s = _enc_layer_schema(cfg)
    s["ln_cross"] = ParamSpec((cfg.d_model,), ("embed",), scale=0.0)
    s["cross"] = _attn_schema(cfg.d_model)
    return s


def whisper_schema(cfg: WhisperConfig) -> dict:
    """The params' schema (the reference's ``whisper_schema``)."""
    d = cfg.d_model
    return {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"), scale=0.02),
        "pos_dec": ParamSpec((cfg.max_dec_len, d), (None, "embed"), scale=0.01),
        "pos_enc": ParamSpec((cfg.enc_len, d), (None, "embed"), scale=0.01),
        "enc_layers": stack_schema(_enc_layer_schema(cfg), cfg.enc_layers),
        "dec_layers": stack_schema(_dec_layer_schema(cfg), cfg.dec_layers),
        "ln_enc": ParamSpec((d,), ("embed",), scale=0.0),
        "ln_dec": ParamSpec((d,), ("embed",), scale=0.0),
    }


def _layers(stack: dict, n: int) -> list:
    """Each layer's weights, the stacked leaves unbound once."""
    layers = tree_map(lambda leaf: leaf.unbind(0), stack)
    return [tree_map(lambda leaves: leaves[l], layers) for l in range(n)]


def _mha(w, xq, xkv, cfg: WhisperConfig, pos=None, causal: bool = False,
         autograd: bool = False):
    """Multi-head attention of ``xq`` over ``xkv``: causal from position 0
    (``pos`` the queries' and keys' positions) or unmasked."""
    b, sq, d = xq.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = (xq @ w["wq"]).reshape(b, sq, h, hd)
    k = (xkv @ w["wk"]).reshape(b, -1, h, hd)
    v = (xkv @ w["wv"]).reshape(b, -1, h, hd)
    out = attend(q, k, v, pos, pos, scale=1.0 / math.sqrt(hd),
                 start=0 if causal else None, flash_chunk=cfg.flash_chunk,
                 causal=causal, autograd=autograd)
    return out.reshape(b, sq, d) @ w["wo"]


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation; F.gelu to erf
    return F.gelu(x, approximate="tanh")


def _ffn(w, x):
    return _gelu((x @ w["w_up"]).float()).to(x.dtype) @ w["w_down"]


def _enc_layer(w, x, cfg):
    h = rms_norm(x, w["ln1"])
    x = x + _mha(w["self"], h, h, cfg)
    return x + _ffn(w, rms_norm(x, w["ln2"]))


def _dec_layer(w, x, enc_out, cfg, pos, autograd):
    h = rms_norm(x, w["ln1"])
    x = x + _mha(w["self"], h, h, cfg, pos, causal=True, autograd=autograd)
    h = rms_norm(x, w["ln_cross"])
    x = x + _mha(w["cross"], h, enc_out, cfg)
    return x + _ffn(w, rms_norm(x, w["ln2"]))


def _each_layer(fn, ws, x, *args, autograd: bool):
    """``x`` through ``fn(w, x, *args)`` for each layer's ``w``; under
    ``autograd`` each layer under ``torch.utils.checkpoint`` (the
    reference's per-layer ``jax.checkpoint``)."""
    for w in ws:
        if autograd:
            x = checkpointed(fn, w, x, *args)
        else:
            x = fn(w, x, *args)
    return x


def encode(params, cfg: WhisperConfig, frames: torch.Tensor, *,
           autograd: bool = False) -> torch.Tensor:
    """``frames`` (B, enc_len, d) stub embeddings -> the encoder's states."""
    x = frames + params["pos_enc"][None].to(frames.dtype)
    x = _each_layer(_enc_layer, _layers(params["enc_layers"], cfg.enc_layers), x,
                    cfg, autograd=autograd)
    return rms_norm(x, params["ln_enc"])


def _pos_dec(params, start, s: int) -> torch.Tensor:
    """Rows ``start..start+s-1`` of the decoder's positional embedding,
    rounded to bf16 as the reference rounds them; ``start`` an int, or a
    decode step's (1,) int64 position (``s`` = 1), read by index."""
    table = params["pos_dec"]
    rows = (table.index_select(0, start) if isinstance(start, torch.Tensor)
            else table[start:start + s])
    return rows[None].to(torch.bfloat16)


def _logits(params, x):
    x = rms_norm(x, params["ln_dec"])
    return (x @ params["embed"].t()).float()


def decode(params, cfg: WhisperConfig, tokens: torch.Tensor,
           enc_out: torch.Tensor, *, autograd: bool = False) -> torch.Tensor:
    """The teacher-forced decoder pass: ``tokens`` (B, S) over ``enc_out``
    -> logits (B, S, V)."""
    b, s = tokens.shape
    x = params["embed"][tokens] + _pos_dec(params, 0, s)
    pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x = _each_layer(_dec_layer, _layers(params["dec_layers"], cfg.dec_layers), x,
                    enc_out, cfg, pos, autograd, autograd=autograd)
    return _logits(params, x)


def forward(params, cfg: WhisperConfig, frames: torch.Tensor,
            tokens: torch.Tensor, *, autograd: bool = False) -> torch.Tensor:
    """``decode`` over ``encode(frames)``.  ``autograd=False`` is the
    serving route (the decoder's self-attention on K4 where
    ``attend_route`` says so); ``autograd=True`` the training route."""
    enc_out = encode(params, cfg, frames, autograd=autograd)
    return decode(params, cfg, tokens, enc_out, autograd=autograd)


def init_cache(cfg: WhisperConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device = "cuda") -> dict:
    """Zero caches: the decoder's self K/V ``k``/``v`` (L, B, max_len, H, hd)
    and the cross K/V ``ck``/``cv`` (L, B, enc_len, H, hd), which
    ``precompute_cross_kv`` fills once a request."""
    dev = resolve_device(device)
    h, hd, n = cfg.n_heads, cfg.head_dim, cfg.dec_layers

    def zeros(s):
        return torch.zeros((n, batch, s, h, hd), dtype=dtype, device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "ck": zeros(cfg.enc_len), "cv": zeros(cfg.enc_len)}


def precompute_cross_kv(params, cfg: WhisperConfig, enc_out: torch.Tensor,
                        cache: dict) -> dict:
    """The cache with its cross K/V computed from ``enc_out`` (B, enc_len,
    d) for every decoder layer, in the cache's dtype (a new tree; the
    self K/V leaves are shared)."""
    h, hd, n = cfg.n_heads, cfg.head_dim, cfg.dec_layers
    b = enc_out.shape[0]
    cross = params["dec_layers"]["cross"]
    ck = torch.einsum("bsd,ldh->lbsh", enc_out, cross["wk"]).reshape(
        n, b, cfg.enc_len, h, hd)
    cv = torch.einsum("bsd,ldh->lbsh", enc_out, cross["wv"]).reshape(
        n, b, cfg.enc_len, h, hd)
    return {**cache, "ck": ck.to(cache["ck"].dtype), "cv": cv.to(cache["cv"].dtype)}


def decode_step(params, cfg: WhisperConfig, cache: dict, tokens: torch.Tensor,
                pos):
    """One decoder token ``tokens`` (B, 1) at position ``pos``, over the
    self-KV cache (written in place at ``pos``) and the cache's cross K/V:
    ``pos`` a Python int, range-checked against the cache, or a 0-d
    integer tensor on the cache's device, which its caller checks (a
    captured step's copied-in position).  Returns ``(logits (B, 1, V),
    cache)``."""
    b = tokens.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    max_len = cache["k"].shape[2]
    if not isinstance(pos, torch.Tensor) and not 0 <= int(pos) < max_len:
        raise ValueError(f"position {int(pos)} is outside the cache length "
                         f"{max_len}")
    dev = tokens.device
    at = position_index(pos, dev)
    x = params["embed"][tokens] + _pos_dec(params, at, 1)
    q_pos = at.expand(b, 1)
    k_pos = torch.arange(max_len, dtype=torch.int32, device=dev).expand(b, max_len)
    self_mask = make_attn_mask(q_pos, k_pos)
    cross_mask = torch.zeros((b, 1, 1, cfg.enc_len), dtype=torch.float32,
                             device=dev)
    scale = 1.0 / math.sqrt(hd)
    for l, w in enumerate(_layers(params["dec_layers"], cfg.dec_layers)):
        hn = rms_norm(x, w["ln1"])
        q = (hn @ w["self"]["wq"]).reshape(b, 1, h, hd)
        kc, vc = cache["k"][l], cache["v"][l]
        for c, wkv in ((kc, w["self"]["wk"]), (vc, w["self"]["wv"])):
            c.index_copy_(1, at, (hn @ wkv).reshape(b, 1, h, hd).to(c.dtype))
        out = attention(q, kc, vc, self_mask, scale=scale)
        x = x + out.reshape(b, 1, -1) @ w["self"]["wo"]
        hn = rms_norm(x, w["ln_cross"])
        qc = (hn @ w["cross"]["wq"]).reshape(b, 1, h, hd)
        outc = attention(qc, cache["ck"][l], cache["cv"][l], cross_mask,
                         scale=scale)
        x = x + outc.reshape(b, 1, -1) @ w["cross"]["wo"]
        x = x + _ffn(w, rms_norm(x, w["ln2"]))
    return _logits(params, x), cache


def lm_loss(params, cfg: WhisperConfig, frames: torch.Tensor,
            tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``targets`` (B, S) given
    ``frames``, through the training route."""
    return next_token_nll(forward(params, cfg, frames, tokens, autograd=True),
                          targets)
