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

Tensor parallelism.  Under a process mesh with a ``model`` axis of more
than one rank each rank holds its cut of every leaf (``schema_shardings``)
and exchanges activations, never parameters: the self- and cross-
attention's ``wq``/``wk``/``wv`` are column cuts (16 heads divide 2 and
16; where the columns cut inside heads the projections are gathered and
every rank attends every head), ``wo`` a row cut summed over ``model``,
``w_up``/``w_down`` as an FFN's; each rank attends its heads (on K4 where
the route says so).  Where the width does not divide (the smoke's 64 over
model 3) a block is whole, as the reference replicates it, and computed
as on one device, its input as it is and its output not summed.  The
vocab (51,865) is odd and stays whole at full width; where it divides
(smoke) it is cut, as the transformer's.  The caches keep the reference's
``cache_axes``: the self cache on the sequence where its length divides
the ranks, else whole (its leaves carry the axes that cut them as
``seq_axes``), written by ``transformer.write_block`` and read by
``merged_decode`` or, whole, as on one device; the cross cache on the
sequence where the ranks divide ``enc_len`` (1,500 over 2: merged without
a mask), else whole.  A decode step over model ranks computes every
head's query, key and value on every rank (the column blocks gathered).
``precompute_cross_kv`` fills either cache with the reference's values.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..sharding import BATCH, MODEL, QUEUE_3C, model_ranks, shard_hint
from ..tree import tree_map
from .common import (ParamSpec, attention, embed_rows, make_attn_mask,
                     next_token_nll, position_index, rms_norm, run_layer,
                     stack_schema, vocab_logits)
from .transformer import attend, merged_decode, row_out, write_block

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
    (``pos`` the queries' and keys' positions) or unmasked; on K4 where
    ``attend_route`` says so, never under ``autograd``.  Over model ranks
    holding column blocks of ``wq``/``wk``/``wv``, this rank's heads (each
    input through ``copy``; every head from the gathered projections where
    a block is not whole heads) and the row-cut ``wo`` summed; over model
    ranks holding them whole, as on one device."""
    b, sq, d = xq.shape
    h, hd = cfg.n_heads, cfg.head_dim
    tp = model_ranks()
    if tp is not None and not tp.cut(w["wq"], 1, d):
        tp = None  # whole on every rank
    if tp is not None:
        xq, xkv = (tp.copy(xq),) * 2 if xkv is xq else (tp.copy(xq),
                                                          tp.copy(xkv))
    q, k, v = xq @ w["wq"], xkv @ w["wk"], xkv @ w["wv"]
    if tp is not None and h % tp.size:  # a cut inside a head: every head
        q, k, v = (tp.gather_partial(t, -1) for t in (q, k, v))
    elif tp is not None:
        h //= tp.size
    q, k, v = (t.reshape(b, -1, h, hd) for t in (q, k, v))
    out = attend(q, k, v, pos, pos, scale=1.0 / math.sqrt(hd),
                 start=0 if causal else None, flash_chunk=cfg.flash_chunk,
                 causal=causal, autograd=autograd)
    out = out.reshape(b, sq, h * hd)
    return out @ w["wo"] if tp is None else row_out(tp, out, w["wo"])


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation; F.gelu to erf
    return F.gelu(x, approximate="tanh")


def _ffn(w, x, cfg: WhisperConfig):
    tp = model_ranks()
    if tp is not None and tp.cut(w["w_up"], 1, cfg.d_ff):
        # column-cut up, row-cut down, summed over model
        h = _gelu((tp.copy(x) @ w["w_up"]).float()).to(x.dtype)
        return tp.reduce(h @ w["w_down"])
    return _gelu((x @ w["w_up"]).float()).to(x.dtype) @ w["w_down"]


def _enc_layer(w, x, cfg, autograd):
    h = rms_norm(x, w["ln1"])
    x = x + _mha(w["self"], h, h, cfg, autograd=autograd)
    return x + _ffn(w, rms_norm(x, w["ln2"]), cfg)


def _dec_layer(w, x, enc_out, cfg, pos, autograd):
    h = rms_norm(x, w["ln1"])
    x = x + _mha(w["self"], h, h, cfg, pos, causal=True, autograd=autograd)
    h = rms_norm(x, w["ln_cross"])
    x = x + _mha(w["cross"], h, enc_out, cfg, autograd=autograd)
    return x + _ffn(w, rms_norm(x, w["ln2"]), cfg)


def _each_layer(fn, stack: str, ws, x, *args, autograd: bool):
    """``x`` through ``fn(w, x, *args)`` for each layer's ``w`` of
    ``params[stack]``, its FSDP shards gathered first (``run_layer``);
    under ``autograd`` each layer under ``torch.utils.checkpoint`` (the
    reference's per-layer ``jax.checkpoint``)."""
    for w in ws:
        x = run_layer(fn, stack, w, x, *args, remat=autograd)
    return x


def encode(params, cfg: WhisperConfig, frames: torch.Tensor, *,
           autograd: bool = False) -> torch.Tensor:
    """``frames`` (B, enc_len, d) stub embeddings -> the encoder's states."""
    x = frames + params["pos_enc"][None].to(frames.dtype)
    x = shard_hint(x, BATCH, None, None)
    x = _each_layer(_enc_layer, "enc_layers",
                    _layers(params["enc_layers"], cfg.enc_layers), x, cfg,
                    autograd, autograd=autograd)
    return rms_norm(x, params["ln_enc"])


def _pos_dec(params, start, s: int) -> torch.Tensor:
    """Rows ``start..start+s-1`` of the decoder's positional embedding,
    rounded to bf16 as the reference rounds them; ``start`` an int, or a
    decode step's (1,) int64 position (``s`` = 1), read by index."""
    table = params["pos_dec"]
    rows = (table.index_select(0, start) if isinstance(start, torch.Tensor)
            else table[start:start + s])
    return rows[None].to(torch.bfloat16)


def _logits(params, cfg: WhisperConfig, x):
    x = rms_norm(x, params["ln_dec"])
    return vocab_logits(x, params["embed"].t(), cfg.vocab, lambda t: t.float())


def decode(params, cfg: WhisperConfig, tokens: torch.Tensor,
           enc_out: torch.Tensor, *, autograd: bool = False) -> torch.Tensor:
    """The teacher-forced decoder pass: ``tokens`` (B, S) over ``enc_out``
    -> logits (B, S, V)."""
    b, s = tokens.shape
    x = embed_rows(params["embed"], tokens, cfg.vocab) + _pos_dec(params, 0, s)
    x = shard_hint(x, BATCH, None, None)
    pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    x = _each_layer(_dec_layer, "dec_layers",
                    _layers(params["dec_layers"], cfg.dec_layers), x, enc_out,
                    cfg, pos, autograd, autograd=autograd)
    return _logits(params, cfg, x)


def forward(params, cfg: WhisperConfig, frames: torch.Tensor,
            tokens: torch.Tensor, *, autograd: bool = False) -> torch.Tensor:
    """``decode`` over ``encode(frames)``.  ``autograd=False`` is the
    serving route (the encoder's attention and the decoder's self- and
    cross-attention on K4 where ``attend_route`` says so);
    ``autograd=True`` the training route."""
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
    self K/V leaves are shared).  Over model ranks each computes its heads,
    gathered to every head, and keeps its block of the encoder positions
    where the leaf is cut on them: the cut of the reference's leaf."""
    hd, n = cfg.head_dim, cfg.dec_layers
    b = enc_out.shape[0]
    cross = params["dec_layers"]["cross"]
    tp = model_ranks()

    def kv(wkv):
        out = torch.einsum("bsd,ldh->lbsh", enc_out, wkv).reshape(
            n, b, cfg.enc_len, -1, hd)
        if tp is None:
            return out
        if tp.cut(wkv, 2, cfg.d_model):  # this rank's columns: every head's
            out = tp.gather(out, 3)
        cut = cache["ck"].shape[2] != cfg.enc_len
        return out[:, :, tp.block(cfg.enc_len)] if cut else out

    ck, cv = kv(cross["wk"]), kv(cross["wv"])
    return {**cache, "ck": ck.to(cache["ck"].dtype), "cv": cv.to(cache["cv"].dtype)}


def decode_step(params, cfg: WhisperConfig, cache: dict, tokens: torch.Tensor,
                pos):
    """One decoder token ``tokens`` (B, 1) at position ``pos``, over the
    self-KV cache (written in place at ``pos``) and the cache's cross K/V:
    ``pos`` a Python int, range-checked against the cache, or a 0-d
    integer tensor on the cache's device, which its caller checks (a
    captured step's copied-in position).  Returns ``(logits (B, 1, V),
    cache)``."""
    tp = model_ranks()
    if tp is not None:
        return _decode_step_tp(tp, params, cfg, cache, tokens, pos)
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
        x = x + _ffn(w, rms_norm(x, w["ln2"]), cfg)
    return _logits(params, cfg, x), cache


def _all_heads(tp, w, x, d: int, keys=("wq", "wk", "wv")):
    """Every head of ``x`` through the projections ``w[keys]`` on every
    rank (a decode step's): the column blocks gathered over ``model``, or
    whole; and whether they (and ``wo``, in row blocks) are cut."""
    cut = tp.cut(w["wq"], 1, d)
    out = tuple(x @ w[key] for key in keys)
    return (tuple(tp.gather(t, -1) for t in out) if cut else out), cut


def _decode_step_tp(tp, params, cfg: WhisperConfig, cache: dict,
                    tokens: torch.Tensor, pos):
    """``decode_step`` over model ranks and this rank's cut of the caches
    (``cache_axes``).  Each rank computes every head's query, key and
    value (``_all_heads``).  The self cache, where cut on the sequence,
    takes the new position where this rank's block holds it and the
    query attends over the rank's positions, the partial softmaxes merged
    by log-sum-exp; where whole (its length does not divide the ranks) it
    is written and read as on one device.  The cross cache is cut on the
    sequence where the ranks divide ``enc_len`` (merged without a mask),
    else whole.  A row-cut ``wo`` takes this rank's rows and is summed;
    a whole one is used as it is."""
    if isinstance(pos, torch.Tensor):
        raise NotImplementedError(f"{cfg.name}: a captured step (a tensor "
                                  f"position) over model = {tp.size}; "
                                  f"{QUEUE_3C}")
    b = tokens.shape[0]
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    sl = cache["k"].shape[2]
    cut_self = getattr(cache["k"], "seq_axes", (MODEL,)) != ()
    lo = tp.rank * sl if cut_self else 0
    max_len = sl * tp.size if cut_self else sl
    if not 0 <= pos < max_len:
        raise ValueError(f"position {pos} is outside the cache length "
                         f"{max_len}")
    dev = tokens.device
    x = embed_rows(params["embed"], tokens, cfg.vocab) + _pos_dec(
        params, position_index(pos, dev), 1)
    q_pos = torch.full((b, 1), pos, dtype=torch.long, device=dev)
    scale = 1.0 / math.sqrt(hd)
    self_mask = make_attn_mask(q_pos, torch.arange(
        max_len, dtype=torch.int32, device=dev).expand(b, max_len))
    cross_mask = torch.zeros((b, 1, 1, cfg.enc_len), dtype=torch.float32,
                             device=dev)

    def out_proj(out, wo, cut):
        out = out.reshape(b, 1, d)
        return row_out(tp, out, wo) if cut else out @ wo

    for l, w in enumerate(_layers(params["dec_layers"], cfg.dec_layers)):
        ws, wc = w["self"], w["cross"]
        hn = rms_norm(x, w["ln1"])
        (q, k, v), cut = _all_heads(tp, ws, hn, d)
        q, k, v = (t.reshape(b, 1, h, hd) for t in (q, k, v))
        kc, vc = cache["k"][l], cache["v"][l]
        write_block(kc, k, lo, pos)
        write_block(vc, v, lo, pos)
        if cut_self:
            out = merged_decode(tp, q, kc, vc, q_pos, lo, scale, None, None)
        else:
            out = attention(q, kc, vc, self_mask, scale=scale)
        x = x + out_proj(out, ws["wo"], cut)
        hn = rms_norm(x, w["ln_cross"])
        (qc,), cut = _all_heads(tp, wc, hn, d, ("wq",))
        qc = qc.reshape(b, 1, h, hd)
        ck, cv = cache["ck"][l], cache["cv"][l]
        if tp.cut(ck, 1, cfg.enc_len):
            out = merged_decode(tp, qc, ck, cv, q_pos, tp.rank * ck.shape[1],
                                scale, None, None, causal=False)
        else:
            out = attention(qc, ck, cv, cross_mask, scale=scale)
        x = x + out_proj(out, wc["wo"], cut)
        x = x + _ffn(w, rms_norm(x, w["ln2"]), cfg)
    return _logits(params, cfg, x), cache


def lm_loss(params, cfg: WhisperConfig, frames: torch.Tensor,
            tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``targets`` (B, S) given
    ``frames``, through the training route."""
    return next_token_nll(forward(params, cfg, frames, tokens, autograd=True),
                          targets)
