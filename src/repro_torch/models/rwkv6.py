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

Tensor parallelism.  Under a process mesh with a ``model`` axis of more
than one rank (``sharding.model_ranks``) each rank holds its cut of every
leaf, as ``schema_shardings`` places it, and computes on it; the layers
exchange activations, never parameters (``copy`` and ``reduce`` are
Megatron-LM's *f* and *g*, as in ``models.transformer``).  A block whose
leaves do not divide over the ranks is whole, as the reference replicates
them, and computed as on one device (the smoke's 64 widths over model 3):
its input taken as it is and its output not summed.  The time mix: ``wr``,
``wk``, ``wv``, ``wg`` are column cuts in whole heads, ``u`` and
``ln_head`` cut by head, the scan runs on the rank's heads and the row-cut
``wo`` is summed; where the columns divide but the heads do not, the
products are gathered and every rank scans every head.  The ranks' work diverges at each column-cut product,
so each mixed input goes through ``copy`` there (a ``copy`` on ``x``
before the mix would leave the whole ``mix_*`` gradients one rank's
columns); the decay's LoRA, ``w_lora_b`` and ``w0`` are whole and each
rank slices its heads' columns of them, so its hidden and those two
leaves go through ``copy`` before the slice (trap 2).  The channel mix:
``wk_ffn`` column-cut, ``wv_ffn`` row-cut, and ``wr_ffn`` column-cut
too, so the sigmoid gate ``r`` is this rank's column block while ``k @
wv_ffn`` is a partial sum over ``ff``: the partial sum is reduced first,
its block times the rank's ``r``, and the blocks gathered (trap 1); a
whole ``wr_ffn`` gates the summed product whole.  The
vocab is cut (65,536 rows): a lookup of this rank's rows summed, the tied
head's logits gathered.  The state keeps the reference's ``cache_axes``:
the scan state ``s`` (L, B, H, hd, hd) cut by head, the shift carries
``xa``/``xf`` (L, B, d) along d, so a decode step gathers each layer's
(B, d) carries (the one cache content that crosses ``model``) and keeps
its block of the new ones.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..sharding import (BATCH, keep_vocab_cut, model_ranks, sequence_ranks,
                        shard_hint)
from ..tree import tree_map
from .common import (ParamSpec, at_least_fp32, embed_rows, next_token_nll,
                     prev_rows, rms_norm, run_layer, stack_schema,
                     vocab_logits)
from .linear_scan import chunked_linear_attention, linear_step, scan_over_ranks
from .transformer import row_out

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
    tp = model_ranks()
    if tp is not None and tp.cut(w["wr"], 1, cfg.d_model):
        return _time_mix_tp(tp, w, x, cfg, x_prev, state, decode, remat)
    b, t = x.shape[:2]
    h, hd = cfg.n_heads, cfg.head_dim
    xs = x_prev[:, None] if decode else _shift(x, x_prev)
    r = _mix(x, xs, w["mix_r"]) @ w["wr"]
    k = _mix(x, xs, w["mix_k"]) @ w["wk"]
    v = _mix(x, xs, w["mix_v"]) @ w["wv"]
    g = _mix(x, xs, w["mix_g"]) @ w["wg"]
    xw = _mix(x, xs, w["mix_w"])
    dd = torch.tanh(xw @ w["w_lora_a"]) @ w["w_lora_b"]
    y, state = _heads_scan(w, cfg, r, k, v, _log_decay(w["w0"], dd), state,
                           w["u"], w["ln_head"], decode, remat)
    y = y * F.silu(at_least_fp32(g)).to(y.dtype)
    return y @ w["wo"], x[:, -1], state


def _log_decay(w0, dd):
    return -torch.exp(torch.clamp(at_least_fp32(w0) + at_least_fp32(dd),
                                  -8.0, 4.0))


def _heads_scan(w, cfg: RwkvConfig, r, k, v, log_w, state, u, ln_head,
                decode: bool, remat: bool):
    """The scan over the heads of ``r``/``k``/``v``/``log_w`` (B, T, n *
    hd), their bonus ``u`` and norm gain ``ln_head`` (n, hd): ``(y (B, T,
    n * hd) normed per head, the scan state)``."""
    b, t = r.shape[:2]
    hd = cfg.head_dim
    n = r.shape[-1] // hd
    rh, kh, vh, lw = (a.reshape(b, t, n, hd) for a in (r, k, v, log_w))
    u = at_least_fp32(u)
    seq = None if decode else sequence_ranks()
    if decode:
        y, state = linear_step(rh[:, 0], kh[:, 0], vh[:, 0], lw[:, 0], state,
                               bonus_u=u)
        y = y[:, None]
    elif seq is not None:  # this rank's block, from the ranks before it
        y = scan_over_ranks(seq, rh, kh, vh, lw, bonus_u=u, chunk=cfg.chunk,
                            remat=remat)
    else:
        y, state = chunked_linear_attention(rh, kh, vh, lw, bonus_u=u,
                                            chunk=cfg.chunk, state=state,
                                            remat=remat)
    y = rms_norm(y, ln_head)  # per head, with the (n, hd) gain
    return y.reshape(b, t, n * hd), state


def _channel_mix(w, x, cfg: RwkvConfig, x_prev, decode: bool):
    tp = model_ranks()
    if tp is not None:
        return _channel_mix_tp(tp, w, x, cfg, x_prev, decode)
    xs = x_prev[:, None] if decode else _shift(x, x_prev)
    k = _mix(x, xs, w["mix_fk"]) @ w["wk_ffn"]
    k = torch.square(torch.relu(at_least_fp32(k))).to(x.dtype)
    r = torch.sigmoid(at_least_fp32(_mix(x, xs, w["mix_fr"]) @ w["wr_ffn"]))
    return (k @ w["wv_ffn"]) * r.to(x.dtype), x[:, -1]


def _layer(w, x, cfg: RwkvConfig, xa, xf, s, decode: bool, remat: bool):
    """One layer: ``(x', xa', xf', s')``.  The shift carries are the
    normed inputs of the two mixes, not the residual stream.  Under a held
    sequence each mix's carry into this rank's block is the previous
    rank's last row (``prev_rows``; rank 0's the zero state's)."""
    seq = None if decode else sequence_ranks()
    h_in = rms_norm(x, w["ln_att"])
    if seq is not None:
        xa = prev_rows(seq, h_in, 1, xa[:, None])[:, 0]
    att, xa, s = _time_mix(w, h_in, cfg, xa, s, decode, remat)
    x = x + att
    h2 = rms_norm(x, w["ln_ffn"])
    if seq is not None:
        xf = prev_rows(seq, h2, 1, xf[:, None])[:, 0]
    ffn, xf = _channel_mix(w, h2, cfg, xf, decode)
    return x + ffn, xa, xf, s


# ---------------------------------------------------------------------------
# tensor parallelism over the mesh's model axis
# ---------------------------------------------------------------------------


def _carry_tp(tp, x_prev, d: int):
    """The whole shift carry (B, d): gathered where this rank holds its
    block of the columns (a decode step's state), else as it is."""
    return tp.gather(x_prev, -1) if x_prev.shape[-1] != d else x_prev


def _carry_out(tp, x, x_prev, d: int):
    """The carry to keep: ``x[:, -1]``, this rank's block of it where the
    state holds blocks."""
    last = x[:, -1]
    return last[:, tp.block(d)] if x_prev.shape[-1] != d else last


def _time_mix_tp(tp, w, x, cfg: RwkvConfig, x_prev, state, decode: bool,
                 remat: bool):
    """``_time_mix`` on this rank's heads: column-cut ``wr``/``wk``/``wv``/
    ``wg`` (each mixed input through ``copy`` first, so that the whole
    ``mix_*`` gradients sum the ranks' columns), its block of the decay
    (the LoRA's hidden, ``w_lora_b`` and ``w0`` through ``copy``, then
    sliced), ``u`` and ``ln_head`` cut by head, the scan on its heads, and
    the row-cut ``wo`` summed over ``model``.  ``state`` is this rank's
    heads, or every head (a forward's zeros).  Where the columns are cut
    inside heads (``u`` whole), the products are gathered and every rank
    scans every head, the whole leaves through ``copy``, and keeps its
    row block for ``wo``."""
    d = cfg.d_model
    own = tp.cut(w["u"], 0, cfg.n_heads)  # a block of whole heads
    cols = tp.block(d) if own else slice(None)
    xs = (_carry_tp(tp, x_prev, d)[:, None] if decode
          else _shift(x, _carry_tp(tp, x_prev, d)))
    r, k, v, g = (tp.copy(_mix(x, xs, w[m])) @ w[p] for m, p in (
        ("mix_r", "wr"), ("mix_k", "wk"), ("mix_v", "wv"), ("mix_g", "wg")))
    if not own:  # every head on every rank
        r, k, v, g = (tp.gather_partial(t, -1) for t in (r, k, v, g))
    hid = tp.copy(torch.tanh(_mix(x, xs, w["mix_w"]) @ w["w_lora_a"]))
    dd = hid @ tp.copy(w["w_lora_b"])[:, cols]
    log_w = _log_decay(tp.copy(w["w0"])[cols], dd)
    if own and state.shape[1] == cfg.n_heads:  # every head: this rank's
        state = state[:, tp.block(cfg.n_heads)]
    u, ln = ((w["u"], w["ln_head"]) if own
             else (tp.copy(w["u"]), tp.copy(w["ln_head"])))
    y, state = _heads_scan(w, cfg, r, k, v, log_w, state, u, ln, decode,
                           remat)
    y = y * F.silu(at_least_fp32(g)).to(y.dtype)
    return row_out(tp, y, w["wo"]), _carry_out(tp, x, x_prev, d), state


def _channel_mix_tp(tp, w, x, cfg: RwkvConfig, x_prev, decode: bool):
    """``_channel_mix`` over model ranks: ``wk_ffn`` column-cut and
    ``wv_ffn`` row-cut where ``ff`` divides (its product a partial sum,
    summed over ``model`` first), else whole; the sigmoid gate from a
    column-cut ``wr_ffn`` is this rank's block of ``r``, the summed
    product's same block times it and the blocks gathered (trap 1: never
    the partial sum times ``r``); a whole ``wr_ffn`` gates it whole."""
    d = x.shape[-1]
    prev = _carry_tp(tp, x_prev, d)
    xs = prev[:, None] if decode else _shift(x, prev)
    xk = _mix(x, xs, w["mix_fk"])
    ff_cut = tp.cut(w["wk_ffn"], 1, cfg.d_ff)
    k = (tp.copy(xk) if ff_cut else xk) @ w["wk_ffn"]
    k = torch.square(torch.relu(at_least_fp32(k))).to(x.dtype)
    kv = k @ w["wv_ffn"]
    if ff_cut:
        kv = tp.reduce(kv)
    xr = _mix(x, xs, w["mix_fr"])
    if not tp.cut(w["wr_ffn"], 1, d):  # the gate whole
        r = torch.sigmoid(at_least_fp32(xr @ w["wr_ffn"]))
        return kv * r.to(x.dtype), _carry_out(tp, x, x_prev, d)
    r = torch.sigmoid(at_least_fp32(tp.copy(xr) @ w["wr_ffn"]))
    out = tp.gather(tp.copy(kv)[..., tp.block(d)] * r.to(x.dtype), -1)
    return out, _carry_out(tp, x, x_prev, d)


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
    x = embed_rows(params["embed"], tokens, cfg.vocab)
    # at batch 1 the sequence over data: a held sequence's block
    held = not decode and sequence_ranks() is not None
    x = shard_hint(x, BATCH, "data" if x.shape[0] == 1 else None, None,
                   seq_dim=1 if held else None)
    layers = tree_map(lambda leaf: leaf.unbind(0), params["layers"])
    new = []
    for l in range(cfg.layers):
        w = tree_map(lambda leaves: leaves[l], layers)
        x, *st = run_layer(_layer, "layers", w, x, cfg, state["xa"][l],
                           state["xf"][l], state["s"][l], decode, autograd,
                           remat=autograd)
        new.append(st)
    x = rms_norm(x, params["ln_f"])
    return vocab_logits(x, params["embed"].t(), cfg.vocab), new


def forward(params, cfg: RwkvConfig, tokens: torch.Tensor, *,
            autograd: bool = False) -> torch.Tensor:
    """``tokens`` (B, T) -> logits (B, T, V), from a zero state built in
    bf16 as the reference's (its zeros are exact in any dtype).
    ``autograd`` is the training route (remat per layer and per chunk);
    the values are the same.  Under a held sequence (batch 1) ``tokens`` is
    this rank's block: the token shifts take the previous block's last
    rows and the scan composes its state across the blocks."""
    state = init_state(cfg, tokens.shape[0], torch.bfloat16, tokens.device)
    logits, _ = _run(params, cfg, tokens, state, decode=False,
                     autograd=autograd)
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
    with keep_vocab_cut():  # the vocab-parallel loss over model ranks
        logits = forward(params, cfg, tokens, autograd=True)
    return next_token_nll(logits, targets, cfg.vocab)
