"""Decoder-only LM, the dense GQA subset of the JAX package's
``models/transformer.py``: RMS-norm pre-norm layers with GQA attention
(optional per-head qk-norm, attention/logit softcaps, sandwich norms,
embedding scale, sliding windows) and a SwiGLU/GeGLU FFN.

Layers are a Python loop over per-layer weights (the reference scans a
stacked tree; the stacked ``dense_layers`` layout is kept, so the
reference's params carry across unchanged).  Attention takes one of two
routes, chosen by the caller:

* serving (``forward``, ``prefill``, ``decode_step``): causal attention
  from position 0 with several queries runs on K4 (``kernels.flash_attn``);
  every other case (single-query decode against the cache, windows,
  softcaps) is the plain ``attention``.  K4 has no backward and refuses
  autograd on the card;
* training (``lm_loss``, ``forward(autograd=True)``): the reference's own
  differentiable selection (``_attend``, reference ``:304-318``): plain
  masked attention up to ``flash_chunk`` positions, the two-level
  online-softmax scan above it, over the lower triangle of blocks under
  ``flash_block_skip``.

MLA latent attention, MoE FFNs and the sequence-sharded ring cache are
not ported (ROADMAP Queue A 11) and raise ``NotImplementedError``.

KV caches are updated in place: ``prefill`` and ``decode_step`` write the
new positions into the cache they are given and return it, where the
reference returns a new tree (an in-place write saves one cache copy a
step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..devices import resolve_device
from ..kernels.flash_attn import flash_attention
from ..tree import tree_map as map_params
from .common import (NEG_INF, apply_rope, attention, make_attn_mask, rms_norm,
                     rope_inv_freq, softcap)

__all__ = ["LMConfig", "init_lm", "lm_params_from_numpy", "map_params", "forward",
           "lm_loss", "init_cache", "decode_step", "prefill"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig`` fields that a dense GQA stack reads.
    ``attn="mla"`` and ``moe`` exist so a config can say what it is; the
    port raises on them."""

    name: str
    layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"  # "silu" | "gelu"
    attn: str = "gqa"  # "gqa" | "mla"
    moe: Optional[object] = None
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    window: Optional[int] = None
    window_pattern: str = "none"  # "none" | "all" | "alternate"
    rope_base: float = 10000.0
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma: x *= sqrt(d_model)
    sandwich_norms: bool = False  # gemma2 post-attn/post-ffn norms
    max_seq: int = 4096
    # the training route's attention: plain masked attention up to
    # flash_chunk positions, the chunked online-softmax scan above; with
    # flash_block_skip the scan skips the blocks above the diagonal
    flash_chunk: int = 1024
    flash_block_skip: bool = True

    def __post_init__(self):
        if self.act not in ("silu", "gelu"):
            raise ValueError(f"act must be 'silu' or 'gelu', got {self.act!r}")
        if self.window_pattern not in ("none", "all", "alternate"):
            raise ValueError(f"unknown window_pattern {self.window_pattern!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads={self.n_heads} is not a multiple of "
                             f"n_kv_heads={self.n_kv_heads}")


def _check_supported(cfg: LMConfig) -> None:
    if cfg.attn != "gqa":
        raise NotImplementedError(
            f"attn={cfg.attn!r}: MLA is not ported (ROADMAP Queue A 11)")
    if cfg.moe is not None:
        raise NotImplementedError("MoE layers are not ported (ROADMAP Queue A 11)")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _layer_shapes(cfg: LMConfig) -> dict[str, tuple[tuple[int, ...], float | None]]:
    """``name -> (per-layer shape, init scale)``; scale None = fan-in,
    0.0 = zeros (the reference's ``_layer_schema``)."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {"ln_attn": ((d,), 0.0),
         "wq": ((d, h * hd), None),
         "wk": ((d, hkv * hd), None),
         "wv": ((d, hkv * hd), None),
         "wo": ((h * hd, d), None)}
    if cfg.qk_norm:
        s["q_ln"] = ((hd,), 0.0)
        s["k_ln"] = ((hd,), 0.0)
    s["ln_ffn"] = ((d,), 0.0)
    if cfg.sandwich_norms:
        s["ln_attn_post"] = ((d,), 0.0)
        s["ln_ffn_post"] = ((d,), 0.0)
    s["w_gate"] = ((d, cfg.d_ff), None)
    s["w_up"] = ((d, cfg.d_ff), None)
    s["w_down"] = ((cfg.d_ff, d), None)
    return s


def init_lm(cfg: LMConfig, generator: torch.Generator,
            device: str | torch.device = "cuda",
            dtype: torch.dtype = torch.float32) -> dict:
    """Random params in the reference's schema (stacked ``dense_layers``):
    fan-in-scaled normals, 0.02 for the embedding (and untied head), zeros
    for the norm gains.  Drawn from ``generator`` on the CPU, leaf by leaf
    in sorted-key order, then moved to ``device``.  The reference draws
    with a jax PRNG, which is not re-implemented: the same seed gives
    other weights there."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def leaf(shape, scale):
        if scale == 0.0:
            return torch.zeros(shape, dtype=dtype)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        return torch.randn(shape, generator=generator, dtype=dtype) * std

    layer = _layer_shapes(cfg)
    tree = {
        "dense_layers": {name: leaf((cfg.layers,) + shape, scale)
                         for name, (shape, scale) in sorted(layer.items())},
        "embed": leaf((cfg.vocab, cfg.d_model), 0.02),
        "ln_f": leaf((cfg.d_model,), 0.0),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = leaf((cfg.d_model, cfg.vocab), 0.02)
    return map_params(lambda t: t.to(dev), tree)


def _leaf_from_numpy(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, as jax hands it over
        return torch.tensor(a.view(np.int16), device=dev).view(torch.bfloat16)
    return torch.tensor(a, device=dev)


def lm_params_from_numpy(tree: dict, device: str | torch.device = "cuda") -> dict:
    """Carry a tree made elsewhere across unchanged: same tree, same
    layouts, same values and dtypes (bf16 included).  The JAX package's
    ``bundle.init`` params, or its AdamW state ``{"m", "v", "step"}``, as
    nested dicts of numpy arrays."""
    dev = resolve_device(device)
    return map_params(lambda a: _leaf_from_numpy(a, dev), tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _layer_windows(cfg: LMConfig, n_layers: int) -> list:
    """Per-layer sliding-window size (None = global)."""
    if cfg.window is None or cfg.window_pattern == "none":
        return [None] * n_layers
    if cfg.window_pattern == "all":
        return [cfg.window] * n_layers
    # alternate: even layers local, odd global (gemma2)
    return [cfg.window if i % 2 == 0 else None for i in range(n_layers)]


def _attend(q, k, v, q_pos, k_pos, cfg: LMConfig, window, *, scale=None,
            start: int | None = None):
    """Attention of ``q`` (B, Sq, H, D) over ``k``/``v`` (B, Sk, Hkv, D).

    ``start=0`` promises that every row's query positions are
    ``0..Sq-1`` and its key positions ``0..Sk-1`` — position equals index,
    so the causal mask is K4's index mask.  That case, with several queries
    and no window or softcap, runs on K4 over the first ``min(Sq, Sk)``
    keys (later keys are masked for every query).  Everything else is the
    plain masked ``attention``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if start == 0 and sq > 1 and window is None and cfg.attn_softcap is None:
        kk = min(sq, sk)
        qf = q.permute(0, 2, 1, 3).reshape(b * h, sq, d)
        kf = k[:, :kk].permute(0, 2, 1, 3).reshape(b * hkv, kk, d)
        vf = v[:, :kk].permute(0, 2, 1, 3).reshape(b * hkv, kk, v.shape[-1])
        out = flash_attention(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                              scale=scale, causal=True, rep=h // hkv)
        return out.reshape(b, h, sq, -1).permute(0, 2, 1, 3)
    mask = make_attn_mask(q_pos, k_pos, window)
    return attention(q, k, v, mask, scale=scale, attn_softcap=cfg.attn_softcap)


def _flash_attention(q, k, v, q_pos, k_pos, *, scale, window, attn_softcap,
                     chunk, block_skip):
    """Two-level flash attention with an online softmax over KV chunks,
    differentiable: the reference's ``_flash_attention`` (``:167``) and,
    with ``block_skip``, its ``_flash_attention_triangle`` (``:230``), which
    visits only the (q block, kv block) pairs with kv <= q, in the order of
    its flat scan.  q: (B, Sq, H, D), k/v: (B, Sk, Hkv, D).  Each q block
    runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``), so backward recomputes it and the saved state
    stays O(Sq * chunk) per block."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = h // hkv
    qc, kc = min(chunk, sq), min(chunk, sk)
    if sq % qc or sk % kc or (block_skip and sq != sk):
        raise ValueError(f"flash attention over Sq={sq}, Sk={sk} in chunks of "
                         f"{chunk} (block skip {block_skip})")
    nq, nk = sq // qc, sk // kc
    qg = q.reshape(b, nq, qc, hkv, rep, d)
    kg = k.reshape(b, nk, kc, hkv, d)
    vg = v.reshape(b, nk, kc, hkv, dv)
    qp = q_pos.reshape(b, nq, qc)
    kp = k_pos.reshape(b, nk, kc)

    def q_block(qb, qpb, kbs, vbs, kpbs):
        m = torch.full((b, hkv, rep, qc), -math.inf, device=q.device)
        l = torch.zeros((b, hkv, rep, qc), device=q.device)
        acc = torch.zeros((b, hkv, rep, qc, dv), device=q.device)
        for j in range(kbs.shape[1]):
            kb, vb, kpb = kbs[:, j], vbs[:, j], kpbs[:, j]
            logits = torch.einsum("bqhrd,bkhd->bhrqk", qb, kb).float() * scale
            if attn_softcap is not None:
                logits = softcap(logits, attn_softcap)
            ok = kpb[:, None, :] <= qpb[:, :, None]
            if window is not None:
                ok &= kpb[:, None, :] > qpb[:, :, None] - window
            logits = logits + torch.where(ok, 0.0, NEG_INF)[:, None, None]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhrqk,bkhd->bhrqd", p.to(vb.dtype), vb).float()
            m = m_new
        return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)

    blocks = []
    for i in range(nq):
        n = i + 1 if block_skip else nk
        blocks.append(checkpoint(q_block, qg[:, i], qp[:, i], kg[:, :n],
                                 vg[:, :n], kp[:, :n], use_reentrant=False))
    out = torch.stack(blocks, dim=1)  # (B, nq, hkv, rep, qc, dv)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(b, sq, h, dv)


def _attend_autograd(q, k, v, q_pos, k_pos, cfg: LMConfig, window, *,
                     scale=None):
    """The training route: the reference's ``_attend`` (``:304-318``), every
    branch differentiable.  Above ``flash_chunk`` positions (both lengths
    multiples of it) the chunked scan, over the lower triangle of blocks
    under ``flash_block_skip`` when Sq == Sk; otherwise the plain masked
    ``attention``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    sq, sk, c = q.shape[1], k.shape[1], cfg.flash_chunk
    if sq > c and sq % c == 0 and sk % c == 0:
        return _flash_attention(
            q, k, v, q_pos, k_pos, scale=scale, window=window,
            attn_softcap=cfg.attn_softcap, chunk=c,
            block_skip=cfg.flash_block_skip and sq == sk)
    mask = make_attn_mask(q_pos, k_pos, window)
    return attention(q, k, v, mask, scale=scale, attn_softcap=cfg.attn_softcap)


def _gqa_attn(w, x, cfg: LMConfig, rope, q_pos, k_pos, window, cache=None,
              start: int | None = None, autograd: bool = False):
    """The attention block's output.  ``cache`` = dict(k=(B, S, hkv, hd),
    v=...) is written in place at positions ``start..start+S-1``, or
    None.  ``autograd`` takes the training route (``_attend_autograd``)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ w["wq"]).reshape(b, s, h, hd)
    k = (x @ w["wk"]).reshape(b, s, hkv, hd)
    v = (x @ w["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, w["q_ln"])
        k = rms_norm(k, w["k_ln"])
    q = apply_rope(q, rope, q_pos)
    k = apply_rope(k, rope, q_pos)
    if cache is not None:
        cache["k"][:, start:start + s] = k.to(cache["k"].dtype)
        cache["v"][:, start:start + s] = v.to(cache["v"].dtype)
        out = _attend(q, cache["k"], cache["v"], q_pos, k_pos, cfg, window,
                      start=start)
    elif autograd:
        out = _attend_autograd(q, k, v, q_pos, k_pos, cfg, window)
    else:
        out = _attend(q, k, v, q_pos, k_pos, cfg, window, start=start)
    return out.reshape(b, s, h * hd) @ w["wo"]


def _act(cfg: LMConfig):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu if cfg.act == "silu" else (lambda t: F.gelu(t, approximate="tanh"))


def _ffn(w, x, cfg: LMConfig):
    g = x @ w["w_gate"]
    u = x @ w["w_up"]
    return (_act(cfg)(g.float()).to(u.dtype) * u) @ w["w_down"]


def _layer(w, x, cfg: LMConfig, rope, q_pos, k_pos, window, cache, start,
           autograd):
    h_in = rms_norm(x, w["ln_attn"])
    attn_out = _gqa_attn(w, h_in, cfg, rope, q_pos, k_pos, window, cache, start,
                         autograd)
    if cfg.sandwich_norms:
        attn_out = rms_norm(attn_out, w["ln_attn_post"])
    x = x + attn_out
    ffn_out = _ffn(w, rms_norm(x, w["ln_ffn"]), cfg)
    if cfg.sandwich_norms:
        ffn_out = rms_norm(ffn_out, w["ln_ffn_post"])
    return x + ffn_out


def _run_stack(stack_w, x, cfg, rope, q_pos, k_pos, caches, start,
               autograd=False):
    """The layer loop over the stacked weights; ``caches`` the stacked
    (L, B, S, hkv, hd) K/V pair (written in place) or None.  Each stacked
    leaf is unbound once, so its gradient is one stack of the layers'
    (not a sum of L zero-padded selects)."""
    windows = _layer_windows(cfg, cfg.layers)
    layers = {name: leaf.unbind(0) for name, leaf in stack_w.items()}
    for l in range(cfg.layers):
        w = {name: leaf[l] for name, leaf in layers.items()}
        cache = None if caches is None else {"k": caches["k"][l],
                                             "v": caches["v"][l]}
        x = _layer(w, x, cfg, rope, q_pos, k_pos, windows[l], cache, start,
                   autograd)
    return x


def _embed(params, cfg: LMConfig, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x


def _unembed(params, cfg: LMConfig, x):
    x = rms_norm(x, params["ln_f"])
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head).float()
    if cfg.logit_softcap is not None:
        logits = softcap(logits, cfg.logit_softcap)
    return logits


def _positions(b: int, start: int, s: int, device) -> torch.Tensor:
    return torch.arange(start, start + s, dtype=torch.int32,
                        device=device).expand(b, s)


def forward(params, cfg: LMConfig, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None, *,
            autograd: bool = False) -> torch.Tensor:
    """Full-sequence forward: ``tokens`` (B, S) -> logits (B, P + S, V),
    with ``prefix_embeds`` (B, P, d_model) (stub frontend embeddings, such
    as PaliGemma's image patches) ahead of the token embeddings.
    ``autograd=False`` is the serving route (causal attention on K4);
    ``autograd=True`` the training route (``_attend_autograd``), which
    backward differentiates."""
    _check_supported(cfg)
    x = _embed(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    pos = _positions(b, 0, s, x.device)
    rope = rope_inv_freq(cfg.head_dim, cfg.rope_base, x.device)
    x = _run_stack(params["dense_layers"], x, cfg, rope, pos, pos, None, 0,
                   autograd)
    return _unembed(params, cfg, x)


def lm_loss(params, cfg: LMConfig, tokens: torch.Tensor, targets: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``targets`` (B, S) over
    the token positions (the prefix's are dropped), through the training
    route's attention."""
    logits = forward(params, cfg, tokens, prefix_embeds, autograd=True)
    if prefix_embeds is not None:
        logits = logits[:, prefix_embeds.shape[1]:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean()


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> dict:
    """Stacked (L-leading) zero KV caches for decode."""
    _check_supported(cfg)
    shape = (cfg.layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"dense": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                      "v": torch.zeros(shape, dtype=dtype, device=dev)}}


def _cached_pass(params, cfg: LMConfig, cache, tokens, start: int):
    _check_supported(cfg)
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    max_len = cache["dense"]["k"].shape[2]
    if start + s > max_len:
        raise ValueError(f"positions {start}..{start + s - 1} exceed the "
                         f"cache length {max_len}")
    q_pos = _positions(b, start, s, x.device)
    # k_pos <= q_pos hides the not-yet-written cache slots
    k_pos = _positions(b, 0, max_len, x.device)
    rope = rope_inv_freq(cfg.head_dim, cfg.rope_base, x.device)
    x = _run_stack(params["dense_layers"], x, cfg, rope, q_pos, k_pos,
                   cache["dense"], start)
    return _unembed(params, cfg, x), cache


def decode_step(params, cfg: LMConfig, cache, tokens: torch.Tensor, pos: int):
    """One decode step: ``tokens`` (B, 1) at position ``pos`` (the same for
    every row).  Returns ``(logits (B, 1, V), cache)``, the cache written
    in place at ``pos``."""
    return _cached_pass(params, cfg, cache, tokens, int(pos))


def prefill(params, cfg: LMConfig, cache, tokens: torch.Tensor):
    """Batched cache-filling prefill: ``tokens`` (B, P) -> ``(logits (B, P,
    V), cache)`` with positions ``0..P-1`` written in place — the same as
    P ``decode_step`` calls, in one pass whose attention runs on K4."""
    return _cached_pass(params, cfg, cache, tokens, 0)
