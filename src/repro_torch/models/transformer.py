"""Decoder-only LM, the JAX package's ``models/transformer.py``: RMS-norm
pre-norm layers with GQA attention (optional per-head qk-norm,
attention/logit softcaps, sandwich norms, embedding scale, sliding
windows) or MLA latent attention with a compressed KV cache
(DeepSeek-V2/V3), and a SwiGLU/GeGLU FFN or a routed MoE FFN
(``models.moe``) after ``n_dense_layers`` dense-first layers.

Layers are a Python loop over per-layer weights (the reference scans a
stacked tree; the stacked ``dense_layers`` / ``moe_layers`` layout is
kept, so the reference's params carry across unchanged).  Attention takes
one of two routes, chosen by the caller:

* serving (``forward``, ``prefill``, ``decode_step``): causal attention
  from position 0 with several queries runs on K4 (``kernels.flash_attn``)
  where K4 has an instance for the shape (``attend_route``); every other
  case (single-query decode against the cache, windows shorter than the
  queries, softcaps, head
  dims K4 lacks, MLA's v narrower than its q/k) takes the training
  route's plain or chunked attention, decided from the shapes before any
  launch.  K4 has no backward and refuses autograd on the card;
* training (``lm_loss``, ``forward(autograd=True)``): the reference's own
  differentiable selection (``_attend``, reference ``:304-318``): plain
  masked attention up to ``flash_chunk`` positions, the two-level
  online-softmax scan above it, over the lower triangle of blocks under
  ``flash_block_skip``.

KV caches are updated in place: ``prefill`` and ``decode_step`` write the
new positions into the cache they are given and return it, where the
reference returns a new tree (an in-place write saves one cache copy a
step).  On one device an indexed write has the values of both of the
reference's cache writes (``_ring_write``'s select and its
dynamic-update-slice); which one it picks matters only for a cache
sharded over a mesh, which waits for the port's sharding slice.  The
write is an ``index_copy_`` at the pass's positions, so ``decode_step``
takes its position as a Python int or as a 0-d integer tensor on the
cache's device (a captured step's copied-in position), with the same
values either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..kernels.flash_attn import HEAD_DIMS, flash_attention
from ..tree import tree_leaves
from ..tree import tree_map as map_params
from .common import (NEG_INF, ParamSpec, apply_rope, attention, checkpointed,
                     make_attn_mask, next_token_nll, params_from_numpy, rms_norm,
                     rope_inv_freq, schema_init, softcap, stack_schema)
from .moe import MoEConfig, moe_ffn, moe_schema

__all__ = ["LMConfig", "MLAConfig", "MoEConfig", "lm_schema", "init_lm",
           "lm_params_from_numpy",
           "map_params", "forward", "lm_loss", "init_cache", "decode_step",
           "prefill", "attend_route", "attend"]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int  # 0 => direct q projection
    kv_lora: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_dim: int


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig``."""

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
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    n_dense_layers: int = 0  # leading dense layers before the MoE stack
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
    sub_quadratic: bool = False  # True only for SSM/hybrid families

    def __post_init__(self):
        if self.act not in ("silu", "gelu"):
            raise ValueError(f"act must be 'silu' or 'gelu', got {self.act!r}")
        if self.attn not in ("gqa", "mla"):
            raise ValueError(f"attn must be 'gqa' or 'mla', got {self.attn!r}")
        if self.attn == "mla" and not isinstance(self.mla, MLAConfig):
            raise ValueError("attn='mla' needs mla=MLAConfig(...)")
        if self.moe is not None and not isinstance(self.moe, MoEConfig):
            raise ValueError(f"moe must be a MoEConfig, got {type(self.moe)}")
        if self.window_pattern not in ("none", "all", "alternate"):
            raise ValueError(f"unknown window_pattern {self.window_pattern!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads={self.n_heads} is not a multiple of "
                             f"n_kv_heads={self.n_kv_heads}")

    @property
    def q_dim(self):
        if self.attn == "mla":
            return self.mla.qk_nope_dim + self.mla.qk_rope_dim
        return self.head_dim

    @property
    def rope_dim(self):
        return self.mla.qk_rope_dim if self.attn == "mla" else self.head_dim


def _stacks(cfg: LMConfig) -> list[tuple[str, str, int, bool, int]]:
    """``(params key, cache key, layers, MoE FFN, first layer)`` of each
    non-empty stack: the dense-first layers, then the MoE layers."""
    n_moe = (cfg.layers - cfg.n_dense_layers) if cfg.moe else 0
    n_dense = cfg.layers - n_moe
    out = []
    if n_dense:
        out.append(("dense_layers", "dense", n_dense, False, 0))
    if n_moe:
        out.append(("moe_layers", "moe", n_moe, True, n_dense))
    return out


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _layer_schema(cfg: LMConfig, moe_layer: bool = False) -> dict:
    """One layer's schema (the reference's ``_layer_schema``), the MoE
    FFN nested under ``"moe"``."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s: dict = {"ln_attn": ParamSpec((d,), ("embed",), scale=0.0)}
    if cfg.attn == "mla":
        m = cfg.mla
        qh = m.qk_nope_dim + m.qk_rope_dim
        if m.q_lora:
            s["wq_a"] = ParamSpec((d, m.q_lora), ("embed", None))
            s["q_ln"] = ParamSpec((m.q_lora,), (None,), scale=0.0)
            s["wq_b"] = ParamSpec((m.q_lora, h * qh), (None, "heads"))
        else:
            s["wq"] = ParamSpec((d, h * qh), ("embed", "heads"))
        s["wkv_a"] = ParamSpec((d, m.kv_lora + m.qk_rope_dim), ("embed", None))
        s["kv_ln"] = ParamSpec((m.kv_lora,), (None,), scale=0.0)
        s["wkv_b"] = ParamSpec((m.kv_lora, h * (m.qk_nope_dim + m.v_dim)),
                               (None, "heads"))
        s["wo"] = ParamSpec((h * m.v_dim, d), ("heads", "embed"))
    else:
        s["wq"] = ParamSpec((d, h * hd), ("embed", "heads"))
        s["wk"] = ParamSpec((d, hkv * hd), ("embed", "kv_heads"))
        s["wv"] = ParamSpec((d, hkv * hd), ("embed", "kv_heads"))
        s["wo"] = ParamSpec((h * hd, d), ("heads", "embed"))
        if cfg.qk_norm:
            s["q_ln"] = ParamSpec((hd,), (None,), scale=0.0)
            s["k_ln"] = ParamSpec((hd,), (None,), scale=0.0)
    s["ln_ffn"] = ParamSpec((d,), ("embed",), scale=0.0)
    if cfg.sandwich_norms:
        s["ln_attn_post"] = ParamSpec((d,), ("embed",), scale=0.0)
        s["ln_ffn_post"] = ParamSpec((d,), ("embed",), scale=0.0)
    if moe_layer:
        s["moe"] = moe_schema(cfg.moe)
    else:
        s["w_gate"] = ParamSpec((d, cfg.d_ff), ("embed", "ff"))
        s["w_up"] = ParamSpec((d, cfg.d_ff), ("embed", "ff"))
        s["w_down"] = ParamSpec((cfg.d_ff, d), ("ff", "embed"))
    return s


def lm_schema(cfg: LMConfig) -> dict:
    """The params' schema (the reference's ``lm_schema``): the stacked
    ``dense_layers`` and ``moe_layers``, the embedding, the final norm
    and, untied, the head."""
    tree = {key: stack_schema(_layer_schema(cfg, moe_layer), n)
            for key, _, n, moe_layer, _ in _stacks(cfg)}
    tree["embed"] = ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                              scale=0.02)
    tree["ln_f"] = ParamSpec((cfg.d_model,), ("embed",), scale=0.0)
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab),
                                    ("embed", "vocab"), scale=0.02)
    return tree


def init_lm(cfg: LMConfig, generator: torch.Generator,
            device: str | torch.device = "cuda",
            dtype: torch.dtype = torch.float32) -> dict:
    """Random params in the reference's schema (stacked ``dense_layers``
    and ``moe_layers``): ``schema_init`` of ``lm_schema`` — fan-in-scaled
    normals, 0.02 for the embedding (and untied head), zeros for the norm
    gains, drawn leaf by leaf on the generator's device."""
    return schema_init(lm_schema(cfg), generator, device, dtype)


# the reference's params (any family) carried across as numpy
lm_params_from_numpy = params_from_numpy


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _layer_windows(cfg: LMConfig, n_layers: int, offset: int = 0) -> list:
    """Per-layer sliding-window size (None = global) of a stack whose first
    layer is layer ``offset`` of the model."""
    if cfg.window is None or cfg.window_pattern == "none":
        return [None] * n_layers
    if cfg.window_pattern == "all":
        return [cfg.window] * n_layers
    # alternate: even layers local, odd global (gemma2)
    return [cfg.window if (i + offset) % 2 == 0 else None for i in range(n_layers)]


def attend_route(sq: int, sk: int, d: int, dv: int, *, window=None,
                 attn_softcap=None, start: int | None = None,
                 flash_chunk: int = 1024, causal: bool = True) -> str:
    """Which attention the serving route runs for queries ``(.., sq, .., d)``
    over keys ``(.., sk, .., d)`` and values of width ``dv``, decided from
    the shapes before any launch; every family's attention asks it.

    ``"k4"`` where K4 has an instance for the shape: causal from ``start ==
    0`` with several queries, no softcap, ``d`` in K4's ``HEAD_DIMS`` and
    ``dv == d``, and no window or one of at least ``sq`` positions (with
    positions equal to indices such a window masks no key the causal mask
    keeps, so the function is the same).  No transformer arch of the
    reference moves by the window clause: Gemma2's windows come with a
    softcap.  Otherwise the training route's selection: ``"chunked"`` (the
    online-softmax scan: causal, both lengths multiples of ``flash_chunk``
    and the queries more than one chunk) or ``"plain"`` (masked
    attention; an all-zero mask where not ``causal``)."""
    if (causal and start == 0 and sq > 1 and attn_softcap is None
            and d in HEAD_DIMS and dv == d and (window is None or sq <= window)):
        return "k4"
    c = flash_chunk
    if causal and sq > c and sq % c == 0 and sk % c == 0:
        return "chunked"
    return "plain"


def attend(q, k, v, q_pos, k_pos, *, scale: float, window=None,
           attn_softcap=None, start: int | None = None, flash_chunk: int = 1024,
           block_skip: bool = False, causal: bool = True,
           autograd: bool = False) -> torch.Tensor:
    """Attention of ``q`` (B, Sq, H, D) over ``k`` (B, Sk, Hkv, D) and ``v``
    (B, Sk, Hkv, Dv) at positions ``q_pos`` (B, Sq) / ``k_pos`` (B, Sk),
    routed by ``attend_route``; ``autograd`` takes the training route,
    never K4: the chunked scan (over the lower triangle of blocks under
    ``block_skip`` when Sq == Sk) or the plain masked ``attention``.

    ``start=0`` promises that every row's query positions are ``0..Sq-1``
    and its key positions ``0..Sk-1`` — position equals index, so the
    causal mask is K4's index mask; K4 then runs over the first ``min(Sq,
    Sk)`` keys (later keys are masked for every query)."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    # without start, attend_route gives the training route's selection
    route = attend_route(sq, sk, d, v.shape[-1], window=window,
                         attn_softcap=attn_softcap,
                         start=None if autograd else start,
                         flash_chunk=flash_chunk, causal=causal)
    if route == "k4":
        kk = min(sq, sk)
        qf = q.permute(0, 2, 1, 3).reshape(b * h, sq, d)
        kf = k[:, :kk].permute(0, 2, 1, 3).reshape(b * hkv, kk, d)
        vf = v[:, :kk].permute(0, 2, 1, 3).reshape(b * hkv, kk, d)
        out = flash_attention(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                              scale=scale, causal=True, rep=h // hkv)
        return out.reshape(b, h, sq, -1).permute(0, 2, 1, 3)
    if route == "chunked":
        return _flash_attention(
            q, k, v, q_pos, k_pos, scale=scale, window=window,
            attn_softcap=attn_softcap, chunk=flash_chunk,
            block_skip=block_skip and sq == sk)
    if causal:
        mask = make_attn_mask(q_pos, k_pos, window)
    else:
        mask = torch.zeros((b, 1, sq, sk), dtype=torch.float32, device=q.device)
    return attention(q, k, v, mask, scale=scale, attn_softcap=attn_softcap)


def _attend(q, k, v, q_pos, k_pos, cfg: LMConfig, window, *, scale=None,
            start: int | None = None, autograd: bool = False):
    """``attend`` with the transformer's softcap, chunk and block skip."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return attend(q, k, v, q_pos, k_pos, scale=scale, window=window,
                  attn_softcap=cfg.attn_softcap, start=start,
                  flash_chunk=cfg.flash_chunk, block_skip=cfg.flash_block_skip,
                  autograd=autograd)


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
        blocks.append(checkpointed(q_block, qg[:, i], qp[:, i], kg[:, :n],
                                   vg[:, :n], kp[:, :n]))
    out = torch.stack(blocks, dim=1)  # (B, nq, hkv, rep, qc, dv)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(b, sq, h, dv)


def _write(cache: dict, name: str, new: torch.Tensor,
           q_pos: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, S, ...) into ``cache[name]`` in place at the
    positions ``q_pos`` (B, S) int64 (the same in every row); returns the
    whole cache leaf."""
    leaf = cache[name]
    return leaf.index_copy_(1, q_pos[0], new.to(leaf.dtype))


def _gqa_attn(w, x, cfg: LMConfig, rope, q_pos, k_pos, window, cache=None,
              start: int | None = None, autograd: bool = False):
    """The attention block's output.  ``cache`` = dict(k=(B, S, hkv, hd),
    v=...) is written in place at the positions ``q_pos``, or None.
    ``start`` (0 or None) is ``attend``'s.  ``autograd`` takes the
    training route (``attend``'s, never K4)."""
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
        k, v = _write(cache, "k", k, q_pos), _write(cache, "v", v, q_pos)
    out = _attend(q, k, v, q_pos, k_pos, cfg, window, start=start,
                  autograd=autograd)
    return out.reshape(b, s, h * hd) @ w["wo"]


def _mla_attn(w, x, cfg: LMConfig, rope, q_pos, k_pos, window, cache=None,
              start: int | None = None, autograd: bool = False):
    """MLA (the reference's ``_mla_attn``, ``:386-421``) with the
    compressed-latent cache ``dict(ckv=(B, S, kv_lora), krope=(B, S,
    rope_dim))``, written in place; keys and values are expanded from the
    latent over every cached position."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    qh = m.qk_nope_dim + m.qk_rope_dim
    if m.q_lora:
        q = rms_norm(x @ w["wq_a"], w["q_ln"]) @ w["wq_b"]
    else:
        q = x @ w["wq"]
    q_nope, q_rope = q.reshape(b, s, h, qh).split([m.qk_nope_dim, m.qk_rope_dim],
                                                  dim=-1)
    q_rope = apply_rope(q_rope, rope, q_pos)
    ckv, krope = (x @ w["wkv_a"]).split([m.kv_lora, m.qk_rope_dim], dim=-1)
    ckv = rms_norm(ckv, w["kv_ln"])
    krope = apply_rope(krope[:, :, None, :], rope, q_pos)[:, :, 0, :]
    if cache is not None:
        ckv = _write(cache, "ckv", ckv, q_pos)
        krope = _write(cache, "krope", krope, q_pos)
    sk = ckv.shape[1]
    kvx = (ckv @ w["wkv_b"]).reshape(b, sk, h, m.qk_nope_dim + m.v_dim)
    k_nope, v = kvx.split([m.qk_nope_dim, m.v_dim], dim=-1)
    k_rope = krope[:, :, None, :].expand(b, sk, h, m.qk_rope_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope], dim=-1)
    out = _attend(q_full, k_full, v, q_pos, k_pos, cfg, window,
                  scale=1.0 / math.sqrt(qh), start=start, autograd=autograd)
    return out.reshape(b, s, h * m.v_dim) @ w["wo"]


def _act(cfg: LMConfig):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu if cfg.act == "silu" else (lambda t: F.gelu(t, approximate="tanh"))


def _ffn(w, x, cfg: LMConfig):
    g = x @ w["w_gate"]
    u = x @ w["w_up"]
    return (_act(cfg)(g.float()).to(u.dtype) * u) @ w["w_down"]


def _layer(w, x, cfg: LMConfig, rope, q_pos, k_pos, window, moe_layer, cache,
           start, autograd):
    h_in = rms_norm(x, w["ln_attn"])
    attn_fn = _mla_attn if cfg.attn == "mla" else _gqa_attn
    attn_out = attn_fn(w, h_in, cfg, rope, q_pos, k_pos, window, cache, start,
                       autograd)
    if cfg.sandwich_norms:
        attn_out = rms_norm(attn_out, w["ln_attn_post"])
    x = x + attn_out
    h2 = rms_norm(x, w["ln_ffn"])
    if moe_layer:
        b, s, d = h2.shape
        ffn_out = moe_ffn(w["moe"], h2.reshape(b * s, d), cfg.moe).reshape(b, s, d)
    else:
        ffn_out = _ffn(w, h2, cfg)
    if cfg.sandwich_norms:
        ffn_out = rms_norm(ffn_out, w["ln_ffn_post"])
    return x + ffn_out


def _run_stack(stack_w, x, cfg, rope, q_pos, k_pos, caches, start, autograd,
               n, moe_layer, offset):
    """The loop over one stack's ``n`` layers, the first of them layer
    ``offset`` of the model; ``caches`` the stack's (L, B, S, ...) cache
    leaves (written in place) or None.  Each stacked leaf is unbound once,
    so its gradient is one stack of the layers' (not a sum of L
    zero-padded selects)."""
    windows = _layer_windows(cfg, n, offset)
    layers = map_params(lambda leaf: leaf.unbind(0), stack_w)
    for l in range(n):
        w = map_params(lambda leaves: leaves[l], layers)
        cache = None if caches is None else {k: c[l] for k, c in caches.items()}
        x = _layer(w, x, cfg, rope, q_pos, k_pos, windows[l], moe_layer, cache,
                   start, autograd)
    return x


def _run_stacks(params, cfg: LMConfig, x, q_pos, k_pos, cache, start,
                autograd=False):
    """Every stack in order (dense-first, then MoE), with the stacks'
    caches ``cache["dense"]`` / ``cache["moe"]`` or None."""
    rope = rope_inv_freq(cfg.rope_dim, cfg.rope_base, x.device)
    for key, cache_key, n, moe_layer, offset in _stacks(cfg):
        x = _run_stack(params[key], x, cfg, rope, q_pos, k_pos,
                       None if cache is None else cache[cache_key], start,
                       autograd, n, moe_layer, offset)
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


def _positions(b: int, start, s: int, device,
               dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Positions ``start..start+S-1`` in every row, (B, S) of ``dtype``;
    ``start`` an int or a 0-d integer tensor on ``device``."""
    if isinstance(start, torch.Tensor):
        pos = torch.arange(s, dtype=dtype, device=device) + start.to(dtype)
    else:
        pos = torch.arange(start, start + s, dtype=dtype, device=device)
    return pos.expand(b, s)


def forward(params, cfg: LMConfig, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None, *,
            autograd: bool = False) -> torch.Tensor:
    """Full-sequence forward: ``tokens`` (B, S) -> logits (B, P + S, V),
    with ``prefix_embeds`` (B, P, d_model) (stub frontend embeddings, such
    as PaliGemma's image patches) ahead of the token embeddings.
    ``autograd=False`` is the serving route (causal attention on K4 where
    ``attend_route`` says so); ``autograd=True`` the training route
    (``attend``'s, never K4), which backward differentiates."""
    x = _embed(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    pos = _positions(b, 0, s, x.device)
    x = _run_stacks(params, cfg, x, pos, pos, None, 0, autograd)
    return _unembed(params, cfg, x)


def lm_loss(params, cfg: LMConfig, tokens: torch.Tensor, targets: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``targets`` (B, S) over
    the token positions (the prefix's are dropped), through the training
    route's attention."""
    logits = forward(params, cfg, tokens, prefix_embeds, autograd=True)
    if prefix_embeds is not None:
        logits = logits[:, prefix_embeds.shape[1]:]
    return next_token_nll(logits, targets)


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> dict:
    """Stacked (L-leading) zero caches for decode, one a stack (``"dense"``,
    ``"moe"``): K/V ``(L, B, S, hkv, hd)``, or MLA's latent ``ckv (L, B, S,
    kv_lora)`` and ``krope (L, B, S, rope_dim)``."""
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    out = {}
    for _, cache_key, n, _, _ in _stacks(cfg):
        if cfg.attn == "mla":
            m = cfg.mla
            out[cache_key] = {"ckv": zeros(n, batch, max_len, m.kv_lora),
                              "krope": zeros(n, batch, max_len, m.qk_rope_dim)}
        else:
            shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            out[cache_key] = {"k": zeros(*shape), "v": zeros(*shape)}
    return out


def _cached_pass(params, cfg: LMConfig, cache, tokens, start):
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    max_len = tree_leaves(cache)[0].shape[2]
    tensor_start = isinstance(start, torch.Tensor)
    if not tensor_start and start + s > max_len:
        raise ValueError(f"positions {start}..{start + s - 1} exceed the "
                         f"cache length {max_len}")
    # int64: the first row is also the cache writes' index
    q_pos = _positions(b, start, s, x.device, torch.long)
    # k_pos <= q_pos hides the not-yet-written cache slots
    k_pos = _positions(b, 0, max_len, x.device)
    # attend_route's start == 0 is a host-side fact: a tensor start says
    # nothing there (and a decode step, Sq = 1, never takes K4)
    x = _run_stacks(params, cfg, x, q_pos, k_pos, cache,
                    None if tensor_start else start)
    return _unembed(params, cfg, x), cache


def decode_step(params, cfg: LMConfig, cache, tokens: torch.Tensor, pos):
    """One decode step: ``tokens`` (B, 1) at position ``pos`` (the same for
    every row): a Python int, range-checked against the cache, or a 0-d
    integer tensor on the cache's device, which its caller checks (a
    captured step's copied-in position).  Returns ``(logits (B, 1, V),
    cache)``, the cache written in place at ``pos``."""
    return _cached_pass(params, cfg, cache, tokens,
                        pos if isinstance(pos, torch.Tensor) else int(pos))


def prefill(params, cfg: LMConfig, cache, tokens: torch.Tensor):
    """Batched cache-filling prefill: ``tokens`` (B, P) -> ``(logits (B, P,
    V), cache)`` with positions ``0..P-1`` written in place — the same as
    P ``decode_step`` calls, in one pass whose attention runs on K4 where
    ``attend_route`` says so."""
    return _cached_pass(params, cfg, cache, tokens, 0)
