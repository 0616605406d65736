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
dynamic-update-slice).  The
write is an ``index_copy_`` at the pass's positions, so ``decode_step``
takes its position as a Python int or as a 0-d integer tensor on the
cache's device (a captured step's copied-in position), with the same
values either way.

Tensor and expert parallelism.  Under a process mesh with a ``model``
axis of more than one rank (``sharding.model_ranks``) each rank holds its
cut of every leaf, as ``schema_shardings`` places it, and computes on it;
the layers exchange activations, never parameters (Megatron-LM's tensor
parallelism, arXiv:1909.08053 §3, with ``copy`` and ``reduce`` its *f*
and *g*; the reference gets the same from GSPMD).  Column-cut products
(``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``, the head) give this rank's
column block; row-cut ones (``wo``, ``w_down``) take its row block of the
input and are summed over the ranks.  Where a block is not whole heads
(``resolve_pspec`` cuts the flattened ``heads x head_dim`` wherever it
divides: SmolLM's 9 heads) the projection is gathered, every rank attends
every head and keeps its row block for ``wo``; query heads whose KV heads
another rank holds take them from the gathered K/V.  The embedding looks
up this rank's vocab rows (zeros elsewhere) and sums; the logits are this
rank's vocab block, kept so by the loss (``common.next_token_nll``'s
vocab-parallel cross-entropy) and under ``sharding.keep_vocab_cut`` (the
prefill and serve steps), else gathered whole.  MLA cuts its heads (``wq``/``wq_b``,
``wkv_b``, ``wo``); its latents and norms are whole on every rank.  The
caches are cut as the reference's ``cache_axes`` place them: the KV heads
over ``model`` where they divide the production degree 16 (each rank
writes and reads its heads), else the sequence (each rank holds one block
of positions and writes the new positions that fall in it; a decode step
attends over its own positions and the ranks' partial softmaxes are
merged by log-sum-exp; MLA's in the absorbed form, ``wkv_b``'s key half
folded into the query, so only latent queries cross ranks).  A decode
step moves no cache leaf between ranks.

What does not divide is whole, as the reference replicates it.  Where
``wq``'s heads do not divide at all, every rank computes the attention
block as one device does: its input taken as it is (no ``copy``) and its
output whole (no sum), so neither the forward nor the gradient is counted
``model`` times.  MLA whose heads do not divide computes every head on
every rank (``_mla_attn``: a cut projection gathered, a whole one used as
it is, a cut ``wo`` summed).  A cache whose KV heads or positions do not
divide is held whole on every rank and written and read as on one device
(each leaf carries the axes that cut its positions, ``seq_axes``).

The sequence over the mesh.  At a batch of one under
``sharding.hold_sequence`` (the reference's fallback to the sequence over
``data``) a pass over the sequence holds this rank's block of it (of one
position or more), at its own positions (PaliGemma's prefix and tokens
each cut so): the
attention gathers every block's K/V (MLA's latents) over the data ranks,
the gradient reduce-scattered back, and masks by position, so it takes
the chunked or plain route, never K4, whose mask is by index.  The cache
holds this rank's block of positions, over data and ``model`` jointly
where the layout is ``"seq"`` and over data beside heads over ``model``
otherwise (``_cache_seq_axes``): a prefill writes the gathered prompt's
positions that fall in the block, a decode step's one token lands on the
rank that owns its slot, and the step attends over the rank's block,
merged by log-sum-exp over the ranks that cut it (``merged_decode``).  A
decode step's one position is whole on every rank
(``sharding.whole_sequence``), and so is a prompt that does not divide
over the data ranks, which the prefill writes into the cache as its own
length cuts it.  Under ``REPRO_SEQ_PARALLEL=1`` over model ranks a pass
with no cache holds the residual stream cut on its sequence over
``model`` between the stacks' entry and exit (``_layer``: Megatron's
sequence parallelism; under a held sequence, its block of this data
rank's block).  Under ``REPRO_BASELINE=1`` the caches are the reference's
baseline (``cache_layout``): K/V heads over ``model``, or the head dim,
which a decode step contracts in blocks whose partial scores are summed
over ``model``; MLA's latent widths, gathered whole before the attention.
A captured step over a cut cache raises ``NotImplementedError`` (ROADMAP
Queue A item 3(c)); so does a held sequence's pass from a position other
than 0, which no entry point of the reference runs.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..kernels.flash_attn import HEAD_DIMS, flash_attention
from ..sharding import (BATCH, MODEL, QUEUE_3C, active_mesh, baseline,
                        held_sequence, keep_vocab_cut, model_ranks,
                        resolve_pspec, sequence_ranks, shard_hint, spec_axes,
                        whole_sequence)
from ..tree import tree_leaves
from ..tree import tree_map as map_params
from .common import (NEG_INF, ParamSpec, apply_rope, attention, checkpointed,
                     embed_rows, make_attn_mask, next_token_nll,
                     params_from_numpy, rms_norm, rope_inv_freq, run_layer,
                     schema_init, softcap, stack_schema, vocab_logits)
from .moe import MoEConfig, moe_ffn, moe_schema

__all__ = ["LMConfig", "MLAConfig", "MoEConfig", "lm_schema", "init_lm",
           "lm_params_from_numpy",
           "map_params", "forward", "lm_loss", "init_cache", "decode_step",
           "prefill", "attend_route", "attend", "cache_layout", "heads_tp",
           "row_out", "glu_ffn", "kv_for", "write_block", "merged_decode"]


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
    # flash_block_skip the scan skips the blocks above the diagonal, and
    # without it (the default under REPRO_BASELINE=1, read when the config
    # is built, as the reference's) it visits the full rectangle, masked
    flash_chunk: int = 1024
    flash_block_skip: bool = dataclasses.field(
        default_factory=lambda: not baseline())
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
                 flash_chunk: int = 1024, causal: bool = True,
                 autograd: bool = False) -> str:
    """Which attention the serving route runs for queries ``(.., sq, .., d)``
    over keys ``(.., sk, .., d)`` and values of width ``dv``, decided from
    the shapes before any launch; every family's attention asks it.

    ``"k4"`` where K4 has an instance for the shape and the call is not on
    the training route (``autograd``: K4 has no backward): several
    queries, no softcap, ``d`` in K4's ``HEAD_DIMS`` and ``dv == d``; and
    either causal from ``start == 0`` with no window or one of at least
    ``sq`` positions (with positions equal to indices such a window masks
    no key the causal mask keeps, so the function is the same), or
    without the causal mask and without a window (Whisper's encoder and
    its decoder's cross-attention).  No transformer arch of the reference
    moves by the window clause: Gemma2's windows come with a softcap.
    Otherwise the training route's selection: ``"chunked"`` (the
    online-softmax scan: causal, both lengths multiples of ``flash_chunk``
    and the queries more than one chunk) or ``"plain"`` (masked
    attention; an all-zero mask where not ``causal``)."""
    if (not autograd and sq > 1 and attn_softcap is None and d in HEAD_DIMS
            and dv == d
            and (causal and start == 0 and (window is None or sq <= window)
                 or not causal and window is None)):
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
    Sk)`` keys (later keys are masked for every query).  Without the
    causal mask K4 runs over all ``Sk`` keys."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    route = attend_route(sq, sk, d, v.shape[-1], window=window,
                         attn_softcap=attn_softcap, start=start,
                         flash_chunk=flash_chunk, causal=causal,
                         autograd=autograd)
    if route == "k4":
        kk = min(sq, sk) if causal else sk
        qf = q.permute(0, 2, 1, 3).reshape(b * h, sq, d)
        kf = k[:, :kk].permute(0, 2, 1, 3).reshape(b * hkv, kk, d)
        vf = v[:, :kk].permute(0, 2, 1, 3).reshape(b * hkv, kk, d)
        out = flash_attention(qf.contiguous(), kf.contiguous(), vf.contiguous(),
                              scale=scale, causal=causal, rep=h // hkv)
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
    return leaf.index_copy_(1, q_pos[0], _fit(leaf, new).to(leaf.dtype))


def _fit(leaf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``new``'s block of its last dimension where ``leaf`` holds this
    rank's block of it over ``model`` (``cache_layout``'s head dim or
    latent width), else ``new``."""
    w = leaf.shape[-1]
    if new.shape[-1] == w:
        return new
    r = model_ranks().rank
    return new[..., r * w:(r + 1) * w]


def _gqa_attn(w, x, cfg: LMConfig, rope, q_pos, k_pos, window, cache=None,
              start: int | None = None, autograd: bool = False,
              sp: bool = False):
    """The attention block's output.  ``cache`` = dict(k=(B, S, hkv, hd),
    v=...) is written in place at the positions ``q_pos``, or None.
    ``start`` (0 or None) is ``attend``'s.  ``autograd`` takes the
    training route (``attend``'s, never K4).  Under a held sequence
    (``sharding.sequence_ranks``) ``x`` is this rank's block of positions
    ``q_pos`` and the K/V of every block are gathered (masked by position,
    ``k_pos`` every rank's); a cache cut over ranks is this rank's block
    of positions (``_cache_pass``).  Over model ranks whose ``wq`` is cut
    the block runs cut (``_gqa_attn_tp``); where it is whole (the heads do
    not divide) every rank computes it as one device does, with no
    collective but those of a cut cache, its output whole (with ``sp``,
    cut to this rank's block of the sequence)."""
    tp = model_ranks()
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if tp is not None and tp.cut(w["wq"], 1, h * hd):
        return _gqa_attn_tp(tp, w, x, cfg, rope, q_pos, k_pos, window, cache,
                            start, autograd, sp)
    q = (x @ w["wq"]).reshape(b, s, h, hd)
    k = (x @ w["wk"]).reshape(b, s, hkv, hd)
    v = (x @ w["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, w["q_ln"])
        k = rms_norm(k, w["k_ln"])
    q = apply_rope(q, rope, q_pos)
    k = apply_rope(k, rope, q_pos)
    seq = sequence_ranks()
    if cache is not None:
        grp = _cache_ranks()
        (k, v), k_pos, lo = _cache_pass(grp, seq, cache, ("k", "v"), (k, v),
                                        start, q_pos, k_pos)
        if lo is not None:  # this rank's block of positions, merged
            cut = k.shape[-1] < hd  # and this rank's block of the head dim
            out = merged_decode(grp, q[..., tp.block(hd)] if cut else q, k, v,
                                q_pos, lo, 1.0 / math.sqrt(hd), window,
                                cfg.attn_softcap, width=tp if cut else None)
            return out.reshape(b, 1, h * hd) @ w["wo"]
    elif seq is not None:  # every rank's K/V of the sequence
        k, v = seq.gather(k, 1), seq.gather(v, 1)
    out = _attend(q, k, v, q_pos, k_pos, cfg, window,
                  start=start if seq is None else None, autograd=autograd)
    out = out.reshape(b, s, h * hd) @ w["wo"]
    return tp.scatter(out, 1) if sp else out


def _mla_attn(w, x, cfg: LMConfig, rope, q_pos, k_pos, window, cache=None,
              start: int | None = None, autograd: bool = False,
              sp: bool = False):
    """MLA (the reference's ``_mla_attn``, ``:386-421``) with the
    compressed-latent cache ``dict(ckv=(B, S, kv_lora), krope=(B, S,
    rope_dim))``, written in place; keys and values are expanded from the
    latent over every cached position.  Under a held sequence the latents
    of every block are gathered (a decode step attends over this rank's
    block of the cache, merged by log-sum-exp), as ``_gqa_attn``'s K/V.

    Over model ranks that hold every one of ``wq``/``wq_b``, ``wkv_b`` and
    ``wo`` as blocks of whole heads the block runs on this rank's heads
    (``_mla_attn_tp``).  Otherwise (heads that do not divide: DeepSeek-V2's
    128 over model 3 cut ``wq_b``'s 24,576 columns inside heads and hold
    ``wkv_b`` and ``wo`` whole) every rank computes every head: a cut
    projection is gathered over ``model``, a whole one used as it is, and
    a cut ``wo`` takes this rank's row block and is summed.  Where ``wo``
    is cut each rank's backward carries its rows' part of the gradient,
    so the block's inputs and whole weights go through ``copy`` (their
    gradients summed); where it is whole the output is too, and no sum
    is taken."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    qh, dkv = m.qk_nope_dim + m.qk_rope_dim, m.qk_nope_dim + m.v_dim
    wq = w["wq_b"] if m.q_lora else w["wq"]
    tp = model_ranks()
    q_cut = kv_cut = o_cut = False
    if tp is not None:
        q_cut, kv_cut, o_cut = (tp.cut(wq, 1, h * qh),
                                tp.cut(w["wkv_b"], 1, h * dkv),
                                tp.cut(w["wo"], 0, h * m.v_dim))
        if h % tp.size == 0 and q_cut and kv_cut and o_cut:
            return _mla_attn_tp(tp, w, x, cfg, rope, q_pos, k_pos, window,
                                cache, start, autograd, sp)

    def entry(t):  # an input of a block whose backward is each rank's part
        return tp.copy(t) if o_cut else t

    def cols(a, wt, cut):  # a @ wt, every column on every rank
        if not cut:
            return a @ entry(wt)
        if o_cut:
            return tp.gather_partial(a @ wt, -1)
        return tp.gather(tp.copy(a) @ wt, -1)

    xq = rms_norm(x @ w["wq_a"], w["q_ln"]) if m.q_lora else x
    q = cols(entry(xq), wq, q_cut)
    q_nope, q_rope = q.reshape(b, s, h, qh).split([m.qk_nope_dim, m.qk_rope_dim],
                                                  dim=-1)
    q_rope = apply_rope(q_rope, rope, q_pos)
    ckv, krope = (x @ w["wkv_a"]).split([m.kv_lora, m.qk_rope_dim], dim=-1)
    ckv = rms_norm(ckv, w["kv_ln"])
    krope = apply_rope(krope[:, :, None, :], rope, q_pos)[:, :, 0, :]
    scale = 1.0 / math.sqrt(qh)
    seq = sequence_ranks()
    grp = lo = None
    if cache is not None:
        grp = _cache_ranks()
        (ckv, krope), k_pos, lo = _latent_pass(grp, seq, cache, (ckv, krope),
                                               start, q_pos, k_pos)
        if lo is not None and kv_cut:  # wkv_b's columns and the positions cut
            out = _mla_decode_cut_columns(tp, grp, w, cfg, q_nope, q_rope,
                                          {"ckv": ckv, "krope": krope}, q_pos,
                                          lo, scale, window)
            return _mla_out(tp, out, w["wo"], o_cut, sp)
    elif seq is not None:  # every rank's latents
        ckv, krope = seq.gather(ckv, 1), seq.gather(krope, 1)
    sk = ckv.shape[1]
    kvx = cols(entry(ckv), w["wkv_b"], kv_cut).reshape(b, sk, h, dkv)
    k_nope, v = kvx.split([m.qk_nope_dim, m.v_dim], dim=-1)
    k_rope = entry(krope)[:, :, None, :].expand(b, sk, h, m.qk_rope_dim)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope], dim=-1)
    if lo is not None:
        out = merged_decode(grp, q_full, k_full, v, q_pos, lo, scale, window,
                            cfg.attn_softcap)
    else:
        out = _attend(q_full, k_full, v, q_pos, k_pos, cfg, window,
                      scale=scale, start=start if seq is None else None,
                      autograd=autograd)
    return _mla_out(tp, out.reshape(b, s, h * m.v_dim), w["wo"], o_cut, sp)


def _mla_out(tp, out: torch.Tensor, wo: torch.Tensor, o_cut: bool,
             sp: bool) -> torch.Tensor:
    """Every head's output (B, S, h * v_dim) through ``wo``: row-cut, this
    rank's rows summed over ``model``; whole, as it is (with ``sp`` cut to
    this rank's block of the sequence)."""
    if o_cut:
        return row_out(tp, out, wo, sp)
    y = out @ wo
    return tp.scatter(y, 1) if sp else y


def _mla_decode_cut_columns(tp, grp, w, cfg: LMConfig, q_nope, q_rope, cache,
                            q_pos, lo: int, scale: float,
                            window) -> torch.Tensor:
    """One MLA decode step of every head over this rank's block of the
    latent cache (cut over ``grp``) where ``wkv_b``'s columns are cut over
    ``model`` inside heads: the absorbed form (``_mla_decode_tp``), each
    rank folding its columns' part of ``wkv_b``'s key half into the
    latent queries and mapping the latent outputs through its part of the
    value half, each part summed over ``model``.  Returns (B, 1, h *
    v_dim), the same on every rank.  No gradient is taken here."""
    m = cfg.mla
    b, _, h, _ = q_nope.shape
    dkv = m.qk_nope_dim + m.v_dim
    wkv_b = w["wkv_b"]
    nc = wkv_b.shape[1]
    c0 = tp.rank * nc
    h0, h1 = c0 // dkv, -(-(c0 + nc) // dkv)  # the heads these columns touch
    part = wkv_b.new_zeros(m.kv_lora, (h1 - h0) * dkv)
    part[:, c0 - h0 * dkv:c0 - h0 * dkv + nc] = wkv_b
    w_uk, w_uv = part.reshape(m.kv_lora, h1 - h0, dkv).split(
        [m.qk_nope_dim, m.v_dim], dim=-1)
    q_lat = q_nope.new_zeros(b, 1, h, m.kv_lora)
    q_lat[:, :, h0:h1] = torch.einsum("bshn,chn->bshc", q_nope[:, :, h0:h1],
                                      w_uk)
    q_lat = tp.all_reduce(q_lat)
    keys = torch.cat([cache["ckv"], cache["krope"]], dim=-1)[:, :, None]
    lat = merged_decode(grp, torch.cat([q_lat, q_rope], dim=-1), keys,
                        cache["ckv"][:, :, None], q_pos, lo, scale, window,
                        cfg.attn_softcap)
    out = q_nope.new_zeros(b, 1, h, m.v_dim)
    out[:, :, h0:h1] = torch.einsum("bshc,chv->bshv", lat[:, :, h0:h1], w_uv)
    return tp.all_reduce(out).reshape(b, 1, h * m.v_dim)


# ---------------------------------------------------------------------------
# tensor parallelism over the mesh's model axis
# ---------------------------------------------------------------------------

# the production meshes' model degree, by which the reference lays a KV
# cache out (its ``_use_ring_cache``): KV heads that divide it are cut over
# model, otherwise the sequence is
PRODUCTION_MODEL_DEGREE = 16


def cache_layout(cfg: LMConfig) -> str:
    """How ``registry._kv_cache_axes`` places the cache over ``model``:
    ``"heads"`` where the KV heads divide 16 (the KV heads over ``model``
    where they divide it, else the head dim where it does), else
    ``"seq"``, the sequence over ``model`` (MLA's latents too).  Under
    ``REPRO_BASELINE=1`` every K/V cache is ``"heads"`` and MLA's is
    ``"width"``, each latent's width over ``model`` where it divides (the
    reference's ``_use_ring_cache`` then False): a decode step contracts
    a cut head dim in blocks (``merged_decode``'s ``width``) and gathers a
    cut latent width whole (``_latent_pass``)."""
    if cfg.attn == "mla":
        return "width" if baseline() else "seq"
    if baseline() or cfg.n_kv_heads % PRODUCTION_MODEL_DEGREE == 0:
        return "heads"
    return "seq"


def _own(tp, n: int) -> tuple[int, int]:
    """``(first, count)`` of this rank's block of ``n`` heads, or ``(0, n)``
    where they do not divide over the ranks (every rank then has them
    all)."""
    if n % tp.size:
        return 0, n
    return tp.rank * (n // tp.size), n // tp.size


def kv_for(q_lo: int, nq: int, kv_lo: int, k, v, rep: int):
    """The K/V heads that query heads ``q_lo..q_lo+nq-1`` read (GQA: head
    ``h`` reads KV head ``h // rep``) out of ``k``/``v`` (B, S, n, D),
    which hold KV heads from ``kv_lo``: a slice where the block is whole
    groups, else one KV head a query head."""
    if q_lo % rep == 0 and nq % rep == 0:
        a = q_lo // rep - kv_lo
        return k[:, :, a:a + nq // rep], v[:, :, a:a + nq // rep]
    idx = torch.tensor([(q_lo + j) // rep - kv_lo for j in range(nq)],
                       device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def write_block(leaf: torch.Tensor, new: torch.Tensor, lo: int,
                start: int) -> None:
    """Write ``new`` (B, S, ...), positions ``start..start+S-1``, into
    ``leaf``, this rank's block of positions ``lo..lo+Sl-1``: the ones
    that fall in it (the others are other ranks')."""
    a = max(start, lo)
    e = min(start + new.shape[1], lo + leaf.shape[1])
    if a < e:
        leaf[:, a - lo:e - lo] = _fit(leaf, new[:, a - start:e - start]).to(
            leaf.dtype)


def _seq_cache_write(grp, cache: dict, names, news, start, held=None):
    """Write new entries ``news`` (B, S, ...) at positions ``start..`` into
    ``cache[names]``, this rank's block of positions over the ranks ``grp``
    that cut the cache's sequence (``sharding.SequenceRanks``; None: the
    cache is whole): those that fall in it.  Where a pass over several
    positions (a prefill) holds this rank's block of them over ``held`` (a
    held sequence), the blocks are gathered first.  Returns ``(*news
    whole, their positions (B, S))``."""
    if not isinstance(start, int):
        raise NotImplementedError(f"a cache cut over {grp.axes} at a tensor "
                                  f"position (a captured step); {QUEUE_3C}")
    if held is not None:
        news = tuple(held.gather(t, 1) for t in news)
    for name, new in zip(names, news):
        lo = 0 if grp is None else grp.lo(cache[name].shape[1])
        write_block(cache[name], new, lo, start)
    b, s = news[0].shape[:2]
    return (*news, _positions(b, start, s, news[0].device))


def _cache_pass(grp, seq, cache: dict, names, news, start, q_pos, k_pos):
    """Write a pass's new entries ``news`` into ``cache[names]`` and return
    what it attends over: ``(entries, their positions, lo)``.  A whole
    cache (``grp`` None) outside a held sequence's block (``seq``) is
    written at ``q_pos`` and read whole at ``k_pos``.  Otherwise the new
    entries are written where this rank holds them (``_seq_cache_write``,
    gathered first over a held block): a pass over several positions, or
    a held block, attends over the new entries whole; a one-position pass
    over a cache cut over ``grp`` attends over this rank's block of it,
    from position ``lo`` (merged by log-sum-exp over ``grp``; ``lo`` None
    elsewhere).

    A leaf that holds this rank's block of its last dimension over
    ``model`` (``cache_layout``'s head dim or latent width) is written with
    that block of the new entries (``_fit``).  A pass from position 0 then
    attends over the new entries whole; a one-position pass over it reads
    this rank's block from ``lo`` (0 where the positions are whole), which
    its caller contracts over the head dim's blocks (``merged_decode``'s
    ``width``) or gathers (``_latent_pass``)."""
    one = seq is None and news[0].shape[1] == 1
    cut = any(cache[n].shape[-1] < t.shape[-1] for n, t in zip(names, news))
    if grp is None and seq is None:
        leaves = tuple(_write(cache, n, t, q_pos) for n, t in zip(names, news))
        if not cut:
            return leaves, k_pos, None
        if not one and isinstance(start, int) and start == 0:
            return tuple(news), q_pos, None
        lo = 0
    else:
        *got, pos = _seq_cache_write(grp, cache, names, news, start, held=seq)
        if grp is None or not one:
            return tuple(got), pos, None
        leaves, lo = tuple(cache[n] for n in names), grp.lo(
            cache[names[0]].shape[1])
    return leaves, None, lo


def _latent_pass(grp, seq, cache: dict, news, start, q_pos, k_pos):
    """``_cache_pass`` over MLA's latents ``("ckv", "krope")``, the leaves
    that hold this rank's block of their width over ``model`` read whole,
    gathered over it (the reference all-gathers them)."""
    leaves, pos, lo = _cache_pass(grp, seq, cache, ("ckv", "krope"), news,
                                  start, q_pos, k_pos)
    if lo is None or all(t.shape[-1] == n.shape[-1]
                         for t, n in zip(leaves, news)):
        return leaves, pos, lo
    leaves = tuple(model_ranks().mesh.all_gather(t, MODEL, dim=t.ndim - 1)
                   if t.shape[-1] < n.shape[-1] else t
                   for t, n in zip(leaves, news))
    return (leaves, k_pos, None) if grp is None else (leaves, None, lo)


def merged_decode(tp, q, kc, vc, q_pos, lo: int, scale: float, window,
                  attn_softcap, causal: bool = True,
                  width=None) -> torch.Tensor:
    """One query position's attention over a sequence cut over ranks:
    ``tp`` the ranks that cut it (``sharding.ModelRanks`` over ``model``,
    or ``SequenceRanks`` over ``data`` and ``model`` at batch 1: anything
    with ``all_reduce``; None where the positions are whole); ``q`` (B, 1,
    H, D) every head, ``kc``/``vc`` (B, Sl, Hkv, D[v]) this rank's
    positions ``lo..lo+Sl-1`` (causal at ``q_pos``, or, without
    ``causal``, every position: Whisper's cross-attention).  Each rank's
    partial softmax is merged by log-sum-exp: the maximum, then the
    rescaled sums and outputs all-reduced.  With ``width`` (the model
    ranks), ``q``, ``kc`` and ``vc`` are each rank's block of the head dim
    (``cache_layout``'s baseline): the partial scores are summed over
    them first, and the output blocks gathered, as the reference's
    compiled decode does.  Returns (B, 1, H, Dv), the same on every
    rank."""
    b, sq, hh, d = q.shape
    sl, hkv = kc.shape[1], kc.shape[2]
    rep = hh // hkv
    logits = torch.einsum("bqhrd,bkhd->bhrqk", q.reshape(b, sq, hkv, rep, d),
                          kc).float()
    if width is not None:
        logits = width.all_reduce(logits)
    logits = logits * scale
    if attn_softcap is not None:
        logits = softcap(logits, attn_softcap)
    if causal:
        k_pos = torch.arange(lo, lo + sl, device=q.device).expand(b, sl)
        logits = logits + make_attn_mask(q_pos, k_pos, window)[:, :, None]
    mx = logits.amax(dim=-1)
    if tp is not None:
        mx = tp.all_reduce(mx, "max")
    p = torch.exp(logits - mx[..., None])
    acc = torch.einsum("bhrqk,bkhd->bqhrd", p.to(vc.dtype), vc).float()
    tot = torch.cat([acc, p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]],
                    dim=-1)
    if tp is not None:
        tot = tp.all_reduce(tot)
    out = (tot[..., :-1] / tot[..., -1:]).reshape(b, sq, hh, -1).to(q.dtype)
    if width is not None:
        out = width.mesh.all_gather(out.contiguous(), MODEL, dim=3)
    return out


def heads_tp(tp, x, wq, wk, wv, h: int, hkv: int, hd: int, what: str):
    """The query and KV heads this rank computes from a column-cut ``wq``
    (and ``wk``/``wv``, cut or whole): ``(q (B, S, nq, hd), k, v (B, S,
    nkv, hd), q_lo, kv_lo)``, its own block of whole heads, or every head
    (the projection gathered, the backward summed) where a block is not
    whole heads.  ``what`` names the model in an error: a whole ``wq``
    (heads that do not divide at all) is the caller's to compute as on
    one device."""
    b, s, _ = x.shape
    if not tp.cut(wq, 1, h * hd):
        raise ValueError(f"{what}: heads_tp takes a column-cut wq; a whole "
                         f"one is computed as on one device")
    xf = tp.copy(x)
    kv_cut = tp.cut(wk, 1, hkv * hd)
    if not kv_cut:  # whole, but each rank's heads take their part
        wk, wv = tp.copy(wk), tp.copy(wv)
    q, k, v = xf @ wq, xf @ wk, xf @ wv
    # whole heads: this rank's block; a cut inside a head: every head
    q_lo, nq = _own(tp, h)
    if nq == h:
        q = tp.gather_partial(q, -1)
    kv_lo, nkv = _own(tp, hkv) if kv_cut else (0, hkv)
    if kv_cut and nkv == hkv:
        k, v = tp.gather_partial(k, -1), tp.gather_partial(v, -1)
    return (q.reshape(b, s, nq, hd), k.reshape(b, s, nkv, hd),
            v.reshape(b, s, nkv, hd), q_lo, kv_lo)


def row_out(tp, out: torch.Tensor, wo: torch.Tensor,
            sp: bool = False) -> torch.Tensor:
    """``out`` (B, S, n) through a row-cut ``wo`` summed over ``model``:
    where ``out`` holds every head (``n`` all of ``wo``'s rows), this
    rank's row block of it first.  With ``sp`` (the sequence-parallel
    stream) the sum is reduce-scattered: this rank's block of the
    sequence."""
    c = wo.shape[0]  # this rank's rows
    if out.shape[-1] != c:
        out = out[..., tp.rank * c:(tp.rank + 1) * c]
    return tp.reduce_scatter(out @ wo, 1) if sp else tp.reduce(out @ wo)


def _cache_seq_axes(cfg: LMConfig, tp, max_len: int) -> tuple[str, ...]:
    """The mesh axes of more than one rank that cut the positions of a
    cache of ``max_len`` positions, as ``registry._kv_cache_axes`` places
    them (``resolve_pspec``): of a held sequence's axes (``data`` at batch
    1) and, where the layout is ``"seq"``, ``model``, all where their
    product divides, else the first that divides alone, else none (the
    cache is whole on every rank)."""
    cand = held_sequence() + ((MODEL,) if tp is not None
                              and cache_layout(cfg) == "seq" else ())
    if not cand:
        return ()
    return spec_axes(resolve_pspec((max_len,), (cand,), active_mesh().shape)[0])


# the axes that cut the positions of the cache a pass writes (a cache's
# leaves carry them as ``seq_axes``, set by ``init_cache``)
_CACHE_AXES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_cache_axes", default=())


def _cache_ranks():
    """The ranks that cut the positions of the cache the pass writes
    (``sharding.SequenceRanks``), None where it is whole."""
    axes = _CACHE_AXES.get()
    return sequence_ranks(axes) if axes else None


def _gqa_attn_tp(tp, w, x, cfg: LMConfig, rope, q_pos, k_pos, window, cache,
                 start, autograd, sp=False):
    """``_gqa_attn`` on this rank's cut of ``wq``/``wk``/``wv`` (columns)
    and ``wo`` (rows): the attention output summed over ``model`` (with
    ``sp``, reduce-scattered over the sequence).  Under a held sequence
    the K/V of every block of positions are gathered over its axes.  A
    cache whose KV heads are cut holds this rank's heads; else it holds
    every KV head, the positions cut where they divide
    (``_cache_seq_axes``)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v, q_lo, kv_lo = heads_tp(tp, x, w["wq"], w["wk"], w["wv"], h, hkv,
                                    hd, cfg.name)
    nq, nkv = q.shape[2], k.shape[2]
    if cfg.qk_norm:
        q = rms_norm(q, tp.copy(w["q_ln"]))
        k = rms_norm(k, tp.copy(w["k_ln"]))
    q = apply_rope(q, rope, q_pos)
    k = apply_rope(k, rope, q_pos)
    seq = sequence_ranks()
    scale = 1.0 / math.sqrt(hd)
    if cache is not None:
        heads = cache["k"].shape[2] < hkv  # this rank's KV heads
        if not heads and nkv < hkv:  # the new positions of every KV head
            k, v = tp.gather(k, 2), tp.gather(v, 2)
            kv_lo, nkv = 0, hkv
        grp = _cache_ranks()
        (k, v), k_pos, lo = _cache_pass(grp, seq, cache, ("k", "v"), (k, v),
                                        start, q_pos, k_pos)
        if lo is not None and heads:  # this rank's heads of its positions
            kk, vv = kv_for(q_lo, nq, kv_lo, k, v, h // hkv)
            out = merged_decode(grp, q, kk, vv, q_pos, lo, scale, window,
                                cfg.attn_softcap)
            return row_out(tp, out.reshape(b, 1, nq * hd), w["wo"])
        if lo is not None:  # decode: every head over this rank's positions
            qa = q if nq == h else tp.gather(q, 2)
            cut = k.shape[-1] < hd  # and this rank's block of the head dim
            out = merged_decode(grp, qa[..., tp.block(hd)] if cut else qa, k,
                                v, q_pos, lo, scale, window, cfg.attn_softcap,
                                width=tp if cut else None)
            return row_out(tp, out.reshape(b, 1, h * hd), w["wo"])
    elif seq is not None:  # every rank's block of positions
        k, v = seq.gather(k, 1), seq.gather(v, 1)
    kk, vv = kv_for(q_lo, nq, kv_lo, k, v, h // hkv)
    out = _attend(q, kk, vv, q_pos, k_pos, cfg, window,
                  start=start if seq is None else None, autograd=autograd)
    return row_out(tp, out.reshape(b, s, nq * hd), w["wo"], sp)


def _mla_attn_tp(tp, w, x, cfg: LMConfig, rope, q_pos, k_pos, window, cache,
                 start, autograd, sp=False):
    """``_mla_attn`` on this rank's heads of ``wq``/``wq_b``, ``wkv_b`` and
    ``wo`` (each a block of whole heads), the latent projections and
    norms whole; the output summed over ``model`` (with ``sp``,
    reduce-scattered over the sequence).  A decode step over a
    sequence-cut latent cache takes the absorbed form
    (``_mla_decode_tp``).  Under a held sequence the latents of every
    block are gathered over its axes, and the cache is cut over them and
    ``model`` jointly where its positions divide."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    qh, dkv = m.qk_nope_dim + m.qk_rope_dim, m.qk_nope_dim + m.v_dim
    wq = w["wq_b"] if m.q_lora else w["wq"]
    nh = h // tp.size
    if m.q_lora:
        q = tp.copy(rms_norm(x @ w["wq_a"], w["q_ln"])) @ wq
    else:
        q = tp.copy(x) @ wq
    q_nope, q_rope = q.reshape(b, s, nh, qh).split([m.qk_nope_dim, m.qk_rope_dim],
                                                   dim=-1)
    q_rope = apply_rope(q_rope, rope, q_pos)
    ckv, krope = (x @ w["wkv_a"]).split([m.kv_lora, m.qk_rope_dim], dim=-1)
    ckv = rms_norm(ckv, w["kv_ln"])
    krope = apply_rope(krope[:, :, None, :], rope, q_pos)[:, :, 0, :]
    scale = 1.0 / math.sqrt(qh)
    seq = sequence_ranks()
    if cache is not None:
        grp = _cache_ranks()
        (ckv, krope), k_pos, lo = _latent_pass(grp, seq, cache, (ckv, krope),
                                               start, q_pos, k_pos)
        if lo is not None:  # the leaves as the pass reads them
            return _mla_decode_tp(tp, grp, w, cfg, q_nope, q_rope,
                                  {"ckv": ckv, "krope": krope}, q_pos, lo,
                                  scale, window)
    elif seq is not None:  # every rank's block of positions
        ckv, krope = seq.gather(ckv, 1), seq.gather(krope, 1)
    ckv, krope = tp.copy(ckv), tp.copy(krope)
    sk = ckv.shape[1]
    kvx = (ckv @ w["wkv_b"]).reshape(b, sk, nh, dkv)
    k_nope, v = kvx.split([m.qk_nope_dim, m.v_dim], dim=-1)
    k_rope = krope[:, :, None, :].expand(b, sk, nh, m.qk_rope_dim)
    out = _attend(torch.cat([q_nope, q_rope], dim=-1),
                  torch.cat([k_nope, k_rope], dim=-1), v, q_pos, k_pos, cfg,
                  window, scale=scale, start=start if seq is None else None,
                  autograd=autograd)
    y = out.reshape(b, s, nh * m.v_dim) @ w["wo"]
    return tp.reduce_scatter(y, 1) if sp else tp.reduce(y)


def _mla_decode_tp(tp, grp, w, cfg: LMConfig, q_nope, q_rope, cache, q_pos,
                   lo: int, scale: float, window):
    """One MLA decode step over this rank's block of the latent cache, in
    the absorbed form: each rank folds ``wkv_b``'s key half of its heads
    into their queries (``q_nope @ W_uk^T``, a query over the latent), the
    latent queries of every head are gathered, each rank attends them over
    its positions (keys ``[ckv, krope]``, values ``ckv``), the partial
    softmaxes are merged by log-sum-exp over ``grp``, the ranks that cut
    the cache's sequence, and each rank maps its heads' latent outputs
    through ``wkv_b``'s value half and ``wo``."""
    m = cfg.mla
    b, _, nh, _ = q_nope.shape
    wkv_b = w["wkv_b"].reshape(m.kv_lora, nh, m.qk_nope_dim + m.v_dim)
    w_uk, w_uv = wkv_b.split([m.qk_nope_dim, m.v_dim], dim=-1)
    q_lat = torch.einsum("bshn,chn->bshc", q_nope, w_uk)
    qa = tp.gather(torch.cat([q_lat, q_rope], dim=-1), 2)
    keys = torch.cat([cache["ckv"], cache["krope"]], dim=-1)[:, :, None]
    lat = merged_decode(grp, qa, keys, cache["ckv"][:, :, None], q_pos, lo,
                        scale, window, cfg.attn_softcap)
    own = lat[:, :, tp.rank * nh:(tp.rank + 1) * nh]
    out = torch.einsum("bshc,chv->bshv", own, w_uv)
    return tp.reduce(out.reshape(b, 1, nh * m.v_dim) @ w["wo"])


def _act(cfg: LMConfig):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu if cfg.act == "silu" else (lambda t: F.gelu(t, approximate="tanh"))


def glu_ffn(w, x, d_ff: int, act, sp: bool = False) -> torch.Tensor:
    """The gated FFN ``(act(x @ w_gate) * (x @ w_up)) @ w_down``; over model
    ranks holding column-cut gate and up and a row-cut down, this rank's
    columns, summed over ``model`` (with ``sp``, reduce-scattered over the
    sequence)."""
    tp = model_ranks()
    if tp is not None and tp.cut(w["w_gate"], 1, d_ff):
        xf = tp.copy(x)
        g, u = xf @ w["w_gate"], xf @ w["w_up"]
        return row_out(tp, act(g.float()).to(u.dtype) * u, w["w_down"], sp)
    g = x @ w["w_gate"]
    u = x @ w["w_up"]
    out = (act(g.float()).to(u.dtype) * u) @ w["w_down"]
    return tp.scatter(out, 1) if sp and tp is not None else out


def _ffn(w, x, cfg: LMConfig, sp: bool = False):
    return glu_ffn(w, x, cfg.d_ff, _act(cfg), sp)


def seq_parallel() -> bool:
    """Whether ``REPRO_SEQ_PARALLEL=1`` asks for the sequence-parallel
    residual stream (the reference's flag, ``transformer.py:438``)."""
    return os.environ.get("REPRO_SEQ_PARALLEL") == "1"


def _layer(w, x, cfg: LMConfig, rope, q_pos, k_pos, window, moe_layer, cache,
           start, autograd, sp=False):
    """One layer.  ``sp``: the sequence-parallel residual stream over
    ``model`` (Megatron's sequence parallelism, arXiv:2205.05198 §4.2;
    ``_run_stacks`` decides it): ``x`` is this rank's block of the
    sequence, the norms run on it (their gains through ``copy``: each
    rank's gradient is its block's part), each sublayer's normed input is
    gathered over ``model`` before its column-cut products (backward, this
    rank's block of the summed gradient), and its row-cut output
    reduce-scattered back to the block.  The MoE's output, summed as on
    the whole stream (a whole shared expert added after the sum), is cut
    to the block (``scatter``: backward, gathered)."""
    tp = model_ranks() if sp else None
    if cache is None and x.shape[1] > 1 and seq_parallel():
        # the reference's sequence-parallel residual stream
        x = shard_hint(x, BATCH, "model", None, seq_dim=1 if sp else None,
                       seq_axes=(MODEL,))

    def gain(name):
        return tp.copy(w[name]) if sp else w[name]

    def whole(t):
        return tp.gather(t, 1) if sp else t

    h_in = whole(rms_norm(x, gain("ln_attn")))
    attn_fn = _mla_attn if cfg.attn == "mla" else _gqa_attn
    attn_out = attn_fn(w, h_in, cfg, rope, q_pos, k_pos, window, cache, start,
                       autograd, sp)
    if cfg.sandwich_norms:
        attn_out = rms_norm(attn_out, gain("ln_attn_post"))
    x = x + attn_out
    h2 = whole(rms_norm(x, gain("ln_ffn")))
    if moe_layer:
        b, s, d = h2.shape
        ffn_out = moe_ffn(w["moe"], h2.reshape(b * s, d), cfg.moe).reshape(b, s, d)
        if sp:
            ffn_out = tp.scatter(ffn_out, 1)
    else:
        ffn_out = _ffn(w, h2, cfg, sp)
    if cfg.sandwich_norms:
        ffn_out = rms_norm(ffn_out, gain("ln_ffn_post"))
    return x + ffn_out


def _run_stack(key, stack_w, x, cfg, rope, q_pos, k_pos, caches, start,
               autograd, n, moe_layer, offset, sp=False):
    """The loop over the ``n`` layers of the stack ``params[key]``, the
    first of them layer ``offset`` of the model; ``caches`` the stack's
    (L, B, S, ...) cache leaves (written in place) or None.  Each stacked
    leaf is unbound once, so its gradient is one stack of the layers' (not
    a sum of L zero-padded selects).  Each layer gathers its FSDP shards
    as it runs (``run_layer``).  On the training route each layer runs
    under ``checkpointed`` (the reference's per-layer ``jax.checkpoint``
    where it has no cache): backward recomputes, and gathers, one layer at
    a time, so only the layers' inputs persist."""
    windows = _layer_windows(cfg, n, offset)
    layers = map_params(lambda leaf: leaf.unbind(0), stack_w)
    remat = caches is None and autograd and torch.is_grad_enabled()
    for l in range(n):
        w = map_params(lambda leaves: leaves[l], layers)
        cache = None if caches is None else {k: c[l] for k, c in caches.items()}
        x = run_layer(_layer, key, w, x, cfg, rope, q_pos, k_pos, windows[l],
                      moe_layer, cache, start, autograd, sp, remat=remat)
    return x


def _run_stacks(params, cfg: LMConfig, x, q_pos, k_pos, cache, start,
                autograd=False):
    """Every stack in order (dense-first, then MoE), with the stacks'
    caches ``cache["dense"]`` / ``cache["moe"]`` or None.  Under
    ``REPRO_SEQ_PARALLEL=1`` over model ranks, a pass with no cache over
    several positions holds the residual stream as this rank's block of
    the sequence between the stacks' entry and exit (``_layer``) where
    the positions divide over ``model`` (under a held sequence, its block
    of this data rank's block)."""
    rope = rope_inv_freq(cfg.rope_dim, cfg.rope_base, x.device)
    tp = model_ranks()
    # a sequence that does not divide over model stays whole, as the
    # reference's hint then replicates it
    sp = (tp is not None and cache is None and x.shape[1] > 1
          and seq_parallel() and x.shape[1] % tp.size == 0)
    if sp:  # under a held sequence, this rank's block of the data block
        x = tp.scatter(x, 1)
    for key, cache_key, n, moe_layer, offset in _stacks(cfg):
        x = _run_stack(key, params[key], x, cfg, rope, q_pos, k_pos,
                       None if cache is None else cache[cache_key], start,
                       autograd, n, moe_layer, offset, sp)
    return tp.gather(x, 1) if sp else x


def _embed(params, cfg: LMConfig, tokens):
    x = embed_rows(params["embed"], tokens, cfg.vocab)
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    # the batch over (pod, data); at batch 1 the sequence over data, which a
    # pass over a held sequence holds as its block
    cut = bool(held_sequence())
    return shard_hint(x, BATCH, "data" if x.shape[0] == 1 else None, None,
                      seq_dim=1 if cut else None)


def _unembed(params, cfg: LMConfig, x):
    x = rms_norm(x, params["ln_f"])
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]

    def finish(logits):
        logits = logits.float()
        if cfg.logit_softcap is not None:
            logits = softcap(logits, cfg.logit_softcap)
        return logits

    return vocab_logits(x, head, cfg.vocab, finish)


def _positions(b: int, start, s: int, device,
               dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Positions ``start..start+S-1`` in every row, (B, S) of ``dtype``;
    ``start`` an int or a 0-d integer tensor on ``device``."""
    if isinstance(start, torch.Tensor):
        pos = torch.arange(s, dtype=dtype, device=device) + start.to(dtype)
    else:
        pos = torch.arange(start, start + s, dtype=dtype, device=device)
    return pos.expand(b, s)


def _pass_positions(b: int, lens, device):
    """``(q_pos, k_pos)`` (B, S) int32 of a pass from position 0 over
    segments of ``lens`` positions: ``0..S-1`` for both, or, under a held
    sequence, this rank's block of each segment and every rank's
    (``sharding.SequenceRanks.positions``)."""
    seq = sequence_ranks()
    if seq is None:
        pos = _positions(b, 0, sum(lens), device)
        return pos, pos
    q_pos, k_pos = seq.positions(lens, device)
    return q_pos.expand(b, -1), k_pos.expand(b, -1)


def forward(params, cfg: LMConfig, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None, *,
            autograd: bool = False) -> torch.Tensor:
    """Full-sequence forward: ``tokens`` (B, S) -> logits (B, P + S, V),
    with ``prefix_embeds`` (B, P, d_model) (stub frontend embeddings, such
    as PaliGemma's image patches) ahead of the token embeddings.
    ``autograd=False`` is the serving route (causal attention on K4 where
    ``attend_route`` says so); ``autograd=True`` the training route
    (``attend``'s, never K4), which backward differentiates.  Under a held
    sequence (batch 1) ``tokens`` and ``prefix_embeds`` are
    this rank's blocks, and so are the logits' positions."""
    x = _embed(params, cfg, tokens)
    lens = [tokens.shape[1]]
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        lens = [prefix_embeds.shape[1]] + lens
    q_pos, k_pos = _pass_positions(x.shape[0], lens, x.device)
    start = 0 if q_pos is k_pos else None  # a block from lo is no index mask
    x = _run_stacks(params, cfg, x, q_pos, k_pos, None, start, autograd)
    return _unembed(params, cfg, x)


def lm_loss(params, cfg: LMConfig, tokens: torch.Tensor, targets: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``targets`` (B, S) over
    the token positions (the prefix's are dropped), through the training
    route's attention; over model ranks from the vocab-cut logits
    (``common.next_token_nll``).  Under a held sequence, the mean over
    this rank's block of the tokens."""
    with keep_vocab_cut():
        logits = forward(params, cfg, tokens, prefix_embeds, autograd=True)
    if prefix_embeds is not None:
        logits = logits[:, prefix_embeds.shape[1]:]
    return next_token_nll(logits, targets, cfg.vocab)


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda") -> dict:
    """Stacked (L-leading) zero caches for decode, one a stack (``"dense"``,
    ``"moe"``): K/V ``(L, B, S, hkv, hd)``, or MLA's latent ``ckv (L, B, S,
    kv_lora)`` and ``krope (L, B, S, rope_dim)``.  Over model ranks, this
    rank's cut (``cache_layout``): ``"heads"``, ``hkv`` over the ranks
    where they divide, else ``hd`` where it does; ``"width"``, each
    latent's width where it divides; ``"seq"``, ``S`` where it divides;
    under a held sequence (batch 1), ``S``
    also over its axes (over data and model jointly, or over data beside
    heads over model: ``_cache_seq_axes``).  What does not divide is held
    whole, as the reference replicates it.  Each leaf carries the axes
    that cut its positions as ``seq_axes``: a pass reads the cache so."""
    dev = resolve_device(device)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    widths = (cfg.mla.kv_lora, cfg.mla.qk_rope_dim) if cfg.mla else ()
    tp = model_ranks()
    layout = cache_layout(cfg)
    if tp is not None and layout == "heads":
        if hkv % tp.size == 0:
            hkv //= tp.size
        elif hd % tp.size == 0:
            hd //= tp.size
    if tp is not None and layout == "width":
        widths = tuple(n // tp.size if n % tp.size == 0 else n for n in widths)
    axes = _cache_seq_axes(cfg, tp, max_len)
    if axes:  # this rank's block of the positions
        max_len //= active_mesh().group_size(axes)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    out = {}
    for _, cache_key, n, _, _ in _stacks(cfg):
        if cfg.attn == "mla":
            out[cache_key] = {"ckv": zeros(n, batch, max_len, widths[0]),
                              "krope": zeros(n, batch, max_len, widths[1])}
        else:
            shape = (n, batch, max_len, hkv, hd)
            out[cache_key] = {"k": zeros(*shape), "v": zeros(*shape)}
    for leaf in tree_leaves(out):
        leaf.seq_axes = axes
    return out


def _cached_pass(params, cfg: LMConfig, cache, tokens, start,
                 decode: bool = False):
    """A pass over ``tokens`` from ``start`` that writes ``cache``: a
    decode step (``decode``: one position, whole on every rank of a held
    sequence, which holds that row alike: ``sharding.whole_sequence``) or
    a prefill (under a held sequence, this rank's block of the prompt)."""
    leaf = tree_leaves(cache)[0]
    max_len = leaf.shape[2]
    tensor_start = isinstance(start, torch.Tensor)
    # a cache made elsewhere than init_cache is read as its layout cuts it
    axes = getattr(leaf, "seq_axes", None)
    if axes is None:
        tp = model_ranks()
        axes = held_sequence() + ((MODEL,) if tp is not None and
                                  cache_layout(cfg) == "seq" else ())
    grp = sequence_ranks(axes) if axes else None
    if grp is not None:
        if tensor_start:
            raise NotImplementedError(
                f"{cfg.name}: a captured step (a tensor position) over a "
                f"cache cut over {grp.axes}; {QUEUE_3C}")
        max_len *= grp.size
    with whole_sequence() if decode else contextlib.nullcontext():
        x = _embed(params, cfg, tokens)
        b, s, _ = x.shape
        seq = sequence_ranks()
        if seq is not None and start != 0:
            raise NotImplementedError(
                f"{cfg.name}: a held sequence's pass over several positions "
                f"from {start}: no entry point of the reference runs one (its "
                f"prefill starts at 0, its decode step takes one position)")
        n = s * (seq.size if seq is not None else 1)  # the pass's positions
        if not tensor_start and start + n > max_len:
            raise ValueError(f"positions {start}..{start + n - 1} exceed the "
                             f"cache length {max_len}")
        # int64: the first row is also the cache writes' index
        if seq is None:
            q_pos = _positions(b, start, s, x.device, torch.long)
        else:  # this rank's block of the prompt
            q_pos = _positions(b, seq.lo(s), s, x.device, torch.long)
        # k_pos <= q_pos hides the not-yet-written cache slots
        k_pos = _positions(b, 0, max_len, x.device)
        # attend_route's start == 0 is a host-side fact: a tensor start says
        # nothing there (and a decode step, Sq = 1, never takes K4); a block
        # of the prompt from lo is no index mask either (the attention asks)
        token = _CACHE_AXES.set(() if grp is None else grp.axes)
        try:
            x = _run_stacks(params, cfg, x, q_pos, k_pos, cache,
                            None if tensor_start else start)
        finally:
            _CACHE_AXES.reset(token)
        return _unembed(params, cfg, x), cache


def decode_step(params, cfg: LMConfig, cache, tokens: torch.Tensor, pos):
    """One decode step: ``tokens`` (B, 1) at position ``pos`` (the same for
    every row): a Python int, range-checked against the cache, or a 0-d
    integer tensor on the cache's device, which its caller checks (a
    captured step's copied-in position).  Returns ``(logits (B, 1, V),
    cache)``, the cache written in place at ``pos``."""
    return _cached_pass(params, cfg, cache, tokens,
                        pos if isinstance(pos, torch.Tensor) else int(pos),
                        decode=True)


def prefill(params, cfg: LMConfig, cache, tokens: torch.Tensor):
    """Batched cache-filling prefill: ``tokens`` (B, P) -> ``(logits (B, P,
    V), cache)`` with positions ``0..P-1`` written in place — the same as
    P ``decode_step`` calls, in one pass whose attention runs on K4 where
    ``attend_route`` says so."""
    return _cached_pass(params, cfg, cache, tokens, 0)
