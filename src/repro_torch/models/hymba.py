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

Tensor parallelism.  Under a process mesh with a ``model`` axis of more
than one rank each rank holds its cut of every leaf (``schema_shardings``)
and exchanges activations, never parameters.  At full width none of the
head counts divides 2 or 16 (25 heads and 5 KV heads of 64, 50 SSM
heads).  Attention takes ``transformer.heads_tp``: whole heads where the
cut is (smoke), else the projections gathered, every rank attending
every head on K4 and keeping its row block for ``wo_attn``.  The KV ring
is cut as the reference's ``cache_axes`` place it, by KV head where they
divide the ranks, else on head_dim; a decode step over a head_dim-cut
ring sums the ranks' partial ``q . k`` logits over ``model`` before its
softmax, each rank's ``p . v`` is its head_dim block, gathered.  The SSM
branch runs on the rank's block of the ``d_inner`` channels (its cut of
``conv``, its row blocks of ``w_bc``, ``w_dt`` and ``wo_ssm``).  ``w_in``
is the column-cut concatenation [u | z]: at model 2 rank 0 holds all of
``u``, so the local products are gathered and each rank takes its block
of both halves (trap 3).  ``B``, ``C`` and ``dt`` are row-cut products
summed over ``model``.  The SSM state keeps the reference's cut: by head
where the SSM heads divide the ranks (block r is whole heads), else on
head_dim, where a rank holds channels ``h * hd + j`` for ``j`` in its
slice of every head, not its contiguous block (trap 4): ``u`` is gathered
and sliced so for the scan, whose output is gathered back to the block.
Where the SSM heads and head_dim both do not divide, the state is whole
and every rank scans every head, keeping its block of the output.  The
conv tail is whole on every rank (every channel's input is gathered
anyway); where it holds the rows of every data rank (the reference
replicates it) a decode step reads its rows and all-gathers the new rows
over the data axes.  A branch whose widths do not divide at all (the
smoke's 64 over model 3: ``wq`` and ``d_inner`` whole) is whole on every
rank, as the reference replicates it, and computed as on one device
(``[u | z]`` gathered where only ``w_in``'s doubled width divides).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..devices import resolve_device
from ..sharding import (BATCH, active_mesh, keep_vocab_cut,
                        model_ranks, resolve_pspec, sequence_ranks, shard_hint,
                        spec_axes)
from ..tree import tree_map
from .common import (ParamSpec, apply_rope, attention, embed_rows,
                     make_attn_mask, next_token_nll, position_index, prev_rows,
                     rms_norm, rope_inv_freq, run_layer, stack_schema,
                     vocab_logits)
from .linear_scan import chunked_linear_attention, linear_step, scan_over_ranks
from .transformer import attend, glu_ffn, heads_tp, kv_for, row_out

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
    tp = model_ranks()
    di = cfg.d_inner
    if tp is not None and di % tp.size == 0:
        return _ssm_branch_tp(tp, w, x, cfg, conv_tail, s, decode, remat)
    b, t, _ = x.shape
    if tp is not None and tp.cut(w["w_in"], 1, 2 * di):  # the rest whole
        uz = tp.gather(tp.copy(x) @ w["w_in"], -1)
    else:
        uz = x @ w["w_in"]
    u, z = uz.chunk(2, dim=-1)
    seq = None if decode else sequence_ranks()
    if seq is not None:  # the previous block's last rows
        conv_tail = prev_rows(seq, u, cfg.conv_width - 1, conv_tail)
    u, conv_tail = _causal_conv(u, w["conv"], conv_tail)
    u = F.silu(u.float()).to(x.dtype)
    b_in, c_out = (u @ w["w_bc"]).chunk(2, dim=-1)  # (B, T, ns) each
    dt = _softplus((u @ w["w_dt"]).float())  # (B, T, hm)
    y, s = _scan(cfg, u.reshape(b, t, cfg.ssm_heads, cfg.head_dim), b_in,
                 c_out, dt, w["a_log"], s, decode, remat)
    y = y.reshape(b, t, di) + u * w["d_skip"].repeat_interleave(
        cfg.head_dim).to(u.dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    return y @ w["wo_ssm"], conv_tail, s


def _scan(cfg: HymbaConfig, u, b_in, c_out, dt, a_log, s, decode: bool,
          remat: bool):
    """The selective scan as linear attention with ``k = B``, ``r = C``
    and ``v = dt * u`` per head: ``u`` (B, T, n, dv) the channels of ``n``
    heads (``dv`` of each), ``dt`` (B, T, n) and ``a_log`` (n,) theirs.
    Returns ``(y (B, T, n, dv), s')``."""
    b, t, n, _ = u.shape
    ns = cfg.ssm_state
    a = -torch.exp(a_log.float())  # (n,) < 0
    # each head's dt scales its dv channels (jnp.repeat, not a tiling)
    kh = b_in[:, :, None, :].expand(b, t, n, ns)
    rh = c_out[:, :, None, :].expand(b, t, n, ns)
    vh = u * dt[..., None].to(u.dtype)
    lw = (dt * a)[..., None].expand(b, t, n, ns)
    if decode:
        y, s = linear_step(rh[:, 0], kh[:, 0], vh[:, 0], lw[:, 0], s)
        return y[:, None], s
    seq = sequence_ranks()
    if seq is not None:  # this rank's block, from the ranks before it
        return scan_over_ranks(seq, rh, kh, vh, lw, chunk=cfg.chunk,
                               remat=remat), s
    return chunked_linear_attention(rh, kh, vh, lw, chunk=cfg.chunk, state=s,
                                    remat=remat)


def _fuse_and_ffn(w, x, attn_out, ssm_out, cfg: HymbaConfig):
    fused = 0.5 * (rms_norm(attn_out, w["ln_attn_out"])
                   + rms_norm(ssm_out, w["ln_ssm_out"]))
    x = x + fused
    return x + glu_ffn(w, rms_norm(x, w["ln_ffn"]), cfg.d_ff, F.silu)


def _layers(params, cfg: HymbaConfig):
    """Each layer's weights, the stacked leaves unbound once."""
    layers = tree_map(lambda leaf: leaf.unbind(0), params["layers"])
    return [tree_map(lambda leaves: leaves[l], layers) for l in range(cfg.layers)]


def _unembed(params, cfg: HymbaConfig, x):
    x = rms_norm(x, params["ln_f"])
    return vocab_logits(x, params["embed"].t(), cfg.vocab, lambda t: t.float())


def _attn_branch(w, x, cfg: HymbaConfig, rope, pos, autograd: bool,
                 k_pos=None):
    """The attention branch over the prompt (positions ``pos`` from 0).
    Under a held sequence ``x`` is this rank's block at positions ``pos``:
    every block's K/V are gathered (keys at ``k_pos``) and masked by
    position under the window."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    tp = model_ranks()
    if tp is not None and not tp.cut(w["wq"], 1, cfg.n_heads * hd):
        tp = None  # whole on every rank: as on one device
    if tp is not None:  # this rank's heads, or every head
        q, k, v, q_lo, kv_lo = heads_tp(tp, x, w["wq"], w["wk"], w["wv"],
                                        cfg.n_heads, cfg.n_kv_heads, hd,
                                        cfg.name)
        q, k = apply_rope(q, rope, pos), apply_rope(k, rope, pos)
        k, v = kv_for(q_lo, q.shape[2], kv_lo, k, v,
                      cfg.n_heads // cfg.n_kv_heads)
    else:
        q, k, v = _qkv(w, x, cfg, rope, pos)
    seq = sequence_ranks()
    if seq is not None:
        k, v = seq.gather(k, 1), seq.gather(v, 1)
    attn = attend(q, k, v, pos, pos if seq is None else k_pos,
                  scale=1.0 / math.sqrt(hd), window=cfg.window,
                  start=0 if seq is None else None,
                  flash_chunk=cfg.flash_chunk,
                  autograd=autograd).reshape(b, s, -1)
    return attn @ w["wo_attn"] if tp is None else row_out(tp, attn, w["wo_attn"])


def forward(params, cfg: HymbaConfig, tokens: torch.Tensor, *,
            autograd: bool = False) -> torch.Tensor:
    """``tokens`` (B, T) -> logits (B, T, V) from a zero SSM state (the conv
    tail bf16 zeros, as the reference's).  ``autograd=False`` is the
    serving route (attention on K4 where ``attend_route`` says so);
    ``autograd=True`` the training route, which backward differentiates
    (each scan chunk recomputed in backward, as the reference's).  Under a
    held sequence (batch 1) ``tokens`` is this rank's block: the attention
    gathers every block's K/V, the causal conv takes the previous block's
    last rows, and the scan composes its state across the blocks."""
    b, s = tokens.shape
    x = embed_rows(params["embed"], tokens, cfg.vocab)
    seq = sequence_ranks()
    # at batch 1 the sequence over data: a held sequence's block
    x = shard_hint(x, BATCH, "data" if b == 1 else None, None,
                   seq_dim=1 if seq is not None else None)
    if seq is None:
        pos = k_pos = torch.arange(s, dtype=torch.int32,
                                   device=x.device).expand(b, s)
    else:
        pos, k_pos = (p.expand(b, -1) for p in seq.positions([s], x.device))
    rope = rope_inv_freq(cfg.head_dim, cfg.rope_base, x.device)
    tail = torch.zeros((b, cfg.conv_width - 1, cfg.d_inner), dtype=torch.bfloat16,
                       device=x.device)
    s0 = torch.zeros((b, cfg.ssm_heads, cfg.ssm_state, cfg.head_dim),
                     dtype=torch.float32, device=x.device)
    for w in _layers(params, cfg):
        x = run_layer(_layer, "layers", w, x, cfg, rope, pos, k_pos, tail, s0,
                      autograd)
    return _unembed(params, cfg, x)


def _layer(w, x, cfg: HymbaConfig, rope, pos, k_pos, tail, s0, autograd):
    """One layer of the pass over the prompt from a zero SSM state."""
    h_in = rms_norm(x, w["ln"])
    attn_out = _attn_branch(w, h_in, cfg, rope, pos, autograd, k_pos)
    ssm_out, _, _ = _ssm_branch(w, h_in, cfg, tail, s0, False, autograd)
    return _fuse_and_ffn(w, x, attn_out, ssm_out, cfg)


# ---------------------------------------------------------------------------
# tensor parallelism over the mesh's model axis
# ---------------------------------------------------------------------------


def _uz_blocks(tp, x, w_in, di: int):
    """``x @ w_in`` = ``[u | z]`` from this rank's column block of
    ``w_in``: the local products gathered (the backward summed), then
    ``(u whole, this rank's channel block of u, its block of z)``."""
    uz = tp.gather_partial(tp.copy(x) @ w_in, -1)
    blk = tp.block(di)
    return uz[..., :di], uz[..., :di][..., blk], uz[..., di:][..., blk]


def _ssm_branch_tp(tp, w, x, cfg: HymbaConfig, conv_tail, s, decode: bool,
                   remat: bool):
    """``_ssm_branch`` on this rank's block of the ``d_inner`` channels,
    the block its cut of ``conv`` and its row blocks of ``w_bc``, ``w_dt``
    and ``wo_ssm`` hold.  ``w_in`` is the column-cut concatenation ``[u |
    z]``: the local products are gathered and each rank takes its block of
    both halves (trap 3; at model 2 rank 0 holds all of ``u``).  ``B``,
    ``C`` and ``dt`` are the row-cut products summed over ``model``, every
    head's.  The scan runs on the cut the state has (``cache_axes``):
    where the SSM heads divide the ranks, block r is whole heads and the
    state is cut by head; else the state is cut on head_dim, a rank holding
    a slice of the channels of every head, so ``u`` goes in gathered and
    sliced so, and the scan's output is gathered back to the block (trap
    4); where neither divides the state is whole and every rank scans
    every head.  The conv tail is whole on every rank (each has every
    channel's input).  ``s`` is the state's cut, or every head's (a forward's
    zeros)."""
    b, t, _ = x.shape
    di, hm, hd = cfg.d_inner, cfg.ssm_heads, cfg.head_dim
    blk = tp.block(di)
    u_in, u, z = _uz_blocks(tp, x, w["w_in"], di)
    seq = None if decode else sequence_ranks()
    if seq is not None:  # the previous block's last rows, every channel
        conv_tail = prev_rows(seq, u_in, cfg.conv_width - 1, conv_tail)
    u, _ = _causal_conv(u, w["conv"], conv_tail[..., blk])
    # the next call's tail, every channel
    tail = torch.cat([conv_tail.to(u_in.dtype), u_in], dim=1)[:, -(
        cfg.conv_width - 1):]
    u = F.silu(u.float()).to(x.dtype)  # (B, T, di / ranks)
    b_in, c_out = tp.copy(tp.reduce(u @ w["w_bc"])).chunk(2, dim=-1)
    dt = _softplus(tp.copy(tp.reduce(u @ w["w_dt"])).float())  # (B, T, hm)
    if hm % tp.size == 0:  # block r is whole heads; so is the state's cut
        heads = tp.block(hm)
        if s.shape[1] == hm:
            s = s[:, heads]
        y, s = _scan(cfg, u.reshape(b, t, -1, hd), b_in, c_out, dt[..., heads],
                     w["a_log"], s, decode, remat)
        y = y.reshape(b, t, -1)
        d_skip = w["d_skip"]
    elif hd % tp.size == 0:  # the state's head_dim over model
        sl = tp.block(hd)
        if s.shape[-1] == hd:
            s = s[..., sl]
        uh = tp.gather_partial(u, -1).reshape(b, t, hm, hd)[..., sl]
        y, s = _scan(cfg, uh, b_in, c_out, dt, tp.copy(w["a_log"]), s,
                     decode, remat)
        y = tp.gather_partial(y, -1).reshape(b, t, di)[..., blk]
        d_skip = tp.copy(w["d_skip"])
    else:  # the state whole: every rank scans every head
        uh = tp.gather_partial(u, -1).reshape(b, t, hm, hd)
        y, s = _scan(cfg, uh, b_in, c_out, dt, tp.copy(w["a_log"]), s,
                     decode, remat)
        y = y.reshape(b, t, di)[..., blk]
        d_skip = tp.copy(w["d_skip"])
    skip = d_skip.repeat_interleave(hd)
    y = y + u * (skip if skip.shape[0] == u.shape[-1] else skip[blk]).to(u.dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    return tp.reduce(y @ w["wo_ssm"]), tail, s


def _ring_attn_tp(tp, w, x, cfg: HymbaConfig, rope, q_pos, mask, ck, cv,
                  slot) -> torch.Tensor:
    """A decode step's attention over this rank's cut of the KV ring
    (``cache_axes``: its KV heads where they divide the ranks, else its
    slice of head_dim; whole where neither does), the new K/V written at
    ``slot``.  Over a head_dim slice every rank attends every head: its
    partial ``q . k`` logits are summed over ``model`` before the softmax,
    and each ``p . v`` is its head_dim block, gathered."""
    b = x.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v, q_lo, kv_lo = heads_tp(tp, x, w["wq"], w["wk"], w["wv"], h, hkv,
                                    hd, cfg.name)
    q, k = apply_rope(q, rope, q_pos), apply_rope(k, rope, q_pos)
    scale = 1.0 / math.sqrt(hd)
    if ck.shape[-2] < hkv:  # this rank's KV heads
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        kk, vv = kv_for(q_lo, q.shape[2], kv_lo, ck, cv, h // hkv)
        out = attention(q, kk, vv, mask, scale=scale)
        return row_out(tp, out.reshape(b, 1, -1), w["wo_attn"])
    if k.shape[2] < hkv:
        k, v = tp.gather(k, 2), tp.gather(v, 2)
    if q.shape[2] < h:
        q = tp.gather(q, 2)
    if ck.shape[-1] == hd:  # the ring whole on every rank
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        out = attention(q, ck, cv, mask, scale=scale)
    else:
        sl = tp.block(hd)
        ck.index_copy_(1, slot, k[..., sl].to(ck.dtype))
        cv.index_copy_(1, slot, v[..., sl].to(cv.dtype))
        qs = q[..., sl].reshape(b, 1, hkv, h // hkv, -1)
        logits = tp.all_reduce(torch.einsum("bqhrd,bkhd->bhrqk", qs, ck).float())
        probs = torch.softmax(logits * scale + mask[:, :, None], dim=-1)
        out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(cv.dtype), cv)
        out = tp.gather(out.reshape(b, 1, h, -1), -1)
    return row_out(tp, out.reshape(b, 1, h * hd), w["wo_attn"])


def _row_axes(rows: int) -> tuple:
    """The data axes over which a batch of ``rows`` global rows is cut
    (``resolve_pspec`` of the token batch's ``BATCH`` candidates)."""
    mesh = active_mesh()
    return spec_axes(resolve_pspec((rows,), (BATCH,), mesh.shape)[0])


def _tail_rows(tail: torch.Tensor, b: int) -> torch.Tensor:
    """This pass's ``b`` rows of a conv-tail leaf: the leaf, or, where it
    holds the rows of every data rank (the reference's ``cache_axes``
    replicate it, as the dry run and a model-axis cache lay it out), this
    rank's block of them."""
    if tail.shape[0] == b:
        return tail
    i = active_mesh().group_rank(_row_axes(tail.shape[0]))
    return tail[i * b:(i + 1) * b]


def _keep_tail(leaf: torch.Tensor, new: torch.Tensor) -> None:
    """Write ``new`` into the conv-tail ``leaf``; a leaf of every data
    rank's rows takes every rank's new rows (all-gathered over the data
    axes that cut the batch), so it stays the same on every rank."""
    if leaf.shape[0] != new.shape[0]:
        new = active_mesh().all_gather(new, _row_axes(leaf.shape[0]), 0)
    leaf.copy_(new)


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
    x = embed_rows(params["embed"], tokens, cfg.vocab)
    dev = x.device
    h, hd = cfg.n_heads, cfg.head_dim
    kv_len = state["kv"]["k"].shape[2]
    at = position_index(pos, dev)
    slot = at % kv_len
    q_pos = at.expand(b, 1)
    k_pos = ring_key_positions(at, kv_len, dev).expand(b, kv_len)
    mask = make_attn_mask(q_pos, k_pos, cfg.window)
    rope = rope_inv_freq(hd, cfg.rope_base, dev)
    tp = model_ranks()
    for l, w in enumerate(_layers(params, cfg)):
        h_in = rms_norm(x, w["ln"])
        ck, cv = state["kv"]["k"][l], state["kv"]["v"][l]
        if tp is not None and tp.cut(w["wq"], 1, h * hd):
            attn_out = _ring_attn_tp(tp, w, h_in, cfg, rope, q_pos, mask, ck,
                                     cv, slot)
        else:
            q, k, v = _qkv(w, h_in, cfg, rope, q_pos)
            ck.index_copy_(1, slot, k.to(ck.dtype))
            cv.index_copy_(1, slot, v.to(cv.dtype))
            attn = attention(q, ck, cv, mask, scale=1.0 / math.sqrt(hd))
            attn_out = attn.reshape(b, 1, h * hd) @ w["wo_attn"]
        ssm_out, tail, s = _ssm_branch(w, h_in, cfg,
                                       _tail_rows(state["conv"][l], b),
                                       state["s"][l], True)
        _keep_tail(state["conv"][l], tail)
        state["s"][l] = s
        x = _fuse_and_ffn(w, x, attn_out, ssm_out, cfg)
    return _unembed(params, cfg, x), state


def lm_loss(params, cfg: HymbaConfig, tokens: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood of ``targets`` (B, T),
    through the training route."""
    with keep_vocab_cut():  # the vocab-parallel loss over model ranks
        logits = forward(params, cfg, tokens, autograd=True)
    return next_token_nll(logits, targets, cfg.vocab)
