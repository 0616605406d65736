"""Shared model building blocks: the param schema with logical sharding
axes, the params drawn from it or carried across from numpy, RMS norm,
softcap, RoPE, the causal/sliding-window mask, GQA attention and the
next-token loss.

Counterparts of the JAX package's ``models/common.py``, with the same
layouts: activations ``(B, S, H, D)``, GQA by head repetition with query
head ``h = g * rep + r`` reading KV head ``g``.  Each family defines a
*schema*, the reference's nested dict of ``ParamSpec`` leaves, from which
come its random init (``schema_init``), its shapes (``schema_shapes``,
meta tensors), its PartitionSpecs on a mesh (``schema_pspecs``) and its
parameter count (``count_params``), and its shardings
(``schema_shardings``: a ``sharding.NamedSharding`` a leaf, its DTensor
placements on the mesh's dimensions), which ``sharding.shard_tree`` and
``gather_tree`` apply to a tree of full leaves under a process mesh and
undo.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..devices import resolve_device
from ..sharding import (NamedSharding, PartitionSpec, gather_layer,
                        model_ranks, placement, shard_tree, use_placement,
                        vocab_cut_kept)
from ..tree import tree_leaves, tree_map

__all__ = ["ParamSpec", "MODEL_AXIS", "stack_schema", "spec_to_pspec",
           "schema_init", "schema_shapes", "schema_pspecs", "count_params",
           "schema_shardings",
           "params_from_numpy", "at_least_fp32", "embed_rows", "vocab_logits",
           "whole_vocab", "greedy", "prev_rows", "rms_norm",
           "softcap", "rope_inv_freq", "apply_rope", "make_attn_mask",
           "attention", "next_token_nll", "position_index", "checkpointed",
           "run_layer", "NEG_INF"]

NEG_INF = -1e30  # additive mask value (finite, as in the reference)

# params only ever shard over the model axis (FSDP adds the data axes)
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: its shape, the logical axis of each dimension, and
    its init scale (None = fan-in, 0.0 = zeros)."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, len == len(shape)
    scale: float | None = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


# logical axes that shard over the model (tensor) axis of the mesh
_MODEL_SHARDED = {"vocab", "heads", "kv_heads", "ff", "experts", "out_ch"}


def stack_schema(schema: dict, n: int) -> dict:
    """A layer's schema with a leading, unsharded axis of ``n`` layers on
    every leaf (the reference's stacked schema)."""
    return tree_map(lambda p: ParamSpec((n,) + p.shape, (None,) + p.axes,
                                        p.scale), schema)


def spec_to_pspec(spec: ParamSpec, mesh, fsdp: bool = False) -> PartitionSpec:
    """The leaf's ``PartitionSpec`` on ``mesh`` (anything with a ``shape``
    dict of axis sizes): the first model-sharded logical axis that divides
    the model axis takes it, every other dimension is replicated (SmolLM's
    9 heads on model = 16).  ``fsdp=True`` (training) also shards the
    largest remaining dimension that divides the data (and pod) degree
    over those axes, for stacked (>= 3-D) layer weights only: the
    reference found a 2-D embedding sharded over data made GSPMD
    replicate the whole table.  A mesh without those axes (``model``
    alone) has no FSDP cut."""
    model_size = mesh.shape[MODEL_AXIS]
    out: list = []
    used_model = False
    for dim, ax in zip(spec.shape, spec.axes):
        if ax in _MODEL_SHARDED and not used_model and dim % model_size == 0:
            out.append(MODEL_AXIS)
            used_model = True
        else:
            out.append(None)
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if fsdp and data_axes and len(spec.shape) >= 3:
        dsize = math.prod(mesh.shape[a] for a in data_axes)
        cands = [(dim, i) for i, (dim, sp) in enumerate(zip(spec.shape, out))
                 if sp is None and dim % dsize == 0 and dim >= dsize]
        if cands:
            _, i = max(cands)
            out[i] = data_axes if len(data_axes) > 1 else data_axes[0]
    return PartitionSpec(*out)


def schema_init(schema: dict, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32,
                shardings: dict | None = None) -> dict:
    """Random params of a schema: fan-in-scaled normals (the fan-in is the
    second-last axis, else the last), the leaf's own scale where it has
    one, zeros where it is 0.0.  Leaf by leaf in sorted-key order, each
    leaf is drawn from ``generator`` on the generator's own device and
    moved to ``device`` before the next is drawn, so a CUDA generator draws
    on the card and the host never holds the tree.  With ``shardings`` (a
    tree of ``sharding.NamedSharding`` like the schema) each drawn leaf is
    cut to this rank's shard at once, so a rank never holds more than one
    full leaf.  The reference draws with a jax PRNG, which is not
    re-implemented: the same seed gives other weights there."""
    dev = resolve_device(device)

    def leaf(spec: ParamSpec, sh):
        shape, scale = spec.shape, spec.scale
        if scale == 0.0:
            t = torch.zeros(shape, dtype=dtype, device=generator.device
                            if sh is not None else dev)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
            t = torch.randn(shape, generator=generator, dtype=dtype,
                            device=generator.device).mul_(std)
        return (t if sh is None else shard_tree(t, sh)).to(dev)

    def draw(node, sh):
        if isinstance(node, dict):
            return {k: draw(node[k], None if sh is None else sh[k])
                    for k in sorted(node)}
        return leaf(node, sh)

    return draw(schema, shardings)


def schema_shapes(schema: dict, dtype: torch.dtype = torch.float32) -> dict:
    """The params as meta tensors (shape and dtype, no storage): the
    reference's ``ShapeDtypeStruct`` tree."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"),
                    schema)


def schema_pspecs(schema: dict, mesh, fsdp: bool = False) -> dict:
    """Each leaf's ``spec_to_pspec`` on ``mesh``."""
    return tree_map(lambda s: spec_to_pspec(s, mesh, fsdp), schema)


def count_params(schema: dict) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(schema))


def schema_shardings(schema: dict, mesh, fsdp: bool = False) -> dict:
    """Each leaf's ``NamedSharding`` on ``mesh`` (its ``spec_to_pspec``,
    FSDP's data-axis cut where ``fsdp``)."""
    return tree_map(lambda s: NamedSharding(mesh, spec_to_pspec(s, mesh, fsdp)),
                    schema)


def _leaf_from_numpy(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, as jax hands it over
        return torch.tensor(a.view(np.int16), device=dev).view(torch.bfloat16)
    return torch.tensor(a, device=dev)


def params_from_numpy(tree: dict, device: str | torch.device = "cuda") -> dict:
    """Carry a tree made elsewhere across unchanged: same tree, same
    layouts, same values and dtypes (bf16 included).  Any family's params
    from the JAX package's ``bundle.init`` / ``schema_init``, or its AdamW
    state ``{"m", "v", "step"}``, as nested dicts of numpy arrays."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_from_numpy(a, dev), tree)


def checkpointed(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    backward recomputes it, saving only its inputs (the reference's
    ``jax.checkpoint``).  No model draws random numbers, so no RNG state
    is saved; reading the card's would fail inside a CUDA-graph capture
    of a train step.  The recompute runs under the placement that was
    active for the forward (the mesh, a held sequence, a kept vocab cut:
    ``sharding.placement``): on the card the backward runs on autograd's
    device thread, which does not see the caller's ``use_mesh``."""
    state = placement()

    def run(*a):
        with use_placement(state):
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def _gathered(fn, stack: str, w, *args):
    return fn(gather_layer(w, stack), *args)


def run_layer(fn, stack: str, w, *args, remat: bool = False):
    """``fn(w, *args)`` for one layer's weights ``w`` of ``params[stack]``,
    its FSDP shards gathered over the data axes first
    (``sharding.gather_layer``, the identity outside an FSDP train step).
    With ``remat`` under ``checkpointed``: backward gathers the layer
    again instead of keeping it."""
    if remat:
        return checkpointed(_gathered, fn, stack, w, *args)
    return _gathered(fn, stack, w, *args)


def next_token_nll(logits: torch.Tensor, targets: torch.Tensor,
                   vocab: int | None = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``targets`` (B, S) under ``logits``
    (B, S, V): the reference's ``lm_loss`` tail.  Over model ranks whose
    ``logits`` are their block of the ``vocab`` columns (``vocab_logits``
    with the cut kept) it is the vocab-parallel cross-entropy: no rank
    holds the whole vocabulary."""
    tp = model_ranks()
    if vocab is not None and tp is not None and logits.shape[-1] != vocab:
        lo = tp.rank * logits.shape[-1]
        return _VocabParallelNLL.apply(logits, targets, lo, tp).mean()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0].mean()


class _VocabParallelNLL(torch.autograd.Function):
    """Megatron's vocab-parallel cross-entropy (arXiv:1909.08053 §3): per
    position ``log(sum_v exp(l_v - m)) - (l_t - m)`` from this rank's block
    of the logits, with ``m`` the all-reduced maximum and the sum of
    exponentials and the target's shifted logit (from the rank that holds
    it, zero elsewhere) all-reduced together.  Backward, this rank's block
    of ``softmax - onehot(target)``, the only tensor saved."""

    @staticmethod
    def forward(ctx, logits, targets, lo, tp):
        n = logits.shape[-1]
        mx = tp.all_reduce(logits.amax(dim=-1), "max")
        z = logits - mx[..., None]
        loc = targets.long() - lo
        inside = (loc >= 0) & (loc < n)
        loc = loc.clamp(0, n - 1)
        zt = torch.where(inside, torch.gather(z, -1, loc[..., None])[..., 0],
                         0.0)
        e = z.exp_()
        tot = tp.all_reduce(torch.stack([e.sum(dim=-1), zt]))
        e.div_(tot[0][..., None])  # this rank's block of the softmax
        ctx.save_for_backward(e, loc, inside)
        return torch.log(tot[0]) - tot[1]

    @staticmethod
    def backward(ctx, grad):
        p, loc, inside = ctx.saved_tensors
        g = p * grad[..., None]
        g.scatter_add_(-1, loc[..., None],
                       torch.where(inside, -grad, 0.0)[..., None].to(g.dtype))
        return g, None, None, None


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or as it is in float64: the dtype the norms, the
    gates and the scan compute in, so that a float64 model stays float64
    throughout."""
    return x if x.dtype == torch.float64 else x.float()


def embed_rows(table: torch.Tensor, tokens: torch.Tensor,
               vocab: int) -> torch.Tensor:
    """``table[tokens]``.  Over model ranks that hold ``table`` (V, d) as
    their block of the vocab rows, each looks up its rows (zeros for the
    other ranks' tokens) and the lookups are summed over ``model``."""
    tp = model_ranks()
    if tp is None or not tp.cut(table, 0, vocab):
        return table[tokens]
    n = table.shape[0]
    loc = tokens.long() - tp.rank * n
    inside = ((loc >= 0) & (loc < n))[..., None]
    return tp.reduce(torch.where(inside, table[loc.clamp(0, n - 1)], 0.0))


def vocab_logits(x: torch.Tensor, head: torch.Tensor, vocab: int,
                 finish=at_least_fp32) -> torch.Tensor:
    """``finish(x @ head)`` for a head (d, V).  Over model ranks that hold
    its block of vocab columns, each computes that block (``finish``, a
    softcap, applied to it); under ``sharding.keep_vocab_cut`` the block is
    returned as it is, for the vocab-parallel loss (``next_token_nll``) or
    the greedy pick (``greedy``), else the blocks are gathered whole: what
    follows is then the same on every rank, so the gradient is this rank's
    slice."""
    tp = model_ranks()
    if tp is None or not tp.cut(head, 1, vocab):
        return finish(x @ head)
    block = finish(tp.copy(x) @ head)
    if vocab_cut_kept():
        return block
    return tp.gather(block, -1)


def whole_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """``logits`` (.., V) whole: where they are this rank's block of the
    ``vocab`` columns (``vocab_logits`` with the cut kept), the blocks
    all-gathered, no gradient; else as they are."""
    tp = model_ranks()
    if tp is None or logits.shape[-1] == vocab:
        return logits
    return tp.mesh.all_gather(logits, "model", dim=-1)


def greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """``logits.argmax(-1)`` over the whole vocabulary, int64.  Where the
    logits are this rank's block of the ``vocab`` columns, each rank takes
    its block's maximum and first index at it, and the winner is reduced
    over ``model``: the largest value, then among the ranks holding it the
    lowest index (the whole vocabulary's first maximum, as ``argmax``)."""
    tp = model_ranks()
    if tp is None or logits.shape[-1] == vocab:
        return logits.argmax(dim=-1)
    n = logits.shape[-1]
    idx = logits.argmax(dim=-1)
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    top = tp.all_reduce(val, "max")
    cand = torch.where(val == top, -(idx + tp.rank * n),
                       torch.full_like(idx, -vocab))
    return -tp.all_reduce(cand, "max")


def prev_rows(seq, x: torch.Tensor, n: int, first: torch.Tensor) -> torch.Tensor:
    """The ``n`` rows (dimension 1) before this rank's block of ``x`` (B,
    T, ...) over the ranks ``seq`` (a halo: a token shift's or a causal
    conv's carry across a block boundary), taken from as many earlier
    ranks as hold them; ``first`` (B, n, ...) stands before the first
    block.  Each block's last ``min(n, T)`` rows are gathered (backward,
    summed to the rank that holds each), and every rank reads the gather,
    so every rank's backward runs its collective."""
    t = x.shape[1]
    m = min(n, t)
    rows = seq.gather(x[:, -m:], 1)  # block j's last m rows at j*m
    if m == t:  # blocks no longer than the carry: the whole sequence
        lead = torch.cat([first.to(x.dtype), rows], dim=1)
        return lead[:, seq.rank * t:seq.rank * t + n]
    if seq.rank == 0:
        return first.to(x.dtype) + rows[:, :n] * 0.0
    return rows[:, (seq.rank - 1) * n:seq.rank * n]


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + gamma)`` in fp32 (float64 for
    float64), cast back."""
    dt = x.dtype
    xf = at_least_fp32(x)
    xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + at_least_fp32(gamma))).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)


def rope_inv_freq(head_dim: int, base: float = 10000.0,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """``base ** (-j / half)``, computed on ``device`` with ``base`` a
    scalar operand: no host tensor is copied there, so the decode glue can
    compute it per call inside a CUDA-graph capture."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(float(base), exps)


def position_index(pos, device) -> torch.Tensor:
    """A decode step's position as a (1,) int64 tensor on ``device``: the
    index its cache write (``index_copy_``) and reads (``index_select``)
    take.  ``pos`` is a Python int (a fill, no host copy) or a 0-d integer
    tensor on ``device``, which a captured step reads as the graph's
    copied-in position; it never goes into a slice or to the host."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).long()
    return torch.full((1,), int(pos), dtype=torch.long, device=device)


def apply_rope(x: torch.Tensor, inv_freq: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Half-split rotation.  ``x`` (B, S, H, D); ``positions`` (B, S)."""
    ang = positions.float()[:, :, None] * inv_freq  # (B, S, D/2)
    c = torch.cos(ang)[:, :, None, :]
    s = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def make_attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                   window: int | None = None) -> torch.Tensor:
    """Causal (+ optional sliding window) additive mask: ``q_pos`` (B, Sq),
    ``k_pos`` (B, Sk) -> (B, 1, Sq, Sk) float32 of {0, NEG_INF}."""
    ok = k_pos[:, None, :] <= q_pos[:, :, None]
    if window is not None:
        ok &= k_pos[:, None, :] > q_pos[:, :, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))[:, None]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, *, scale: float | None = None,
              attn_softcap: float | None = None) -> torch.Tensor:
    """``q`` (B, Sq, H, D), ``k``/``v`` (B, Sk, Hkv, D[v]); GQA by head
    repetition.  Softmax in fp32; returns (B, Sq, H, Dv).  Where no
    gradient is taken the scale, the mask and the softmax run in place on
    the one (B, Hkv, rep, Sq, Sk) fp32 score tensor; the training route
    keeps them out of place, as autograd needs."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    rep = h // hkv
    qg = q.reshape(b, sq, hkv, rep, d)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() * scale
        if attn_softcap is not None:
            logits = softcap(logits, attn_softcap)
        logits = logits + mask[:, :, None, :, :]  # (B,1,Sq,Sk) -> (B,1,1,Sq,Sk)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
    else:  # one name, so each superseded tensor is freed at once
        probs = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float()
        probs.mul_(scale)
        if attn_softcap is not None:
            probs = softcap(probs, attn_softcap)
        probs.add_(mask[:, :, None, :, :])
        probs.sub_(probs.amax(dim=-1, keepdim=True)).exp_()
        probs = probs.div_(probs.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])
