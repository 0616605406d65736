"""Mixture-of-Experts FFN with sort-based capacity dispatch: the JAX
package's ``models/moe.py``.

Routing: a router GEMM in the activation dtype, an fp32 softmax, the top
k experts per token (ties to the lower expert index, as
``jax.lax.top_k``), gate weights renormalised over the k.  Capacity: per
dispatch group, the (token, k) entries are sorted stably by expert; an
entry's position in its expert's segment beyond ``cap`` drops it.  Two
dispatches of those entries compute the same function:

* ``moe_ffn``, the served one, the reference's gather-based grouped
  dispatch (``_moe_ffn_grouped``): an int32 slot -> token map, a gather of
  the activations into an (G, E, cap, d) buffer, batched SwiGLU experts,
  and a gather of each entry's expert output row back;
* ``moe_ffn_plain``, the reference's float-scatter formulation
  (``_moe_baseline_scatter``): the entries scattered into the buffer and
  their weighted outputs scatter-added back to their tokens.  Tests and
  the card check hold the first against it; a served path runs it only
  under ``REPRO_BASELINE=1``.

Under a process mesh whose ranks split the batch, the dispatch groups
are the reference's groups of the global tokens, with the reference's
capacity: a rank dispatches the groups that its rows make up (at a batch
of one held over the data ranks, its block of the sequence: the same
contiguous tokens).  Where a group covers rows of several ranks
(``dispatch_groups`` not a multiple of the ranks: DeepSeek's 16 groups
fall to 1 at a decode step under 16 tokens) the rows are all-gathered
over the data axes whose ranks hold distinct rows (``sharding.row_axes``),
each rank dispatches every group that holds one of its rows as one device
does, so the drops follow the global token-major order, and keeps its own
rows of the output; backward, the gather's gradient is this rank's slice
(another rank's rows reach none of this rank's outputs).  Under the
sequence-parallel stream the layer gathers the MoE's input over ``model``
and cuts its summed output back to the rank's block
(``models.transformer._layer``): the dispatch is the whole sequence's.

Expert parallelism: where the mesh's ``model`` axis has more than one
rank (``sharding.model_ranks``) the experts are held as the reference's
``spec_to_pspec`` places them (``_expert_cut``).  Where the experts
divide, each rank holds its block of ``E / model`` experts and of the
router's columns: the router's logits are gathered over ``model`` before
the top k, so every rank routes alike, and each rank runs its experts on
its block of the expert buffer.  Where they do not, the router is whole
(routing is local and alike) and each expert's ``ff`` is cut where it
divides (``w_gate`` / ``w_up`` by columns, ``w_down`` by rows): every
rank runs every expert on its ``ff`` block.  Either way the routed
output is a partial sum, and so is the shared experts' where their ``ff``
is cut; the partial sums go through one sum over ``model``.  Where
nothing divides (the smoke configs over model 3) the layer is whole on
every rank: no collective, computed as on one device.

``REPRO_BASELINE=1`` selects the float-scatter dispatch inside
``moe_ffn``, as the reference's ``_moe_ffn_grouped`` does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..sharding import (BATCH, MODEL, active_mesh, baseline, batch_ranks,
                        model_ranks, row_axes, shard_hint)
from .common import ParamSpec

__all__ = ["MoEConfig", "moe_schema", "moe_ffn", "moe_ffn_plain", "route",
           "Routing", "capacity", "dispatch_groups"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_model: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.0
    # dispatch groups: capacity bookkeeping is done per contiguous token
    # group (the reference sets it to the data-parallel degree)
    dispatch_groups: int = 1


def moe_schema(cfg: MoEConfig) -> dict:
    """One MoE layer's schema (the reference's ``moe_schema``): the router,
    the routed experts' stacked FFN and, nested under ``"shared"``, the
    shared experts'."""
    e, d, f = cfg.n_routed, cfg.d_model, cfg.d_ff_expert
    s = {"router": ParamSpec((d, e), ("embed", "experts")),
         "w_gate": ParamSpec((e, d, f), ("experts", "embed", "ff")),
         "w_up": ParamSpec((e, d, f), ("experts", "embed", "ff")),
         "w_down": ParamSpec((e, f, d), ("experts", "ff", "embed"))}
    if cfg.n_shared:
        fs = f * cfg.n_shared
        s["shared"] = {"w_gate": ParamSpec((d, fs), ("embed", "ff")),
                       "w_up": ParamSpec((d, fs), ("embed", "ff")),
                       "w_down": ParamSpec((fs, d), ("ff", "embed"))}
    return s


def capacity(cfg: MoEConfig, t: int) -> int:
    """Slots an expert has in a group of ``t`` tokens: ``cf * k * t / e``
    truncated, at least 8, rounded up to a multiple of 8."""
    cap = max(int(cfg.capacity_factor * cfg.top_k * t / cfg.n_routed), 8)
    return -(-cap // 8) * 8


def dispatch_groups(cfg: MoEConfig, t: int) -> int:
    """``cfg.dispatch_groups`` where it divides ``t`` tokens, else 1."""
    return cfg.dispatch_groups if t % cfg.dispatch_groups == 0 else 1


class Routing(NamedTuple):
    """One dispatch group's routing: gate weights and experts ``(G, T,
    K)``; ``order``, the stable sort of the token-major (token, k) entries
    by expert; for each sorted entry, its position in its expert's
    segment ``pos``, whether it fits (``keep``), its buffer slot
    ``dest_e`` / ``dest_c`` (column ``cap`` the drop bin) and its token
    ``src_token``; ``cap`` the slots an expert has."""
    gate_w: torch.Tensor
    gate_e: torch.Tensor
    order: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    dest_e: torch.Tensor
    dest_c: torch.Tensor
    src_token: torch.Tensor
    cap: int


def _expert_cut(tp, w: dict, cfg: MoEConfig) -> str | None:
    """How this rank holds the routed experts over the model ranks ``tp``,
    as ``spec_to_pspec`` places them: ``"experts"`` (its block of the
    experts and of the router's columns), ``"ff"`` (every expert's block
    of ``ff``, the router whole) or None (whole, or no model ranks)."""
    if tp is None:
        return None
    if tp.cut(w["w_gate"], 0, cfg.n_routed):
        return "experts"
    if tp.cut(w["w_gate"], 2, cfg.d_ff_expert):
        return "ff"
    return None


def route(w: dict, xg: torch.Tensor, cfg: MoEConfig) -> Routing:
    """Router, top-k and capacity of ``xg`` (G, T, d) (the reference's
    ``_moe_ffn_grouped`` ``:93-113``).  Over model ranks that hold blocks
    of the router's columns the logits are gathered, so every rank routes
    alike (and, where ``xg`` is ``copy``'s, the router's gradient is
    summed); a whole router routes alike as it is."""
    g, t, _ = xg.shape
    e, k = cfg.n_routed, cfg.top_k
    cap = capacity(cfg, t)
    logits = torch.einsum("gtd,de->gte", xg, w["router"].to(xg.dtype))
    tp = model_ranks()
    if _expert_cut(tp, w, cfg) == "experts":
        logits = tp.gather_partial(logits, -1)
    probs = torch.softmax(logits.float(), dim=-1)
    # a stable descending sort keeps tied experts in index order, the
    # lower index first, as jax.lax.top_k; torch.topk promises no order
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_e = vals[..., :k], idx[..., :k]
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    flat_e = gate_e.reshape(g, t * k)
    # stable: ties (one expert's entries) keep their token-major order,
    # which decides the entries that overflow the capacity
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    experts = torch.arange(e, device=xg.device).expand(g, e).contiguous()
    starts = torch.searchsorted(se, experts, side="left")  # (G, E)
    pos = torch.arange(t * k, device=xg.device)[None] - torch.gather(starts, 1, se)
    keep = pos < cap
    dest_e = torch.where(keep, se, e - 1)
    dest_c = torch.where(keep, pos, cap)  # cap column = drop bin
    src_token = order // k
    return Routing(gate_w, gate_e, order, pos, keep, dest_e, dest_c, src_token,
                   cap)


def _silu_gate(gg: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return F.silu(gg.float()).to(u.dtype) * u


def _expert_ffn_grouped(w: dict, xb: torch.Tensor) -> torch.Tensor:
    """xb: (G, E, C, d) -> (G, E, C, d); SwiGLU experts as batched GEMMs."""
    gg = torch.einsum("gecd,edf->gecf", xb, w["w_gate"])
    u = torch.einsum("gecd,edf->gecf", xb, w["w_up"])
    return torch.einsum("gecf,efd->gecd", _silu_gate(gg, u), w["w_down"])


def _shared_ffn(w: dict, xg: torch.Tensor) -> torch.Tensor:
    s = w["shared"]
    gg = torch.einsum("gtd,df->gtf", xg, s["w_gate"])
    u = torch.einsum("gtd,df->gtf", xg, s["w_up"])
    return torch.einsum("gtf,fd->gtd", _silu_gate(gg, u), s["w_down"])


def _groups(x: torch.Tensor, cfg: MoEConfig):
    """``(groups (G, T/G, d), offset)``: the dispatch groups that this
    rank dispatches.  Where ``k`` ranks each hold T of the batch's tokens
    (``sharding.batch_ranks``), the groups are those of the k*T global
    tokens.  Where ``k`` divides their count each rank holds whole ones,
    its own, and ``offset`` is None; else the ranks' rows are all-gathered
    over ``sharding.row_axes`` and the groups are those holding one of
    this rank's rows, which start ``offset`` rows into them."""
    t, d = x.shape
    k = batch_ranks()
    g = dispatch_groups(cfg, t * k)
    if g % k == 0:
        xg = x.reshape(g // k, t * k // g, d)
        # the dispatch groups align with the batch's shards
        return (shard_hint(xg, BATCH, None, None) if g > 1 else xg), None
    axes = row_axes()
    tg = t * k // g
    lo = active_mesh().group_rank(axes) * t
    first, last = lo // tg, (lo + t - 1) // tg
    rows = active_mesh().gather_from(x, axes, 0)
    return (rows[first * tg:(last + 1) * tg].reshape(last + 1 - first, tg, d),
            lo - first * tg)


def _gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src`` (G, N, d) rows at ``idx`` (G, M) -> (G, M, d)."""
    return torch.gather(src, 1, idx[..., None].expand(-1, -1, src.shape[-1]))


def _gather_dispatch(w: dict, xf: torch.Tensor, r: Routing,
                     gate_w: torch.Tensor, cfg: MoEConfig, e0: int, el: int,
                     held, hint: bool) -> torch.Tensor:
    """Gather-based grouped dispatch (the reference's ``:83-150``) over
    experts ``e0..e0+el-1``: only an int32 slot -> token map is scattered;
    activations are gathered into the expert buffer and each entry of
    those experts gathers its expert output row back, weighted by
    ``gate_w``.  ``held``: the buffer's dimension this rank holds as its
    block over ``model``; ``hint``: whether the groups are this rank's
    block over the data axes (their hints then hold)."""
    g, t, d = xf.shape
    e, k = cfg.n_routed, cfg.top_k
    cap = r.cap
    gi = torch.arange(g, device=xf.device)[:, None].expand_as(r.dest_e)
    # slot -> token + 1 (0 = empty); duplicate indices land only in the
    # drop bin (column cap), which is sliced off
    slot_src = torch.zeros((g, e, cap + 1), dtype=torch.int32, device=xf.device)
    slot_src[gi, r.dest_e, r.dest_c] = (r.src_token + 1).to(torch.int32)
    slot_src = slot_src[:, e0:e0 + el, :cap]
    valid = slot_src > 0

    flat_idx = (slot_src - 1).clamp_min(0).reshape(g, el * cap).long()
    buf = _gather_rows(xf, flat_idx).reshape(g, el, cap, d)
    buf = buf * valid[..., None].to(xf.dtype)
    if hint:
        buf = shard_hint(buf, BATCH, MODEL, None, None, model_dim=held)
    out_buf = _expert_ffn_grouped(w, buf)
    if hint:
        out_buf = shard_hint(out_buf, BATCH, MODEL, None, None, model_dim=held)

    # combine: each (token, k) entry of these experts gathers its
    # expert-output row
    inv = torch.argsort(r.order, dim=-1)  # entry -> sorted position
    entry_pos = torch.gather(r.pos, 1, inv)
    entry_keep = torch.gather(r.keep, 1, inv)
    local_e = r.gate_e.reshape(g, t * k) - e0
    mine = entry_keep & (local_e >= 0) & (local_e < el)
    entry_slot = local_e.clamp(0, el - 1) * cap + entry_pos.clamp_max(cap - 1)
    vals = _gather_rows(out_buf.reshape(g, el * cap, d), entry_slot)
    vals = torch.where(mine[..., None], vals, 0.0)
    return (vals.reshape(g, t, k, d) * gate_w[..., None].to(xf.dtype)).sum(dim=2)


def _scatter_dispatch(w: dict, xf: torch.Tensor, r: Routing,
                      gate_w: torch.Tensor, cfg: MoEConfig, e0: int,
                      el: int) -> torch.Tensor:
    """The same by float scatters (the reference's
    ``_moe_baseline_scatter``, ``:169-192``): the kept entries of experts
    ``e0..e0+el-1`` written into the (G, el, cap + 1, d) buffer, the
    experts run, each entry's output weighted and scatter-added back to
    its token."""
    g, tg, d = xf.shape
    k, cap = cfg.top_k, r.cap
    gi = torch.arange(g, device=xf.device)[:, None].expand_as(r.dest_e)
    local_e = r.dest_e - e0
    mine = r.keep & (local_e >= 0) & (local_e < el)
    dest_e = torch.where(mine, local_e, 0)
    dest_c = torch.where(mine, r.dest_c, cap)  # cap column = drop bin
    x_entries = _gather_rows(xf, r.src_token)
    buf0 = torch.zeros((g, el, cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf0[gi, dest_e, dest_c] = x_entries
    out_buf0 = F.pad(_expert_ffn_grouped(w, buf0[:, :, :cap]), (0, 0, 0, 1))
    sw = torch.gather(gate_w.reshape(g, tg * k), 1, r.order)
    contrib = out_buf0[gi, dest_e, dest_c] * sw[..., None].to(xf.dtype)
    contrib = torch.where(mine[..., None], contrib, 0.0)
    y = torch.zeros((g, tg, d), dtype=xf.dtype, device=xf.device)
    return y.index_put((gi, r.src_token), contrib, accumulate=True)


def _moe_groups(w: dict, xg: torch.Tensor, cfg: MoEConfig, plain: bool,
                hint: bool = True) -> torch.Tensor:
    """The MoE's output on the groups ``xg`` (G, T, d): the gather-based
    dispatch, or with ``plain`` the float-scatter one.  Over model ranks
    the routed experts (and the shared ones) held cut give partial sums,
    which a block's input ``copy`` feeds and one sum over ``model``
    totals; what is held whole is computed as on one device and added
    after the sum."""
    e = cfg.n_routed
    tp = model_ranks()
    cut = _expert_cut(tp, w, cfg)
    # this rank's experts e0..e0+el-1 (all of them unless cut by experts)
    el = e // tp.size if cut == "experts" else e
    e0 = tp.rank * el if cut == "experts" else 0
    xf = tp.copy(xg) if cut else xg
    r = route(w, xf if cut == "experts" else xg, cfg)
    # a whole router's gates weigh partial sums under an ff cut: their
    # gradient is summed over the ranks
    gate_w = tp.copy(r.gate_w) if cut == "ff" else r.gate_w
    if plain:
        y = _scatter_dispatch(w, xf, r, gate_w, cfg, e0, el)
    else:
        y = _gather_dispatch(w, xf, r, gate_w, cfg, e0, el,
                             1 if cut == "experts" else None, hint)
    shared_cut = bool(cfg.n_shared) and tp is not None and tp.cut(
        w["shared"]["w_gate"], 1, cfg.d_ff_expert * cfg.n_shared)
    if cut:
        if shared_cut:  # its column block, in the same sum
            y = y + _shared_ffn(w, xf)
        y = tp.reduce(y)
    elif shared_cut:
        y = y + tp.reduce(_shared_ffn(w, tp.copy(xg)))
    if cfg.n_shared and not shared_cut:  # whole: the same on every rank
        y = y + _shared_ffn(w, xg)
    return y


def _moe(w: dict, x: torch.Tensor, cfg: MoEConfig, plain: bool) -> torch.Tensor:
    t, d = x.shape
    xg, offset = _groups(x, cfg)
    y = _moe_groups(w, xg, cfg, plain, hint=offset is None)
    if offset is None:
        return y.reshape(t, d)
    return y.reshape(-1, d)[offset:offset + t]  # this rank's rows


def moe_ffn(w: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x: (T, d) -> (T, d), dispatched per group (``dispatch_groups``);
    under ``REPRO_BASELINE=1`` by float scatters, as the reference."""
    return _moe(w, x, cfg, baseline())


def moe_ffn_plain(w: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The same function by float scatters (the reference's
    ``_moe_baseline_scatter``), on one device or over ranks alike."""
    return _moe(w, x, cfg, True)
