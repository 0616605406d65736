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
  the card check hold the first against it; no served path runs it.

Expert parallelism (the reference's ``experts`` axis over the mesh) waits
for the port's sharding slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

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


def route(w: dict, xg: torch.Tensor, cfg: MoEConfig) -> Routing:
    """Router, top-k and capacity of ``xg`` (G, T, d) (the reference's
    ``_moe_ffn_grouped`` ``:93-113``)."""
    g, t, _ = xg.shape
    e, k = cfg.n_routed, cfg.top_k
    cap = capacity(cfg, t)
    logits = torch.einsum("gtd,de->gte", xg, w["router"].to(xg.dtype))
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


def _grouped(x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    t, d = x.shape
    g = dispatch_groups(cfg, t)
    return x.reshape(g, t // g, d)


def _gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src`` (G, N, d) rows at ``idx`` (G, M) -> (G, M, d)."""
    return torch.gather(src, 1, idx[..., None].expand(-1, -1, src.shape[-1]))


def _moe_ffn_grouped(w: dict, xg: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Gather-based grouped dispatch (the reference's ``:83-150``): only an
    int32 slot -> token map is scattered; activations are gathered into
    the expert buffer and each entry gathers its expert output back."""
    g, t, d = xg.shape
    e, k = cfg.n_routed, cfg.top_k
    r = route(w, xg, cfg)
    cap = r.cap
    gi = torch.arange(g, device=xg.device)[:, None].expand_as(r.dest_e)
    # slot -> token + 1 (0 = empty); duplicate indices land only in the
    # drop bin (column cap), which is sliced off
    slot_src = torch.zeros((g, e, cap + 1), dtype=torch.int32, device=xg.device)
    slot_src[gi, r.dest_e, r.dest_c] = (r.src_token + 1).to(torch.int32)
    slot_src = slot_src[:, :, :cap]
    valid = slot_src > 0

    flat_idx = (slot_src - 1).clamp_min(0).reshape(g, e * cap).long()
    buf = _gather_rows(xg, flat_idx).reshape(g, e, cap, d)
    buf = buf * valid[..., None].to(xg.dtype)
    out_buf = _expert_ffn_grouped(w, buf)

    # combine: each (token, k) entry gathers its expert-output row
    inv = torch.argsort(r.order, dim=-1)  # entry -> sorted position
    entry_pos = torch.gather(r.pos, 1, inv)
    entry_keep = torch.gather(r.keep, 1, inv)
    flat_e = r.gate_e.reshape(g, t * k)
    entry_slot = flat_e * cap + entry_pos.clamp_max(cap - 1)
    vals = _gather_rows(out_buf.reshape(g, e * cap, d), entry_slot)
    vals = torch.where(entry_keep[..., None], vals, 0.0)
    y = (vals.reshape(g, t, k, d) * r.gate_w[..., None].to(xg.dtype)).sum(dim=2)
    if cfg.n_shared:
        y = y + _shared_ffn(w, xg)
    return y


def moe_ffn(w: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x: (T, d) -> (T, d), dispatched per group (``dispatch_groups``)."""
    t, d = x.shape
    return _moe_ffn_grouped(w, _grouped(x, cfg), cfg).reshape(t, d)


def moe_ffn_plain(w: dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The same function by float scatters (the reference's
    ``_moe_baseline_scatter``, ``:169-192``): the kept entries written into
    the (G, E, cap + 1, d) buffer, the experts run, each entry's output
    weighted and scatter-added back to its token."""
    t, d = x.shape
    xg = _grouped(x, cfg)
    g, tg, _ = xg.shape
    e, k = cfg.n_routed, cfg.top_k
    r = route(w, xg, cfg)
    gi = torch.arange(g, device=x.device)[:, None].expand_as(r.dest_e)
    x_entries = _gather_rows(xg, r.src_token)
    buf0 = torch.zeros((g, e, r.cap + 1, d), dtype=xg.dtype, device=x.device)
    buf0[gi, r.dest_e, r.dest_c] = x_entries
    out_buf0 = F.pad(_expert_ffn_grouped(w, buf0[:, :, :r.cap]), (0, 0, 0, 1))
    sw = torch.gather(r.gate_w.reshape(g, tg * k), 1, r.order)
    contrib = out_buf0[gi, r.dest_e, r.dest_c] * sw[..., None].to(xg.dtype)
    contrib = torch.where(r.keep[..., None], contrib, 0.0)
    y = torch.zeros((g, tg, d), dtype=xg.dtype, device=x.device)
    y = y.index_put((gi, r.src_token), contrib, accumulate=True)
    if cfg.n_shared:
        y = y + _shared_ffn(w, xg)
    return y.reshape(t, d)
