"""A uniform ``ModelBundle`` over every model family of the reference's
``models/registry.py``: the transformer (``make_lm_bundle``, family
``"lm"``, and ``"vlm"`` with stub prefix embeddings in the batch), RWKV6
(``"ssm"``), Hymba (``"hybrid"``) and Whisper (``"encdec"``, with stub
frame embeddings in the batch).

A bundle gives the launchers what they need: the params' schema (their
shapes, logical axes and init), the training loss, the prefill, the
decode step, the cache and, for the transformer, its cache-filling
prefill (the other families have none: the serve loop steps the decoder
over the prompt), and the logical sharding axes of a batch's and a
cache's leaves (``cache_axes`` / ``batch_axes``, resolved on a mesh by
``launch.steps.batch_pspecs`` / ``cache_pspecs``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from . import hymba as hymba_mod
from . import rwkv6 as rwkv_mod
from . import transformer as lm
from . import whisper as whisper_mod
from ..devices import resolve_device
from ..sharding import (BATCH, baseline, batch_ranks, held_sequence,
                        model_ranks, resolve_pspec, spec_axes)
from ..tree import tree_map
from .common import schema_init, schema_shapes

__all__ = ["ModelBundle", "make_lm_bundle", "make_rwkv_bundle",
           "make_hymba_bundle", "make_whisper_bundle", "with_layers",
           "rank_cache"]


@dataclasses.dataclass
class ModelBundle:
    name: str
    family: str  # "lm" | "vlm" | "ssm" | "hybrid" | "encdec"
    cfg: Any
    schema: dict  # the params tree with ParamSpec leaves
    sub_quadratic: bool
    has_decoder: bool
    loss_fn: Callable  # (params, batch) -> scalar
    prefill_fn: Callable  # (params, batch) -> logits
    decode_fn: Callable  # (params, cache, batch) -> (logits, cache)
    make_cache: Callable  # (batch, max_len, dtype, device) -> cache tree
    cache_axes: Callable  # (cache tree) -> the same tree of axes tuples
    batch_axes: Callable  # (batch dict) -> the same dict of axes tuples
    # (params, cache, batch) -> (logits (B, P, V), filled cache): one
    # cache-filling prompt pass; None for a family without one (the serve
    # loop steps decode_fn over the prompt)
    prefill_cache_fn: Optional[Callable] = None

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32,
             device: str | torch.device = "cuda",
             shardings: dict | None = None) -> dict:
        """Random params of ``schema`` drawn from ``generator`` leaf by leaf
        on the generator's device, in ``dtype`` on ``device``; with
        ``shardings`` each leaf cut to this rank's shard as it is drawn."""
        return schema_init(self.schema, generator, device, dtype, shardings)

    def param_shapes(self, dtype: torch.dtype = torch.float32) -> dict:
        """The params as meta tensors: shapes and ``dtype``, no storage."""
        return schema_shapes(self.schema, dtype)


def _token_batch_axes(batch: dict) -> dict:
    """Tokens and labels: the batch over (pod, data), the sequence
    replicated, or over data where the batch is 1; a scalar (the decode
    position) replicated."""
    out = {}
    for k, v in batch.items():
        if v.ndim == 0:
            out[k] = ()
        elif v.ndim >= 2 and v.shape[0] == 1:
            out[k] = (None, "data") + (None,) * (v.ndim - 2)
        else:
            out[k] = (BATCH,) + (None,) * (v.ndim - 1)
    return out


def _kv_cache_axes(tree: dict) -> dict:
    """(L, B, S, H, hd) K/V leaves: the batch over (pod, data); heads and
    head dim over model where the KV heads divide the production model
    degree (16), else the sequence over model (over data and model at
    batch 1).  MLA's (L, B, S, dim) latents: the sequence so.  Under the
    reference's ``REPRO_BASELINE=1`` every K/V leaf takes heads and head
    dim over model (``resolve_pspec``: the heads where they divide, else
    the head dim) and every latent its width, the sequence over data at
    batch 1 (``transformer.cache_layout``)."""
    base = baseline()

    def one(x):
        bat = BATCH if x.shape[1] > 1 else None
        seq = ("data", "model") if x.shape[1] == 1 else "model"
        held = "data" if x.shape[1] == 1 else None
        if x.ndim == 5:
            if base or x.shape[3] % 16 == 0:
                return (None, bat, held, "model", "model")
            return (None, bat, seq, None, None)
        if x.ndim == 4:
            if base:
                return (None, bat, held, "model")
            return (None, bat, seq, None)
        if x.ndim == 3:
            return (None, bat, "model")
        return (None,) * x.ndim

    return tree_map(one, tree)


def rank_cache(make: Callable, cache_axes: Callable) -> Callable:
    """A bundle's ``make_cache`` from its family's ``make(b, s, dtype,
    device)`` (the whole cache of ``b`` rows) and ``cache_axes``: as
    ``make`` with no model ranks; over model ranks, this rank's cut of the
    cache of every data rank's rows (``b`` this rank's; under a held
    sequence the one row every rank holds), each leaf cut as
    ``cache_axes`` places it on the mesh (``steps.cache_pspecs``): zeros
    of the cut's shape, a leaf the reference replicates whole.  A leaf
    whose sequence ``cache_axes`` places over ``data`` at batch 1 is cut
    over it as over ``model`` (the reference's ``_kv_cache_axes``)."""
    def make_cache(b, s, dtype=torch.float32, device="cuda"):
        tp = model_ranks()
        if tp is None:
            return make(b, s, dtype, device)
        rows = 1 if held_sequence() else batch_ranks()
        full = make(b * rows, s, dtype, "meta")
        dev = resolve_device(device)
        sizes = tp.mesh.shape

        def cut(leaf, axes):
            spec = resolve_pspec(leaf.shape, axes, sizes)
            shape = [n // math.prod(sizes[a] for a in spec_axes(e))
                     for n, e in zip(leaf.shape, spec)]
            return torch.zeros(shape, dtype=leaf.dtype, device=dev)

        return tree_map(cut, full, cache_axes(full))

    return make_cache


def make_lm_bundle(cfg: lm.LMConfig, family: str = "lm") -> ModelBundle:
    """The transformer (dense GQA, MLA, MoE) as a bundle.  A ``"vlm"`` batch may carry
    ``"prefix"`` (B, P, d_model) embeddings ahead of its tokens (the
    reference's PaliGemma stubs its image frontend so)."""
    if family not in ("lm", "vlm"):
        raise ValueError(f"family {family!r}: the port's LM bundles are "
                         f"'lm' or 'vlm'")

    def loss_fn(params, batch):
        return lm.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                          batch.get("prefix"))

    def prefill_fn(params, batch):
        return lm.forward(params, cfg, batch["tokens"], batch.get("prefix"))

    def decode_fn(params, cache, batch):
        return lm.decode_step(params, cfg, cache, batch["tokens"], batch["pos"])

    def prefill_cache_fn(params, cache, batch):
        return lm.prefill(params, cfg, cache, batch["tokens"])

    def make_cache(b, s, dtype=torch.float32, device="cuda"):
        return lm.init_cache(cfg, b, s, dtype, device)

    return ModelBundle(
        name=cfg.name, family=family, cfg=cfg, schema=lm.lm_schema(cfg),
        sub_quadratic=cfg.sub_quadratic,
        has_decoder=True, loss_fn=loss_fn, prefill_fn=prefill_fn,
        decode_fn=decode_fn, make_cache=make_cache,
        cache_axes=_kv_cache_axes, batch_axes=_token_batch_axes,
        prefill_cache_fn=prefill_cache_fn,
    )


def make_rwkv_bundle(cfg: rwkv_mod.RwkvConfig) -> ModelBundle:
    """RWKV6: an O(1) recurrent state for its cache."""
    def make(b, s, dtype=torch.float32, device="cuda"):
        del s  # the state does not grow with the sequence
        return rwkv_mod.init_state(cfg, b, dtype, device)

    def cache_axes(tree):
        return tree_map(lambda x: (None, BATCH if x.shape[1] > 1 else None,
                                   "model") + (None,) * (x.ndim - 3), tree)

    return ModelBundle(
        name=cfg.name, family="ssm", cfg=cfg, schema=rwkv_mod.rwkv_schema(cfg),
        sub_quadratic=True, has_decoder=True,
        loss_fn=lambda p, b: rwkv_mod.lm_loss(p, cfg, b["tokens"], b["labels"]),
        prefill_fn=lambda p, b: rwkv_mod.forward(p, cfg, b["tokens"]),
        decode_fn=lambda p, c, b: rwkv_mod.decode_step(p, cfg, c, b["tokens"],
                                                       b["pos"]),
        make_cache=rank_cache(make, cache_axes), cache_axes=cache_axes,
        batch_axes=_token_batch_axes,
    )


def make_hymba_bundle(cfg: hymba_mod.HymbaConfig) -> ModelBundle:
    """Hymba: a windowed KV ring plus the SSM state for its cache."""
    def make(b, s, dtype=torch.float32, device="cuda"):
        return hymba_mod.init_state(cfg, b, s, dtype, device)

    def cache_axes(tree):
        def one(x):
            bat = BATCH if x.shape[1] > 1 else None
            if x.ndim == 5 and x.shape[-1] == cfg.head_dim and \
                    x.shape[-2] != cfg.ssm_state:  # the KV ring
                return (None, bat, None, "model", "model")
            if x.ndim == 5:  # the SSM state (L, B, Hm, ns, hd)
                return (None, bat, "model", None, "model")
            return (None,) * x.ndim

        return tree_map(one, tree)

    return ModelBundle(
        name=cfg.name, family="hybrid", cfg=cfg,
        schema=hymba_mod.hymba_schema(cfg), sub_quadratic=True, has_decoder=True,
        loss_fn=lambda p, b: hymba_mod.lm_loss(p, cfg, b["tokens"], b["labels"]),
        prefill_fn=lambda p, b: hymba_mod.forward(p, cfg, b["tokens"]),
        decode_fn=lambda p, c, b: hymba_mod.decode_step(p, cfg, c, b["tokens"],
                                                        b["pos"]),
        make_cache=rank_cache(make, cache_axes), cache_axes=cache_axes,
        batch_axes=_token_batch_axes,
    )


def make_whisper_bundle(cfg: whisper_mod.WhisperConfig) -> ModelBundle:
    """Whisper: a batch carries ``"frames"`` (B, enc_len, d_model) stub
    embeddings for the encoder; the decode cache's cross K/V are zeros
    until ``whisper.precompute_cross_kv`` fills them."""
    def loss_fn(params, batch):
        return whisper_mod.lm_loss(params, cfg, batch["frames"], batch["tokens"],
                                   batch["labels"])

    def prefill_fn(params, batch):
        return whisper_mod.forward(params, cfg, batch["frames"], batch["tokens"])

    def decode_fn(params, cache, batch):
        return whisper_mod.decode_step(params, cfg, cache, batch["tokens"],
                                       batch["pos"])

    def cache_axes(tree):
        return tree_map(lambda x: (None, BATCH if x.shape[1] > 1 else None,
                                   "model", None, None), tree)

    cut = rank_cache(lambda b, s, dtype, device: whisper_mod.init_cache(
        cfg, b, s, dtype, device), cache_axes)

    def make_cache(b, s, dtype=torch.float32, device="cuda"):
        cache = cut(b, s, dtype, device)
        tp = model_ranks()
        if tp is not None:  # decode_step reads the self cache as they say
            for key in ("k", "v"):
                cache[key].seq_axes = () if s % tp.size else ("model",)
        return cache

    return ModelBundle(
        name=cfg.name, family="encdec", cfg=cfg,
        schema=whisper_mod.whisper_schema(cfg), sub_quadratic=False,
        has_decoder=True, loss_fn=loss_fn, prefill_fn=prefill_fn,
        decode_fn=decode_fn, make_cache=make_cache, cache_axes=cache_axes,
        batch_axes=_token_batch_axes,
    )


_MAKERS = {"ssm": make_rwkv_bundle, "hybrid": make_hymba_bundle,
           "encdec": make_whisper_bundle}


def with_layers(bundle: ModelBundle, layers: int) -> ModelBundle:
    """``bundle`` cut to its first ``layers`` layers (a config's
    dense-first layers come first): the same widths at less depth.  For
    Whisper ``layers`` cuts the encoder and the decoder alike."""
    cfg = bundle.cfg
    if bundle.family == "encdec":
        for name, have in (("encoder", cfg.enc_layers), ("decoder", cfg.dec_layers)):
            if not 1 <= layers <= have:
                raise ValueError(f"{bundle.name}'s {name} has {have} layers, "
                                 f"asked for {layers}")
        return make_whisper_bundle(dataclasses.replace(
            cfg, enc_layers=layers, dec_layers=layers))
    if not 1 <= layers <= cfg.layers:
        raise ValueError(f"{bundle.name} has {cfg.layers} layers, "
                         f"asked for {layers}")
    cut = dataclasses.replace(cfg, layers=layers)
    if bundle.family in _MAKERS:
        return _MAKERS[bundle.family](cut)
    return make_lm_bundle(cut, bundle.family)
