"""A uniform ``ModelBundle`` over the port's model families: the LM half
of the reference's ``models/registry.py`` (``make_lm_bundle``, family
``"lm"``, and ``"vlm"`` with stub prefix embeddings in the batch).

A bundle gives the launchers what they need: init, the training loss,
the prefill, the decode step, the cache and its cache-filling prefill.
The reference's ``schema`` and its batch and cache sharding axes are
sharding data; they wait for the port's sharding slice (ROADMAP Queue A
11), as do the other families' bundles (rwkv6, hymba, whisper).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from . import transformer as lm

__all__ = ["ModelBundle", "make_lm_bundle", "with_layers"]


@dataclasses.dataclass
class ModelBundle:
    name: str
    family: str  # "lm" | "vlm"
    cfg: Any
    sub_quadratic: bool
    has_decoder: bool
    loss_fn: Callable  # (params, batch) -> scalar
    prefill_fn: Callable  # (params, batch) -> logits
    decode_fn: Callable  # (params, cache, batch) -> (logits, cache)
    make_cache: Callable  # (batch, max_len, dtype, device) -> cache tree
    # (params, cache, batch) -> (logits (B, P, V), filled cache): one
    # cache-filling prompt pass
    prefill_cache_fn: Optional[Callable] = None

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32,
             device: str | torch.device = "cuda") -> dict:
        """Random params drawn from ``generator`` leaf by leaf on the
        generator's device, in ``dtype`` on ``device``."""
        return lm.init_lm(self.cfg, generator, device, dtype)


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
        name=cfg.name, family=family, cfg=cfg, sub_quadratic=cfg.sub_quadratic,
        has_decoder=True, loss_fn=loss_fn, prefill_fn=prefill_fn,
        decode_fn=decode_fn, make_cache=make_cache,
        prefill_cache_fn=prefill_cache_fn,
    )


def with_layers(bundle: ModelBundle, layers: int) -> ModelBundle:
    """``bundle`` cut to its first ``layers`` layers (a config's
    dense-first layers come first): the same widths at less depth."""
    if not 1 <= layers <= bundle.cfg.layers:
        raise ValueError(f"{bundle.name} has {bundle.cfg.layers} layers, "
                         f"asked for {layers}")
    return make_lm_bundle(dataclasses.replace(bundle.cfg, layers=layers),
                          bundle.family)
