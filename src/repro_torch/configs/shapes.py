"""The assigned input shapes and their meta-tensor stand-ins: the
reference's ``configs/shapes.py``.

Every (arch x shape) cell resolves to a step kind:
  train_4k    -> train step   (loss, gradients and the optimizer update)
  prefill_32k -> prefill step (full-sequence logits)
  decode_32k  -> serve step   (one new token against a seq_len KV cache)
  long_500k   -> serve step   (batch 1, 512k context; sub-quadratic archs
                               only)

The stand-ins are meta tensors (shape and dtype, no storage), the
counterpart of ``jax.ShapeDtypeStruct``: a cell's batch and cache are
built with no allocation, at any size.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SHAPES", "Cell", "token_struct", "batch_structs"]

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str

    @property
    def kind(self):
        return SHAPES[self.shape]["kind"]


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def token_struct(b: int, s: int) -> torch.Tensor:
    return _struct((b, s), torch.int32)


def batch_structs(bundle, shape_name: str, *, smoke_scale: int | None = None):
    """Meta-tensor stand-ins for every model input of this cell:
    ``(batch dict, cache tree or None)``.  The stub frontend embeddings
    (Whisper's frames, PaliGemma's prefix) and the cache are bf16, as the
    reference's dry run builds them.  No allocation."""
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    if smoke_scale:
        b, s = max(b // smoke_scale, 2), max(s // smoke_scale, 16)
    kind = sh["kind"]
    cfg = bundle.cfg

    extras = {}
    if bundle.family == "encdec":
        extras["frames"] = _struct((b, cfg.enc_len, cfg.d_model), torch.bfloat16)
    if bundle.family == "vlm":
        extras["prefix"] = _struct((b, 256, cfg.d_model), torch.bfloat16)

    if kind == "train":
        return {"tokens": token_struct(b, s), "labels": token_struct(b, s),
                **extras}, None
    if kind == "prefill":
        return {"tokens": token_struct(b, s), **extras}, None
    # decode: one new token against an s-long cache or state
    batch = {"tokens": token_struct(b, 1), "pos": _struct((), torch.int32)}
    return batch, bundle.make_cache(b, s, torch.bfloat16, META)
