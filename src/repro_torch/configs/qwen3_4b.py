"""Qwen3-4B: GQA with per-head qk-norm [hf:Qwen/Qwen3-4B family]: the
reference's ``configs/qwen3_4b.py`` numbers."""
from ..models.registry import ModelBundle, make_lm_bundle
from ..models.transformer import LMConfig

ARCH = "qwen3-4b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH,
        layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab=151936,
        qk_norm=True,
        tie_embeddings=True,
        rope_base=1000000.0,
        max_seq=32768,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH + "-smoke",
        layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        qk_norm=True,
        max_seq=128,
    )


def full_bundle() -> ModelBundle:
    return make_lm_bundle(full())


def smoke_bundle() -> ModelBundle:
    return make_lm_bundle(smoke())
