"""Gemma2-9B: alternating local/global windows, attention and logit
softcaps, sandwich norms, scaled embeddings [arXiv:2408.00118; hf]: the
reference's ``configs/gemma2_9b.py`` numbers."""
from ..models.registry import ModelBundle, make_lm_bundle
from ..models.transformer import LMConfig

ARCH = "gemma2-9b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH,
        layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab=256000,
        act="gelu",
        attn_softcap=50.0,
        logit_softcap=30.0,
        window=4096,
        window_pattern="alternate",
        sandwich_norms=True,
        embed_scale=True,
        tie_embeddings=True,
        max_seq=32768,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH + "-smoke",
        layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        act="gelu",
        attn_softcap=50.0,
        logit_softcap=30.0,
        window=16,
        window_pattern="alternate",
        sandwich_norms=True,
        embed_scale=True,
        max_seq=128,
    )


def full_bundle() -> ModelBundle:
    return make_lm_bundle(full())


def smoke_bundle() -> ModelBundle:
    return make_lm_bundle(smoke())
