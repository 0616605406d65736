"""PaliGemma-3B: the SigLIP frontend stubbed as 256 prefix patch
embeddings ahead of a gemma-1 2B text backbone (MQA, one kv head)
[arXiv:2407.07726; hf]: the reference's ``configs/paligemma_3b.py``
numbers, family ``"vlm"``."""
from ..models.registry import ModelBundle, make_lm_bundle
from ..models.transformer import LMConfig

ARCH = "paligemma-3b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH,
        layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=257216,
        act="gelu",
        embed_scale=True,
        tie_embeddings=True,
        max_seq=32768,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH + "-smoke",
        layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab=256,
        act="gelu",
        embed_scale=True,
        max_seq=128,
    )


def full_bundle() -> ModelBundle:
    return make_lm_bundle(full(), family="vlm")


def smoke_bundle() -> ModelBundle:
    return make_lm_bundle(smoke(), family="vlm")
