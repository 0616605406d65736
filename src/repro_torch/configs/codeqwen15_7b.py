"""CodeQwen1.5-7B: dense MHA (kv heads == heads), untied head
[hf:Qwen/CodeQwen1.5-7B]: the reference's ``configs/codeqwen15_7b.py``
numbers."""
from ..models.registry import ModelBundle, make_lm_bundle
from ..models.transformer import LMConfig

ARCH = "codeqwen1.5-7b"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH,
        layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab=92416,
        tie_embeddings=False,
        rope_base=1000000.0,
        max_seq=65536,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH + "-smoke",
        layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        tie_embeddings=False,
        max_seq=128,
    )


def full_bundle() -> ModelBundle:
    return make_lm_bundle(full())


def smoke_bundle() -> ModelBundle:
    return make_lm_bundle(smoke())
