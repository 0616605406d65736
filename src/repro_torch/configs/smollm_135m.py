"""SmolLM-135M, llama-arch small [hf:HuggingFaceTB/SmolLM-135M]: the
reference's ``configs/smollm_135m.py`` numbers, as the port's
``LMConfig`` (``full`` / ``smoke``) and as the bundles the reference's
constructors return (``full_bundle`` / ``smoke_bundle``)."""
from ..models.registry import ModelBundle, make_lm_bundle
from ..models.transformer import LMConfig

ARCH = "smollm-135m"


def full() -> LMConfig:
    return LMConfig(
        name=ARCH,
        layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        head_dim=64,
        d_ff=1536,
        vocab=49152,
        tie_embeddings=True,
        max_seq=32768,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH + "-smoke",
        layers=2,
        d_model=48,
        n_heads=3,
        n_kv_heads=1,
        head_dim=16,
        d_ff=96,
        vocab=256,
        max_seq=128,
    )


def full_bundle() -> ModelBundle:
    return make_lm_bundle(full())


def smoke_bundle() -> ModelBundle:
    return make_lm_bundle(smoke())
