"""DeepSeek-V3 671B: MLA, 1 shared + 256 routed experts, top-8, three
dense-first layers [arXiv:2412.19437; hf]; the MTP head omitted.  The
reference's ``configs/deepseek_v3_671b.py`` numbers.

DeepSeek-V3 publishes a sigmoid router with a bias term; the reference
(and so the port) routes it as DeepSeek-V2, softmax top-k with the gate
weights renormalised over the k."""
from ..models.registry import ModelBundle, make_lm_bundle
from ..models.transformer import LMConfig, MLAConfig, MoEConfig

ARCH = "deepseek-v3-671b"


def full(dispatch_groups: int = 16) -> LMConfig:
    return LMConfig(
        name=ARCH,
        layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=18432,  # dense-first layers (hf); the experts' width is 2048
        vocab=129280,
        attn="mla",
        mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_dim=128),
        moe=MoEConfig(n_routed=256, top_k=8, d_model=7168, d_ff_expert=2048,
                      n_shared=1, dispatch_groups=dispatch_groups),
        n_dense_layers=3,
        tie_embeddings=False,
        max_seq=32768,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH + "-smoke",
        layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        attn="mla",
        mla=MLAConfig(q_lora=32, kv_lora=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
        moe=MoEConfig(n_routed=8, top_k=2, d_model=64, d_ff_expert=32, n_shared=1),
        n_dense_layers=1,
        tie_embeddings=False,
        max_seq=128,
    )


def full_bundle(dispatch_groups: int = 16) -> ModelBundle:
    return make_lm_bundle(full(dispatch_groups))


def smoke_bundle() -> ModelBundle:
    return make_lm_bundle(smoke())
