"""DeepSeek-V2 236B: MLA (kv_lora 512), 2 shared + 160 routed experts,
top-6, one dense-first layer [arXiv:2405.04434; hf]: the reference's
``configs/deepseek_v2_236b.py`` numbers.

The router is the reference's, softmax top-k with the gate weights
renormalised over the k, as DeepSeek-V2 publishes it."""
from ..models.registry import ModelBundle, make_lm_bundle
from ..models.transformer import LMConfig, MLAConfig, MoEConfig

ARCH = "deepseek-v2-236b"


def full(dispatch_groups: int = 16) -> LMConfig:
    return LMConfig(
        name=ARCH,
        layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=12288,  # dense-first layer width (hf); experts use 1536
        vocab=102400,
        attn="mla",
        mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_dim=128),
        moe=MoEConfig(n_routed=160, top_k=6, d_model=5120, d_ff_expert=1536,
                      n_shared=2, dispatch_groups=dispatch_groups),
        n_dense_layers=1,
        tie_embeddings=False,
        max_seq=32768,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name=ARCH + "-smoke",
        layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        attn="mla",
        mla=MLAConfig(q_lora=0, kv_lora=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
        moe=MoEConfig(n_routed=8, top_k=2, d_model=64, d_ff_expert=32, n_shared=2),
        n_dense_layers=1,
        tie_embeddings=False,
        max_seq=128,
    )


def full_bundle(dispatch_groups: int = 16) -> ModelBundle:
    return make_lm_bundle(full(dispatch_groups))


def smoke_bundle() -> ModelBundle:
    return make_lm_bundle(smoke())
