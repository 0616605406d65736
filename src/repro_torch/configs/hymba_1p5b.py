"""Hymba-1.5B: parallel attention and Mamba heads [arXiv:2411.13676; hf]:
the reference's ``configs/hymba_1p5b.py`` numbers.  Sub-quadratic: windowed
attention and an O(1) SSM state."""
from ..models.hymba import HymbaConfig
from ..models.registry import ModelBundle, make_hymba_bundle

ARCH = "hymba-1.5b"


def full() -> HymbaConfig:
    return HymbaConfig(
        name=ARCH,
        layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab=32001,
        ssm_state=16,
        window=1024,
    )


def smoke() -> HymbaConfig:
    return HymbaConfig(
        name=ARCH + "-smoke",
        layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        ssm_state=8,
        window=16,
        chunk=8,
    )


def full_bundle() -> ModelBundle:
    return make_hymba_bundle(full())


def smoke_bundle() -> ModelBundle:
    return make_hymba_bundle(smoke())
