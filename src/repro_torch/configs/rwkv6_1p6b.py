"""RWKV6-1.6B "Finch": attention-free, data-dependent decay
[arXiv:2404.05892]: the reference's ``configs/rwkv6_1p6b.py`` numbers.
An O(1) recurrent state."""
from ..models.registry import ModelBundle, make_rwkv_bundle
from ..models.rwkv6 import RwkvConfig

ARCH = "rwkv6-1.6b"


def full() -> RwkvConfig:
    return RwkvConfig(
        name=ARCH,
        layers=24,
        d_model=2048,
        d_ff=7168,
        vocab=65536,
        head_dim=64,
    )


def smoke() -> RwkvConfig:
    return RwkvConfig(
        name=ARCH + "-smoke",
        layers=2,
        d_model=64,
        d_ff=128,
        vocab=256,
        head_dim=16,
        decay_lora=8,
        chunk=8,
    )


def full_bundle() -> ModelBundle:
    return make_rwkv_bundle(full())


def smoke_bundle() -> ModelBundle:
    return make_rwkv_bundle(smoke())
