"""Whisper-medium backbone: encoder-decoder, the conv frontend stubbed
[arXiv:2212.04356]: the reference's ``configs/whisper_medium.py``
numbers."""
from ..models.registry import ModelBundle, make_whisper_bundle
from ..models.whisper import WhisperConfig

ARCH = "whisper-medium"


def full() -> WhisperConfig:
    return WhisperConfig(
        name=ARCH,
        enc_layers=24,
        dec_layers=24,
        d_model=1024,
        n_heads=16,
        d_ff=4096,
        vocab=51865,
        enc_len=1500,
        max_dec_len=32768,
    )


def smoke() -> WhisperConfig:
    return WhisperConfig(
        name=ARCH + "-smoke",
        enc_layers=2,
        dec_layers=2,
        d_model=64,
        n_heads=4,
        d_ff=128,
        vocab=256,
        enc_len=12,
        max_dec_len=64,
    )


def full_bundle() -> ModelBundle:
    return make_whisper_bundle(full())


def smoke_bundle() -> ModelBundle:
    return make_whisper_bundle(smoke())
