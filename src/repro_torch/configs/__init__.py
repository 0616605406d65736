"""Architecture registry: ``--arch <id>`` resolution for the launchers.

``ARCH_IDS`` holds every arch id of the reference, in its order (its
``configs/__init__.py``): the transformer archs, RWKV6, Hymba and
Whisper."""
from importlib import import_module

__all__ = ["ARCH_IDS", "get_bundle"]

_MODULES = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "smollm-135m": "smollm_135m",
    "gemma2-9b": "gemma2_9b",
    "qwen3-4b": "qwen3_4b",
    "hymba-1.5b": "hymba_1p5b",
    "whisper-medium": "whisper_medium",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "paligemma-3b": "paligemma_3b",
}

ARCH_IDS = list(_MODULES)


def get_bundle(arch: str, *, smoke: bool = False, **kw):
    """The ``ModelBundle`` of ``arch``: its smoke config, or its full one
    built with ``kw`` (DeepSeek's ``dispatch_groups``), as the reference's
    ``get_bundle``."""
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    mod = import_module(f"{__name__}.{_MODULES[arch]}")
    return mod.smoke_bundle() if smoke else mod.full_bundle(**kw)
