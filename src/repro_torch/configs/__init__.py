"""Architecture registry: ``--arch <id>`` resolution for the launchers.

``ARCH_IDS`` holds the archs the port has.  The reference's other ids
(its ``configs/__init__.py``) need model families or attention variants
the port does not have yet and raise ``NotImplementedError``."""
from importlib import import_module

__all__ = ["ARCH_IDS", "get_bundle"]

_MODULES = {
    "smollm-135m": "smollm_135m",
}

ARCH_IDS = list(_MODULES)

# the reference's arch ids without a port
_NOT_PORTED = ("deepseek-v3-671b", "deepseek-v2-236b", "codeqwen1.5-7b",
               "gemma2-9b", "qwen3-4b", "hymba-1.5b", "whisper-medium",
               "rwkv6-1.6b", "paligemma-3b")


def get_bundle(arch: str, *, smoke: bool = False):
    """The ``ModelBundle`` of ``arch``: its smoke config or its full one."""
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP Queue A 11); the "
            f"port has {ARCH_IDS}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    mod = import_module(f"{__name__}.{_MODULES[arch]}")
    return mod.smoke_bundle() if smoke else mod.full_bundle()
