from .kernel import flash_attention, flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain"]
