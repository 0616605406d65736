from .kernel import HEAD_DIMS, flash_attention, flash_attention_plain

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_plain"]
