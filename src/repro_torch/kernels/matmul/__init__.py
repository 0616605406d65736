from .kernel import matmul, matmul_plain

__all__ = ["matmul", "matmul_plain"]
