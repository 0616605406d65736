from .kernel import coded_gemm, coded_gemm_plain
from .ops import crme_decode, crme_encode

__all__ = ["coded_gemm", "coded_gemm_plain", "crme_encode", "crme_decode"]
