from .kernel import coded_worker_plain
from .ops import coded_transition, coded_worker, conv2d_im2col

__all__ = ["coded_worker", "coded_worker_plain", "coded_transition",
           "conv2d_im2col"]
