"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and
their plain PyTorch versions.

  * K1 ``conv2d.coded_worker`` — a worker's coded subtask as one
    implicit-GEMM convolution (replaces ``coded_worker_pallas``);
  * K2 ``matmul.matmul`` — the fp32 GEMM with a ReLU epilogue under both
    GEMMs of the fused transition (replaces ``matmul_pallas``).
"""
