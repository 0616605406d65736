"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers and
their plain PyTorch versions.

  * K1 ``conv2d.coded_worker`` — a worker's coded subtask as one
    implicit-GEMM convolution (replaces ``coded_worker_pallas``);
  * K2 ``matmul.matmul`` — the fp32 GEMM with a ReLU epilogue under both
    GEMMs of the fused transition and the coded LM worker GEMM (replaces
    ``matmul_pallas``);
  * K3 ``coded_gemm.coded_gemm`` — the CRME code-matrix GEMM under the
    coded LM weight encode and survivor decode (replaces
    ``coded_gemm_pallas_legacy`` / ``coded_gemm_pallas``);
  * K4 ``flash_attn.flash_attention`` — causal online-softmax attention
    under the LM prefill (replaces ``flash_attention_pallas``).
"""
