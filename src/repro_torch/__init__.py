"""repro_torch: the FCDCC coded distributed convolution system on PyTorch.

A port of the JAX package ``repro`` (kept beside it as the reference) to
PyTorch: coded CNN serving and coded LM decode serving, with the worker
convolution, the transition and worker GEMMs, the CRME coded GEMM and
prefill attention running as hand-written CUDA kernels for Hopper
(``repro_torch.kernels``), and the LM's training path (``launch.train``,
plain PyTorch: no kernel of the reference has a backward).  The package imports torch and numpy only.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; asking for CUDA on a machine without it raises instead of
falling back.
"""
from .devices import resolve_device

__all__ = ["resolve_device"]
