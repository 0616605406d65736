"""repro_torch: the FCDCC coded distributed convolution system on PyTorch.

A port of the JAX package ``repro`` (kept beside it as the reference) to
PyTorch, with the worker convolution and the transition GEMMs running as
hand-written CUDA kernels for Hopper (``repro_torch.kernels``).  The
package imports torch and numpy only.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; asking for CUDA on a machine without it raises instead of
falling back.
"""
from .devices import resolve_device

__all__ = ["resolve_device"]
