"""Static analysis for the port's coded serving stack (the counterpart of
``repro.analysis``).

Two analyzer families:

- ``contracts``: enumerates every program cell the pipeline family can
  build (CNN archs x buckets x backends x transition fusing, and the coded
  LM decoder) and checks the reference's jit contracts on each one, run
  once under a dispatch recorder (``dispatch_tools``) — no constants held
  in place of coding-matrix arguments, no f64, float32 outputs, no host
  syncs, and a static proof of the bounded-program contract; on CUDA each
  cell is also captured into a CUDA graph and its replay held against an
  eager call.
- ``concurrency``: an AST lint over the threaded layers (``serving/``,
  ``runtime/``, ``kernels/native.py``) — ``# guarded-by:`` enforcement,
  lock-acquisition-order cycles, ``Condition.wait`` predicate loops, and
  thread/executor lifecycle.

CLI: ``python -m repro_torch.analysis --strict`` (see ``__main__``).
"""

from .findings import Finding, Report, Severity

__all__ = ["Finding", "Report", "Severity"]
