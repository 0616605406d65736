"""Build, load and bind the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use each
``.cu`` file is compiled by its own ``nvcc`` process (all started together)
for ``sm_90a``, the objects are linked into one shared library, and the
library is loaded with ``ctypes``: pointers and the stream travel as
``c_void_p``, sizes as ``c_longlong``, and every entry point returns the
``cudaGetLastError()`` of its launch.  The build is cached under ``_build/``
next to this file, keyed by a hash of the sources and flags, so a later
process reuses it.  Nothing here runs at import time.
"""
from __future__ import annotations

import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["LaunchCounter", "LaunchTotal", "build_library", "load_library",
           "check_launch", "launch_on", "held_launches", "NUM_SMS",
           "cost_counter", "record_kernel"]

NUM_SMS = 132  # streaming multiprocessors of an H100 SXM: the launch plans fill them

CSRC = Path(__file__).parent / "csrc"
BUILD_ROOT = Path(__file__).parent / "_build"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
# entry point -> argument types (every entry point returns the cudaError_t)
SIGNATURES = {
    # x, w, out, C, H, W, KH, KW, stride, G, B, EB, NB, bn, splits, stream
    "coded_worker_f32": [_P, _P, _P] + [_I] * 12 + [_P],
    # x, w, filter split scratch, out, then as coded_worker_f32
    "coded_worker_tc_f32": [_P] * 4 + [_I] * 12 + [_P],
    # a, b, out, M, N, K, relu, splits, stream
    "matmul_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # code (host), feats, out, R_out, R_in, F, vec, threads, stream
    "coded_gemm_f32": [_P, _P, _P] + [_I] * 5 + [_P],
    # q, k, v, out, BH, Sq, Sk, D, rep, scale, causal, bf16, heads, rows,
    # warps, stream
    "flash_attn": [_P] * 4 + [_I] * 5 + [_F] + [_I] * 5 + [_P],
    # the same arguments, with the 3xTF32 kernel's K/V scratch after out
    "flash_attn_tiled": [_P] * 5 + [_I] * 5 + [_F] + [_I] * 5 + [_P],
}


# per thread: the launches a CUDA-graph capture in progress records into
# its graph (None outside a capture)
_capture = threading.local()


class held_launches:
    """Context manager around a CUDA-graph capture on this thread: a
    wrapper called inside it records its launch into the graph, not onto
    the card, so ``LaunchCounter.add`` tallies it in the dict this returns
    (counter -> launches the graph holds) instead of the count.  The
    graph's owner adds the tally to the counts at every replay."""

    def __enter__(self) -> dict:
        self._prev = getattr(_capture, "held", None)
        _capture.held = {}
        return _capture.held

    def __exit__(self, *exc) -> None:
        _capture.held = self._prev


class LaunchCounter:
    """Thread-safe count of one kernel's launches (worker threads launch
    concurrently).  A wrapper adds one where it launches its kernel, and
    nowhere else — a run reads it to prove the path went through the
    kernel.  A launch recorded into a CUDA graph (``held_launches``)
    counts once per replay of that graph, when the graph's owner replays
    it."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0  # guarded-by: self._lock

    def add(self, k: int = 1) -> None:
        held = getattr(_capture, "held", None)
        if held is not None:
            held[self] = held.get(self, 0) + k
            return
        with self._lock:
            self._count += k

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def reset(self) -> None:
        with self._lock:
            self._count = 0


class LaunchTotal:
    """One wrapper's launches over the several kernels it may launch, read
    and reset as one ``LaunchCounter``: the sum of the kernels' own
    counters, which the wrapper adds to."""

    def __init__(self, name: str, parts):
        self.name = name
        self.parts = tuple(parts)

    @property
    def count(self) -> int:
        return sum(c.count for c in self.parts)

    def reset(self) -> None:
        for c in self.parts:
            c.reset()


# the cost counter of the block being counted (``launch.cost_analysis``'s
# ``CostCounter`` sets it for its block), None outside one
cost_counter: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_cost", default=None)


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """Charge the active cost counter (if any) with one launch of the
    hand-written kernel ``name`` that a wrapper stands in for (on meta
    operands, where nothing launches): ``flops`` (counted as product
    FLOPs) and ``nbytes`` of HBM traffic.  Its ``LaunchCounter`` does not
    move."""
    counter = cost_counter.get()
    if counter is not None:
        counter.charge(name, flops, nbytes)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels under " + str(CSRC))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> tuple[Path, str]:
    """Compile and link the kernels (or find the cached build).  Returns
    ``(library path, compiler log)``; raises with the log on failure."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        sources = sorted(CSRC.glob("*.cu"))
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for s, o in zip(sources, objs)
        ]
        logs, failed = [], []
        for s, p in zip(sources, procs):
            text, _ = p.communicate()
            logs.append(f"== {s.name}\n{text}")
            if p.returncode != 0:
                failed.append(s.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed:\n{link.stdout}")
        log_path.write_text(log)
        os.replace(tmp_lib, lib)  # atomic: a concurrent builder sees all or none
    return lib, log


_load_lock = threading.Lock()
_library: ctypes.CDLL | None = None  # guarded-by: _load_lock


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, then reused by every
    thread of the process)."""
    global _library
    lib = _library  # set once, never reset: a plain read is enough after that
    if lib is not None:
        return lib
    with _load_lock:
        if _library is None:
            path, _ = build_library()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _library = lib
        return _library


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {rc}")


def launch_on(name: str, t: torch.Tensor, fn, *args) -> None:
    """Call the entry point ``fn(*args, stream)`` on ``t``'s device and the
    calling thread's current stream there — per thread, so a worker thread
    inside ``torch.cuda.stream(s)`` launches on ``s`` — and raise if the
    launch failed.  The stream is read as its raw handle (building a
    ``torch.cuda.Stream`` object costs microseconds a call), and the device
    is switched only when it is not already current."""
    index = t.get_device()
    if index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check_launch(name, rc)
