"""Kernel autotuner: per-cell launch-plan sweeps with a persistent ledger
(the reference's ``kernels/autotune.py`` for K1 and K2).

The coded hot path runs two kernels whose best launch depends on the
(geometry, batch-bucket) cell: K1, the worker's implicit-GEMM convolution
(``conv2d.coded_worker``: its route, tensor-core or FFMA kernel, N-tile
and K split, a ``WorkerPlan``), and
K2, the transition GEMMs (``matmul.matmul``: the column kernel or the
split kernel with 1-8 K slices, a ``MatmulPlan``).  Their heuristics
(``worker_plan``, ``matmul_plan``) pick from the shape alone.  This module
times a bounded candidate set per cell on the card, the heuristic's own
plan always among them, and records the winner in a JSON ledger keyed by
``kind/device tag/shape``; the wrappers consult it at every launch
(``conv2d.kernel.choose_worker_plan``, ``matmul.kernel.choose_matmul_plan``).

Contract with the bounded-program guarantee: **lookups never sweep**.  A
sweep runs only through the explicit ``tune_*`` entry points (called by
``CodedPipeline.autotune_kernels``); a miss at launch returns None and the
wrapper takes its heuristic's plan.  A lookup is a dictionary read, so it
may run inside a CUDA-graph capture, and a plan is a launch argument: a
tuned program is the same one capture per (geometry, bucket) an untuned
one is.

The device tag is ``cuda/sm_<major><minor>`` (``cuda/sm_90`` on an H100),
``cpu`` off the card, where the reference's keys carry their
``interpret`` flag.  The ledger lives at ``results/autotune_cache_torch.json``
in the checkout by default (machine local, git-ignored); override it with
``REPRO_AUTOTUNE_CACHE`` or the ``path`` arguments.
"""
from __future__ import annotations

import json
import os
import threading

import torch

__all__ = [
    "cache_path", "clear_cache", "load_cache", "save_cache", "sweep_count",
    "device_tag", "matmul_key", "worker_key", "matmul_params",
    "worker_params", "worker_candidates", "matmul_candidates",
    "tune_matmul", "tune_worker",
]

_LOCK = threading.RLock()
# key -> {"params": {...}, "us": float, "swept": [...]}  # guarded-by: _LOCK
_CACHE: dict | None = None
# how many real sweeps ran (tests assert cache hits skip them)  # guarded-by: _LOCK
_SWEEPS = 0
# device index -> tag; filled once a device, read at every launch
_TAGS: dict = {}

_ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..",
                                      ".."))
# stream hold before each timed launch (about 0.5 ms on an H100), so the
# events bracket the kernel and not the host's issue of it
_HOLD_CYCLES = 1_000_000


def cache_path() -> str:
    return os.environ.get(
        "REPRO_AUTOTUNE_CACHE",
        os.path.join(_ROOT, "results", "autotune_cache_torch.json"))


def device_tag(device=None) -> str:
    """``cuda/sm_<major><minor>`` of a CUDA device (the current one where
    ``device`` is ``"cuda"`` or None and a card is present), else ``cpu``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if dev.index is None else dev.index
    tag = _TAGS.get(index)
    if tag is None:
        major, minor = torch.cuda.get_device_capability(index)
        tag = _TAGS[index] = f"cuda/sm_{major}{minor}"
    return tag


def matmul_key(m: int, k: int, n: int, *, relu: bool = False,
               device=None) -> str:
    return (f"matmul/{device_tag(device)}/"
            f"m{m}k{k}n{n}/relu={int(bool(relu))}")


def worker_key(xe_shape: tuple, ke_shape: tuple, stride: int, *,
               device=None) -> str:
    """Cell key for one worker subtask: coded-share and filter-group shapes
    (the batch dim rides inside ``xe_shape``, so buckets key separately)."""
    xs = "x".join(map(str, xe_shape))
    ks = "x".join(map(str, ke_shape))
    return f"worker/{device_tag(device)}/xe{xs}/ke{ks}/s{stride}"


# -- ledger ----------------------------------------------------------------
def load_cache(path: str | None = None, *, reload: bool = False) -> dict:
    """The in-memory ledger, loading the JSON file on first touch."""
    global _CACHE
    with _LOCK:
        if _CACHE is None or reload:
            p = path or cache_path()
            try:
                with open(p) as f:
                    _CACHE = json.load(f)
            except (FileNotFoundError, json.JSONDecodeError):
                _CACHE = {}
        return _CACHE


def save_cache(path: str | None = None) -> str:
    p = path or cache_path()
    with _LOCK:
        cache = load_cache(path)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        tmp = f"{p}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, p)  # atomic: concurrent readers never see a torn file
    return p


def clear_cache(*, memory_only: bool = False, path: str | None = None) -> None:
    """Drop the in-memory ledger (and the JSON file unless ``memory_only``)."""
    global _CACHE, _SWEEPS
    with _LOCK:
        _CACHE = None
        _SWEEPS = 0
        if not memory_only:
            try:
                os.remove(path or cache_path())
            except FileNotFoundError:
                pass


def sweep_count() -> int:
    """Real sweeps run since import/clear — the cache-hit test hook."""
    return _SWEEPS


def _lookup(key: str, path: str | None = None) -> dict | None:
    cache = _CACHE
    if cache is None:
        cache = load_cache(path)
    entry = cache.get(key)
    if not entry:
        return None
    if not isinstance(entry, dict) or "params" not in entry:
        raise ValueError(f"ledger entry {key}: {entry!r} holds no params")
    params = entry["params"]
    # a copy; anything else is handed on for the kernel's check to refuse
    return dict(params) if isinstance(params, dict) else params


def _record(key: str, params: dict, us: float, swept: list, path=None) -> None:
    global _SWEEPS
    with _LOCK:
        _SWEEPS += 1
        load_cache(path)[key] = {
            "params": params,
            "us": round(us, 2),
            "swept": swept,
        }
        save_cache(path)


# -- launch-time lookups (never sweep) -------------------------------------
def matmul_params(m: int, k: int, n: int, *, relu: bool = False,
                  device=None) -> dict | None:
    """The recorded K2 plan (``{"kernel": "column"}`` or ``{"kernel":
    "split", "splits": s}``) for this GEMM cell, or None."""
    return _lookup(matmul_key(m, k, n, relu=relu, device=device))


def worker_params(xe_shape: tuple, ke_shape: tuple, stride: int, *,
                  device=None) -> dict | None:
    """The recorded K1 plan (``{"route": ..., "bn": ..., "splits": ...}``)
    for this worker cell, or None.  An entry recorded before K1 had
    routes (``{"bn", "splits"}``) is handed on, and ``worker_plan_of``
    refuses it: a cell is swept again, never launched on a plan made for
    the other kernel."""
    return _lookup(worker_key(xe_shape, ke_shape, stride, device=device))


# -- candidates --------------------------------------------------------------
def _unique(plans: list[dict]) -> list[dict]:
    out = []
    for p in plans:
        if p not in out:
            out.append(p)
    return out


def worker_candidates(xe_shape: tuple, ke_shape: tuple,
                      stride: int) -> list[dict]:
    """K1's candidates for a worker cell: the heuristic's plan first, then
    on each route every N-tile (32, 64, 128) with every K split of
    ``SPLIT_CHOICES`` that leaves each slice at least the route's
    ``MIN_SPLIT_CHUNKS`` stages (``{"route", "bn", "splits"}``)."""
    from .conv2d import kernel as k1

    m, n, k = k1.gemm_shape(xe_shape, ke_shape, stride)
    cands = [k1.plan_params(k1.worker_plan(m, n, k))]
    for route in k1.ROUTES:
        if route == "ffma" and k > k1.MAX_K:
            continue
        chunks = -(-k // k1.TILE_K[route])
        cands += [{"route": route, "bn": bn, "splits": s}
                  for bn in k1.BN_CHOICES for s in k1.SPLIT_CHOICES
                  if s == 1 or chunks >= s * k1.MIN_SPLIT_CHUNKS[route]]
    return _unique(cands)


def matmul_candidates(m: int, k: int, n: int) -> list[dict]:
    """K2's candidates for an ``(m, k) @ (k, n)`` cell: the heuristic's
    plan first, the column kernel, and, where ``m <= SPLIT_MAX_M`` and
    ``k >= SPLIT_MIN_K``, the split kernel over ``SPLIT_CHOICES`` (the
    plans ``scripts/torch_route_sweep.py`` drives)."""
    from .matmul import kernel as k2

    cands = [k2.plan_params(k2.matmul_plan(m, n, k)), {"kernel": "column"}]
    if m <= k2.SPLIT_MAX_M and k >= k2.SPLIT_MIN_K:
        cands += [{"kernel": "split", "splits": s} for s in k2.SPLIT_CHOICES]
    return _unique(cands)


# -- timing ----------------------------------------------------------------
def _device_us(launch, repeat: int) -> float:
    """The least device time of ``launch()`` over ``repeat`` timed calls,
    after one warm-up: CUDA events around each call, the stream held by
    ``torch.cuda._sleep`` while the host issues them."""
    launch()
    best = float("inf")
    for _ in range(repeat):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_HOLD_CYCLES)
        start.record()
        launch()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3)
    return best


def _card(device) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("autotuning times K1/K2 on a CUDA card; none here")
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"autotuning runs on a CUDA device, got {dev}")
    return dev


def _sweep(key: str, cands: list[dict], launch_with, repeat: int,
           path) -> dict:
    swept = []
    best, best_us = None, float("inf")
    for cand in cands:
        us = _device_us(lambda c=cand: launch_with(c), repeat)
        swept.append({"params": dict(cand), "us": round(us, 2)})
        if us < best_us:
            best, best_us = dict(cand), us
    _record(key, best, best_us, swept, path)
    return best


# -- sweeps ----------------------------------------------------------------
def tune_matmul(m: int, k: int, n: int, *, relu: bool = False, device=None,
                candidates=None, repeat: int = 3, force: bool = False,
                path: str | None = None) -> dict:
    """Time K2's plans for an (m, k, n) cell on the card; record the winner.

    Returns the winning params.  A recorded cell returns at once without
    sweeping unless ``force``.  Raises without a card.
    """
    dev = _card(device)
    key = matmul_key(m, k, n, relu=relu, device=dev)
    if not force:
        hit = _lookup(key, path)
        if hit is not None:
            return hit
    from .matmul import kernel as k2

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=dev)
    b = torch.randn((k, n), generator=gen, device=dev)
    return _sweep(
        key, list(candidates or matmul_candidates(m, k, n)),
        lambda c: k2.launch_plan(k2.matmul_plan_of(c, m, n, k), a, b,
                                 relu=relu), repeat, path)


def tune_worker(xe_shape: tuple, ke_shape: tuple, stride: int, *,
                device=None, candidates=None, repeat: int = 3,
                force: bool = False, path: str | None = None) -> dict:
    """Time K1's plans for one (shapes, stride) cell on the card; record
    the winner.

    ``xe_shape``: one worker's coded input shares ``(ell_a, [B,] C, h_hat,
    Wp)``; ``ke_shape``: its filter groups ``(ell_b, N/k_b, C, KH, KW)``.
    A recorded cell returns at once unless ``force``, or unless its entry
    names a plan K1 refuses (``worker_plan_of``: one recorded before K1
    had routes), which is swept again.  Raises without a card.
    """
    dev = _card(device)
    key = worker_key(xe_shape, ke_shape, stride, device=dev)
    from .conv2d import kernel as k1

    m, n, k = k1.gemm_shape(xe_shape, ke_shape, stride)
    if not force:
        hit = _lookup(key, path)
        if hit is not None:
            try:
                k1.worker_plan_of(hit, m, n, k)
                return hit
            except ValueError:
                pass  # a plan K1 no longer takes (one without a route): sweep
    gen = torch.Generator(device=dev).manual_seed(0)
    xe = torch.randn(tuple(xe_shape), generator=gen, device=dev)
    ke = torch.randn(tuple(ke_shape), generator=gen, device=dev)
    return _sweep(
        key, list(candidates or worker_candidates(xe_shape, ke_shape, stride)),
        lambda c: k1.launch_worker(k1.worker_plan_of(c, m, n, k), xe, ke,
                                   stride), repeat, path)
