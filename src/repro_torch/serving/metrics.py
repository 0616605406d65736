"""Per-request serving metrics: latency breakdown, percentiles, throughput.

Every request that flows through the ``CodedServer`` leaves one
``RequestRecord`` (arrival -> batch start -> finish, tagged with its
model); ``MetricsCollector`` aggregates them into a ``ServingStats`` with
queue-wait / execute / end-to-end percentiles and images/s throughput.
Multi-model servers get the same
stats *per model* (``stats(model=...)`` / ``per_model_stats()``) while
the aggregate view stays exactly the single-model one; equal-depth batch
merges are counted per model too (``count_coalesced``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np

__all__ = ["OverlapStats", "RequestRecord", "ServingStats",
           "MetricsCollector", "percentile"]


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """Lifecycle timestamps of one served request (``time.perf_counter``)."""

    request_id: int
    arrival_t: float   # submit() called
    start_t: float     # its batch began executing layer 0
    finish_t: float    # result decoded and delivered
    bucket: int        # padded batch size the request rode in
    batch_real: int    # real (unpadded) requests in that batch
    model: str = ""    # model namespace the request was served under

    @property
    def queue_wait_s(self) -> float:
        return self.start_t - self.arrival_t

    @property
    def execute_s(self) -> float:
        return self.finish_t - self.start_t

    @property
    def e2e_s(self) -> float:
        return self.finish_t - self.arrival_t


def percentile(xs: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile (p in [0, 100]); nan when empty."""
    if not xs:
        return float("nan")
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p))


@dataclasses.dataclass(frozen=True)
class ServingStats:
    """Aggregate over a set of completed requests."""

    completed: int
    wall_s: float            # first arrival -> last finish
    images_per_s: float
    e2e_p50_s: float
    e2e_p95_s: float
    e2e_p99_s: float
    queue_wait_p50_s: float
    queue_wait_p95_s: float
    execute_p50_s: float
    execute_p95_s: float
    mean_batch_real: float   # average *real* occupancy of executed buckets
    coalesced: int = 0       # equal-depth batch merges behind these requests

    def summary_line(self) -> str:
        return (
            f"{self.completed} reqs in {self.wall_s:.3f}s "
            f"({self.images_per_s:.1f} img/s) "
            f"e2e p50/p95/p99 {self.e2e_p50_s*1e3:.1f}/"
            f"{self.e2e_p95_s*1e3:.1f}/{self.e2e_p99_s*1e3:.1f} ms "
            f"queue p50 {self.queue_wait_p50_s*1e3:.1f} ms "
            f"mean batch {self.mean_batch_real:.2f}"
        )


@dataclasses.dataclass(frozen=True)
class OverlapStats:
    """Per-phase round timings under pipelined serving.

    Each collected worker round contributes one (dispatch, worker, collect,
    transition) tuple; ``busy_wall_s`` is the engine's wall time with at
    least one round in flight.  ``overlap_efficiency`` is the observable
    form of the pipelining win: serial phase seconds per busy wall second —
    ~1.0 at depth 1 (phases ARE the wall), > 1.0 when master-side
    collect/transition of one batch overlapped another batch's worker
    compute."""

    rounds: int            # collected worker rounds
    dispatch_s: float      # sum: master-side encode + submit
    worker_s: float        # sum: dispatch -> delta-th result visible
    collect_s: float       # sum: reap + gather (decode excluded)
    transition_s: float    # sum: decode or fused transition
    busy_wall_s: float     # wall time with >= 1 round in flight
    max_depth: int         # deepest pipeline window actually reached

    @property
    def serial_s(self) -> float:
        """What the phases would cost executed back to back."""
        return (self.dispatch_s + self.worker_s + self.collect_s
                + self.transition_s)

    @property
    def overlap_efficiency(self) -> float:
        """serial_s / busy_wall_s (nan before any busy span closes)."""
        if self.busy_wall_s <= 0:
            return float("nan")
        return self.serial_s / self.busy_wall_s


class MetricsCollector:
    """Thread-safe sink for ``RequestRecord``s (the engine thread writes,
    callers read a snapshot).  Records are tagged per model; ``stats``
    with no argument is the aggregate over every model."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: list[RequestRecord] = []  # guarded-by: self._lock
        self._coalesced: dict[str, int] = {}  # guarded-by: self._lock
        # per-model round phase tuples (dispatch, worker, collect, transition)
        self._phases: dict[str, list[tuple]] = {}  # guarded-by: self._lock
        self._busy_wall_s: float = 0.0  # guarded-by: self._lock
        self._max_depth: int = 0  # guarded-by: self._lock

    def record(self, rec: RequestRecord) -> None:
        with self._lock:
            self._records.append(rec)

    def count_coalesced(self, model: str, merges: int = 1) -> None:
        """Account ``merges`` equal-depth batch merges to ``model``."""
        with self._lock:
            self._coalesced[model] = self._coalesced.get(model, 0) + merges

    def record_phases(self, model: str, *, dispatch_s: float, worker_s: float,
                      collect_s: float, transition_s: float) -> None:
        """One collected worker round's phase breakdown (engine thread)."""
        with self._lock:
            self._phases.setdefault(model, []).append(
                (dispatch_s, worker_s, collect_s, transition_s)
            )

    def note_busy(self, wall_s: float) -> None:
        """Close one busy span: ``wall_s`` seconds with >= 1 round in
        flight (the engine calls this when its window drains to empty)."""
        with self._lock:
            self._busy_wall_s += wall_s

    def note_depth(self, depth: int) -> None:
        """Track the deepest pipeline window observed."""
        with self._lock:
            if depth > self._max_depth:
                self._max_depth = depth

    def overlap_stats(self, model: str | None = None) -> OverlapStats:
        """Aggregate ``OverlapStats`` — all models, or one model's rounds
        (busy wall and max depth are engine-wide either way)."""
        with self._lock:
            if model is None:
                phases = [p for ps in self._phases.values() for p in ps]
            else:
                phases = list(self._phases.get(model, []))
            busy, depth = self._busy_wall_s, self._max_depth
        sums = [sum(p[k] for p in phases) for k in range(4)] \
            if phases else [0.0] * 4
        return OverlapStats(
            rounds=len(phases), dispatch_s=sums[0], worker_s=sums[1],
            collect_s=sums[2], transition_s=sums[3],
            busy_wall_s=busy, max_depth=depth,
        )

    def records(self, model: str | None = None) -> list[RequestRecord]:
        with self._lock:
            recs = list(self._records)
        if model is None:
            return recs
        return [r for r in recs if r.model == model]

    def models(self) -> list[str]:
        """Model names seen so far (served requests or counted merges)."""
        with self._lock:
            seen = {r.model for r in self._records} | set(self._coalesced)
        return sorted(seen)

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._coalesced.clear()
            self._phases.clear()
            self._busy_wall_s = 0.0
            self._max_depth = 0

    def coalesced(self, model: str | None = None) -> int:
        with self._lock:
            if model is None:
                return sum(self._coalesced.values())
            return self._coalesced.get(model, 0)

    def stats(self, model: str | None = None) -> ServingStats:
        """Aggregate stats — over every model (``model=None``, the
        single-model view) or one model's requests only."""
        recs = self.records(model)
        merges = self.coalesced(model)
        if not recs:
            return ServingStats(0, 0.0, 0.0, *([float("nan")] * 7), 0.0,
                                coalesced=merges)
        e2e = [r.e2e_s for r in recs]
        qw = [r.queue_wait_s for r in recs]
        ex = [r.execute_s for r in recs]
        wall = max(r.finish_t for r in recs) - min(r.arrival_t for r in recs)
        return ServingStats(
            completed=len(recs),
            wall_s=wall,
            images_per_s=len(recs) / wall if wall > 0 else float("inf"),
            e2e_p50_s=percentile(e2e, 50),
            e2e_p95_s=percentile(e2e, 95),
            e2e_p99_s=percentile(e2e, 99),
            queue_wait_p50_s=percentile(qw, 50),
            queue_wait_p95_s=percentile(qw, 95),
            execute_p50_s=percentile(ex, 50),
            execute_p95_s=percentile(ex, 95),
            mean_batch_real=float(np.mean([r.batch_real for r in recs])),
            coalesced=merges,
        )

    def per_model_stats(self) -> dict[str, "ServingStats"]:
        """One ``ServingStats`` per model seen (aggregate view unchanged)."""
        return {m: self.stats(m) for m in self.models()}
