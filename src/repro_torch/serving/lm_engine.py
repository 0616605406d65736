"""``CodedLMServer``: continuous-batching LM *token* serving over a
resident ``CodedDecoderPipeline``.

The CNN server (``engine.py``) admits late arrivals at ConvL boundaries;
an LM decode loop has a finer natural boundary — the decode *step*.  This
engine keeps a fixed pool of request *slots* (rows of the pipeline's KV
slot caches).  Each iteration of the engine thread:

  1. **admit** — pops waiting prompts into free slots through the shared
     ``MultiScheduler`` (the same admission, bucketing and in-flight caps
     CNN models use), runs ONE batched prefill for the whole admitted
     group (attention on K4), copies the filled K/V rows into the group's
     contiguous cache slots, and emits each row's first token from its own
     last-prompt-position logits;
  2. **step** — advances every active slot one token with a single coded
     decode step: ``4 x layers`` worker GEMM rounds (K2) dispatched
     through the cluster's ``dispatch_pipeline_layer`` /
     ``collect_pipeline_layer`` seam, each decoded from the fastest delta
     (K3), batched at the slot-prefix bucket;
  3. **complete** — finished requests resolve their handles with the
     generated tokens; their slots are recycled by compacting the last
     active row down (slot state plus the K/V cache rows move together),
     so active slots always form a prefix and new admissions land
     contiguously.

Prompts are packed as fixed-width int32 rows (``pack_request``) so the
scheduler's stack/pad machinery applies unchanged.  Prompt rows padded
beyond their true length leave garbage K/V at positions >= plen — never
attended: the decode step at position p overwrites position p (in place,
in the slot row the request owns, which compaction moves whole) before
the causal mask first exposes it.

On the card the engine thread runs on a CUDA stream of its own, as the
CNN engine does: the legacy default stream would synchronise with every
worker stream.  The server can own its ``FcdccCluster`` or *share* one
(pass ``cluster=``): registered under its own model name, the LM's GEMM
rounds and a CNN pipeline's ConvL rounds run on the same worker pool.

On a CUDA device a decode step replays CUDA graphs (``core/graphs.py``):
the glue between rounds from the pipeline, each worker's GEMM round from
the device pool; and an admission's prefill replays the pipeline's
prefill graph of its bucket (the reference's jitted prefill).
``warmup()`` captures them all on the stream the engine serves on, one
zero prefill and one zero step a bucket, before ``start()``.  The slot caches
are the pipeline's own (``slot_cache``), claimed by one server at a time
(``warmup`` and ``start`` claim, ``shutdown`` releases) and zeroed in
place when the engine starts and after a failed step, so the captured
attention glue keeps its resident leaves.  The server reads the
pipeline's ``graphs`` switch; ``set_graphs(False)`` decodes eagerly, op
by op.
"""
from __future__ import annotations

import contextlib

import threading
import time

import numpy as np
import torch

from ..core.decoder_pipeline import CodedDecoderPipeline
from ..runtime import FcdccCluster, StragglerModel
from .scheduler import MultiScheduler, RequestHandle, ScheduledBatch

__all__ = ["CodedLMServer", "pack_request", "unpack_request"]


def pack_request(prompt, max_new_tokens: int, max_prompt: int) -> np.ndarray:
    """One request as a fixed-width int32 row ``[plen, gen, tokens...]`` —
    equal-width rows are what lets the scheduler stack and pad prompt
    batches exactly like image batches."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    if prompt.size < 1:
        raise ValueError("prompt must have at least one token")
    if prompt.size > max_prompt:
        raise ValueError(
            f"prompt length {prompt.size} exceeds max_prompt={max_prompt}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    row = np.zeros(2 + max_prompt, np.int32)
    row[0] = prompt.size
    row[1] = max_new_tokens
    row[2:2 + prompt.size] = prompt
    return row


def unpack_request(row) -> tuple[np.ndarray, int]:
    """Inverse of ``pack_request``: (prompt tokens, max_new_tokens)."""
    row = np.asarray(row)
    plen, gen = int(row[0]), int(row[1])
    return row[2:2 + plen].astype(np.int32), gen


class _Slot:
    """Engine-private per-request decode state riding one KV cache row.
    Only the engine thread creates, advances, and recycles these.
    # guarded-by: engine-thread"""

    __slots__ = ("req", "batch", "remaining", "tokens")

    def __init__(self, req, batch: ScheduledBatch, remaining: int,
                 first_token: int):
        self.req = req
        self.batch = batch
        self.remaining = remaining
        self.tokens = [first_token]


class CodedLMServer:
    """Continuous-batching greedy-decode server over one coded decoder
    pipeline.  ``submit()`` is thread-safe and returns a ``RequestHandle``
    whose ``result()`` is the generated token array.  Use as a context
    manager or ``start()``/``shutdown()``.

    ``execution="cluster"`` (default) runs every GEMM round through the
    master/worker runtime; ``execution="direct"`` runs the single-process
    path (optionally with ``worker_ids`` forcing a survivor subset) — no
    cluster, for tests and parity baselines.

    ``on_logits(request_id, row)``, when given, is called on the engine
    thread with the ``(vocab,)`` logits row each served token was chosen
    from, in token order (the prefill row, then one row per decode step),
    so a caller can hold the served logits themselves against a reference.

    ``pool`` / ``devices`` choose the worker pool of the cluster the server
    builds (``"threads"`` or ``"device"``; None takes the pipeline's own
    preference, else the auto rule of ``runtime.resolve_pool``).
    Compiled programs follow the pipeline's own switch
    (``pipeline.set_graphs``).
    """

    def __init__(self, pipeline: CodedDecoderPipeline,
                 straggler: StragglerModel | None = None, *,
                 cluster: FcdccCluster | None = None,
                 mode: str = "simulated", execution: str = "cluster",
                 model: str = "lm", max_prompt: int = 16,
                 worker_ids=None, on_logits=None,
                 pool: str | None = None, devices=None,
                 poll_interval_s: float = 0.005):
        if execution not in ("cluster", "direct"):
            raise ValueError(f"unknown execution mode {execution!r}")
        if pipeline.bucket_sizes is None:
            raise ValueError("pipeline needs bucket_sizes for serving")
        if max_prompt < 1 or max_prompt >= pipeline.max_len:
            raise ValueError(
                f"need 1 <= max_prompt < max_len={pipeline.max_len}, "
                f"got {max_prompt}")
        self.pipeline = pipeline
        self.model = model
        self.execution = execution
        self.max_prompt = int(max_prompt)
        self.slots = pipeline.max_batch
        self.worker_ids = worker_ids
        self._on_logits = on_logits
        self.cluster = cluster
        self._owns_cluster = cluster is None and execution == "cluster"
        # the master's stream on the card: warmup captures there, and the
        # engine thread serves there
        self._master_stream = None  # guarded-by: control-thread
        if execution == "cluster":
            if self.cluster is None:
                self.cluster = FcdccCluster(
                    pipeline.specs[0].plan, straggler, mode=mode,
                    backend=pipeline.backend,
                    pool=pool if pool is not None else pipeline.pool,
                    devices=devices if devices is not None
                    else pipeline.devices,
                    device=pipeline.device)
            self.cluster.load_pipeline(pipeline, model)
        self.scheduler = MultiScheduler()
        self.scheduler.add_model(
            model, pipeline.pad_to_bucket, max_batch=pipeline.max_batch,
            max_inflight=max(2, self.slots))
        self._poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._drain = True  # guarded-by: control-thread
        self._thread: threading.Thread | None = None  # guarded-by: control-thread
        # token-throughput counters, written only by the engine thread and
        # read by stats() (plain int/float reads are atomic enough for
        # monitoring)  # guarded-by: engine-thread
        self.tokens_generated = 0
        self.decode_steps = 0
        self.decode_time_s = 0.0
        self.prefill_time_s = 0.0
        # seconds warmup() spent prefilling: per bucket a warm-up run, the
        # capture and its first replay (eager: one run)
        self.prefill_warmup_s = 0.0  # guarded-by: control-thread
        self.requests_served = 0
        # sums over the cluster's GEMM rounds: master encode, time to the
        # delta-th worker result, decode (seconds)  # guarded-by: engine-thread
        self.rounds = 0
        self.round_encode_s = 0.0
        self.round_compute_s = 0.0
        self.round_decode_s = 0.0

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "CodedLMServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self.pipeline.claim_slot_cache(self)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._engine_main, name="coded-lm-engine", daemon=True)
        self._thread.start()
        return self

    def shutdown(self, *, drain: bool = True, timeout: float = 120.0) -> None:
        """Stop the engine; ``drain=True`` finishes queued + in-flight
        requests first.  Idempotent."""
        self._drain = drain
        self._stop.set()
        thread = self._thread
        if thread is not None:
            with self.scheduler.not_empty:
                self.scheduler.not_empty.notify_all()
            thread.join(timeout)
            if thread.is_alive():
                err = TimeoutError(f"engine thread not done after {timeout}s")
                self.scheduler.cancel_all(err)
                raise err
            self._thread = None
            self.scheduler.cancel_all(RuntimeError("server shut down"))
        self.pipeline.release_slot_cache(self)
        if self._owns_cluster and self.cluster is not None:
            self.cluster.shutdown()

    def __enter__(self) -> "CodedLMServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- request path --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int) -> RequestHandle:
        """Enqueue one prompt (sequence of token ids) for greedy decoding
        of ``max_new_tokens`` tokens."""
        row = pack_request(prompt, max_new_tokens, self.max_prompt)
        if self._thread is None or self._stop.is_set():
            raise RuntimeError("server not running; call start()")
        return self.scheduler.submit(self.model, torch.from_numpy(row))

    def generate(self, prompt, max_new_tokens: int,
                 timeout: float = 120.0) -> np.ndarray:
        return self.submit(prompt, max_new_tokens).result(timeout=timeout)

    def tokens_per_second(self) -> float:
        busy = self.decode_time_s + self.prefill_time_s
        return self.tokens_generated / busy if busy > 0 else 0.0

    def warmup(self) -> None:
        """One prefill of zero prompts of the server's width and one decode
        step of zero tokens per bucket through the serving path, before
        ``start()``: builds and loads the kernels and, with CUDA graphs,
        captures the prefill's and every glue program's graph (and every
        worker round's, where the pipeline asks for worker graphs) on the
        engine's stream, outside the served timings.  Claims the slot
        caches, and zeroes them again afterwards."""
        if self._thread is not None:
            raise RuntimeError("warmup() runs before start()")
        pipe = self.pipeline
        pipe.claim_slot_cache(self)
        with self._master_ctx():
            t0 = time.perf_counter()
            for b in pipe.bucket_sizes:
                pipe.prefill_prompt(np.zeros((b, self.max_prompt), np.int32))
            if pipe.device.type == "cuda":
                torch.cuda.current_stream(pipe.device).synchronize()
            self.prefill_warmup_s += time.perf_counter() - t0
            for b in pipe.bucket_sizes:
                tokens = torch.zeros(b, dtype=torch.int32, device=pipe.device)
                pos = torch.zeros(b, dtype=torch.int32, device=pipe.device)
                cache = pipe.slot_cache(self.slots)
                self._step(tokens, cache, pos, None)
            pipe.slot_cache(self.slots)
            if pipe.device.type == "cuda":
                torch.cuda.current_stream(pipe.device).synchronize()

    def _step(self, tokens, cache, pos, timings):
        """One decode step on the serving path (cluster or direct)."""
        pipe = self.pipeline
        if self.execution == "cluster":
            return pipe.run_decode_step_cluster(
                self.cluster, tokens, cache, pos, model=self.model,
                timings=timings)
        return pipe.run_decode_step_direct(tokens, cache, pos, self.worker_ids)

    # -- engine loop ---------------------------------------------------------
    def _master_ctx(self):
        """The master's stream on the card (made once), nothing on the
        CPU."""
        device = self.pipeline.device
        if device.type != "cuda":
            return contextlib.nullcontext()
        if self._master_stream is None:
            self._master_stream = torch.cuda.Stream(device=device)
        return torch.cuda.stream(self._master_stream)

    def _engine_main(self) -> None:
        with self._master_ctx():
            self._engine_loop()

    def _engine_loop(self) -> None:
        pipe = self.pipeline
        sched = self.scheduler[self.model]
        cache = pipe.slot_cache(self.slots)
        # host-side per-slot decode state; active slots are ALWAYS the
        # prefix [0, len(slots_live)) — compaction maintains the invariant
        slots_live: list[_Slot] = []  # guarded-by: engine-thread
        last_tok = np.zeros(self.slots, np.int32)  # guarded-by: engine-thread
        pos = np.zeros(self.slots, np.int32)  # guarded-by: engine-thread
        outstanding: dict[int, int] = {}  # id(batch) -> unfinished rows  # guarded-by: engine-thread

        def finish_slot(i: int, err: BaseException | None = None) -> None:
            slot = slots_live[i]
            if err is None:
                slot.req.finish(result=np.asarray(slot.tokens, np.int32))
                self.requests_served += 1
            else:
                slot.req.finish(error=err)
            key = id(slot.batch)
            outstanding[key] -= 1
            if outstanding[key] == 0:
                del outstanding[key]
                self.scheduler.retire(self.model, slot.batch)
            # compact: move the last active row into the freed slot so the
            # active region stays a prefix (cache rows travel with it)
            j = len(slots_live) - 1
            if i != j:
                slots_live[i] = slots_live[j]
                last_tok[i], pos[i] = last_tok[j], pos[j]
                for c in cache:
                    c["k"] = pipe.slot_write(c["k"], pipe.slot_take(c["k"], j), i)
                    c["v"] = pipe.slot_write(c["v"], pipe.slot_take(c["v"], j), i)
            slots_live.pop()
            last_tok[j] = pos[j] = 0

        def fail_all(err: BaseException) -> None:
            for i in range(len(slots_live) - 1, -1, -1):
                finish_slot(i, err)

        while True:
            if self._stop.is_set() and (
                    not self._drain or (not slots_live and not sched.has_work())):
                break
            # -- admit into free slots (late admission per decode step) -----
            while len(slots_live) < self.slots:
                batch = sched.admit(limit=self.slots - len(slots_live))
                if batch is None:
                    break
                try:
                    self._admit(batch, cache, slots_live, last_tok, pos,
                                outstanding, finish_slot)
                except Exception as err:  # prefill failure: fail this group
                    for req in batch.requests:
                        req.finish(error=err)
                    self.scheduler.retire(self.model, batch)
            if not slots_live:
                if self._stop.is_set():
                    continue
                with self.scheduler.not_empty:
                    while (not self._stop.is_set() and not sched.can_admit()
                           and not len(sched.queue)):
                        self.scheduler.not_empty.wait(self._poll_interval_s)
                continue
            # -- one decode step over the active slot prefix ----------------
            active = len(slots_live)
            b = pipe.bucketize(active)
            t0 = time.perf_counter()
            timings: list = []
            try:
                tokens = torch.tensor(last_tok[:b], device=pipe.device)
                step_pos = torch.tensor(pos[:b], device=pipe.device)
                logits, nxt, cache = self._step(tokens, cache, step_pos,
                                                timings)
                nxt = nxt.cpu().numpy()
            except Exception as err:  # ClusterDegraded, kernel failure, ...
                # a mid-step failure leaves the caches inconsistent for every
                # rider: fail them all rather than serve wrong tokens
                fail_all(err)
                cache = pipe.slot_cache(self.slots)  # zeroed in place
                continue
            self.decode_steps += 1
            self.decode_time_s += time.perf_counter() - t0
            self.tokens_generated += active
            for t in timings:
                self.rounds += 1
                self.round_encode_s += t.encode_s
                self.round_compute_s += t.compute_s
                self.round_decode_s += t.decode_s
            # -- record tokens; retire finished requests (reverse order so
            # compaction swaps never disturb lower unprocessed slots) -------
            pos[:active] += 1
            last_tok[:active] = nxt[:active]
            for i in range(active):
                slot = slots_live[i]
                slot.tokens.append(int(nxt[i]))
                slot.remaining -= 1
                if self._on_logits is not None:
                    self._on_logits(slot.req.request_id, logits[i])
            for i in range(active - 1, -1, -1):
                if slots_live[i].remaining == 0:
                    finish_slot(i)
        if not self._drain:
            self.scheduler.cancel_all(RuntimeError("server shut down"))

    def _admit(self, batch: ScheduledBatch, cache, slots_live, last_tok, pos,
               outstanding, finish_slot) -> None:
        """Prefill one admitted group and seat it in contiguous free slots.

        ONE batched prefill serves the whole (bucket-padded) group; per-row
        first tokens come from each row's own last prompt position.  Rows
        are seated at ``[row0, row0 + real)`` — contiguous by the prefix
        invariant — so the K/V copy is one slice write per cache leaf.
        The prefill's ks/vs are its scratch cache, which the next
        admission's prefill overwrites: they are copied into the slots
        here, and only gathered logits rows (copies) leave the call."""
        pipe = self.pipeline
        rows = batch.x.numpy()
        real = batch.real
        t0 = time.perf_counter()
        logits, ks, vs = pipe.prefill_prompt(rows[:, 2:2 + self.max_prompt])
        row0 = len(slots_live)
        for c, lk, lv in zip(cache, ks, vs):
            c["k"] = pipe.slot_write(c["k"], lk[:real], row0)
            c["v"] = pipe.slot_write(c["v"], lv[:real], row0)
        plens = rows[:real, 0]
        last = torch.as_tensor(plens.astype(np.int64) - 1, device=logits.device)
        last_logits = logits[torch.arange(real, device=logits.device), last]
        first = last_logits.argmax(dim=-1).cpu().numpy().astype(np.int32)
        self.prefill_time_s += time.perf_counter() - t0
        self.tokens_generated += real
        outstanding[id(batch)] = real
        for r in range(real):
            slots_live.append(_Slot(batch.requests[r], batch,
                                    int(rows[r, 1]) - 1, int(first[r])))
            if self._on_logits is not None:
                self._on_logits(batch.requests[r].request_id, last_logits[r])
            last_tok[row0 + r] = first[r]
            pos[row0 + r] = int(plens[r])
        # single-token requests are done at admission (prefill emitted
        # their one token); retire top-down so compaction stays safe
        for i in range(len(slots_live) - 1, row0 - 1, -1):
            if slots_live[i].remaining == 0:
                finish_slot(i)
