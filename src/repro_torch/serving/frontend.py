"""Stdlib JSON/HTTP front-end for the multi-model ``CodedServer``.

An HTTP server with a BOUNDED handler pool (no third-party deps) in front
of the engine:

  * ``POST /v1/infer``  — body ``{"model": "...", "input": [[[...]]]}``
    (a nested-list ``(C, H, W)`` tensor; ``model`` optional while a single
    model is registered).  The handler submits to the engine and awaits the
    result on the scheduler's ONE shared completion condition
    (``CodedServer.wait_many``: timeout-sliced waits, no thread parked per
    request Event), so HTTP concurrency maps onto engine concurrency —
    concurrent posts land in the same continuous batches.  A request whose
    result does not arrive within ``result_timeout_s`` answers **504**.
    Replies ``{"model", "request_id", "shape", "output", "latency_s"}``.
    Batched form: ``{"model": "...", "inputs": [t1, t2, ...]}`` submits
    every image in one round trip — all of them fan out to the engine
    *before* the handler waits, then ONE ``wait_many`` covers the whole
    list — and replies ``{"model", "count", "results": [...]}`` with one
    entry per input in order: the single-image payload on success, or
    ``{"error": "..."}`` for that item alone (one bad or timed-out image
    never fails its siblings; an engine that is down or draining is a
    request-level 503, same as the single form).
  * ``GET /v1/models``  — registered models with input shape/dtype, layer
    count and bucket sizes.
  * ``GET /v1/stats``   — aggregate + per-model ``ServingStats``.

Connections are served by ``handler_pool`` pooled threads
(``_PooledHTTPServer``) instead of one spawned thread per connection, so a
burst of slow requests queues at the accept loop instead of growing an
unbounded thread count.

``ServingFrontend`` owns the socket lifecycle: ``start()`` binds (an
ephemeral port when ``port=0``) and serves from a background thread;
``shutdown()`` drains gracefully — stop accepting, join the handler pool
(every accepted request answered), then drain the engine itself (when the
front-end owns it).  Wired into ``launch/serve.py`` via ``--http-port``.

Replies convert a result through ``torch.as_tensor(y).detach().cpu()
.numpy()``, which takes a host array or a tensor on the card alike.
"""
from __future__ import annotations

import json
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .engine import CodedServer

__all__ = ["ServingFrontend"]


def _stats_dict(stats) -> dict:
    d = {k: v for k, v in stats.__dict__.items()}
    # nan is not valid JSON; percentiles of an empty window become null
    return {k: (None if isinstance(v, float) and not np.isfinite(v) else v)
            for k, v in d.items()}


def _overlap_dict(ov) -> dict:
    # dataclass fields + the derived serial_s / overlap_efficiency
    d = {**ov.__dict__, "serial_s": ov.serial_s,
         "overlap_efficiency": ov.overlap_efficiency}
    return {k: (None if isinstance(v, float) and not np.isfinite(v) else v)
            for k, v in d.items()}


class _PooledHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` serving connections from a BOUNDED pool.

    The stock mixin spawns one thread per accepted connection — under a
    burst of slow requests that grows without bound, and each thread parks
    on its own ``Request.done`` event.  Here ``process_request`` hands the
    connection to a fixed ``ThreadPoolExecutor`` instead: at most
    ``pool_size`` requests are in service, later accepts queue in the
    executor, and ``server_close`` joins the pool so graceful drain still
    answers every accepted request before the engine goes away."""

    def __init__(self, addr, handler, pool_size: int):
        if pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {pool_size}")
        super().__init__(addr, handler)
        self._pool = ThreadPoolExecutor(
            max_workers=pool_size, thread_name_prefix="coded-http"
        )

    def process_request(self, request, client_address) -> None:
        # process_request_thread = finish_request + error handling +
        # shutdown_request, exactly what the per-connection thread ran
        self._pool.submit(self.process_request_thread, request,
                          client_address)

    def server_close(self) -> None:
        super().server_close()
        self._pool.shutdown(wait=True)


class _Handler(BaseHTTPRequestHandler):
    # set per-server via the factory in ServingFrontend
    server_version = "CodedServing/1.0"
    engine: CodedServer = None
    result_timeout_s: float = 120.0
    # socket read timeout: an idle client connection (opened, nothing sent)
    # must error out rather than pin a handler thread forever — shutdown()
    # joins every handler, so one stalled reader would hang the drain
    timeout = 30.0

    def log_message(self, *args) -> None:  # quiet: the engine has metrics
        pass

    # -- plumbing ----------------------------------------------------------
    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        self._reply(code, {"error": message})

    # -- routes ------------------------------------------------------------
    def do_GET(self) -> None:
        if self.path == "/v1/models":
            models = []
            for name, state in self.engine.models.items():
                pipe = state.pipeline
                models.append({
                    "name": name,
                    "input_shape": list(pipe.input_shape),
                    "dtype": str(pipe.input_dtype).removeprefix("torch."),
                    "layers": len(pipe.specs),
                    "bucket_sizes": list(pipe.bucket_sizes or ()),
                })
            self._reply(200, {"models": models})
        elif self.path == "/v1/stats":
            agg = _stats_dict(self.engine.stats())
            agg["overlap"] = _overlap_dict(self.engine.overlap_stats())
            per_model = {}
            for m, s in self.engine.per_model_stats().items():
                per_model[m] = _stats_dict(s)
                per_model[m]["overlap"] = _overlap_dict(
                    self.engine.overlap_stats(m))
            self._reply(200, {"aggregate": agg, "per_model": per_model})
        else:
            self._error(404, f"no route {self.path!r}")

    def do_POST(self) -> None:
        if self.path != "/v1/infer":
            self._error(404, f"no route {self.path!r}")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError(f"body must be a JSON object, "
                                 f"got {type(payload).__name__}")
            if "inputs" in payload:
                if "input" in payload:
                    raise ValueError("pass either 'input' or 'inputs', not both")
                raw = payload["inputs"]
                if not isinstance(raw, list) or not raw:
                    raise ValueError("'inputs' must be a non-empty list of "
                                     "(C, H, W) tensors")
                batch = list(raw)
            else:
                batch = None
                x = np.asarray(payload["input"], dtype=np.float32)
        except (ValueError, TypeError, KeyError, json.JSONDecodeError) as err:
            self._error(400, f"bad request body: {err}")
            return
        model = payload.get("model")
        if not self.engine.models:
            self._error(503, "no model registered")
            return
        if model is not None and model not in self.engine.models:
            self._error(404, f"unknown model {model!r}; registered: "
                             f"{sorted(self.engine.models)}")
            return
        if model is None and len(self.engine.models) > 1:
            self._error(400, f"{len(self.engine.models)} models registered "
                             f"({sorted(self.engine.models)}); pass model=")
            return
        resolved = (model if model is not None
                    else self.engine.model_names()[0])
        if batch is None:
            try:
                handle = self.engine.submit(x, model)
            except ValueError as err:  # wrong shape / model field required
                self._error(400, str(err))
                return
            except RuntimeError as err:  # engine not running / draining
                self._error(503, str(err))
                return
            if not self.engine.wait_many([handle],
                                         timeout=self.result_timeout_s):
                # the request is NOT cancelled — the engine may still finish
                # it — but this handler's slot is released with a timeout
                self._error(504, f"request {handle.request_id} not done "
                                 f"after {self.result_timeout_s}s")
                return
            item = self._gather(handle)
            if "error" in item:
                self._error(503, item["error"])
                return
            self._reply(200, {"model": resolved, **item})
            return
        # batched: fan every image out BEFORE waiting on any result, so
        # the whole list rides the engine's continuous batches in one HTTP
        # round trip, then ONE shared-condition wait covers all of them;
        # per-ITEM problems (bad tensor, wrong shape, timeout) are reported
        # per item and never fail siblings, while engine-down is a
        # request-level condition and answers 503 like the single form
        handles = []
        for i, raw_x in enumerate(batch):
            try:
                xi = np.asarray(raw_x, dtype=np.float32)
                handles.append(self.engine.submit(xi, model))
            except (ValueError, TypeError) as err:  # bad tensor / shape
                handles.append(f"bad input [{i}]: {err}")
            except RuntimeError as err:  # engine not running / draining
                self._error(503, str(err))
                return
        self.engine.wait_many([h for h in handles if not isinstance(h, str)],
                              timeout=self.result_timeout_s)
        results = []
        for h in handles:
            if isinstance(h, str):
                results.append({"error": h})
            elif not h.done():
                results.append({"error": f"TimeoutError: request "
                                         f"{h.request_id} not done after "
                                         f"{self.result_timeout_s}s"})
            else:
                results.append(self._gather(h))
        self._reply(200, {
            "model": resolved,
            "count": len(results),
            "results": results,
        })

    def _gather(self, handle) -> dict:
        """The per-item reply payload for a handle ``wait_many`` already
        saw complete (``result`` returns without blocking)."""
        try:
            y = torch.as_tensor(handle.result(timeout=0)).detach().cpu().numpy()
        except Exception as err:  # degraded cluster, engine shutdown, ...
            return {"error": f"{type(err).__name__}: {err}"}
        return {
            "request_id": handle.request_id,
            "shape": list(y.shape),
            "output": y.tolist(),
            "latency_s": handle.latency_s,
        }


class ServingFrontend:
    """HTTP front-end over a ``CodedServer``.

    ``manage_server=True`` ties the engine lifecycle to the front-end:
    ``start()`` starts the engine (unless already running) and
    ``shutdown()`` drains it after the HTTP side is quiesced.  With
    ``port=0`` the OS picks a free port — read ``.port`` after start.
    """

    def __init__(self, engine: CodedServer, *, host: str = "127.0.0.1",
                 port: int = 0, manage_server: bool = True,
                 result_timeout_s: float = 120.0, handler_pool: int = 8):
        self.engine = engine
        self.manage_server = manage_server
        handler = type("Handler", (_Handler,), {
            "engine": engine, "result_timeout_s": result_timeout_s,
        })
        # bounded pool instead of a thread per connection; server_close()
        # joins the pool, so graceful drain answers every accepted request
        # before the engine shuts down
        self.httpd = _PooledHTTPServer((host, port), handler, handler_pool)
        self._thread: threading.Thread | None = None

    @property
    def host(self) -> str:
        return self.httpd.server_address[0]

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingFrontend":
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        if self.manage_server and self.engine._thread is None:
            self.engine.start()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="coded-serving-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def shutdown(self) -> None:
        """Graceful drain: stop accepting, join the handler pool (each
        in-service request completes once the engine delivers — or times
        out to a 504), then drain the engine (when managed).  Idempotent."""
        thread, self._thread = self._thread, None
        if thread is not None:
            self.httpd.shutdown()       # stop the accept loop
            thread.join(30.0)
        # joins the bounded handler pool, so every accepted request gets
        # its response before the engine goes away
        self.httpd.server_close()
        if self.manage_server and self.engine._thread is not None:
            self.engine.shutdown(drain=True)

    def __enter__(self) -> "ServingFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()
