"""Stdlib-only streaming HTTP frontend over :class:`AsyncEngine` (torch port).

The JAX package's ``deploy/serving/frontend.py`` over the port's async
engine, with the same routes, bodies and ``/v1/stats`` schema, the
``sanitize`` section included.

``ServingFrontend`` binds a ``ThreadingHTTPServer`` (one thread per
connection — stdlib ``http.server``, no third-party framework) to an
:class:`~repro_torch.deploy.serving.async_engine.AsyncEngine` and speaks
JSON / JSON-lines:

* ``POST /v1/generate`` — body ``{"prompt": [ints], "max_new_tokens":
  N, "stream": true|false, "eos_id": ..., "priority": ...,
  "ttft_slo_ms": ..., "deadline_ms": ...}``.  With ``stream`` (the
  default) the response is newline-delimited JSON over an ``HTTP/1.0``
  close-delimited body: one ``{"token": t, "index": i}`` line per
  sampled token as it is sampled, then a final ``{"done": true, ...}``
  summary line.  Unary returns one JSON object after completion.
* ``GET /v1/status/<rid>`` — live request state.
* ``GET /v1/stats`` — engine counters + latency percentiles.
* ``GET /healthz`` — liveness (``"draining"`` once shutdown started).

Error mapping is structured, not stringly: invalid request bodies are
``400`` with the engine's ``ValueError``/``KVCapacityError`` message and
error type; a shed submission (bounded queue) is ``429`` with a
``Retry-After`` header straight from
:class:`~repro_torch.deploy.serving.scheduler.QueueFullError`; submissions
during drain are ``503``.

Graceful drain: :meth:`ServingFrontend.shutdown` first flips the
frontend into draining (new ``/v1/generate`` refused with ``503``,
status/stats still served), waits for the engine to go idle — in-flight
streams finish normally — then stops the listener.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.deploy import sanitize
from repro_torch.deploy.api import KVCapacityError
from repro_torch.deploy.sanitize import make_lock
from repro_torch.deploy.serving.async_engine import AsyncEngine
from repro_torch.deploy.serving.scheduler import QueueFullError

#: finished handles kept for /v1/status after completion (oldest dropped)
_HISTORY = 1024


def _stats_payload(engine: AsyncEngine) -> dict:
    # one consistent copy under the engine lock — the loop thread keeps
    # appending to the live EngineStats lists while we read them here
    s = engine.stats_snapshot()
    eng = engine.engine
    shadow = eng.session.allocator.shadow if eng.paged else None
    return {
        "requests_submitted": s.requests_submitted,
        "requests_completed": s.requests_completed,
        "requests_evicted": s.requests_evicted,
        "preemptions": s.preemptions,
        "requeues": s.requeues,
        "shed_requests": s.shed_requests,
        "tokens_generated": s.tokens_generated,
        "decode_dispatches": s.decode_dispatches,
        "prefill_dispatches": s.prefill_dispatches,
        "queue_depth": s.queue_depth,
        "peak_queue_depth": s.peak_queue_depth,
        "slots_busy": s.slots_busy,
        "occupancy": s.occupancy(),
        "tokens_per_s": s.tokens_per_s(),
        "ttft_p50_ms": s.ttft(50) * 1e3,
        "ttft_p99_ms": s.ttft(99) * 1e3,
        "tpot_p50_ms": s.tpot(50) * 1e3,
        "tpot_p99_ms": s.tpot(99) * 1e3,
        "goodput_under_slo": s.goodput_under_slo(),
        "step_p50_ms": s.step_latency_p50() * 1e3,
        "step_p99_ms": s.step_latency_p99() * 1e3,
        # where a step's time goes: queue wait (submit -> first admission),
        # the engine's host phases per step, and each dispatch split into
        # its enqueue (the session call) and its fetch (the wait for the
        # device); the share of a chunk dispatch's lanes given a chunk
        "queue_wait_p50_ms": s.queue_wait(50) * 1e3,
        "queue_wait_p99_ms": s.queue_wait(99) * 1e3,
        "engine_host_per_step": s.host_per_step(),
        "prefill_enqueue_ms": 1e3 * s.prefill_enqueue_s / max(1, s.prefill_dispatches),
        "prefill_fetch_ms": 1e3 * s.prefill_fetch_s / max(1, s.prefill_dispatches),
        "decode_enqueue_ms": 1e3 * s.decode_enqueue_s / max(1, s.decode_dispatches),
        "decode_fetch_ms": 1e3 * s.decode_fetch_s / max(1, s.decode_dispatches),
        "chunk_lane_use": s.chunk_lane_use() if eng.paged else None,
        # prefix cache / copy-on-write KV (all zero unless the artifact
        # was compiled with prefix_cache=True)
        "prefix_hit_blocks": s.prefix_hit_blocks,
        "prefix_hit_rate": s.prefix_hit_rate(),
        "blocks_shared": s.blocks_shared,
        "cow_copies": s.cow_copies,
        "scheduler": eng.scheduler_snapshot(),
        # concurrency / KV-lifetime sanitizer counters (all zero unless
        # the process runs with REPRO_SANITIZE=1); "audit_findings" are
        # point-in-time audit_sharing results, the others continuous
        "sanitize": {
            "enabled": sanitize.enabled(),
            "lockdep_findings": len(sanitize.runtime_findings()),
            "shadow_findings": len(shadow.findings) if shadow else 0,
            "audit_findings": s.audit_findings,
        },
    }


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.0 + Connection: close — the streaming body is delimited by
    # EOF, so no chunked framing is needed and every stdlib/curl client
    # can consume it line by line
    protocol_version = "HTTP/1.0"
    server_version = "repro-serving/1"

    def log_message(self, fmt, *args):  # quiet by default
        if self.frontend.verbose:
            super().log_message(fmt, *args)

    @property
    def frontend(self) -> "ServingFrontend":
        return self.server.frontend  # type: ignore[attr-defined]

    # -- plumbing -----------------------------------------------------------

    def _json(self, code: int, payload: dict, headers: dict | None = None):
        body = (json.dumps(payload) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b"{}"
        payload = json.loads(raw.decode())
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        return payload

    # -- routes -------------------------------------------------------------

    def do_GET(self):  # noqa: N802 - http.server API
        fe = self.frontend
        if self.path == "/healthz":
            self._json(200, {"status": "draining" if fe.draining else "ok"})
        elif self.path == "/v1/stats":
            self._json(200, _stats_payload(fe.engine))
        elif self.path.startswith("/v1/status/"):
            try:
                rid = int(self.path.rsplit("/", 1)[1])
            except ValueError:
                self._json(400, {"error": "rid must be an integer",
                                 "type": "ValueError"})
                return
            h = fe.lookup(rid)
            if h is None:
                self._json(404, {"error": f"unknown rid {rid}",
                                 "type": "KeyError"})
                return
            self._json(200, {
                "rid": rid,
                "status": h.status.value,
                "tokens_generated": len(h.tokens),
                "finish_reason": h.finish_reason,
                "preemptions": h.handle.preemptions,
            })
        else:
            self._json(404, {"error": f"no route {self.path}",
                             "type": "KeyError"})

    def do_POST(self):  # noqa: N802 - http.server API
        fe = self.frontend
        if self.path != "/v1/generate":
            self._json(404, {"error": f"no route {self.path}",
                             "type": "KeyError"})
            return
        try:
            req = self._read_body()
        except (ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": str(e), "type": type(e).__name__})
            return
        if fe.draining:
            self._json(503, {"error": "server is draining",
                             "type": "Draining"})
            return
        stream = bool(req.get("stream", True))
        try:
            handle = fe.engine.submit(
                req.get("prompt", []),
                int(req.get("max_new_tokens", 16)),
                eos_id=req.get("eos_id"),
                priority=int(req.get("priority", 0)),
                ttft_slo_ms=req.get("ttft_slo_ms"),
                deadline_ms=req.get("deadline_ms"),
            )
        except QueueFullError as e:
            self._json(429, {
                "error": str(e), "type": "QueueFullError",
                "retry_after_s": e.retry_after_s,
                "queue_depth": e.queue_depth, "max_queue": e.max_queue,
            }, headers={"Retry-After": f"{max(1, round(e.retry_after_s))}"})
            return
        except (ValueError, KVCapacityError, TypeError) as e:
            self._json(400, {"error": str(e), "type": type(e).__name__})
            return
        except RuntimeError as e:
            self._json(503, {"error": str(e), "type": "RuntimeError"})
            return
        fe.register(handle)
        if not stream:
            raw = handle.result()
            self._json(200, {
                "rid": raw.rid, "tokens": raw.tokens,
                "finish_reason": raw.finish_reason,
                "preemptions": raw.preemptions,
            })
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            for i, tok in enumerate(handle):
                self.wfile.write(
                    (json.dumps({"token": tok, "index": i}) + "\n").encode())
                self.wfile.flush()
            self.wfile.write((json.dumps({
                "done": True, "rid": handle.rid,
                "finish_reason": handle.finish_reason,
                "tokens": handle.tokens,
                "preemptions": handle.handle.preemptions,
            }) + "\n").encode())
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            handle.cancel()  # client went away: free the slot


class ServingFrontend:
    """One HTTP listener over one :class:`AsyncEngine` (see module docs).

    ``start()`` serves on a background thread and returns the bound
    ``(host, port)`` — ``port=0`` picks a free port, which is what the
    tests and the CI smoke step use.  ``serve_forever()`` blocks (the
    ``python -m repro_torch.deploy.serving`` entry point).  ``shutdown()``
    drains gracefully; as a context manager it drains on clean exit.
    """

    def __init__(self, engine: AsyncEngine, host: str = "127.0.0.1",
                 port: int = 8080, *, verbose: bool = False):
        self.engine = engine
        self.verbose = verbose
        self.draining = False
        self._handles: dict[int, object] = {}
        # leaf of the declared lock lattice: the registry bodies touch
        # only lock-free handle properties, so nothing nests inside it
        self._hlock = make_lock("frontend.hlock")
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.frontend = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    # -- rid registry --------------------------------------------------------

    def register(self, handle) -> None:
        with self._hlock:
            self._handles[handle.rid] = handle
            while len(self._handles) > _HISTORY:
                rid = next(iter(self._handles))
                if not self._handles[rid].done:
                    break  # never drop a live request's status
                del self._handles[rid]

    def lookup(self, rid: int):
        with self._hlock:
            return self._handles.get(rid)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> tuple[str, int]:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-http",
            daemon=True)
        self._thread.start()
        return self.address

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self, drain: bool = True, timeout: float | None = None):
        """Graceful stop: refuse new generates, let streams finish,
        stop the listener.  ``drain=False`` aborts live work."""
        self.draining = True
        if drain:
            self.engine.drain(timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
        self.engine.close(drain=drain, timeout=timeout)

    def __enter__(self) -> "ServingFrontend":
        self.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown(drain=exc_type is None)
