"""HTTP transcription server over the continuous-batching scheduler:
port of ``whisper_apr_tpu/cli/serve.py``, the same routes, JSON bodies,
status codes and Prometheus names, over the port's
``parallel/serving.BatchScheduler``.

The reference stubs its ``serve`` command ("not yet implemented",
reference: src/cli/commands.rs:770-790); here it is implemented: a stdlib
ThreadingHTTPServer front end feeding the BatchScheduler. The device loop
(scheduler ticks and the streaming sessions' decodes) runs on the thread
that calls ``serve_forever``, and only there: HTTP handler threads create
and read no CUDA tensor. They parse and resample audio on the host,
enqueue requests (``BatchScheduler.submit`` builds the prompt on the
host), create sessions (host state only, no decode), and poll
completions, whose tokens are Python lists decoded to text on the host.

API:
  POST /v1/transcribe   body: WAV bytes (or raw f32 PCM with
                        X-Sample-Format: f32le + X-Sample-Rate header)
                        query: ?language=en&task=transcribe&max_tokens=224
                               &timeout_s=30 (deadline -> status "timeout")
                               &async=1 (return {"id": N} immediately)
                        -> {"text": ..., "tokens": [...], "queue_ms": ...,
                            "status": "ok"|"cancelled"|"timeout"}
  POST /v1/audio/transcriptions  OpenAI-compatible (multipart form-data:
  POST /v1/audio/translations     file / language / response_format json|
                        text|verbose_json) — drop-in for Whisper API
                        clients; /translations runs the translate task
  GET  /v1/jobs/<id>    poll an async job -> result, or {"status":"pending"}
  POST /v1/cancel?id=N  abort a queued/in-flight request (Worker-protocol
                        Abort parity, reference: src/wasm/worker.rs:38)
  GET  /metrics         Prometheus text: slots, queue depth, completions,
                        tokens/sec (scheduler.stats(); SURVEY §5.5)
  GET  /healthz         -> {"status": "ok", "pending": N}

Streaming sessions (HTTP analog of the reference's WASM streaming-session
wrappers, src/wasm/mod.rs:1090-1560, over engine.create_streaming_session):
  POST   /v1/sessions                 ?language=en&rate=16000
                                      &latency=standard|low|ultra
                                      -> {"session": id}
  POST   /v1/sessions/<id>/audio      body: raw f32le at the session rate;
                                      -> {"queued_samples": n}
  GET    /v1/sessions/<id>/events     ?since=N -> {"events": [...],
                                      "next": N', "final": text|null}
  POST   /v1/sessions/<id>/finalize   flush -> final event + "final" text
  DELETE /v1/sessions/<id>            drop the session

Audio is pumped into the session state machine (VAD, chunking, partials)
on the DEVICE-LOOP thread between scheduler ticks, so session decodes
never race batch decodes on the device.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..audio import SAMPLE_RATE, parse_wav
from ..audio.resample import SincResampler
from ..parallel.serving import BatchScheduler


class _HttpSession:
    """One HTTP streaming session: an inbox of raw audio chunks (filled by
    handler threads) plus the events the device-loop pump emitted."""

    def __init__(self, session) -> None:
        self.session = session  # engine-level StreamingSession
        self.inbox: "queue.Queue[np.ndarray]" = queue.Queue()
        self.events: list = []  # [{"kind", "text", "time"}] append-only
        self.final: Optional[str] = None
        self.finalize_requested = False
        self.last_touch = time.time()


def _parse_multipart(content_type: str, body: bytes) -> dict:
    """Parse a multipart/form-data body into {field-name: bytes} using the
    stdlib email parser (the cgi module is gone in 3.13)."""
    import email.parser
    import email.policy

    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1") + b"\r\n\r\n"
        + body)
    if not msg.is_multipart():
        raise ValueError("expected multipart/form-data")
    fields = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name:
            fields[name] = part.get_payload(decode=True)
    return fields


def _decode_body(handler: BaseHTTPRequestHandler, body: bytes) -> np.ndarray:
    fmt = handler.headers.get("X-Sample-Format", "wav")
    if fmt == "f32le":
        rate = int(handler.headers.get("X-Sample-Rate", SAMPLE_RATE))
        samples = np.frombuffer(body, dtype="<f4").astype(np.float32)
    else:
        samples, rate = parse_wav(body)
    if rate != SAMPLE_RATE:
        samples = SincResampler(rate, SAMPLE_RATE).resample(samples)
    return samples


class TranscribeServer:
    """HTTP front end + main-thread device loop."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 8000,
                 n_slots: int = 8, single_thread: bool = False,
                 batched_admission: bool = True) -> None:
        self.engine = engine
        self.scheduler = BatchScheduler(engine, n_slots=n_slots,
                                        batched_admission=batched_admission)
        self.host = host
        self.port = port
        self.single_thread = single_thread
        self._httpd = None
        self._stop = threading.Event()
        # streaming sessions: id -> _HttpSession; mutated only under the
        # lock; audio pumped on the device-loop thread (_pump_sessions)
        self._sessions = {}
        self._session_lock = threading.Lock()
        self._next_session = 0
        self.session_idle_timeout = 600.0

    # -- streaming sessions ---------------------------------------------------
    def _create_session(self, language: str, rate: int,
                        latency: str) -> int:
        from ..audio.streaming import StreamingConfig
        from ..engine import TranscribeOptions

        if latency == "low":
            scfg = StreamingConfig.low_latency()
        elif latency == "ultra":
            scfg = StreamingConfig.ultra_low_latency()
        else:
            scfg = StreamingConfig()
        scfg = dataclasses.replace(scfg, input_sample_rate=rate)
        sess = self.engine.create_streaming_session(
            TranscribeOptions(language=language), rate, config=scfg)
        with self._session_lock:
            sid = self._next_session
            self._next_session += 1
            self._sessions[sid] = _HttpSession(sess)
        return sid

    def _get_session(self, sid_str: str, handler):
        """Resolve a session id from a path segment; answers 400/404 and
        returns None when it can't."""
        try:
            sid = int(sid_str)
        except ValueError:
            handler._json(400, {"error": "bad session id"})
            return None
        with self._session_lock:
            hs = self._sessions.get(sid)
        if hs is None:
            handler._json(404, {"error": "unknown session"})
        return hs

    def _pump_sessions(self) -> None:
        """Drain session inboxes through the streaming state machines.
        Runs ONLY on the device-loop thread (or inline in single-thread
        mode), so session decodes serialize with scheduler ticks."""
        with self._session_lock:
            items = list(self._sessions.items())
        now = time.time()
        for sid, hs in items:
            try:
                while True:
                    try:
                        chunk = hs.inbox.get_nowait()
                    except queue.Empty:
                        break
                    for r in hs.session.push(chunk):
                        hs.events.append({"kind": r.kind, "text": r.text,
                                          "time": r.time})
                if hs.finalize_requested and hs.final is None:
                    hs.final = hs.session.finalize()
                    hs.events.append({"kind": "final", "text": hs.final,
                                      "time": 0.0})
            except Exception as e:  # noqa: BLE001 — surface to the client
                hs.events.append({"kind": "error", "text": str(e),
                                  "time": 0.0})
                if hs.final is None:
                    hs.final = ""
            if now - hs.last_touch > self.session_idle_timeout:
                with self._session_lock:
                    self._sessions.pop(sid, None)

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _json(self, code: int, payload: dict) -> None:
                data = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _wait(self, rid, timeout=300.0):
                """Poll for a completion, pumping the device loop inline in
                single-thread mode; None on timeout."""
                deadline = time.time() + timeout
                while time.time() < deadline:
                    if server.single_thread:
                        server.scheduler.step()
                    comp = server.scheduler.result(rid)
                    if comp is not None:
                        return comp
                    time.sleep(0.005)
                return None

            def _completion_payload(self, comp) -> dict:
                text = (server.scheduler.decode_text(comp)
                        if comp.tokens else "")
                return {
                    "text": text,
                    "tokens": comp.tokens,
                    "queue_ms": round(comp.queue_seconds * 1e3, 1),
                    "decode_ms": round(comp.decode_seconds * 1e3, 1),
                    "status": comp.status,
                }

            def do_GET(self):
                if self.path.startswith("/healthz"):
                    self._json(200, {"status": "ok",
                                     "pending": server.scheduler.pending()})
                elif self.path.startswith("/metrics"):
                    stats = server.scheduler.stats()
                    lines = []
                    for key, val in sorted(stats.items()):
                        name = f"whisper_apr_{key}"
                        kind = ("gauge" if key in (
                            "queue_depth", "active_slots", "n_slots",
                            "tokens_per_decode_second") else "counter")
                        lines.append(f"# TYPE {name} {kind}")
                        lines.append(f"{name} {val}")
                    data = ("\n".join(lines) + "\n").encode("utf-8")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/v1/sessions/"):
                    parsed = urllib.parse.urlparse(self.path)
                    parts = parsed.path.strip("/").split("/")
                    # /v1/sessions/<id>/events
                    if len(parts) != 4 or parts[3] != "events":
                        self._json(404, {"error": "not found"})
                        return
                    hs = server._get_session(parts[2], self)
                    if hs is None:
                        return
                    if server.single_thread:
                        server._pump_sessions()
                    q = urllib.parse.parse_qs(parsed.query)
                    since = int(q.get("since", ["0"])[0])
                    events = hs.events[since:]
                    hs.last_touch = time.time()
                    self._json(200, {"events": events,
                                     "next": since + len(events),
                                     "final": hs.final})
                elif self.path.startswith("/v1/jobs/"):
                    try:
                        rid = int(self.path.rsplit("/", 1)[1])
                    except ValueError:
                        self._json(400, {"error": "bad job id"})
                        return
                    if server.single_thread:
                        server.scheduler.step()
                    comp = server.scheduler.result(rid)
                    if comp is not None:
                        self._json(200, self._completion_payload(comp))
                    elif rid < server.scheduler._next_id:
                        self._json(200, {"status": "pending"})
                    else:
                        self._json(404, {"error": "unknown job"})
                else:
                    self._json(404, {"error": "not found"})

            def do_DELETE(self):
                parts = self.path.strip("/").split("/")
                if len(parts) == 3 and parts[:2] == ["v1", "sessions"]:
                    hs = server._get_session(parts[2], self)
                    if hs is None:
                        return
                    with server._session_lock:
                        server._sessions = {
                            k: v for k, v in server._sessions.items()
                            if v is not hs}
                    self._json(200, {"deleted": True})
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                parsed = urllib.parse.urlparse(self.path)
                q = urllib.parse.parse_qs(parsed.query)
                if parsed.path == "/v1/sessions":
                    try:
                        sid = server._create_session(
                            q.get("language", ["en"])[0],
                            int(q.get("rate", [str(SAMPLE_RATE)])[0]),
                            q.get("latency", ["standard"])[0])
                        self._json(201, {"session": sid})
                    except Exception as e:  # noqa: BLE001 - HTTP boundary
                        self._json(400, {"error": str(e)})
                    return
                if parsed.path.startswith("/v1/sessions/"):
                    parts = parsed.path.strip("/").split("/")
                    if len(parts) != 4 or parts[3] not in ("audio",
                                                           "finalize"):
                        self._json(404, {"error": "not found"})
                        return
                    hs = server._get_session(parts[2], self)
                    if hs is None:
                        return
                    hs.last_touch = time.time()
                    if parts[3] == "audio":
                        length = int(self.headers.get("Content-Length", 0))
                        body = self.rfile.read(length)
                        samples = np.frombuffer(
                            body, dtype="<f4").astype(np.float32)
                        hs.inbox.put(samples)
                        if server.single_thread:
                            server._pump_sessions()
                        self._json(200, {"queued_samples": len(samples)})
                    else:
                        hs.finalize_requested = True
                        if server.single_thread:
                            server._pump_sessions()
                        self._json(202, {"status": "finalizing"})
                    return
                if parsed.path in ("/v1/audio/transcriptions",
                                   "/v1/audio/translations"):
                    # OpenAI-compatible endpoints (drop-in for existing
                    # Whisper API clients; whisper.cpp's server exposes
                    # the same surface): multipart fields file / language /
                    # response_format (json | text | verbose_json);
                    # /translations runs the translate task (-> English)
                    task = ("translate" if parsed.path.endswith("translations")
                            else "transcribe")
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                        body = self.rfile.read(length)
                        ctype = self.headers.get("Content-Type", "")
                        if not ctype.startswith("multipart/form-data"):
                            raise ValueError("expected multipart/form-data")
                        fields = _parse_multipart(ctype, body)
                        if "file" not in fields:
                            raise ValueError("missing 'file' field")
                        samples, rate = parse_wav(fields["file"])
                        if rate != SAMPLE_RATE:
                            samples = SincResampler(
                                rate, SAMPLE_RATE).resample(samples)
                        lang = (fields.get("language") or b"en").decode()
                        fmt = (fields.get("response_format")
                               or b"json").decode()
                    except Exception as e:  # noqa: BLE001 - HTTP boundary
                        self._json(400, {"error": str(e)})
                        return
                    rid = server.scheduler.submit(samples, lang, task)
                    comp = self._wait(rid)
                    if comp is None:
                        self._json(504, {"error": "decode timeout"})
                        return
                    text = (server.scheduler.decode_text(comp)
                            if comp.tokens else "")
                    if fmt == "text":
                        data = (text + "\n").encode("utf-8")
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/plain; charset=utf-8")
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                    elif fmt == "verbose_json":
                        self._json(200, {
                            "task": task, "language": lang,
                            "duration": len(samples) / SAMPLE_RATE,
                            "text": text, "segments": []})
                    else:
                        self._json(200, {"text": text})
                    return
                if parsed.path == "/v1/cancel":
                    try:
                        rid = int(q.get("id", [""])[0])
                    except ValueError:
                        self._json(400, {"error": "bad or missing id"})
                        return
                    ok = server.scheduler.cancel(rid)
                    self._json(200, {"id": rid, "cancelled": ok})
                    return
                if parsed.path != "/v1/transcribe":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    audio = _decode_body(self, body)
                    lang = q.get("language", ["en"])[0]
                    task = q.get("task", ["transcribe"])[0]
                    max_tokens = int(q.get("max_tokens", ["224"])[0])
                    timeout_s = q.get("timeout_s", [None])[0]
                    timeout_s = float(timeout_s) if timeout_s else None
                    rid = server.scheduler.submit(
                        audio, lang, task, max_tokens, timeout_s=timeout_s)
                    if q.get("async", ["0"])[0] in ("1", "true"):
                        self._json(202, {"id": rid, "status": "pending"})
                        return
                    # single-thread mode pumps the device loop inline in _wait
                    comp = self._wait(rid)
                    if comp is not None:
                        self._json(200, self._completion_payload(comp))
                        return
                    self._json(504, {"error": "decode timeout"})
                except Exception as e:  # noqa: BLE001 - HTTP boundary
                    self._json(400, {"error": str(e)})

        return Handler

    def serve_forever(self) -> None:
        """Threaded mode: HTTP handlers on worker threads, device loop on
        THIS thread. Single-thread mode: one serial HTTP server whose
        handlers pump the device loop inline, so that one Python thread
        does everything. ``port=0`` binds a free port; the address bound
        is ``self._httpd.server_address`` once serving."""
        if self.single_thread:
            from http.server import HTTPServer
            self._httpd = HTTPServer((self.host, self.port),
                                     self._make_handler())
            print(f"serving on http://{self.host}:"
                  f"{self._httpd.server_address[1]} "
                  f"({self.scheduler.n_slots} slots, single-thread)")
            try:
                while not self._stop.is_set():
                    self._httpd.handle_request()
            finally:
                self._httpd.server_close()
            return
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        http_thread.start()
        print(f"serving on http://{self.host}:"
              f"{self._httpd.server_address[1]} "
              f"({self.scheduler.n_slots} slots)")
        try:
            while not self._stop.is_set():
                idle = self.scheduler.step() == 0
                self._pump_sessions()
                if idle:
                    time.sleep(0.002)
        finally:
            self._httpd.shutdown()
            self._httpd.server_close()

    def shutdown(self) -> None:
        self._stop.set()


def run_serve(args) -> int:
    from .commands import _load_engine
    engine = _load_engine(args)
    server = TranscribeServer(
        engine, host=args.host, port=args.port, n_slots=args.slots,
        single_thread=args.single_thread,
        batched_admission=not getattr(args, "staged_admission", False))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0
