"""The port's HTTP server (``whisper_apr_tpu_torch.cli.serve``) against
the JAX package's, on the CPU.

A JAX ``TranscribeServer`` and a port ``TranscribeServer``, each over its
CLI's ``--fp32`` engine of the same f32 ``.apr`` (``test_torch_cli.
write_model``; the port's on the CPU), get the same requests in the same
order, threaded and ``--single-thread``, each bound to a free port. The
bodies of completed requests must be equal but for ``queue_ms`` and
``decode_ms``; for a cancel or a timeout, whose tokens depend on timing,
the status codes and the statuses; Prometheus names and counters; session
events; every 400 and 404 body.
"""

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_cli import bursts, speech_like, write_model
from whisper_apr_tpu.cli import commands as jcommands
from whisper_apr_tpu.cli.serve import TranscribeServer as JServer
from whisper_apr_tpu_torch.audio.wav import write_wav
from whisper_apr_tpu_torch.cli import commands as tcommands
from whisper_apr_tpu_torch.cli.serve import TranscribeServer as TServer

REPO = Path(__file__).resolve().parent.parent
TIMING = ("queue_ms", "decode_ms")
# the port scheduler's counters that the JAX scheduler lacks
PORT_COUNTERS = ("admit_rows", "admit_rows_padded", "admit_seconds_sum",
                 "tick_live_rows", "tick_rows", "wait_seconds_sum")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("serve") / "m.apr"))


def _engine_args(model, **kw):
    return argparse.Namespace(model=model, fp32=True, flash_attn=False,
                              verbose=False, **kw)


@pytest.fixture(scope="module")
def engines(model):
    return (jcommands._load_engine(_engine_args(model)),
            tcommands._load_engine(_engine_args(model, device="cpu")))


def wav_bytes(audio: np.ndarray, sr: int, tmp: Path) -> bytes:
    path = tmp / f"clip_{sr}.wav"
    write_wav(str(path), audio, sr)
    return path.read_bytes()


def multipart(fields: dict, boundary: str = "b0undary") -> tuple:
    """(content type, body) of a multipart/form-data request."""
    out = b""
    for name, value in fields.items():
        out += f"--{boundary}\r\n".encode()
        if name == "file":
            out += (b'Content-Disposition: form-data; name="file"; '
                    b'filename="a.wav"\r\nContent-Type: audio/wav\r\n\r\n')
        else:
            out += (f'Content-Disposition: form-data; name="{name}"'
                    f"\r\n\r\n").encode()
            value = value.encode()
        out += value + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return f"multipart/form-data; boundary={boundary}", out


class Served:
    """A TranscribeServer serving on a free port from a thread of its
    own (which is then the device-loop thread)."""

    def __init__(self, cls, engine, single_thread: bool, n_slots: int = 2):
        self.server = cls(engine, port=0, n_slots=n_slots,
                          single_thread=single_thread)
        self.single_thread = single_thread
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        deadline = time.time() + 60
        while self.server._httpd is None and time.time() < deadline:
            time.sleep(0.01)
        self.base = (f"http://127.0.0.1:"
                     f"{self.server._httpd.server_address[1]}")

    def call(self, method: str, path: str, body: bytes = None,
             headers: dict = None) -> tuple:
        """(status code, content type, raw body)."""
        req = urllib.request.Request(self.base + path, data=body,
                                     headers=headers or {}, method=method)
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.headers["Content-Type"], r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers["Content-Type"], e.read()

    def json(self, method, path, body=None, headers=None) -> tuple:
        code, _, data = self.call(method, path, body, headers)
        return code, json.loads(data)

    def poll(self, path: str, until) -> dict:
        deadline = time.time() + 120
        while time.time() < deadline:
            code, out = self.json("GET", path)
            assert code == 200, out
            if until(out):
                return out
            time.sleep(0.02)
        raise AssertionError(f"{path}: no answer in time")

    def close(self) -> None:
        self.server.shutdown()
        if self.single_thread:
            # wake a blocked handle_request; a loop that saw the stop
            # first has closed the socket already (refused), or closes it
            # with this connection still in its backlog (reset)
            with contextlib.suppress(urllib.error.URLError,
                                     ConnectionResetError):
                self.call("GET", "/healthz")
        self.thread.join(timeout=60)
        assert not self.thread.is_alive()


def completed(out: dict) -> dict:
    return {k: v for k, v in out.items() if k not in TIMING}


def script(srv: Served, clips: dict) -> list:
    """The requests, in order; what each answered, timing removed."""
    log = []
    f32 = {"X-Sample-Format": "f32le"}
    log.append(("healthz", srv.json("GET", "/healthz")))

    # synchronous transcriptions: f32le, WAV at 16 and 44.1 kHz, translate
    for label, path, body, headers in (
            ("f32le", "/v1/transcribe?language=en&max_tokens=12",
             clips["one"].astype("<f4").tobytes(), f32),
            ("f32le 8k rate", "/v1/transcribe?language=en&max_tokens=8",
             clips["one"][::2].astype("<f4").tobytes(),
             {**f32, "X-Sample-Rate": "8000"}),
            ("wav 16k", "/v1/transcribe?max_tokens=12&language=en",
             clips["wav16"], {}),
            ("wav 44.1k", "/v1/transcribe?language=en&max_tokens=12",
             clips["wav44"], {}),
            ("translate", "/v1/transcribe?language=de&task=translate"
             "&max_tokens=10", clips["wav16"], {})):
        code, out = srv.json("POST", path, body, headers)
        assert code == 200 and out["status"] == "ok", (label, out)
        assert all(out[k] >= 0 for k in TIMING)
        log.append((label, code, completed(out)))

    # OpenAI-compatible multipart routes
    for route, fmt in (("transcriptions", "json"), ("transcriptions", "text"),
                       ("transcriptions", "verbose_json"),
                       ("translations", "json")):
        ctype, body = multipart({"file": clips["wav44"], "language": "en",
                                 "response_format": fmt})
        log.append((f"{route} {fmt}", srv.call(
            "POST", f"/v1/audio/{route}", body, {"Content-Type": ctype})))

    # async with a poll; a cancelled request queued behind two long ones
    code, out = srv.json("POST", "/v1/transcribe?language=en&max_tokens=12"
                         "&async=1", clips["wav16"])
    assert code == 202 and out["status"] == "pending"
    rid = out["id"]
    log.append(("async", code, out))
    log.append(("job", completed(srv.poll(
        f"/v1/jobs/{rid}", lambda o: o["status"] != "pending"))))
    ids = [srv.json("POST", "/v1/transcribe?language=en&max_tokens=24"
                    "&async=1", clips["wav16"])[1]["id"] for _ in range(3)]
    log.append(("cancel", srv.json("POST", f"/v1/cancel?id={ids[2]}",
                                   b"")))
    done = srv.poll(f"/v1/jobs/{ids[2]}",
                    lambda o: o["status"] != "pending")
    log.append(("cancelled", done["status"]))
    for i in ids[:2]:
        log.append(("long job", completed(srv.poll(
            f"/v1/jobs/{i}", lambda o: o["status"] != "pending"))))

    # a deadline already past: the status and the code, not the tokens
    code, out = srv.json("POST", "/v1/transcribe?language=en&max_tokens=12"
                         "&timeout_s=0.000001", clips["wav16"])
    log.append(("timeout", code, out["status"]))

    # a streaming session: audio in 0.5 s blocks, finalize, delete
    code, out = srv.json("POST", "/v1/sessions?language=en&rate=16000")
    log.append(("session", code, out))
    sid = out["session"]
    audio = clips["burst"]
    for i in range(0, len(audio), 8000):
        log.append(("audio", srv.json(
            "POST", f"/v1/sessions/{sid}/audio",
            audio[i:i + 8000].astype("<f4").tobytes())))
    log.append(("finalize", srv.json("POST",
                                     f"/v1/sessions/{sid}/finalize", b"")))
    ev = srv.poll(f"/v1/sessions/{sid}/events?since=0",
                  lambda o: o["final"] is not None)
    assert not [e for e in ev["events"] if e["kind"] == "error"], ev
    assert ev["events"][-1]["kind"] == "final" and ev["final"], ev
    log.append(("events", ev))
    log.append(("events since", srv.json(
        "GET", f"/v1/sessions/{sid}/events?since={ev['next'] - 1}")))
    log.append(("delete", srv.json("DELETE", f"/v1/sessions/{sid}")))

    # the 400 and 404 paths
    ctype, no_file = multipart({"language": "en"})
    for method, path, body, headers in (
            ("GET", f"/v1/sessions/{sid}/events", None, {}),
            ("DELETE", f"/v1/sessions/{sid}", None, {}),
            ("POST", f"/v1/sessions/{sid}/audio", b"\0" * 8, {}),
            ("GET", "/v1/sessions/abc/events", None, {}),
            ("GET", "/v1/sessions/0/nope", None, {}),
            ("POST", "/v1/sessions/0/nope", b"", {}),
            ("POST", "/v1/sessions?rate=fast", b"", {}),
            ("GET", "/v1/jobs/abc", None, {}),
            ("GET", "/v1/jobs/99999", None, {}),
            ("POST", "/v1/cancel?id=x", b"", {}),
            ("POST", "/v1/cancel", b"", {}),
            ("POST", "/v1/transcribe", b"RIFFxxxx", {}),
            ("POST", "/v1/transcribe?max_tokens=many", b"\0" * 8, f32),
            ("POST", "/v1/audio/transcriptions", b"x",
             {"Content-Type": "application/json"}),
            ("POST", "/v1/audio/transcriptions", no_file,
             {"Content-Type": ctype}),
            ("POST", "/nope", b"x", {}),
            ("GET", "/nope", None, {}),
            ("DELETE", "/v1/nope", None, {})):
        log.append((f"{method} {path}", srv.call(method, path, body,
                                                 headers)))

    # Prometheus text: every name and type, and the counts
    code, ctype, data = srv.call("GET", "/metrics")
    lines = data.decode().splitlines()
    types = [l for l in lines if l.startswith("# TYPE")]
    srv.port_only = [l for l in types
                     if l.split()[2][len("whisper_apr_"):] in PORT_COUNTERS]
    types = [l for l in types if l not in srv.port_only]
    values = dict(l.split() for l in lines if not l.startswith("#"))
    counts = {k: values[f"whisper_apr_{k}"] for k in (
        "completed_ok", "cancelled", "timeout", "completed_total",
        "admitted", "queue_depth", "active_slots", "n_slots")}
    log.append(("metrics", code, ctype, types, counts))
    log.append(("healthz after", srv.json("GET", "/healthz")))
    return log


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clips")
    one = speech_like(1.0, seed=0)
    return {"one": one, "wav16": wav_bytes(speech_like(1.0, seed=2), 16_000,
                                           tmp),
            "wav44": wav_bytes(speech_like(1.0, seed=4, sr=44_100), 44_100,
                               tmp),
            "burst": bursts(seed=5)}


@pytest.mark.parametrize("single_thread", [False, True],
                         ids=["threaded", "single_thread"])
def test_server_answers_equal_jax(engines, clips, single_thread):
    logs, port_only = [], []
    for cls, eng in zip((JServer, TServer), engines):
        srv = Served(cls, eng, single_thread)
        try:
            logs.append(script(srv, clips))
            port_only.append(srv.port_only)
        finally:
            srv.close()
    jlog, tlog = logs
    assert port_only == [[], [f"# TYPE whisper_apr_{k} counter"
                              for k in PORT_COUNTERS]]
    assert [entry[0] for entry in tlog] == [entry[0] for entry in jlog]
    for j, t in zip(jlog, tlog):
        assert t == j, t[0]
    metrics = dict((e[0], e) for e in tlog)["metrics"]
    assert metrics[4]["completed_ok"] == "12"
    assert metrics[4]["cancelled"] == "1" and metrics[4]["timeout"] == "1"


def test_server_binds_a_free_port(engines):
    a = Served(TServer, engines[1], single_thread=False)
    b = Served(TServer, engines[1], single_thread=True)
    try:
        assert a.base != b.base
        assert a.json("GET", "/healthz") == b.json("GET", "/healthz") == (
            200, {"status": "ok", "pending": 0})
    finally:
        a.close()
        b.close()


def test_handler_threads_touch_no_device_state(engines, clips):
    """In threaded mode every decode runs on the serve_forever thread:
    the scheduler's step and the sessions' pushes are spied on."""
    srv = Served(TServer, engines[1], single_thread=False)
    seen = set()
    real_step = srv.server.scheduler.step

    def step():
        seen.add(threading.get_ident())
        return real_step()
    srv.server.scheduler.step = step
    try:
        code, out = srv.json("POST", "/v1/transcribe?language=en"
                             "&max_tokens=6", clips["wav16"])
        assert code == 200 and out["status"] == "ok"
        code, out = srv.json("POST", "/v1/sessions?language=en&rate=16000")
        sid = out["session"]
        session = srv.server._sessions[sid].session
        real_push = session.push

        def push(chunk):
            seen.add(threading.get_ident())
            return real_push(chunk)
        session.push = push
        srv.json("POST", f"/v1/sessions/{sid}/audio",
                 clips["burst"][:16000].astype("<f4").tobytes())
        srv.json("POST", f"/v1/sessions/{sid}/finalize", b"")
        srv.poll(f"/v1/sessions/{sid}/events",
                 lambda o: o["final"] is not None)
    finally:
        srv.close()
    assert seen == {srv.thread.ident}


def test_cli_serve_subprocess(model, clips):
    """``python -m whisper_apr_tpu_torch.cli serve --port 0 --device cpu``
    prints the port it bound, answers, and exits 0 on SIGINT."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "whisper_apr_tpu_torch.cli", "serve", "-m",
         model, "--device", "cpu", "--fp32", "--port", "0", "--slots", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"})
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), line
        base = line.split()[2]
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert json.loads(r.read()) == {"status": "ok", "pending": 0}
        req = urllib.request.Request(
            base + "/v1/transcribe?language=en&max_tokens=6",
            data=clips["wav16"])
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read())["status"] == "ok"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
