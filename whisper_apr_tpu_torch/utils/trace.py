"""Tracing and profiling hooks (port of the JAX package's
``utils/trace.py``).

``trace_span(name)`` records a host wall-time event ``(name, start,
duration)`` when tracing is on (``WHISPER_APR_TRACE`` set, or
``enable_tracing()``), and marks the span for the profilers: a
``torch.profiler.record_function`` range (``torch.profiler`` traces) and,
with a card, an NVTX range (Nsight). Where JAX added a ``named_scope``,
these take its place. ``profile(log_dir)`` wraps ``torch.profiler.profile``
(CPU, and CUDA with a card) and writes a Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Tuple

import torch

_ENABLED = os.environ.get("WHISPER_APR_TRACE", "") not in ("", "0", "false")
_EVENTS: List[Tuple[str, float, float]] = []  # (name, start, duration)


def enable_tracing(enabled: bool = True) -> None:
    global _ENABLED
    _ENABLED = enabled


def tracing_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """A named range for the profilers plus a host wall-time event."""
    if not _ENABLED:
        yield
        return
    nvtx = torch.cuda.is_available()
    start = time.perf_counter()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
    _EVENTS.append((name, start, time.perf_counter() - start))


def trace_event(name: str) -> None:
    """A point event."""
    if _ENABLED:
        _EVENTS.append((name, time.perf_counter(), 0.0))


def drain_events() -> List[Tuple[str, float, float]]:
    global _EVENTS
    ev, _EVENTS = _EVENTS, []
    return ev


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU, and CUDA when there is a card) and write
    ``log_dir/trace.json``, a Chrome trace (Perfetto, chrome://tracing)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
