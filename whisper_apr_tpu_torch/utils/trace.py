"""The port's tracing: named host spans at its layer boundaries, kept in
memory and marked for the profilers.

Tracing is on when ``WHISPER_APR_TRACE`` is set (not "", "0", "false")
or after ``enable_tracing()``. Then ``trace_span(name, **attrs)``:

- records a ``Span``: its name, its start and end on
  ``time.perf_counter_ns()``, its id, the id of its parent (the span open
  on the same thread when it opened; -1 at the top) and its attributes
  (request ids, row counts; ``annotate`` adds more to the innermost open
  span);
- opens a ``torch.profiler.record_function`` range named ``PREFIX +
  name`` (``wa.serve.admit``) while a profiler runs, so a profiled run
  has the program's spans on the profiler's clock beside the device
  operations. Under ``torch.autograd.profiler.emit_nvtx()`` every such
  range is also an NVTX range, for an operator running Nsight. With no
  profiler running the range is skipped: it would cost more than the
  record.

Off, ``trace_span`` returns one shared null context: a span costs one
module-global test and allocates nothing beyond the call.

Records go into a bounded buffer (``MAX_RECORDS``, oldest out first);
``dropped()`` counts the records it pushed out. ``drain_records()``
empties it; ``drain_events()`` gives ``(name, start s, duration s)``,
the JAX package's form. ``enable_tracing()`` takes a clock anchor, the
tightest of a few ``(perf_counter_ns, time_ns)`` pairs, and
``epoch_ns(t)`` puts a ``perf_counter_ns`` time on the profiler's clock
(Unix-epoch ns, as a profiler event's ``start_ns()``), so a span kept
outside a profiled window can still be placed on a device trace.

The spans (parents before ``>``):

- serving, ``parallel/serving.py``: ``serve.step`` (attributes
  ``admitted``, ``live``) > ``serve.admit`` (``ids``, ``bucket``,
  ``padded``) > ``mel``, ``encode``, ``cross_kv``, ``prefill``,
  ``scatter``, ``admit.host``, ``sync``; ``serve.step`` > ``serve.tick``
  (``rows``, ``live``) > ``sync``; ``serve.step`` > ``serve.finish``;
- batch transcription, ``engine.transcribe_batch``: ``batch``
  (``windows``) > ``mel``, ``encode``, ``cross_kv``, ``prefill``,
  ``loop`` > ``loop.step`` > ``sync``, then ``batch.host`` > ``sync``;
- ``mel`` and ``encode`` are ``pipeline``'s, ``cross_kv`` is
  ``decoder.init_cache``'s and ``prefill`` ``decoder.prefill``'s (with
  ``check_tokens``' ``sync``), so every path through them has them;
- set-up: ``engine.init`` (``WhisperApr.__init__``), ``qdecode.prepare``
  (the first ``_qdecode``), ``kernels.load`` (``ops/_build.library()``,
  attribute ``build_s``), ``native.load`` (the host runtime's, ``build_s``);
- ``sync``: a device-to-host read, the host waiting for the card; so the
  wait is never counted as launch time.

``profile(log_dir)`` wraps ``torch.profiler.profile`` (CPU, and CUDA with
a card) and writes a Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Tuple

import torch

PREFIX = "wa."            # the program's record_function ranges
MAX_RECORDS = 1 << 17     # spans kept in memory


class Span(NamedTuple):
    name: str
    start_ns: int         # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: int           # id of the enclosing span on its thread, or -1
    attrs: Dict[str, object]


_ENABLED = os.environ.get("WHISPER_APR_TRACE", "") not in ("", "0", "false")
_RECORDS: "collections.deque[Span]" = collections.deque(maxlen=MAX_RECORDS)
_DROPPED = 0
_IDS = itertools.count()
_LOCK = threading.Lock()
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()
_ANCHOR_NS = 0            # time_ns() - perf_counter_ns()


def _take_anchor(pairs: int = 16) -> None:
    """``time_ns() - perf_counter_ns()`` from the tightest of ``pairs``
    bracketed reads."""
    global _ANCHOR_NS
    best = None
    for _ in range(pairs):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    _ANCHOR_NS = best[1]


def epoch_ns(perf_ns: int) -> int:
    """A ``perf_counter_ns`` time on the profiler's (Unix-epoch) clock."""
    return perf_ns + _ANCHOR_NS


def enable_tracing(enabled: bool = True) -> None:
    global _ENABLED
    if enabled:
        _take_anchor()
    _ENABLED = enabled


def tracing_enabled() -> bool:
    return _ENABLED


def _stack() -> List["_Open"]:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _Open:
    """An open span: its record_function range, and its record at exit."""

    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "_range")

    def __init__(self, name: str, attrs: Dict[str, object]) -> None:
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_Open":
        st = _stack()
        self.parent = st[-1].id if st else -1
        self.id = next(_IDS)
        st.append(self)
        self.start_ns = time.perf_counter_ns()
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        global _DROPPED
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        rec = Span(self.name, self.start_ns, end, self.id, self.parent,
                   self.attrs)
        with _LOCK:
            if len(_RECORDS) == _RECORDS.maxlen:
                _DROPPED += 1
            _RECORDS.append(rec)


def trace_span(name: str, **attrs):
    """A named span for the profilers and the in-memory records (module
    docstring); a shared null context while tracing is off."""
    if not _ENABLED:
        return _OFF
    return _Open(name, attrs)


def annotate(**attrs) -> None:
    """Add attributes to the innermost span open on this thread."""
    if _ENABLED:
        st = _stack()
        if st:
            st[-1].attrs.update(attrs)


def drain_records() -> List[Span]:
    """The records kept, oldest first; the buffer is emptied."""
    with _LOCK:
        out = list(_RECORDS)
        _RECORDS.clear()
    return out


def dropped() -> int:
    """Records pushed out of the full buffer since the process started."""
    return _DROPPED


def drain_events() -> List[Tuple[str, float, float]]:
    """``(name, start s, duration s)`` of each record, start on
    ``time.perf_counter()``; the buffer is emptied."""
    return [(r.name, r.start_ns / 1e9, (r.end_ns - r.start_ns) / 1e9)
            for r in drain_records()]


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


if _ENABLED:
    _take_anchor()
