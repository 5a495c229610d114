"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over a few
steps in the middle of the measured window, reduced to what the per-layer
metrics read.

Each device operation is attributed to the benchmark ranges
(``bench.*``, placed by ``port.Spans`` and the drivers) that were open on
the host when it was launched: the profiler links every kernel to the
innermost host event open at its launch, and that event's start time
lies inside the ranges that enclose it. Busy time is the union of the
device operations' intervals; an idle gap is labelled by the innermost
range open on the host at its middle.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

PREFIX = "bench."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    # device seconds launched inside each range (the range and every range
    # it encloses)
    range_device_s: Dict[str, float]
    # per label, device seconds by operation name
    range_ops: Dict[str, Dict[str, float]]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    idle_by_label: Dict[str, float]


class Tracer:
    """``start()`` / ``stop()`` around the traced steps; ``warm()`` in
    set-up opens the profiler once so that its start in the window is
    quick."""

    def __init__(self) -> None:
        self.prof = None
        self._range = None

    @staticmethod
    def _activities():
        return [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]

    def warm(self) -> None:
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.__enter__()
        self._range = torch.profiler.record_function(PREFIX + "window")
        self._range.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summary(self, labels: Dict[str, str]) -> Optional[Summary]:
        """Reduce the trace; ``labels`` names the idle gaps by range
        (``bench.tick`` -> "tick"). None if no device operation was
        recorded."""
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             labels)


def short(name: str) -> str:
    """A kernel's name without its trailing parameter list (template
    arguments kept)."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if "::" in name[:i] else name
    return name


def _activity(ev) -> str:
    try:
        a = ev.activity_type()
    except AttributeError:
        return "kernel"
    return a if isinstance(a, str) else "kernel"


def reduce_events(events, labels: Dict[str, str]) -> Optional[Summary]:
    from torch.autograd import DeviceType
    ranges = collections.defaultdict(list)      # label -> [(start, end)]
    front: Dict[int, int] = {}                  # frontend id -> start ns
    dev = []                                    # (start, end, name, linked)
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if ev.linked_correlation_id() == 0:
                front[ev.correlation_id()] = ev.start_ns()
            if name.startswith(PREFIX):
                ranges[name].append((ev.start_ns(), ev.end_ns()))
        elif not name.startswith(PREFIX) and _activity(ev) in DEVICE_KINDS:
            dev.append((ev.start_ns(), ev.end_ns(), name,
                        ev.linked_correlation_id()))
    win = ranges.get(PREFIX + "window")
    if not dev or not win:
        return None
    w0, w1 = win[0]
    dev.sort()
    # busy: union of the device intervals inside the window
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, _, _ in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if cur_e is None:
            cur_s, cur_e = s, e
            if s > w0:
                gaps.append((w0, s))
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))

    spans = {k: (np.array([a for a, _ in sorted(v)], np.int64),
                 np.array([b for _, b in sorted(v)], np.int64))
             for k, v in ranges.items() if k != PREFIX + "window"}

    def inside(label: str, t: int) -> Optional[int]:
        starts, ends = spans[label]
        i = bisect.bisect_right(starts, t) - 1
        return int(starts[i]) if i >= 0 and t <= ends[i] else None

    range_s = collections.Counter()
    range_ops: Dict[str, Dict[str, float]] = collections.defaultdict(
        collections.Counter)
    ops = collections.Counter()
    launch = np.array([front.get(l, s) for s, _, _, l in dev], np.int64)
    durs = np.array([min(e, w1) - max(s, w0) for s, e, _, _ in dev],
                    np.int64).clip(min=0)
    for label, (starts, ends) in spans.items():
        i = np.searchsorted(starts, launch, side="right") - 1
        ok = (i >= 0) & (launch <= ends[np.maximum(i, 0)])
        range_s[label] = float(durs[ok].sum()) / 1e9
        for j in np.flatnonzero(ok):
            range_ops[label][dev[j][2]] += durs[j] / 1e9
    for (_, _, name, _), d in zip(dev, durs):
        ops[short(name)] += d / 1e9

    def gap_label(t: int) -> str:
        best, best_start = "outside", -1
        for label in spans:
            s = inside(label, t)
            if s is not None and s > best_start:
                best, best_start = labels.get(label, label), s
        return best

    labelled = [(gap_label((a + b) // 2), (b - a) / 1e9) for a, b in gaps]
    by_label = collections.Counter()
    for lab, d in labelled:
        by_label[lab] += d
    labelled.sort(key=lambda x: -x[1])
    return Summary(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
        range_device_s=dict(range_s),
        range_ops={k: dict(v) for k, v in range_ops.items()},
        device_ops=ops.most_common(10), idle_gaps=labelled[:10],
        idle_by_label=dict(by_label))
