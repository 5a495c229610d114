"""The program's own spans and counters, read beside a traced run.

    python3 -m perfbench.inside --workload <cell> --seed <n> --seconds <s>

From the root of a checkout, on the card. It makes the run that
``perfbench.run --trace 1`` makes (``harness.execute``, the same result
line and the same ``bench.*`` ranges), with the port's tracing
(``whisper_apr_tpu_torch/utils/trace.py``) enabled before set-up, and
then reads what the program recorded into a ``Program``, attached to the
run's ``Record`` as ``rec.program``:

- the span records (host time, ``time.perf_counter_ns()``), of which the
  host-time metrics read those over the measured steps or files and
  outside the profiled window, so the profiler's own cost is not in
  them; set-up spans are those that began before the window opened;
- the growth of the scheduler's ``stats()`` counters over the measured
  steps (serve cells);
- from the profiled window: the device seconds launched inside each of
  the program's ranges (``wa.*``), the idle time by the innermost
  program range open on the host, and each range's start against its
  in-memory record converted by the trace module's clock anchor.

The readers ``metrics/<name>.py`` of ``METRICS`` take that ``Record``
and return None where it has no ``program``, as the benchmark's own runs
leave it. The last line on standard output, after the run's own result
line, is ``{"inside": {metric: {"value", "unit"}}, "breakdown": host ms
by span, "setup_s_by_span": ..., "dropped": records lost to the bounded
buffer, "anchor": {"matched", "median_ms", "median_abs_ms"}}``, the
anchor's offsets in ms (in-memory start less profiler start).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import statistics
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import harness, spec
from . import trace as bench_trace
from .trace import DEVICE_KINDS, _activity

PROGRAM_PREFIX = "wa."
SETUP = ("engine.init", "qdecode.prepare", "kernels.load", "native.load")

METRICS = [
    {"name": "sched.wait_ms.serve", "unit": "ms"},
    {"name": "admit.pad_share.serve", "unit": "%"},
    {"name": "tick.live_share.serve", "unit": "%"},
    {"name": "admit.encode_ms.serve", "unit": "ms"},
    {"name": "admit.prefill_ms.serve", "unit": "ms"},
    {"name": "admit.sync_ms.serve", "unit": "ms"},
    {"name": "admit.device_ms.serve", "unit": "ms"},
    {"name": "tick.sync_ms.serve", "unit": "ms"},
    {"name": "loop.launch_us_per_step.longform", "unit": "us"},
    {"name": "setup.engine_s", "unit": "s"},
]


@dataclasses.dataclass
class Device:
    """The program's ranges in the profiled window."""

    range_s: Dict[str, float]          # device s launched inside, by name
    idle_s: Dict[str, float]           # idle s by innermost range open
    offsets_ns: List[int]              # in-memory start - profiler start


@dataclasses.dataclass
class Program:
    spans: list                        # trace.Span records, oldest first
    t_open_ns: int                     # the window's opening
    measured_ns: Tuple[int, int]       # the measured steps or files
    traced_ns: Optional[Tuple[int, int]]   # the profiled window
    counters: Dict[str, float]         # growth over the measured steps
    device: Optional[Device] = None

    def __post_init__(self) -> None:
        self._kids: Dict[int, list] = collections.defaultdict(list)
        self._by_id = {r.id: r for r in self.spans}
        for r in self.spans:
            self._kids[r.parent].append(r)

    def children(self, r) -> list:
        return self._kids.get(r.id, [])

    def descendants(self, r) -> list:
        out, todo = [], list(self.children(r))
        while todo:
            c = todo.pop()
            out.append(c)
            todo.extend(self.children(c))
        return out

    def ancestors(self, r) -> list:
        out = []
        while r.parent in self._by_id:
            r = self._by_id[r.parent]
            out.append(r)
        return out

    def measured(self, name: str) -> list:
        """Spans of ``name`` inside the measured steps and outside the
        profiled window."""
        a, b = self.measured_ns
        t = self.traced_ns
        return [r for r in self.spans if r.name == name
                and a <= r.start_ns and r.end_ns <= b
                and (t is None or r.end_ns <= t[0] or r.start_ns >= t[1])]

    def host_ns(self, r) -> int:
        """A span's time less its ``sync`` children (the host waiting for
        the card)."""
        return (r.end_ns - r.start_ns) - sum(
            c.end_ns - c.start_ns for c in self.children(r)
            if c.name == "sync")


def program_of(rec) -> Optional[Program]:
    return getattr(rec, "program", None)


def admission_ms(rec, names, nested: bool = False) -> Optional[float]:
    """Host ms of the spans named ``names`` under ``serve.admit`` (its
    children, less their ``sync`` children; or, ``nested``, every
    descendant whole), per request admitted, over the measured steps."""
    p = program_of(rec)
    if rec.kind != "serve" or p is None:
        return None
    admits = p.measured("serve.admit")
    n = sum(len(a.attrs.get("ids", ())) for a in admits)
    if not n:
        return None
    total = 0
    for a in admits:
        if nested:
            total += sum(d.end_ns - d.start_ns for d in p.descendants(a)
                         if d.name in names)
        else:
            total += sum(p.host_ns(c) for c in p.children(a)
                         if c.name in names)
    return total / 1e6 / n


def breakdown(p: Program) -> Dict[str, Dict[str, float]]:
    """Host ms by span over the measured stretch outside the profiled
    window: admission's children per request admitted (less their
    ``sync``; ``sync`` itself counted wherever it sits under
    ``serve.admit``); a tick's launches and its ``sync``; a greedy step's
    launches and its ``sync``; a batch's children per window."""
    out: Dict[str, Dict[str, float]] = {}

    def mean(spans, f):
        return sum(f(r) for r in spans) / 1e6 / len(spans)

    def children_ms(parents, per):
        got = collections.Counter()
        for a in parents:
            for c in p.children(a):
                got[c.name] += p.host_ns(c) / 1e6
            got["sync"] += sum(d.end_ns - d.start_ns for d in
                               p.descendants(a) if d.name == "sync") / 1e6
            got["self"] += (p.host_ns(a) - sum(
                c.end_ns - c.start_ns for c in p.children(a)
                if c.name != "sync")) / 1e6
        return {k: v / per for k, v in got.items()}
    admits = p.measured("serve.admit")
    n = sum(len(a.attrs.get("ids", ())) for a in admits)
    if n:
        out["admission_ms_per_request"] = children_ms(admits, n)
    for name in ("serve.tick", "loop.step"):
        spans = p.measured(name)
        if spans:
            out[name + "_ms"] = {
                "launch": mean(spans, p.host_ns),
                "sync": mean(spans, lambda r: (r.end_ns - r.start_ns)
                             - p.host_ns(r))}
    batches = p.measured("batch")
    w = sum(b.attrs.get("windows", 0) for b in batches)
    if w:
        out["batch_ms_per_window"] = children_ms(batches, w)
    return out


# -- the profiled window ------------------------------------------------------
def reduce_program(events, records, epoch_ns) -> Optional[Device]:
    """Device time by program range, idle time by the innermost program
    range, and the anchor's offsets, from the profiler's events; None
    without a device operation in the window."""
    from torch.autograd import DeviceType
    ranges = collections.defaultdict(list)      # name -> [(start, end)]
    front: Dict[int, int] = {}
    dev, win = [], None
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if ev.linked_correlation_id() == 0:
                front[ev.correlation_id()] = ev.start_ns()
            if name.startswith(PROGRAM_PREFIX):
                ranges[name[len(PROGRAM_PREFIX):]].append(
                    (ev.start_ns(), ev.end_ns()))
            elif name == "bench.window":
                win = (ev.start_ns(), ev.end_ns())
        elif not name.startswith((PROGRAM_PREFIX, "bench.")) \
                and _activity(ev) in DEVICE_KINDS:
            dev.append((ev.start_ns(), ev.end_ns(),
                        front.get(ev.linked_correlation_id(), ev.start_ns())))
    if not dev or win is None:
        return None
    w0, w1 = win
    dev.sort()
    gaps, cur = [], None
    for s, e, _ in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if cur is None:
            if s > w0:
                gaps.append((w0, s))
            cur = e
        elif s > cur:
            gaps.append((cur, s))
            cur = e
        else:
            cur = max(cur, e)
    if cur is not None and cur < w1:
        gaps.append((cur, w1))
    launch = np.array([l for _, _, l in dev], np.int64)
    durs = np.array([min(e, w1) - max(s, w0) for s, e, _ in dev],
                    np.int64).clip(min=0)
    range_s, spans = {}, {}
    for name, v in ranges.items():
        v.sort()
        starts = np.array([a for a, _ in v], np.int64)
        ends = np.array([b for _, b in v], np.int64)
        spans[name] = (starts, ends)
        i = np.searchsorted(starts, launch, side="right") - 1
        ok = (i >= 0) & (launch <= ends[np.maximum(i, 0)])
        range_s[name] = float(durs[ok].sum()) / 1e9
    idle = collections.Counter()
    for a, b in gaps:
        t, best, best_start = (a + b) // 2, "outside", -1
        for name, (starts, ends) in spans.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ends[i] and starts[i] > best_start:
                best, best_start = name, int(starts[i])
        idle[best] += (b - a) / 1e9
    offsets = []
    mine = collections.defaultdict(list)
    for r in records:
        t = epoch_ns(r.start_ns)
        if w0 <= t <= w1:
            mine[r.name].append(t)
    for name, (starts, _) in spans.items():
        got = sorted(mine.get(name, []))
        if len(got) == len(starts):
            offsets += [int(g - s) for g, s in zip(got, starts)]
    return Device(range_s, dict(idle), offsets)


# -- the run ------------------------------------------------------------------
class Watch:
    """Hooks on a driver's run (``harness.execute``'s ``after_setup``):
    the window's opening, the scheduler's counters before every step and
    after the window, the record."""

    def __init__(self) -> None:
        self.run = self.rec = None
        self.t_open = None
        self.before: List[dict] = []
        self.after: Optional[dict] = None

    def __call__(self, run) -> None:
        self.run = run
        mark, window = run.ctx.mark_open, run.window

        def mark_open(t_open):
            self.t_open = t_open
            mark(t_open)

        def watched_window():
            self.rec = window()
            if getattr(run, "sched", None) is not None:
                self.after = run.sched.stats()
            return self.rec
        run.ctx.mark_open = mark_open
        run.window = watched_window
        sched = getattr(run, "sched", None)
        if sched is not None:
            step = sched.step

            def watched_step():
                self.before.append(sched.stats())
                return step()
            sched.step = watched_step

    def counters(self, steps: range) -> Dict[str, float]:
        if not self.before or len(steps) == 0:
            return {}
        a = self.before[steps.start]
        b = (self.before[steps.stop] if steps.stop < len(self.before)
             else self.after)
        return {k: b[k] - a[k] for k in a
                if isinstance(a[k], (int, float)) and k in b}


def window_ns(rec, t_open: float) -> Tuple[Tuple[int, int],
                                            Optional[Tuple[int, int]]]:
    """The measured and the profiled stretches, in perf_counter ns."""
    def ns(rel):
        return int((t_open + rel) * 1e9)
    if rec.kind == "serve":
        m, t = rec.measured_steps, rec.traced_steps
        measured = (ns(rec.steps[m.start].t0), ns(rec.steps[m.stop - 1].t1))
        traced = ((ns(rec.steps[t.start].t0), ns(rec.steps[t.stop - 1].t1))
                  if len(t) else None)
    else:
        t = rec.traced_files
        measured = (ns(0.0), ns(rec.window_end))
        traced = ((ns(rec.files[t.start].t0), ns(rec.files[t.stop - 1].t1))
                  if len(t) else None)
    return measured, traced


def without_program_ranges(reduce):
    """``reduce_events`` over the events less the device-side copies of
    the program's ranges: a profiler whose events have no
    ``activity_type`` (torch 2.11) gives them as kernels, and the
    benchmark's reduction drops such copies of its own ``bench.`` ranges
    by name only."""
    from torch.autograd import DeviceType

    def reduced(events, labels):
        return reduce([ev for ev in events
                       if ev.device_type() == DeviceType.CPU
                       or not ev.name().startswith(PROGRAM_PREFIX)], labels)
    return reduced


def execute(cell: spec.Cell, seed: int, seconds: float, device,
            t_start: float, age: float = 0.0, out=sys.stdout, err=sys.stderr,
            after_setup=None) -> Tuple[int, Optional[dict]]:
    """``harness.execute`` traced, with the program's tracing on; returns
    its exit code and the figures read from the program."""
    from whisper_apr_tpu_torch.utils import trace
    trace.enable_tracing(True)
    trace.drain_records()
    watch = Watch()

    def hooks(run):
        watch(run)
        if after_setup is not None:
            after_setup(run)
    reduce = bench_trace.reduce_events
    bench_trace.reduce_events = without_program_ranges(reduce)
    try:
        rc = harness.execute(cell, seed, seconds, True, device, t_start, age,
                             out=out, err=err, after_setup=hooks)
    finally:
        bench_trace.reduce_events = reduce
        trace.enable_tracing(False)
    records = trace.drain_records()
    rec = watch.rec
    if rc != 0 or rec is None:
        return rc, None
    measured, traced = window_ns(rec, watch.t_open)
    steps = rec.measured_steps if rec.kind == "serve" else range(0)
    dev = None
    tracer = getattr(watch.run, "tracer", None)
    if tracer is not None and tracer.prof is not None:
        dev = reduce_program(tracer.prof.profiler.kineto_results.events(),
                             records, trace.epoch_ns)
    rec.program = Program(records, int(watch.t_open * 1e9), measured, traced,
                          watch.counters(steps), dev)
    setup = collections.Counter()
    for r in records:
        if r.name in SETUP and r.start_ns < rec.program.t_open_ns:
            setup[r.name] += (r.end_ns - r.start_ns) / 1e9
    figures = {"inside": spec.read_metrics(METRICS, rec),
               "breakdown": breakdown(rec.program),
               "setup_s_by_span": dict(setup), "dropped": trace.dropped()}
    if dev is not None:
        off = dev.offsets_ns
        figures["anchor"] = {
            "matched": len(off),
            "median_ms": statistics.median(off) / 1e6 if off else None,
            "median_abs_ms": (statistics.median(map(abs, off)) / 1e6
                              if off else None)}
        print("idle by program span (s): " + json.dumps(
            dict(sorted(dev.idle_s.items(), key=lambda x: -x[1]))), file=err)
        print("device s by program span: " + json.dumps(
            dict(sorted(dev.range_s.items(), key=lambda x: -x[1]))), file=err)
    err.flush()
    print(json.dumps(figures), file=out)
    out.flush()
    return rc, figures


def main(argv=None) -> int:
    from .run import AGE, T_START
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    import torch
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    rc, _ = execute(cell, args.seed, args.seconds, torch.device("cuda", 0),
                    T_START, AGE)
    return rc


if __name__ == "__main__":
    sys.exit(main())
