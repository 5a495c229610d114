"""``perfbench.inside`` at tiny widths on the CPU: a traced serve run and a
traced longform run, with the program's tracing on, give a value for
every figure read from the program's spans and counters (all but the
device's), and every ``bench.*`` range the traced steps or files call
for is still there and not empty. The profiler traces the CPU only
here."""

import io
import json
import time

import pytest
import torch

from perfbench import inside
from perfbench.tests import tiny
from perfbench.trace import Tracer

SEED = 2 ** 32 + 91
BENCH_RANGES = {
    "serve": {"bench.window", "bench.step", "bench.admit", "bench.tick",
              "bench.decode"},
    "longform": {"bench.window", "bench.file", "bench.batch",
                 "bench.encode", "bench.greedy", "bench.loop"}}


def expected_ranges(kind, rec):
    """The ranges every traced window has, and those its steps call for:
    the generator's between two steps, admission's where one admitted."""
    want = set(BENCH_RANGES[kind])
    if kind == "serve":
        if len(rec.traced_steps) > 1:
            want.add("bench.host")
        if any(rec.steps[s].admitted for s in rec.traced_steps):
            want |= {"bench.admit_step", "bench.encode"}
    return want
HOST = {
    "serve": {"sched.wait_ms.serve", "admit.pad_share.serve",
              "tick.live_share.serve", "admit.encode_ms.serve",
              "admit.prefill_ms.serve", "admit.sync_ms.serve",
              "tick.sync_ms.serve", "setup.engine_s"},
    "longform": {"loop.launch_us_per_step.longform", "setup.engine_s"}}

BREAKDOWN = {"serve": {"admission_ms_per_request", "serve.tick_ms"},
             "longform": {"loop.step_ms", "batch_ms_per_window"}}


@pytest.fixture
def cpu_tracer(monkeypatch):
    """The benchmark's tracer over the CPU alone (its first start, made in
    set-up, takes seconds)."""
    def warm(self):
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(1).add_(1)
    monkeypatch.setattr(Tracer, "_activities", staticmethod(
        lambda: [torch.profiler.ProfilerActivity.CPU]))
    monkeypatch.setattr(Tracer, "warm", warm)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


@pytest.mark.parametrize("name, kind, trace, seconds", [
    ("large-v3.serve.chunks", "serve", {"start_s": 0.5, "seconds": 2.5},
     6.0),
    ("large-v3.longform.files", "longform", {"start_s": 0.0, "files": 1},
     2.5)])
def test_traced_run_reads_the_program(cpu_tracer, name, kind, trace,
                                      seconds):
    cell = tiny.cell(name, limit=0.01)   # the faults test's limit
    cell.traffic["trace"] = trace
    runs, recs = [], []

    def keep(run):
        runs.append(run)
        window = run.window
        run.window = lambda: recs.append(window()) or recs[-1]
    out, err = io.StringIO(), io.StringIO()
    rc, figures = inside.execute(cell, SEED, seconds, torch.device("cpu"),
                                 time.perf_counter(), out=out, err=err,
                                 after_setup=keep)
    assert rc == 0, err.getvalue()
    lines = out.getvalue().strip().splitlines()
    assert json.loads(lines[-1]) == figures
    assert json.loads(lines[-2])["correct"]
    got = figures["inside"]
    assert HOST[kind] <= set(got), (set(got), err.getvalue())
    assert all(v["value"] >= 0 for v in got.values())
    if kind == "serve":
        assert 0 < got["tick.live_share.serve"]["value"] <= 100
        assert 0 <= got["admit.pad_share.serve"]["value"] < 100
    assert figures["dropped"] == 0
    assert set(figures["breakdown"]) == BREAKDOWN[kind]
    assert "engine.init" in figures["setup_s_by_span"]
    ranges = {}
    for ev in runs[0].tracer.prof.profiler.kineto_results.events():
        if ev.name().startswith("bench."):
            ranges[ev.name()] = max(ranges.get(ev.name(), 0),
                                    ev.end_ns() - ev.start_ns())
    assert set(ranges) == expected_ranges(kind, recs[0])
    assert len(recs[0].traced_steps if kind == "serve"
               else recs[0].traced_files) > 0
    assert all(d > 0 for d in ranges.values())
