"""Seconds of the program's own set-up in the run's set-up: the engine's
construction, the decode operands' preparation, the kernel library's and
the host runtime's build or load (``engine.init``, ``qdecode.prepare``,
``kernels.load``, ``native.load``; one inside another counted once)."""

from perfbench.inside import SETUP, program_of


def read(rec):
    p = program_of(rec)
    if p is None:
        return None
    spans = [r for r in p.spans if r.name in SETUP
             and r.start_ns < p.t_open_ns
             and not any(a.name in SETUP for a in p.ancestors(r))]
    if not spans:
        return None
    return sum(r.end_ns - r.start_ns for r in spans) / 1e9
