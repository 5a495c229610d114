"""Host time of a greedy step outside its wait for the card (each
``loop.step`` less its ``sync``: the launches and the host's
bookkeeping), per step, over the measured files outside the profiled
window."""

from perfbench.inside import program_of


def read(rec):
    p = program_of(rec)
    if rec.kind != "longform" or p is None:
        return None
    steps = p.measured("loop.step")
    if not steps:
        return None
    return sum(p.host_ns(s) for s in steps) / 1e3 / len(steps)
