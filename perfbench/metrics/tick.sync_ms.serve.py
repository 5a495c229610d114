"""Host time a decode tick waits for the card (the ``sync`` of each
``serve.tick``: the read of its tokens), per tick, over the measured
steps outside the profiled window: the part of ``sched.tick_ms`` that is
the card's."""

from perfbench.inside import program_of


def read(rec):
    p = program_of(rec)
    if rec.kind != "serve" or p is None:
        return None
    ticks = p.measured("serve.tick")
    if not ticks:
        return None
    wait = sum(c.end_ns - c.start_ns for t in ticks for c in p.children(t)
               if c.name == "sync")
    return wait / 1e6 / len(ticks)
