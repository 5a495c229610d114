"""Mean wait from submission to the start of admission, from the
scheduler's own counters: the growth of ``wait_seconds_sum`` over the
measured steps, per request admitted in them."""

from perfbench.inside import program_of


def read(rec):
    p = program_of(rec)
    if rec.kind != "serve" or p is None or not p.counters.get("admitted"):
        return None
    return 1e3 * p.counters["wait_seconds_sum"] / p.counters["admitted"]
