"""Share of the slot-rows the ticks stepped that held a live request, from
the scheduler's counters over the measured steps, in percent."""

from perfbench.inside import program_of


def read(rec):
    p = program_of(rec)
    if rec.kind != "serve" or p is None or not p.counters.get("tick_rows"):
        return None
    return 100.0 * p.counters["tick_live_rows"] / p.counters["tick_rows"]
