"""Share of the rows admission ran that were bucket padding, from the
scheduler's counters over the measured steps, in percent."""

from perfbench.inside import program_of


def read(rec):
    p = program_of(rec)
    if rec.kind != "serve" or p is None or not p.counters.get("admit_rows"):
        return None
    return 100.0 * p.counters["admit_rows_padded"] / p.counters["admit_rows"]
