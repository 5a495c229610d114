"""Mean wall time of a scheduler step that admitted nothing (a pure decode
tick), from the benchmark's clock around ``step()``."""


def read(rec):
    if rec.kind != "serve":
        return None
    ticks = [rec.steps[s] for s in rec.measured_steps
             if rec.steps[s].admitted == 0]
    if not ticks:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in ticks) / len(ticks)
