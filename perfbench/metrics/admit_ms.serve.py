"""Wall time of the steps that admitted, less a mean pure tick each, per
request admitted."""



def read(rec):
    if rec.kind != "serve":
        return None
    steps = [rec.steps[s] for s in rec.measured_steps]
    ticks = [s.t1 - s.t0 for s in steps if s.admitted == 0]
    adm = [s for s in steps if s.admitted > 0]
    if not ticks or not adm:
        return None
    tick = sum(ticks) / len(ticks)
    n = sum(s.admitted for s in adm)
    return 1e3 * sum(s.t1 - s.t0 - tick for s in adm) / n
