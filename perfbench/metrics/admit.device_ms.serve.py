"""Device time launched inside the program's ``serve.admit`` ranges in the
profiled window, per request admitted in the traced steps."""

from perfbench.inside import program_of


def read(rec):
    p = program_of(rec)
    if rec.kind != "serve" or p is None or p.device is None:
        return None
    n = sum(rec.steps[s].admitted for s in rec.traced_steps)
    dev = p.device.range_s.get("serve.admit")
    if not dev or not n:
        return None
    return 1e3 * dev / n
