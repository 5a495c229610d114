"""Device time launched inside the scheduler's decode ticks, per slot-token
decoded for a live request, over the traced steps."""


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    dev = rec.trace.range_device_s.get("bench.tick")
    n = sum(len(p) for p in rec.tick_positions(rec.traced_steps).values())
    if not dev or not n:
        return None
    return 1e6 * dev / n
