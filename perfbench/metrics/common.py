"""Helpers shared by the metric readers."""

import math

import numpy as np

# a percentile that falls on a failed request is reported at this many ms
# (JSON has no infinity); such a run is not correct in any case
MISSED_MS = 3.6e6


def percentile_ms(rec, q: float):
    if rec.kind != "serve":
        return None
    lat = [r.latency for r in rec.requests if r.in_window]
    if not lat:
        return None
    v = float(np.percentile(np.array(lat, dtype=np.float64), q,
                            method="linear")) * 1e3
    return MISSED_MS if not math.isfinite(v) else v


def idle_share(rec, kind: str):
    if rec.kind != kind or rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
