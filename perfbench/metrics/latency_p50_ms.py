"""Median request latency (due time to completion) over every request due
in the window."""

from perfbench.metrics.common import percentile_ms


def read(rec):
    return percentile_ms(rec, 50)
