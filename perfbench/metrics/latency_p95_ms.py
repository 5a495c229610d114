"""95th percentile of request latency (due time to completion) over every
request due in the window; a failed or unfinished request counts as
missing every limit (an infinite latency)."""

from perfbench.metrics.common import percentile_ms


def read(rec):
    return percentile_ms(rec, 95)
