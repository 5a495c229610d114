"""Mean wait before admission, from the scheduler's own counters: the
growth of ``queue_seconds_sum`` over the measured steps, per request
completed in them."""


def read(rec):
    c = rec.counters
    n = c.get("completed_ok", 0) + c.get("cancelled", 0) + c.get("timeout", 0)
    if rec.kind != "serve" or n <= 0:
        return None
    return 1e3 * c["queue_seconds_sum"] / n
