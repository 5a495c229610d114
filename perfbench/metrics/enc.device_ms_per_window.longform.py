"""Device time launched inside the encoder (``pipeline.encode``: log-mel
excluded, the conv stem and 32 blocks), per 30 s window, over the traced
files."""


def read(rec):
    if rec.kind != "longform" or rec.trace is None:
        return None
    dev = rec.trace.range_device_s.get("bench.encode")
    n = sum(rec.files[k].windows for k in rec.traced_files)
    if not dev or not n:
        return None
    return 1e3 * dev / n
