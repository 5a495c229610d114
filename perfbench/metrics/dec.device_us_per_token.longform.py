"""Device time launched inside the greedy loop of ``transcribe_batch``
(``decoder.decode_loop``), per slot-token decoded, over the traced
files."""


def read(rec):
    if rec.kind != "longform" or rec.trace is None:
        return None
    dev = rec.trace.range_device_s.get("bench.loop")
    n = sum(rec.files[k].windows * len(rec.file_steps(rec.files[k]))
            for k in rec.traced_files)
    if not dev or not n:
        return None
    return 1e6 * dev / n
