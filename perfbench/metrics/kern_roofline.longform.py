"""The greedy loop's hand kernels (K5, K6, K7 every layer, K4's greedy
head) against their floor, over the traced files, in percent."""


def read(rec):
    if rec.kind != "longform" or rec.trace is None:
        return None
    measured = rec.hand_kernel_s("bench.loop")
    if not measured:
        return None
    floor = sum(rec.file_floor_s(rec.files[k]) for k in rec.traced_files)
    return 100.0 * floor / measured
