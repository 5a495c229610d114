"""The decode tick's hand kernels (K5, K6, K7 every layer, K8's logits
tail) against their floor: the sum over the traced ticks of each launch's
floor for the live rows (``roofline.tick_floor_s``), over the sum of the
device time of the port's hand-kernel launches inside those ticks, in
percent."""


def read(rec):
    if rec.kind != "serve" or rec.trace is None:
        return None
    measured = rec.hand_kernel_s("bench.tick")
    if not measured:
        return None
    return 100.0 * rec.tick_floor_s(rec.traced_steps) / measured
