"""Model FLOPs of the work the measured steps did (each admission's
encoder, cross K/V and prompt; each live slot-token with its attention
over the live rows) over the summed wall time of those ``step()`` calls
times the bf16 peak, in percent."""

from perfbench import roofline


def read(rec):
    if rec.kind != "serve" or len(rec.measured_steps) == 0:
        return None
    wall = sum(rec.steps[s].t1 - rec.steps[s].t0 for s in rec.measured_steps)
    return 100.0 * rec.step_flops(rec.measured_steps) / (
        wall * roofline.MFU_PEAK)
