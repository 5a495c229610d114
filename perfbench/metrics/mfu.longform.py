"""Model FLOPs of the files completed (each window's encoder, cross K/V,
prompt and greedy tokens) over the window times the bf16 peak, in
percent."""

from perfbench import roofline


def read(rec):
    if rec.kind != "longform" or not rec.files:
        return None
    flops = sum(rec.file_flops(f) for f in rec.files)
    return 100.0 * flops / (rec.window_end * roofline.MFU_PEAK)
