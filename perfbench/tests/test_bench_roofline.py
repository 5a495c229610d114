"""The yardstick's counts against hand counts at tiny widths."""

import pytest

from perfbench import roofline
from perfbench.tests import tiny


def test_encoder_flops_by_hand():
    d = tiny.dims()              # D 384, 2 + 2 layers, FFN 1536, 80 mels
    D, S, M, L = 384, 1500, 80, 2
    conv = 2 * 3000 * 3 * M * D + 2 * 1500 * 3 * D * D
    per_layer = (2 * S * 4 * D * D          # q, k, v, o
                 + 2 * 2 * S * S * D        # scores and values
                 + 2 * 2 * S * D * 1536)    # fc1, fc2
    assert roofline.encoder_flops(d) == conv + L * per_layer


def test_decoder_token_flops_by_hand():
    d = tiny.dims()
    D, L, V = 384, 2, 51865
    per_layer = 2 * (6 * D * D + 2 * D * 1536) + 4 * 11 * D + 4 * 1500 * D
    assert roofline.decoder_token_flops(d, 10) == L * per_layer + 2 * D * V


def test_self_block_bound_by_hand():
    D, B = 384, 4
    rows = 40
    nbytes = (4 * D * D + 4 * 10 * D + 2 * rows * (D + 4) + 2 * B * D * 2
              + 2 * B * (D + 4 + 4))
    flops = 8 * B * D * D + 4 * rows * D
    want = max(nbytes / 3.35e12, flops / 989e12)
    got = roofline.bound_s("self_block", D, B, rows=rows, cache_bytes=1,
                           scales=True)
    assert got == pytest.approx(want, rel=1e-12)


def test_vocab_head_bound_by_hand():
    D, B, V = 384, 2, 51865
    vp = 51968
    nbytes = D * vp + 4 * vp + 2 * B * D * 2 + B * 12 - B * D * 2
    assert roofline.bound_s("qmatvec_greedy_head", D, B, n_vocab=V) == \
        pytest.approx(nbytes / 3.35e12, rel=1e-12)


def test_tick_floor_sums_layers():
    d = tiny.dims()
    kv = dict(self_bytes=1, self_scales=True, cross_bytes=1,
              cross_scales=True)
    one = roofline.tick_floor_s(d, [5, 7], head="qmatvec_stacked", **kv)
    head = roofline.bound_s("qmatvec_stacked", 384, 2, n_vocab=51865)
    layer = (roofline.bound_s("self_block", 384, 2, rows=12, cache_bytes=1,
                              scales=True)
             + roofline.bound_s("cross_block", 384, 2, rows=3000,
                                cache_bytes=1, scales=True)
             + roofline.bound_s("ffn_block", 384, 2, ffn=1536))
    assert one == pytest.approx(2 * layer + head, rel=1e-12)
    assert roofline.tick_floor_s(d, [], head="qmatvec_stacked", **kv) == 0
