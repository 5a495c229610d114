"""The generator is a function of ``--seed``: the same seed gives the same
requests and audio, another seed the same sizes in another order."""

import numpy as np
import pytest

from perfbench import spec, traffic

SEEDS = [0, 2 ** 31 + 5, 2 ** 40 + 17]


def mix(name):
    return spec.resolve(name).traffic


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["large-v3.serve.chunks",
                                  "large-v3.serve.clips"])
def test_serve_deterministic(cell, seed):
    m = mix(cell)
    a = traffic.serve_requests(m, seed, 30.0)
    b = traffic.serve_requests(m, seed, 30.0)
    assert a == b
    c = traffic.serve_requests(m, seed + 1, 30.0)
    assert [r.due for r in a] != [r.due for r in c]


def test_same_sizes_other_order():
    m = mix("large-v3.serve.chunks")
    block = m["block"]
    a = [r for r in traffic.serve_requests(m, 1, 60.0) if r.due >= 0]
    b = [r for r in traffic.serve_requests(m, 2, 60.0) if r.due >= 0]
    n = min(len(a), len(b)) // block * block
    assert n >= block
    assert sorted(r.tokens for r in a[:n]) == sorted(r.tokens for r in b[:n])
    assert [r.tokens for r in a[:n]] != [r.tokens for r in b[:n]]
    ga = np.diff([0.0] + [r.due for r in a[:block]])
    gb = np.diff([0.0] + [r.due for r in b[:block]])
    assert sorted(ga) == pytest.approx(sorted(gb))
    assert list(ga) != pytest.approx(list(gb))
    # a block of gaps averages exactly 1 / rate
    gaps = traffic.poisson_gaps(np.random.default_rng(0), block, block, 7.0)
    assert abs(gaps.mean() - 1 / 7.0) < 1e-12


@pytest.mark.parametrize("cell", ["large-v3.serve.chunks",
                                  "large-v3.serve.clips"])
def test_window_work_fixed_by_rate(cell):
    """Whole blocks from the window's opening: the count and the tokens
    due in a window differ between seeds only by a part of one block."""
    m = mix(cell)
    win = [[r for r in traffic.serve_requests(m, s, 51.0) if r.due >= 0]
           for s in SEEDS]
    n = [len(w) for w in win]
    toks = [sum(r.tokens for r in w) for w in win]
    assert max(n) - min(n) < m["block"]
    assert max(toks) - min(toks) <= 0.03 * max(toks)
    full = int(51.0 * m["rate_rps"]) // m["block"] * m["block"]
    assert len({tuple(sorted(r.n_samples for r in w[:full]))
                for w in win}) == 1


def test_limits_of_draws():
    m = mix("large-v3.serve.clips")
    rs = traffic.serve_requests(m, 5, 60.0)
    assert all(8 <= r.tokens <= 224 for r in rs)
    assert all(4.0 <= r.audio_s <= 30.0 for r in rs)
    assert all(r.offset + r.n_samples <= m["recording_s"] * 16000
               for r in rs)
    f = traffic.files(mix("large-v3.longform.files"), 5, 22)
    assert all(96 <= x.tokens <= 160 and 300 <= x.audio_s <= 600 for x in f)


@pytest.mark.parametrize("seed", SEEDS)
def test_recording_deterministic(seed):
    a = traffic.recording(seed, 3.0, "cpu")
    b = traffic.recording(seed, 3.0, "cpu")
    assert a.dtype == np.float32 and len(a) == 48000
    assert np.array_equal(a, b)
    assert not np.array_equal(a, traffic.recording(seed + 1, 3.0, "cpu"))


def test_unknown_arrivals_refused():
    m = dict(mix("large-v3.serve.chunks"), arrivals="bursts")
    with pytest.raises(ValueError, match="arrivals"):
        traffic.serve_requests(m, 1, 10.0)
