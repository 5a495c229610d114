"""A run at tiny widths on the CPU, everything but the look for a card:
sound, it comes out correct; with the timed path broken underneath, not.
The faults a serve cell or a longform cell can have: a token altered where
it is produced, a step that leaves its state (the KV cache) unchanged,
half of the batch's tokens taken from the other half."""

import io
import json
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

SEED = 2 ** 32 + 77
# sound runs at these widths read a widest gap of 0.0 (bf16 picks the f32
# reference's token everywhere), the float8 control 0.028-0.08; each fault
# reads 0.3 or more
LIMIT = 0.01


def run_once(cell_name, fault=None, seconds=1.5, seed=SEED, limit=LIMIT):
    cell = tiny.cell(cell_name, limit=limit)
    out, err = io.StringIO(), io.StringIO()
    undo = []

    def break_it(run):
        if fault is not None:
            undo.append(fault(run))
    rc = harness.execute(cell, seed, seconds, False, torch.device("cpu"),
                         time.perf_counter(), out=out, err=err,
                         after_setup=break_it)
    for u in undo:
        u()
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def _patch(make):
    """Replace the fused decode step (K5-K8 on the card) where the
    scheduler's tick and the greedy loop look it up."""
    import whisper_apr_tpu_torch.model.kv_variants as kv
    import whisper_apr_tpu_torch.model.qdecode as qd
    orig = qd.decode_step_qf
    broken = make(orig)
    for m in (qd, kv):
        setattr(m, "decode_step_qf", broken)

    def undo():
        for m in (qd, kv):
            setattr(m, "decode_step_qf", orig)
    return undo


def token_altered(run):
    def make(orig):
        def step(*a, **k):
            out, cache = orig(*a, **k)
            if isinstance(out, tuple):          # the fused greedy head
                return ((out[0] + 1) % 50000, *out[1:]), cache
            return out.roll(1, dims=-1), cache
        return step
    return _patch(make)


def state_unchanged(run):
    def make(orig):
        def step(params, qdd, token, pos, cache, *a, **k):
            frozen = type(cache)(*(None if t is None else t.clone()
                                   for t in cache))
            out, _ = orig(params, qdd, token, pos, frozen, *a, **k)
            return out, cache
        return step
    return _patch(make)


def half_batch(run):
    """The second half of the batch left out: its rows come back as token
    0 (the fused head) or as zero logits."""
    def make(orig):
        def step(*a, **k):
            out, cache = orig(*a, **k)
            if isinstance(out, tuple):
                tok = out[0].clone()
                tok[tok.shape[0] // 2:] = 0
                return (tok, *out[1:]), cache
            logits = out.clone()
            logits[logits.shape[0] // 2:] = 0.0
            return logits, cache
        return step
    return _patch(make)


CELLS = ["large-v3.serve.chunks", "large-v3.longform.files"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res, _ = run_once(cell)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "compared"
    assert res["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [token_altered, state_unchanged,
                                   half_batch], ids=lambda f: f.__name__)
def test_fault_is_caught(cell, fault):
    res, err = run_once(cell, fault)
    assert res["correct"] is False
    assert "compared logit_gap_max" in err.splitlines()[-4]


@pytest.mark.parametrize("cell", CELLS)
def test_blind_sample_is_not_correct(cell):
    """A limit that the float8 control's reading would pass too: the sample
    cannot tell a fault from a sound run, so the run is not correct."""
    res, err = run_once(cell, limit=50.0)
    ctl = res["compared"]["control_gap_max"]
    assert res["correct"] is False
    assert res["compared"]["logit_gap_max"]["value"] <= 50.0
    assert ctl["value"] <= ctl["limit"] and ctl["above"] is True
    assert "compared control_gap_max" in err.splitlines()[-3]
