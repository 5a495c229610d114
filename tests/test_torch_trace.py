"""The port's tracing (``utils/trace.py``) and the scheduler's counters,
on the CPU: span records with their parents and attributes, nothing kept
while tracing is off, the bounded buffer and its drop counter, the clock
anchor against a ``torch.profiler`` trace, and the spans and counters of
a tiny scheduler and a tiny batch transcription.
"""

import collections

import numpy as np
import pytest
import torch

from whisper_apr_tpu_torch import ComputeConfig, TranscribeOptions, WhisperApr
from whisper_apr_tpu_torch.config import ModelConfig
from whisper_apr_tpu_torch.model.params import init_params, quantize_params
from whisper_apr_tpu_torch.parallel.serving import BatchScheduler
from whisper_apr_tpu_torch.tokenizer import SpecialTokens
from whisper_apr_tpu_torch.utils import trace


@pytest.fixture
def tracing():
    trace.enable_tracing(True)
    trace.drain_records()
    try:
        yield
    finally:
        trace.enable_tracing(False)
        trace.drain_records()


@pytest.fixture(scope="module")
def engine():
    cfg = ModelConfig(
        model_type="tiny", n_vocab=700, n_audio_ctx=32, n_audio_state=128,
        n_audio_head=4, n_audio_layer=2, n_text_ctx=24, n_text_state=128,
        n_text_head=4, n_text_layer=3, n_mels=80)
    V = cfg.n_vocab
    specials = SpecialTokens(
        eot=V - 1, sot=V - 2, lang_base=V - 110, transcribe=V - 3,
        no_timestamps=V - 4, timestamp_base=V + 1000, is_multilingual=False,
        translate=V - 5, no_speech=V - 6, speaker_turn=V - 7, prev=V - 8)
    return WhisperApr(cfg, quantize_params(init_params(cfg, seed=3), "int8"),
                      specials=specials,
                      compute=ComputeConfig(quantization="int8",
                                            kv_mode="auto"),
                      device="cpu")


def _audios(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.1, 3000 + 500 * i).astype(np.float32)
            for i in range(n)]


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.id]


def test_parents_and_attributes(tracing):
    with trace.trace_span("outer", ids=[7, 9]):
        with trace.trace_span("inner"):
            trace.annotate(rows=4)
        with trace.trace_span("sync"):
            pass
    with trace.trace_span("next"):
        pass
    recs = trace.drain_records()
    by = {r.name: r for r in recs}
    assert [r.name for r in recs] == ["inner", "sync", "outer", "next"]
    assert by["outer"].parent == by["next"].parent == -1
    assert by["inner"].parent == by["sync"].parent == by["outer"].id
    assert by["outer"].attrs == {"ids": [7, 9]}
    assert by["inner"].attrs == {"rows": 4}
    o, i = by["outer"], by["inner"]
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns


def test_off_records_nothing():
    trace.enable_tracing(False)
    trace.drain_records()
    assert trace.trace_span("a") is trace.trace_span("b", rows=1)
    with trace.trace_span("a", rows=1):
        trace.annotate(live=2)
    assert trace.drain_records() == [] and trace.drain_events() == []


def test_bounded_buffer_counts_drops(tracing, monkeypatch):
    monkeypatch.setattr(trace, "_RECORDS", collections.deque(maxlen=4))
    before = trace.dropped()
    for k in range(6):
        with trace.trace_span(f"s{k}"):
            pass
    assert [r.name for r in trace.drain_records()] == ["s2", "s3", "s4",
                                                         "s5"]
    assert trace.dropped() - before == 2


def test_anchor_places_spans_on_the_profiler_clock(tracing):
    """Each span, converted by the anchor, starts within 0.5 ms of its
    own ``record_function`` range in a CPU profiler trace. The profiler's
    first range on a thread spends about a millisecond setting it up, an
    offset that is not the anchor's: one range opens before the spans."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("first"):
            pass
        for k in range(5):
            with trace.trace_span(f"anchor{k}"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    recs = {r.name: r for r in trace.drain_records()}
    ranges = {ev.name(): ev.start_ns()
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith(trace.PREFIX + "anchor")}
    assert len(ranges) == len(recs) == 5
    for name, r in recs.items():
        off = trace.epoch_ns(r.start_ns) - ranges[trace.PREFIX + name]
        assert abs(off) < 500_000, (name, off)


def test_scheduler_spans_and_counters(engine, tracing):
    """A burst of 3 on 8 slots admits at bucket 4 (one padded row), a
    lone request at bucket 1; every tick steps all 8 slot-rows."""
    sched = BatchScheduler(engine, n_slots=8)
    a = _audios(4, seed=5)
    ids = [sched.submit(x, "en", max_tokens=6) for x in a[:3]]
    sched.run_until_drained()
    ids.append(sched.submit(a[3], "en", max_tokens=4))
    sched.run_until_drained()
    assert all(sched.result(i).status == "ok" for i in ids)
    st = sched.stats()
    assert st["admit_rows"] == 5 and st["admit_rows_padded"] == 1
    assert st["tick_rows"] == 8 * st["ticks"]
    assert 0 < st["tick_live_rows"] <= st["tick_rows"]
    assert 0 <= st["wait_seconds_sum"] <= st["queue_seconds_sum"]
    assert 0 < st["admit_seconds_sum"]

    recs = trace.drain_records()
    admits = [r for r in recs if r.name == "serve.admit"]
    assert [r.attrs for r in admits] == [
        {"ids": ids[:3], "bucket": 4, "padded": 1},
        {"ids": ids[3:], "bucket": 1, "padded": 0}]
    steps = {r.id: r for r in recs if r.name == "serve.step"}
    assert len(steps) == st["ticks"]
    assert all(r.parent in steps for r in admits)
    assert sum(r.attrs["admitted"] for r in steps.values()) == 4
    for adm in admits:
        assert [r.name for r in _children(recs, adm)] == [
            "mel", "encode", "cross_kv", "prefill", "scatter", "sync",
            "admit.host"]
        prefill = next(r for r in _children(recs, adm) if r.name == "prefill")
        assert [r.name for r in _children(recs, prefill)] == ["sync"]
    ticks = [r for r in recs if r.name == "serve.tick"]
    assert len(ticks) == st["ticks"]
    assert sum(r.attrs["live"] for r in ticks) == st["tick_live_rows"]
    for t in ticks:
        assert t.attrs["rows"] == 8 and steps[t.parent]
        assert [r.name for r in _children(recs, t)] == ["sync"]
    assert sum(r.name == "serve.finish" for r in recs) == st["ticks"]


def test_batch_transcription_spans(engine, tracing):
    res = engine.transcribe_batch(
        _audios(2, seed=7), TranscribeOptions(language="en", max_tokens=8))
    recs = trace.drain_records()
    (batch,) = [r for r in recs if r.name == "batch"]
    assert batch.attrs == {"windows": 2} and batch.parent == -1
    names = [r.name for r in _children(recs, batch)]
    assert names == ["mel", "encode", "cross_kv", "prefill", "loop",
                     "batch.host"]
    (loop,) = [r for r in recs if r.name == "loop"]
    steps = [r for r in _children(recs, loop) if r.name == "loop.step"]
    n_gen = max(len(r.tokens) for r in res.results) - 4
    assert 0 < len(steps) <= n_gen
    assert all([c.name for c in _children(recs, s)] == ["sync"]
               for s in steps)
    (host,) = [r for r in recs if r.name == "batch.host"]
    assert [r.name for r in _children(recs, host)] == ["sync"]


def test_setup_spans(engine, tracing):
    eng = WhisperApr(engine.config, engine.params, specials=engine.specials,
                     compute=engine.compute, device="cpu")
    assert eng._qdecode is not None
    names = [r.name for r in trace.drain_records()]
    assert names == ["engine.init", "qdecode.prepare"]
