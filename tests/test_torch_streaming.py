"""The port's long-audio and streaming modules against the JAX package's,
on the CPU: the ring buffer, the VAD, the streaming chunker, window
splitting, the overlap dedup, the host log-mel, and the engine's
``transcribe_long``, ``transcribe_file``, ``transcribe_with_vad``,
``transcribe_prefixed`` and ``StreamingSession``.

Inputs are made with numpy from fixed seeds and handed to both packages.
The host modules are copies, so their outputs must be identical; at
44.1 kHz input both packages resample with the same C++ (the port's copy
of the JAX package's ``native/aprcore.cpp``, built with its flags), so
chunks there are identical too (``RESAMPLE_TOL`` is 0). The engines
share one random-init transformers Whisper (f32, the plain CPU path on
both sides) with a word vocabulary, so that texts have words to stitch:
tokens and texts must be identical and segment times within 1e-6. One
int8 case runs the JAX fused step in interpret mode, as
``test_torch_strategies.py`` drives it, against the port's plain versions
of K1-K4.
"""

import dataclasses
import io
import wave

import numpy as np
import pytest
import torch

from helpers import make_hf_twin, small_config, small_specials
from whisper_apr_tpu import vad as jvad
from whisper_apr_tpu.audio import batch as jbatch
from whisper_apr_tpu.audio import mel as jmel
from whisper_apr_tpu.audio import ring_buffer as jring
from whisper_apr_tpu.audio import streaming as jstream
from whisper_apr_tpu.config import ComputeConfig as JCompute
from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.engine import TranscribeOptions as JOptions
from whisper_apr_tpu.engine import WhisperApr as JWhisperApr
from whisper_apr_tpu.inference import streaming as jistream
from whisper_apr_tpu.model import qdecode as jqd
from whisper_apr_tpu.model.params import init_params, quantize_params
from whisper_apr_tpu.tokenizer import BpeTokenizer as JBpe
from whisper_apr_tpu.tokenizer import SpecialTokens as JSpecials
from whisper_apr_tpu.tokenizer import Vocabulary as JVocab
from whisper_apr_tpu_torch import ComputeConfig as TCompute
from whisper_apr_tpu_torch import ModelConfig as TModelConfig
from whisper_apr_tpu_torch import TranscribeOptions, WhisperApr
from whisper_apr_tpu_torch import audio as taudio
from whisper_apr_tpu_torch import vad as tvad
from whisper_apr_tpu_torch.audio import batch as tbatch
from whisper_apr_tpu_torch.audio import mel as tmel
from whisper_apr_tpu_torch.audio import ring_buffer as tring
from whisper_apr_tpu_torch.audio import streaming as tstream
from whisper_apr_tpu_torch.inference import streaming as tistream
from whisper_apr_tpu_torch.model.params import from_jax_params
from whisper_apr_tpu_torch.tokenizer import BpeTokenizer as TBpe
from whisper_apr_tpu_torch.tokenizer import SpecialTokens as TSpecials
from whisper_apr_tpu_torch.tokenizer import Vocabulary as TVocab

SR = 16_000
MEL_TOL = 5.2e-5       # the port's mel against JAX's (test_torch_model.py)
RESAMPLE_TOL = 0.0     # both packages resample with the same C++


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# shared builders (also imported by test_torch_hotwords / _alignment)
# ---------------------------------------------------------------------------

def engine_config() -> ModelConfig:
    """``helpers.small_config`` with 32 audio positions: one window is
    64 mel frames, 10 240 samples."""
    return small_config(n_audio_ctx=32)


def _word_tokenizer(vocab_cls, bpe_cls, n_vocab: int):
    """Byte tokens, then " w<id>" for every other id: decoded texts are
    words (a leading space starts each)."""
    v = vocab_cls.with_base_tokens()
    while len(v) < n_vocab:
        v.add_token(b" w%d" % len(v))
    return bpe_cls(v)


def make_engines(cfg: ModelConfig, seed: int = 1):
    """A JAX and a port engine over one random-init transformers Whisper
    in f32. Every weight matrix is drawn again at std 0.2 (the default
    0.02 decodes one repeated token whatever the audio), so that the
    decodes follow the audio."""
    hf = make_hf_twin(cfg, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in hf.parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    jeng = JWhisperApr.from_hf_model(
        hf, cfg, tokenizer=_word_tokenizer(JVocab, JBpe, cfg.n_vocab),
        specials=small_specials(cfg))
    teng = WhisperApr.from_hf_model(
        hf, TModelConfig(**dataclasses.asdict(cfg)),
        tokenizer=_word_tokenizer(TVocab, TBpe, cfg.n_vocab),
        specials=TSpecials(**dataclasses.asdict(small_specials(cfg))),
        device="cpu")
    return jeng, teng


def speech_like(n: int, seed: int = 0, freq: float = 220.0) -> np.ndarray:
    """A loud tone with a slow vibrato and noise (VAD-positive)."""
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    return (0.5 * np.sin(2 * np.pi * freq * t * (1 + 0.3 * np.sin(t)))
            + 0.1 * rng.normal(size=n)).astype(np.float32)


def silence_like(n: int, seed: int = 0) -> np.ndarray:
    return (1e-4 * np.random.default_rng(seed).normal(size=n)).astype(
        np.float32)


def bursts(plan, seed: int = 0, sr: int = SR) -> np.ndarray:
    """Concatenated (seconds, "speech" | "silence") pieces."""
    out = []
    for i, (sec, kind) in enumerate(plan):
        n = int(sec * sr)
        if kind == "speech":
            t = np.arange(n) / sr
            rng = np.random.default_rng(seed + i)
            out.append((0.5 * np.sin(2 * np.pi * (200 + 60 * i) * t)
                        + 0.05 * rng.normal(size=n)).astype(np.float32))
        else:
            out.append(silence_like(n, seed + i))
    return np.concatenate(out)


def same_result(got, want):
    assert got.tokens == want.tokens
    assert got.text == want.text
    assert got.language == want.language
    assert len(got.segments) == len(want.segments)
    for g, w in zip(got.segments, want.segments):
        assert g.text == w.text and g.tokens == w.tokens
        np.testing.assert_allclose([g.start, g.end], [w.start, w.end],
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def engines():
    return make_engines(engine_config())


# ---------------------------------------------------------------------------
# ring buffer, VAD
# ---------------------------------------------------------------------------

def _ring_ops(rb, seed: int, n_ops: int = 200):
    """A seeded sequence of every RingBuffer operation; returns what each
    returned and the state after it."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_ops):
        op = rng.integers(7)
        n = int(rng.integers(0, 2 * rb.capacity + 2))
        data = rng.normal(size=n).astype(np.float32)
        if op == 0:
            r = rb.write(data)
        elif op == 1:
            r = rb.write_overwrite(data)
        elif op == 2:
            r = rb.read(n).tolist()
        elif op == 3:
            r = rb.peek(n).tolist()
        elif op == 4:
            r = rb.skip(n)
        elif op == 5:
            r = rb.clear()
        else:
            r = rb.write_overwrite(data[: rb.capacity])
        out.append((int(op), r, len(rb), rb.available, rb.free,
                    rb.is_empty(), rb.is_full()))
    return out


@pytest.mark.parametrize("capacity,seed", [(1, 0), (7, 1), (64, 2),
                                           (1000, 3)])
def test_ring_buffer_sequences_equal_jax(capacity, seed):
    assert _ring_ops(tring.RingBuffer(capacity), seed) == \
        _ring_ops(jring.RingBuffer(capacity), seed)
    assert tring.RingBuffer.for_duration(0.25, 8000).capacity == \
        jring.RingBuffer.for_duration(0.25, 8000).capacity


VAD_CONFIGS = {"default": lambda m: m.VadConfig(),
               "low_latency": lambda m: m.VadConfig.low_latency(),
               "high_accuracy": lambda m: m.VadConfig.high_accuracy()}
VAD_PLAN = [(0.7, "silence"), (1.2, "speech"), (0.9, "silence"),
            (0.4, "speech"), (0.2, "silence"), (1.5, "speech")]


@pytest.mark.parametrize("name", list(VAD_CONFIGS))
def test_vad_segments_and_state_equal_jax(name):
    audio = bursts(VAD_PLAN, seed=3)
    t = tvad.VoiceActivityDetector(VAD_CONFIGS[name](tvad))
    j = jvad.VoiceActivityDetector(VAD_CONFIGS[name](jvad))
    assert t.detect(audio) == j.detect(audio)
    assert (t.noise_floor, t.in_speech, t._speech_run, t._silence_run) == \
        (j.noise_floor, j.in_speech, j._speech_run, j._silence_run)
    fs = t.config.frame_size
    t.reset()
    j.reset()
    states = [(t.process_frame(audio[i:i + fs]), t.noise_floor)
              for i in range(0, len(audio) - fs + 1, fs)]
    assert states == [(j.process_frame(audio[i:i + fs]), j.noise_floor)
                      for i in range(0, len(audio) - fs + 1, fs)]
    np.testing.assert_array_equal(
        tvad.StreamingVad(VAD_CONFIGS[name](tvad)).filter(audio),
        jvad.StreamingVad(VAD_CONFIGS[name](jvad)).filter(audio))


@pytest.mark.parametrize("adaptive", [True, False])
def test_silence_detector_equals_jax(adaptive):
    audio = bursts(VAD_PLAN * 3, seed=5)
    t = tvad.SilenceDetector(tvad.SilenceConfig(adaptive=adaptive,
                                                max_silence_duration=0.6))
    j = jvad.SilenceDetector(jvad.SilenceConfig(adaptive=adaptive,
                                                max_silence_duration=0.6))
    got = [t.process_frame(audio[i:i + 480])
           for i in range(0, len(audio), 480)]
    want = [j.process_frame(audio[i:i + 480])
            for i in range(0, len(audio), 480)]
    assert [dataclasses.astuple(s) if s else None for s in got] == \
        [dataclasses.astuple(s) if s else None for s in want]
    assert any(s is not None for s in got)
    frame = audio[:480]
    assert tvad.frame_energy(frame) == jvad.frame_energy(frame)
    assert tvad.zero_crossing_rate(frame) == jvad.zero_crossing_rate(frame)


# ---------------------------------------------------------------------------
# the streaming chunker
# ---------------------------------------------------------------------------

def _config(mod, name: str, sr: int):
    c = {"standard": lambda: mod.StreamingConfig(),
         "low_latency": mod.StreamingConfig.low_latency,
         "ultra_low": mod.StreamingConfig.ultra_low_latency,
         "custom": lambda: mod.StreamingConfig.custom_latency(
             chunk_duration=1.0, chunk_overlap=0.1,
             min_speech_duration_ms=100, buffer_duration=30.0),
         "overflow": lambda: mod.StreamingConfig.custom_latency(
             chunk_duration=2.0, chunk_overlap=0.2,
             min_speech_duration_ms=100, buffer_duration=0.3)}[name]()
    return dataclasses.replace(c, input_sample_rate=sr)


STREAM_PLAN = [(0.6, "silence"), (2.4, "speech"), (1.0, "silence"),
               (4.2, "speech"), (0.8, "silence"), (0.5, "speech"),
               (1.2, "silence")]


def _drive_processor(mod, name: str, sr: int, block_s: float = 0.5):
    """Push the plan in blocks; after each: events, every ready chunk,
    the partial. Then error recovery, an injected overlap and flush."""
    p = mod.StreamingProcessor(_config(mod, name, sr))
    if name == "custom":
        p.set_partial_threshold(0.3)
    audio = bursts(STREAM_PLAN, seed=11, sr=sr)
    block = int(block_s * sr)
    log = []
    for i in range(0, len(audio), block):
        p.push_audio(audio[i:i + block])
        ev = p.process()
        log.append(("events", [(e.kind, round(e.time, 9), e.detail)
                               for e in ev], p.state.value))
        while p.has_chunk():
            log.append(("chunk", p.get_chunk()))
        log.append(("partial", p.get_partial()))
    p.mark_error("test")
    log.append(("error", [e.kind for e in p.process()], p.state.value))
    p.recover_from_error()
    p.set_overlap_buffer(audio[:1000])
    p.push_audio(audio[: 2 * block])
    log.append(("flush", p.flush(), p.state.value))
    return log


def _same_log(got, want, atol: float):
    assert [g[0] for g in got] == [w[0] for w in want]
    for g, w in zip(got, want):
        if g[0] in ("chunk", "partial", "flush") and \
                isinstance(w[1], np.ndarray):
            assert isinstance(g[1], np.ndarray) and g[1].shape == w[1].shape
            np.testing.assert_allclose(g[1], w[1], rtol=0, atol=atol)
            assert g[2:] == w[2:]
        else:
            assert g == w


@pytest.mark.parametrize("name", ["standard", "low_latency", "ultra_low",
                                  "custom", "overflow"])
def test_processor_events_and_chunks_equal_jax_at_16k(name):
    got = _drive_processor(tstream, name, SR)
    _same_log(got, _drive_processor(jstream, name, SR), atol=0.0)
    kinds = {k for entry in got if entry[0] == "events"
             for k, *_ in entry[1]}
    assert "chunk_ready" in kinds and "speech_started" in kinds
    if name == "overflow":
        assert "error" in kinds


@pytest.mark.parametrize("name", ["standard", "custom"])
def test_processor_at_44k_same_events_chunks_in_tolerance(name):
    """At 44.1 kHz both packages resample with the same C++ library: the
    same events and identical chunks."""
    got = _drive_processor(tstream, name, 44_100)
    _same_log(got, _drive_processor(jstream, name, 44_100),
              atol=RESAMPLE_TOL)


# ---------------------------------------------------------------------------
# window splitting, batch mel, dedup, the host log-mel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,chunk,overlap", [
    (0, 100, 0), (100, 100, 10), (101, 100, 10), (1000, 100, 0),
    (1000, 100, 25), (999, 100, 99), (1000, 100, 150), (252_000, 10_240,
                                                        2_560)])
def test_split_into_chunks_equals_jax(n, chunk, overlap):
    audio = np.random.default_rng(n).normal(size=n).astype(np.float32)
    got = tbatch.split_into_chunks(audio, chunk, overlap)
    want = jbatch.split_into_chunks(audio, chunk, overlap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_batch_preprocessor_equals_jax():
    rng = np.random.default_rng(4)
    clips = [rng.normal(0, 0.1, n).astype(np.float32)
             for n in (400, 5000, 20_000)]
    t = tbatch.BatchPreprocessor()
    j = jbatch.BatchPreprocessor()
    np.testing.assert_allclose(t.process_batch(clips, n_frames=80),
                               j.process_batch(clips, n_frames=80),
                               rtol=0, atol=MEL_TOL)
    mels = [rng.normal(size=(n, 80)).astype(np.float32) for n in (3, 9, 5)]
    np.testing.assert_array_equal(t.to_padded_tensor(mels),
                                  j.to_padded_tensor(mels))
    np.testing.assert_array_equal(t.to_padded_tensor(mels, 4),
                                  j.to_padded_tensor(mels, 4))
    assert t.to_padded_tensor([]).shape == j.to_padded_tensor([]).shape


def test_dedup_equals_jax():
    rng = np.random.default_rng(8)
    for _ in range(200):
        prev = rng.integers(0, 6, rng.integers(0, 14)).tolist()
        k = int(rng.integers(0, len(prev) + 1))
        new = prev[len(prev) - k:] + rng.integers(0, 6, rng.integers(
            0, 8)).tolist()
        for lim in (3, 10):
            assert tistream.dedup_overlap_tokens(prev, new, lim) == \
                jistream.dedup_overlap_tokens(prev, new, lim)
    words = ["the", "The,", "cat", "sat.", "on", "'mat'", "a"]
    for _ in range(200):
        prev = " ".join(rng.choice(words, rng.integers(0, 12)))
        new = " ".join(rng.choice(words, rng.integers(0, 12)))
        tail = " ".join(prev.split()[-int(rng.integers(0, 4)):])
        for n in (new, tail + " " + new):
            assert tistream.dedup_overlap_words(prev, n) == \
                jistream.dedup_overlap_words(prev, n)


@pytest.mark.parametrize("n,hop", [(0, 160), (399, 160), (400, 160),
                                   (401, 160), (1000, 160), (16_007, 160),
                                   (5000, 100)])
@pytest.mark.parametrize("n_mels", [40, 80, 128])
def test_host_mel_compute_equals_jax(n, hop, n_mels):
    audio = np.random.default_rng(n).normal(0, 0.1, n).astype(np.float32)
    got = tmel.MelFilterbank.create(n_mels).compute(audio, hop)
    want = jmel.MelFilterbank.create(n_mels).compute(audio, hop)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert got.shape[0] == (0 if n < 400 else (n - 400) // hop + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL)


def test_log_mel_spectrogram_and_htk_equal_jax():
    audio = np.random.default_rng(2).normal(0, 0.1, 9000).astype(np.float32)
    for pad in (True, False):
        np.testing.assert_allclose(
            tmel.log_mel_spectrogram(audio, 80, pad_to_30s=pad),
            jmel.log_mel_spectrogram(audio, 80, pad_to_30s=pad),
            rtol=0, atol=MEL_TOL)
    fb = jmel.mel_filterbank(128)
    np.testing.assert_allclose(
        tmel.log_mel_spectrogram(audio, filters=fb, pad_to_30s=False),
        jmel.log_mel_spectrogram(audio, filters=fb, pad_to_30s=False),
        rtol=0, atol=MEL_TOL)
    for hz in (0.0, 440.0, 8000.0):
        assert tmel.hz_to_mel_htk(hz) == jmel.hz_to_mel_htk(hz)
        m = jmel.hz_to_mel_htk(hz)
        assert tmel.mel_to_hz_htk(m) == jmel.mel_to_hz_htk(m)
    assert (taudio.N_MELS_80, taudio.N_MELS_128, taudio.N_FREQS) == \
        (80, 128, 201)


# ---------------------------------------------------------------------------
# the engine: long audio, files, VAD, prefix reuse, sessions
# ---------------------------------------------------------------------------

GATES_OFF = dict(logprob_thold=-1e9, compression_ratio_thold=1e9,
                 entropy_thold=-1.0)


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("n", [24_000, 252_000])
def test_transcribe_long_equals_jax(engines, n, fallback):
    """3 windows, and 33 (past the 32-row chunking of the batched
    kernels), in one transcribe_batch; with ``fallback`` the gates are
    set so that no window retries (a retry samples, and the port's
    sampler draws from torch, not jax.random)."""
    jeng, teng = engines
    audio = speech_like(n, seed=n)
    kw = dict(language="en", **(GATES_OFF if fallback else {}))
    got = teng.transcribe_long(audio, TranscribeOptions(**kw),
                               fallback=fallback)
    want = jeng.transcribe_long(audio, JOptions(**kw), fallback=fallback)
    same_result(got, want)
    assert len(got.segments) > 1 and got.text
    assert {round(s.start / 0.48, 9) % 1 for s in got.segments} == {0.0}


def test_transcribe_long_one_window_equals_transcribe(engines):
    jeng, teng = engines
    audio = speech_like(9_000, seed=2)
    opts = TranscribeOptions(language="en")
    same_result(teng.transcribe_long(audio, opts),
                jeng.transcribe_long(audio, JOptions(language="en")))
    same_result(teng.transcribe_long(audio, opts), teng.transcribe(audio,
                                                                    opts))


def _wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2")
                      .tobytes())
    return buf.getvalue()


def test_transcribe_file_equals_jax(engines, tmp_path):
    jeng, teng = engines
    path = tmp_path / "long.wav"
    path.write_bytes(_wav_bytes(speech_like(24_000, seed=6), SR))
    opts = dict(language="en")
    got = teng.transcribe_file(str(path), TranscribeOptions(**opts))
    same_result(got, jeng.transcribe_file(str(path), JOptions(**opts)))
    assert len(got.segments) == 3


def test_transcribe_with_vad_equals_jax(engines):
    jeng, teng = engines
    audio = bursts([(0.5, "silence"), (0.6, "speech"), (0.8, "silence"),
                    (0.5, "speech"), (0.9, "silence"), (0.7, "speech"),
                    (0.6, "silence")], seed=21)
    got = teng.transcribe_with_vad(audio, TranscribeOptions(language="en"))
    same_result(got, jeng.transcribe_with_vad(audio,
                                              JOptions(language="en")))
    assert len(got.segments) == 3
    silent = silence_like(8000)
    assert teng.transcribe_with_vad(silent).text == \
        jeng.transcribe_with_vad(silent).text == ""


def _gen(eng, full):
    initial = eng.get_initial_tokens("en")
    return [t for t in full.tokens[len(initial):] if t != eng.specials.eot]


class TestPrefixed:
    """JAX ``tests/test_streaming.py`` TestPrefixReuse, both engines."""

    def test_continuation_is_exact(self, engines):
        jeng, teng = engines
        audio = np.random.default_rng(0).normal(0, 0.2, 16_000).astype(
            np.float32)
        kw = dict(language="en", max_tokens=24)
        full = teng.transcribe(audio, TranscribeOptions(**kw))
        gen = _gen(teng, full)
        assert len(gen) > teng.PREFIX_BUCKET == 8
        got = teng.transcribe_prefixed(audio, gen[:-2],
                                       TranscribeOptions(**kw))
        assert got.tokens == full.tokens
        same_result(got, jeng.transcribe_prefixed(audio, gen[:-2],
                                                  JOptions(**kw)))

    def test_bucket_truncation(self, engines):
        jeng, teng = engines
        audio = np.random.default_rng(1).normal(0, 0.2, 16_000).astype(
            np.float32)
        kw = dict(language="en", max_tokens=20)
        full = teng.transcribe(audio, TranscribeOptions(**kw))
        gen = _gen(teng, full)
        got = teng.transcribe_prefixed(audio, gen[:11],
                                       TranscribeOptions(**kw))
        assert got.tokens == full.tokens
        same_result(got, jeng.transcribe_prefixed(audio, gen[:11],
                                                  JOptions(**kw)))

    def test_too_long_falls_back(self, engines):
        jeng, teng = engines
        audio = np.random.default_rng(2).normal(0, 0.2, 8_000).astype(
            np.float32)
        kw = dict(language="en", max_tokens=8)
        prefix = list(range(5, 5 + 32))
        got = teng.transcribe_prefixed(audio, prefix,
                                       TranscribeOptions(**kw))
        same_result(got, jeng.transcribe_prefixed(audio, prefix,
                                                  JOptions(**kw)))
        same_result(got, teng.transcribe(audio, TranscribeOptions(**kw)))


SESSION_PLAN = [(0.4, "silence"), (2.0, "speech"), (0.7, "silence"),
                (1.6, "speech"), (0.6, "silence")]


def _drive_session(sess, audio: np.ndarray, block: int):
    """Push in blocks; after each, the partial when there is one. Returns
    the results, the partials (with the reused tokens) and the final
    transcript."""
    log = []
    for i in range(0, len(audio), block):
        res = sess.push(audio[i:i + block])
        log.append([(r.kind, r.text, round(r.time, 9)) for r in res])
        if sess.has_partial():
            log.append(("partial", sess.get_partial(),
                        list(sess._partial_tokens)))
    return log, sess.finalize()


def _partials(log):
    return [e for e in log if isinstance(e, tuple) and e[0] == "partial"]


@pytest.mark.parametrize("reuse", [True, False])
def test_streaming_session_equals_jax(engines, reuse):
    jeng, teng = engines
    audio = bursts(SESSION_PLAN, seed=31)
    got = _drive_session(
        tistream.StreamingSession(teng, TranscribeOptions(language="en"),
                                  input_sample_rate=SR, partial_reuse=reuse),
        audio, 8000)
    want = _drive_session(
        jistream.StreamingSession(jeng, JOptions(language="en"),
                                  input_sample_rate=SR, partial_reuse=reuse),
        audio, 8000)
    assert got == want
    log, final = got
    assert final and len(_partials(log)) >= 4
    assert any(r[0] == "chunk" for e in log if isinstance(e, list)
               for r in e)
    if reuse:
        assert max(len(e[2]) for e in _partials(log)) > 3 + 8


def test_engine_session_factory_and_partial(engines):
    _, teng = engines
    sess = teng.create_streaming_session(TranscribeOptions(language="en"),
                                         input_sample_rate=SR)
    assert isinstance(sess, tistream.StreamingSession)
    assert sess._t.processor.config.input_sample_rate == SR
    audio = speech_like(6000, seed=4)
    same_result(teng.transcribe_partial(audio, is_final=True),
                teng.transcribe(audio))


# ---------------------------------------------------------------------------
# int8 weights, kv_mode cross8: the fused step's plain versions of K1-K4
# ---------------------------------------------------------------------------

def _int8_specials(cls):
    return cls(eot=500, sot=501, lang_base=390, transcribe=502,
               no_timestamps=503, timestamp_base=1700, is_multilingual=False,
               translate=504, no_speech=505, speaker_turn=506, prev=507)


@pytest.fixture(scope="module")
def int8_engines():
    cfg = ModelConfig(
        model_type="tiny", n_vocab=700, n_audio_ctx=32, n_audio_state=128,
        n_audio_head=4, n_audio_layer=2, n_text_ctx=24, n_text_state=128,
        n_text_head=4, n_text_layer=2, n_mels=80)
    jp = quantize_params(init_params(cfg, seed=3), "int8")
    engs = {}
    for mode in ("cross8", "int8"):
        jeng = JWhisperApr(cfg, jp, specials=_int8_specials(JSpecials),
                           compute=JCompute(quantization="int8",
                                            kv_mode=mode))
        jeng._qdecode_cache = jqd.prepare_qdecode(jp, cfg)  # CPU: forced on
        teng = WhisperApr(TModelConfig(**dataclasses.asdict(cfg)),
                          from_jax_params(jp),
                          specials=_int8_specials(TSpecials),
                          compute=TCompute(quantization="int8",
                                           kv_mode=mode), device="cpu")
        engs[mode] = (jeng, teng)
    return engs


@pytest.fixture
def interpret():
    jqd.INTERPRET = True
    try:
        yield
    finally:
        jqd.INTERPRET = False


def test_int8_cross8_session_partials_equal_jax(int8_engines, interpret):
    """A short session with prefix reuse: every partial's tokens equal."""
    jeng, teng = int8_engines["cross8"]
    audio = bursts([(0.3, "silence"), (1.5, "speech")], seed=41)
    kw = dict(language="en", max_tokens=16)
    got = _drive_session(
        tistream.StreamingSession(teng, TranscribeOptions(**kw),
                                  input_sample_rate=SR), audio, 6000)
    want = _drive_session(
        jistream.StreamingSession(jeng, JOptions(**kw),
                                  input_sample_rate=SR), audio, 6000)
    assert got == want
    assert len(_partials(got[0])) >= 2


@pytest.mark.parametrize("mode", ["cross8", "int8"])
def test_int8_prefixed_near_the_budget_equals_jax(int8_engines, interpret,
                                                  mode):
    """A 16-token prefix: the prompt fills self rows 0-18 and the steps
    write rows 19-22 (max_tokens - 2), over int8 cross rows (cross8) and
    int8 self rows (int8)."""
    jeng, teng = int8_engines[mode]
    audio = speech_like(9000, seed=5)
    kw = dict(language="en", max_tokens=24)
    prefix = np.random.default_rng(6).integers(0, 400, 19).tolist()
    got = teng.transcribe_prefixed(audio, prefix, TranscribeOptions(**kw))
    want = jeng.transcribe_prefixed(audio, prefix, JOptions(**kw))
    assert got.tokens == want.tokens and got.text == want.text
    assert got.tokens[3:19] == prefix[:16]
