"""The port's word timestamps and diarization against the JAX package's,
on the CPU: the DTW path (the JAX package's native library against the
port's copy of it) on random and tied costs, the cross-attention
aligner (peak and DTW), the word extractor, the silence refinement, the
speaker embeddings and clustering, the traced decoder and encoder
forwards on f32 and int8 weights, and ``word_timestamps=True`` through
the engines of ``test_torch_streaming.make_engines``.

Tolerances: the traced logits and norms within 1e-4 relative, the
attention weights within 1e-5; embeddings within 1e-4 (the host mel
agrees within 5.2e-5); through the engines, word texts identical and
times within one 20 ms encoder frame (the word-timestamp forward reads the
host mel, which differs in rounding).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_streaming import engine_config, make_engines, speech_like
from whisper_apr_tpu import alignment as jalign
from whisper_apr_tpu import diarization as jdiar
from whisper_apr_tpu.engine import TranscribeOptions as JOptions
from whisper_apr_tpu.model import traced as jtraced
from whisper_apr_tpu.model.params import init_params, quantize_params
from whisper_apr_tpu.native import dtw_path as jdtw_path
from whisper_apr_tpu_torch import ModelConfig as TModelConfig
from whisper_apr_tpu_torch import TranscribeOptions
from whisper_apr_tpu_torch import alignment as talign
from whisper_apr_tpu_torch import diarization as tdiar
from whisper_apr_tpu_torch.model import traced as ttraced
from whisper_apr_tpu_torch.model.params import from_jax_params

SR = 16_000


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
# DTW and the aligner
# ---------------------------------------------------------------------------

def _costs():
    rng = np.random.default_rng(0)
    out = [rng.normal(size=s).astype(np.float32)
           for s in ((1, 1), (1, 7), (7, 1), (5, 9), (9, 5), (30, 70))]
    out += [np.zeros((6, 6), np.float32), np.ones((4, 10), np.float32),
            rng.integers(0, 2, (12, 20)).astype(np.float32),
            rng.integers(-1, 2, (20, 12)).astype(np.float32)]
    return out


@pytest.mark.parametrize("i", range(10))
def test_dtw_path_equals_jax(i):
    cost = _costs()[i]
    ti, tj = talign.dtw_path(cost)
    want_i, want_j = jdtw_path(cost)
    np.testing.assert_array_equal(ti, want_i)
    np.testing.assert_array_equal(tj, want_j)
    assert ti.dtype == tj.dtype == np.int32
    assert (ti[0], tj[0]) == (0, 0)
    assert (ti[-1], tj[-1]) == (cost.shape[0] - 1, cost.shape[1] - 1)


def _weights(seed: int, L=2, B=1, H=3, T=9, S=40):
    rng = np.random.default_rng(seed)
    w = rng.random((L, B, H, T, S)).astype(np.float32) ** 4
    return w / w.sum(-1, keepdims=True)


ALIGN_CASES = [dict(), dict(monotonic=False), dict(layers=[1], heads=[0, 2]),
               dict(method="dtw"), dict(method="dtw", layers=[0])]


@pytest.mark.parametrize("kw", ALIGN_CASES)
@pytest.mark.parametrize("num_frames", [None, 25])
def test_token_alignments_equal_jax(kw, num_frames):
    w = _weights(1)
    ids = list(range(300, 309))
    got = talign.CrossAttentionAlignment(
        talign.AlignmentConfig(**kw)).extract_token_alignments(
        w, ids, num_frames)
    want = jalign.CrossAttentionAlignment(
        jalign.AlignmentConfig(**kw)).extract_token_alignments(
        w, ids, num_frames)
    assert [dataclasses.astuple(a) for a in got] == \
        [dataclasses.astuple(a) for a in want]


def test_words_and_refinement_equal_jax():
    """Token pieces with and without a leading space group into words;
    boundaries snap to the quiet 10 ms frames."""
    from test_torch_streaming import _word_tokenizer
    from whisper_apr_tpu.tokenizer import BpeTokenizer as JBpe
    from whisper_apr_tpu.tokenizer import Vocabulary as JVocab
    from whisper_apr_tpu_torch.tokenizer import BpeTokenizer as TBpe
    from whisper_apr_tpu_torch.tokenizer import Vocabulary as TVocab
    ids = [300, ord("a"), ord("b"), 301, 302, ord(" "), ord("c"), 999, 303]
    w = _weights(2, T=len(ids), S=50)
    audio = speech_like(16_000, seed=3)
    audio[4000:6000] *= 0.01
    for method in ("peak", "dtw"):
        got = talign.WordTimestampExtractor(
            _word_tokenizer(TVocab, TBpe, 1000),
            talign.AlignmentConfig(method=method)).extract(w, ids, 45)
        want = jalign.WordTimestampExtractor(
            _word_tokenizer(JVocab, JBpe, 1000),
            jalign.AlignmentConfig(method=method)).extract(w, ids, 45)
        assert [dataclasses.astuple(x) for x in got] == \
            [dataclasses.astuple(x) for x in want]
        assert [x.word for x in got][:2] == ["w300ab", "w301"]
        assert [dataclasses.astuple(x) for x in
                talign.refine_boundaries_by_silence(got, audio)] == \
            [dataclasses.astuple(x) for x in
             jalign.refine_boundaries_by_silence(want, audio)]


# ---------------------------------------------------------------------------
# diarization
# ---------------------------------------------------------------------------

def two_voices(seconds_each: float = 2.0, turns: int = 4,
               seed: int = 0) -> np.ndarray:
    """Alternating turns of a low harmonic voice and a high, breathier
    one."""
    rng = np.random.default_rng(seed)
    n = int(seconds_each * SR)
    t = np.arange(n) / SR
    low = sum(np.sin(2 * np.pi * 140 * k * t) / k for k in range(1, 6))
    high = np.sin(2 * np.pi * 520 * t) + 0.6 * np.sin(2 * np.pi * 1560 * t)
    parts = [(0.3 * (low if i % 2 == 0 else high)
              + 0.02 * rng.normal(size=n)) for i in range(turns)]
    return np.concatenate(parts).astype(np.float32)


def test_embeddings_within_tolerance():
    audio = two_voices()
    t, j = tdiar.EmbeddingExtractor(), jdiar.EmbeddingExtractor()
    for start in (0, 12_000, 40_000):
        win = audio[start:start + 24_000]
        np.testing.assert_allclose(t.extract(win), j.extract(win), rtol=0,
                                   atol=1e-4)
    assert t.extract(audio[:500]) is None and j.extract(audio[:500]) is None


def test_clustering_equals_jax():
    rng = np.random.default_rng(4)
    emb = np.concatenate([rng.normal(0, 0.1, (6, 12)) + 1.0,
                          rng.normal(0, 0.1, (5, 12)) - 1.0,
                          rng.normal(0, 0.1, (4, 12)) * 3])
    for thr, mx in ((0.35, 4), (0.05, 2), (2.0, 4)):
        np.testing.assert_array_equal(
            tdiar.agglomerative_cluster(emb, thr, mx),
            jdiar.agglomerative_cluster(emb, thr, mx))
    for k in (1, 2, 3, 20):
        np.testing.assert_array_equal(tdiar.kmeans_cluster(emb, k, seed=2),
                                      jdiar.kmeans_cluster(emb, k, seed=2))
    assert tdiar.cosine_distance(emb[0], emb[7]) == \
        jdiar.cosine_distance(emb[0], emb[7])
    assert tdiar.cosine_distance(emb[0], 0 * emb[0]) == 1.0


@pytest.mark.parametrize("kw", [dict(distance_threshold=0.1),
                                dict(num_speakers=2)])
def test_diarizer_segments_equal_jax(kw):
    """Agglomerative (the two voices' embeddings sit ~0.26 apart in
    cosine distance, under the default 0.35 cut) and k-means."""
    audio = two_voices()
    got = tdiar.Diarizer(tdiar.DiarizationConfig(**kw)).process(audio)
    want = jdiar.Diarizer(jdiar.DiarizationConfig(**kw)).process(audio)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    assert tdiar.Diarizer().speaker_count(got) == 2
    short = audio[:8000]
    assert [dataclasses.astuple(s) for s in tdiar.Diarizer().process(short)] \
        == [dataclasses.astuple(s) for s in jdiar.Diarizer().process(short)]


# ---------------------------------------------------------------------------
# the traced forwards
# ---------------------------------------------------------------------------

def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))
                 / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_traced_forwards_equal_jax(quant):
    cfg = engine_config()
    jp = init_params(cfg, seed=4)
    if quant == "int8":
        jp = quantize_params(jp, "int8")
    tp = from_jax_params(jp)
    tcfg = TModelConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(5)
    mel = rng.normal(size=(2, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(
        np.float32)
    enc_t, met_t = ttraced.encoder_forward_traced(tp, torch.from_numpy(mel),
                                                  tcfg)
    enc_j, met_j = jtraced.encoder_forward_traced(jp, jnp.asarray(mel), cfg)
    assert _rel(enc_t.numpy(), enc_j) < 1e-4
    for g, w in zip(met_t, met_j):
        assert g["layer"] == w["layer"]
        for k in ("mean_activation", "max_activation", "attention_entropy"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4)

    tokens = rng.integers(0, cfg.n_vocab, (2, 11))
    lt, nt, wt = ttraced.decoder_forward_traced(
        tp, torch.from_numpy(tokens), enc_t, tcfg)
    lj, nj, wj = jtraced.decoder_forward_traced(
        jp, jnp.asarray(tokens, jnp.int32), enc_j, cfg)
    assert lt.shape == lj.shape and _rel(lt.numpy(), lj) < 1e-4
    assert list(nt) == list(nj)
    for k in nj:
        np.testing.assert_allclose(nt[k], nj[k], rtol=1e-4)
    assert wt.shape == (cfg.n_text_layer, 2, cfg.n_text_head, 11,
                        cfg.n_audio_ctx) == wj.shape
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# word timestamps through the engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    return make_engines(engine_config())


@pytest.mark.parametrize("method", ["dtw", "peak"])
def test_engine_word_timestamps_equal_jax(engines, method):
    jeng, teng = engines
    clips = [speech_like(9000, seed=12), speech_like(5000, seed=13)]
    kw = dict(language="en", max_tokens=16, word_timestamps=True,
              word_alignment=method)
    got = teng.transcribe_batch(clips, TranscribeOptions(**kw)).results
    want = jeng.transcribe_batch(clips, JOptions(**kw)).results
    for g, w, clip in zip(got, want, clips):
        assert g.tokens == w.tokens and g.text == w.text
        assert [x.word for x in g.words] == [x.word for x in w.words]
        assert g.words
        np.testing.assert_allclose([(x.start, x.end) for x in g.words],
                                   [(x.start, x.end) for x in w.words],
                                   rtol=0, atol=0.02 + 1e-9)
        starts = [x.start for x in g.words]
        assert starts == sorted(starts)
        assert all(0 <= x.start and x.end <= len(clip) / SR + 0.1
                   for x in g.words)
