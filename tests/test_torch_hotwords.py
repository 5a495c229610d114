"""The port's hotword boosting against the JAX package's, on the CPU: the
token trie, the booster, the domain adapter and the customizer on seeded
logits, ``parse_hotwords``, and the engine's host-stepped hotword decode
(JAX ``tests/test_hotwords.py``) boosted and unboosted, over the f32
engines of ``test_torch_streaming.make_engines``: tokens and texts
identical.
"""

import numpy as np
import pytest
import torch

from test_torch_streaming import engine_config, make_engines, speech_like
from whisper_apr_tpu import vocabulary as jvocab
from whisper_apr_tpu.engine import TranscribeOptions as JOptions
from whisper_apr_tpu.engine import WhisperApr as JWhisperApr
from whisper_apr_tpu_torch import TranscribeOptions, WhisperApr
from whisper_apr_tpu_torch import vocabulary as tvocab


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    return make_engines(engine_config())


def test_parse_hotwords_equals_jax():
    items = ["acme", "zebra:7.5", ("x y", 2.0), ["a", "3"], "ratio:1:2",
             "url:http", "neg:-1.5", ":4", "plain:"]
    assert WhisperApr.parse_hotwords(items) == \
        JWhisperApr.parse_hotwords(items)
    assert WhisperApr.parse_hotwords(items)[:3] == [
        ("acme", 5.0), ("zebra", 7.5), ("x y", 2.0)]
    assert WhisperApr.parse_hotwords(None) == [] == \
        JWhisperApr.parse_hotwords(None)


def _phrases(seed: int):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 12, rng.integers(1, 5)).tolist(),
             float(rng.choice([-2.0, 0.0, 1.5, 4.0, 9.0])))
            for _ in range(rng.integers(1, 8))]


@pytest.mark.parametrize("seed", range(6))
def test_trie_boosts_equal_jax(seed):
    t, j = tvocab.VocabularyTrie(), jvocab.VocabularyTrie()
    for ids, boost in _phrases(seed):
        t.insert(ids, boost)
        j.insert(ids, boost)
    assert len(t) == len(j)
    rng = np.random.default_rng(100 + seed)
    logits = rng.normal(size=(3, 16)).astype(np.float32)
    for _ in range(30):
        ctx = rng.integers(0, 12, rng.integers(0, 6)).tolist()
        assert sorted(t.continuations(ctx)) == sorted(j.continuations(ctx))
        np.testing.assert_array_equal(t.apply_prefix_boost(logits, ctx),
                                      j.apply_prefix_boost(logits, ctx))


def test_booster_adapter_customizer_equal_jax(engines):
    jeng, teng = engines
    phrases = [("w300 w301", 4.0), ("zebra", 2.5), ("  w512 ", None),
               ("", 3.0)]
    tb = tvocab.HotwordBooster(teng.tokenizer, boost=6.0)
    jb = jvocab.HotwordBooster(jeng.tokenizer, boost=6.0)
    for phrase, boost in phrases:
        tb.add_hotword(phrase, boost)
        jb.add_hotword(phrase, boost)
    assert [(h.phrase, h.boost) for h in tb.hotwords] == \
        [(h.phrase, h.boost) for h in jb.hotwords]
    assert len(tb.trie) == len(jb.trie) == 4       # "" encodes " "
    n = teng.config.n_vocab
    logits = np.random.default_rng(3).normal(size=n).astype(np.float32)
    for ctx in ([], [300], [300, 301], [7, 300], [ord("z")]):
        np.testing.assert_array_equal(tb.apply(logits, ctx),
                                      jb.apply(logits, ctx))
    ta, ja = tvocab.DomainAdapter(n), jvocab.DomainAdapter(n)
    for a in (ta, ja):
        a.boost_token(5, 1.5)
        a.boost_token(n + 3, 9.0)
    ta.boost_words(teng.tokenizer, ["w400", "ab"], 2.0)
    ja.boost_words(jeng.tokenizer, ["w400", "ab"], 2.0)
    np.testing.assert_array_equal(ta.bias(), ja.bias())
    tc, jc = tvocab.VocabularyCustomizer(), jvocab.VocabularyCustomizer()
    tc.add_booster(tb)
    tc.add_adapter(ta)
    jc.add_booster(jb)
    jc.add_adapter(ja)
    np.testing.assert_array_equal(tc.static_bias(n), jc.static_bias(n))
    np.testing.assert_array_equal(tc.apply(logits, [300]),
                                  jc.apply(logits, [300]))


def _same(got, want):
    assert [r.tokens for r in got.results] == [r.tokens for r in want.results]
    assert [r.text for r in got.results] == [r.text for r in want.results]
    assert [[(s.start, s.end, s.text) for s in r.segments]
            for r in got.results] == \
        [[(s.start, s.end, s.text) for s in r.segments]
         for r in want.results]


def _clips():
    return [np.random.default_rng(5).normal(0, 0.1, 4000).astype(np.float32),
            speech_like(7000, seed=9)]


def test_unboosted_hotword_path_matches_greedy(engines):
    """An absent phrase at boost 0: the host-stepped decode gives the
    fused greedy path's tokens, and the JAX engine's."""
    jeng, teng = engines
    kw = dict(language="en", max_tokens=12)
    hw = dict(kw, hotwords=[("zzzz_not_present_zzzz", 0.0)])
    clips = _clips()
    got = teng.transcribe_batch(clips, TranscribeOptions(**hw))
    _same(got, jeng.transcribe_batch(clips, JOptions(**hw)))
    base = teng.transcribe_batch(clips, TranscribeOptions(**kw))
    assert [r.tokens for r in got.results] == \
        [r.tokens for r in base.results]


def test_boosted_hotwords_equal_jax(engines):
    """Boosts that change the decode. The word vocabulary has no merges,
    so a phrase encodes to its bytes, and its first byte is boosted at
    every step."""
    jeng, teng = engines
    kw = dict(language="en", max_tokens=12)
    clips = _clips()
    base = teng.transcribe_batch(clips, TranscribeOptions(**kw))
    hw = dict(kw, hotwords=["w300 w301:40", ("w777", 30.0), "w5"])
    got = teng.transcribe_batch(clips, TranscribeOptions(**hw))
    _same(got, jeng.transcribe_batch(clips, JOptions(**hw)))
    assert [r.tokens for r in got.results] != \
        [r.tokens for r in base.results]
    assert any(ord("w") in r.tokens for r in got.results)


def test_boost_flips_the_first_token(engines, monkeypatch):
    """JAX ``test_boosted_phrase_wins_argmax``: a huge boost on another
    token makes it the first generated token, on both engines."""
    jeng, teng = engines
    audio = _clips()[0]
    kw = dict(language="en", max_tokens=8)
    base = teng.transcribe(audio, TranscribeOptions(**kw))
    P = len(teng.get_initial_tokens("en"))
    alt = (base.tokens[P] + 1) % 200
    out = []
    for mod, eng, opts in ((tvocab, teng, TranscribeOptions),
                           (jvocab, jeng, JOptions)):
        monkeypatch.setattr(mod.HotwordBooster, "add_hotword",
                            lambda self, phrase, boost=None:
                            self.trie.insert([alt], 1e9))
        out.append(eng.transcribe(audio, opts(**kw,
                                              hotwords=[("BOOSTME", 1.0)])))
    assert out[0].tokens[P] == alt != base.tokens[P]
    assert out[0].tokens == out[1].tokens
