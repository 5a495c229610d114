"""The port's engine strategies against the JAX engine, at a small width on
the CPU: beam search, n-best, sampling, timestamp tokens and the
temperature fallback, in kv mode "scan" (the scan step, K8 and K9) and
"cross8" (the fused step with the logits tail), and greedy decoding with
f32 weights.

Both engines hold the same weights (the JAX package's seeded
``init_params``, carried across by ``from_jax_params``). The JAX engine
gates its kernel path off the CPU, so its qd is forced through
``eng._qdecode_cache`` and its Pallas kernels run in interpret mode, as
``test_torch_serving.py`` drives it. Compute is f32 on both sides: tokens
must be identical, average log-probs within 1e-4, no-speech
probabilities within 1e-5.
"""

import numpy as np
import pytest
import torch

from whisper_apr_tpu.config import ComputeConfig as JCompute
from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.engine import TranscribeOptions as JOptions
from whisper_apr_tpu.engine import WhisperApr as JWhisperApr
from whisper_apr_tpu.model import qdecode as jqd
from whisper_apr_tpu.model.params import init_params, quantize_params
from whisper_apr_tpu.tokenizer import SpecialTokens
from whisper_apr_tpu_torch import ComputeConfig as TCompute
from whisper_apr_tpu_torch import TranscribeOptions, WhisperApr
from whisper_apr_tpu_torch.model.params import from_jax_params
from whisper_apr_tpu_torch.ops import qmatvec as tqm
from whisper_apr_tpu_torch.tokenizer import SpecialTokens as TSpecials


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

MODES = ["scan", "cross8"]


@pytest.fixture(scope="module")
def cfg():
    return ModelConfig(
        model_type="tiny", n_vocab=700, n_audio_ctx=32, n_audio_state=128,
        n_audio_head=4, n_audio_layer=2, n_text_ctx=24, n_text_state=128,
        n_text_head=4, n_text_layer=3, n_mels=80)


@pytest.fixture(scope="module")
def params(cfg):
    jp = quantize_params(init_params(cfg, seed=3), "int8")
    return jp, from_jax_params(jp)


def _specials(cls, timestamps: bool = False):
    """Special ids of a 700-token test vocabulary; with ``timestamps``
    the ids from 510 up are timestamps (as in Whisper, above EOT)."""
    return cls(eot=500, sot=501, lang_base=390, transcribe=502,
               no_timestamps=503,
               timestamp_base=510 if timestamps else 1700,
               is_multilingual=False, translate=504, no_speech=505,
               speaker_turn=506, prev=507)


def _engines(cfg, jp, tp, mode, timestamps=False, quantized=True):
    jeng = JWhisperApr(cfg, jp, specials=_specials(SpecialTokens, timestamps),
                       compute=JCompute(quantization="int8", kv_mode=mode))
    if quantized:
        jeng._qdecode_cache = jqd.prepare_qdecode(jp, cfg)  # CPU: forced on
    teng = WhisperApr(cfg, tp, specials=_specials(TSpecials, timestamps),
                      compute=TCompute(quantization="int8", kv_mode=mode),
                      device="cpu")
    return jeng, teng


def _audio(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    return (0.3 * np.sin(2 * np.pi * 330 * t)
            + rng.normal(0, 0.05, n)).astype(np.float32)


def _jax(fn, *a, **kw):
    jqd.INTERPRET = True
    try:
        return fn(*a, **kw)
    finally:
        jqd.INTERPRET = False


def _same(got, want):
    assert got.tokens == want.tokens
    assert got.text == want.text
    np.testing.assert_allclose(got.avg_logprob, want.avg_logprob, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got.no_speech_prob, want.no_speech_prob,
                               rtol=0, atol=1e-5)


OPTS = dict(language="en", max_tokens=10)


class TestStrategiesMatchJax:
    @pytest.mark.parametrize("mode", MODES)
    def test_beam(self, cfg, params, mode):
        jeng, teng = _engines(cfg, *params, mode)
        kw = dict(OPTS, strategy="beam", beam_size=3)
        audio = _audio(8_000, seed=1)
        _same(teng.transcribe(audio, TranscribeOptions(**kw)),
              _jax(jeng.transcribe, audio, JOptions(**kw)))

    @pytest.mark.parametrize("mode", MODES)
    def test_nbest(self, cfg, params, mode):
        jeng, teng = _engines(cfg, *params, mode)
        kw = dict(OPTS, strategy="beam", beam_size=3)
        audio = _audio(9_000, seed=2)
        got = teng.transcribe_nbest(audio, TranscribeOptions(**kw))
        want = _jax(jeng.transcribe_nbest, audio, JOptions(**kw))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _same(g, w)

    @pytest.mark.parametrize("mode", MODES)
    def test_timestamps(self, cfg, params, mode):
        """Timestamp tokens: the first generated token is a timestamp
        within the initial cap, and timestamps never decrease."""
        jeng, teng = _engines(cfg, *params, mode, timestamps=True)
        kw = dict(OPTS, timestamps=True)
        audio = _audio(8_000, seed=3)
        got = teng.transcribe(audio, TranscribeOptions(**kw))
        _same(got, _jax(jeng.transcribe, audio, JOptions(**kw)))
        P = len(teng.get_initial_tokens("en", timestamps=True))
        gen = got.tokens[P:]
        assert 510 <= gen[0] <= 560
        ts = [t for t in gen if t >= 510]
        assert ts == sorted(ts)

    @pytest.mark.parametrize("mode", MODES)
    def test_sampling_at_temperature_zero(self, cfg, params, mode):
        """strategy "sampling" at T = 0 with best_of 2: the argmax pick,
        so the JAX engine's tokens, whatever the generator."""
        jeng, teng = _engines(cfg, *params, mode)
        kw = dict(OPTS, strategy="sampling", temperature=0.0, best_of=2)
        audio = _audio(7_000, seed=4)
        _same(teng.transcribe(audio, TranscribeOptions(**kw)),
              _jax(jeng.transcribe, audio, JOptions(**kw)))

    @pytest.mark.parametrize("mode,skip", [("scan", False), ("scan", True),
                                           ("cross8", False)])
    def test_fallback(self, cfg, params, mode, skip):
        """transcribe_with_fallback over two greedy temperatures: the
        gates fail (random weights decode at a low log-prob), so it
        retries; a no-speech threshold of 0 then skips the clip as
        silence."""
        jeng, teng = _engines(cfg, *params, mode)
        kw = dict(OPTS, no_speech_thold=0.0 if skip else 0.6)
        audio = _audio(6_000, seed=5)
        got = teng.transcribe_with_fallback(audio, TranscribeOptions(**kw),
                                            temperatures=(0.0, 0.0))
        want = _jax(jeng.transcribe_with_fallback, audio, JOptions(**kw),
                    temperatures=(0.0, 0.0))
        _same(got, want)
        assert (got.tokens == []) == skip

    def test_greedy_f32_weights(self, cfg):
        """f32 weights: no qd, the plain decode_step."""
        jp = init_params(cfg, seed=3)
        jeng, teng = _engines(cfg, jp, from_jax_params(jp), "auto",
                              quantized=False)
        assert teng._qdecode is None and teng._qf_mode is None
        audio = _audio(8_000, seed=6)
        _same(teng.transcribe(audio, TranscribeOptions(**OPTS)),
              _jax(jeng.transcribe, audio, JOptions(**OPTS)))


class TestStrategies:
    def test_scan_mode_runs_k8_and_k9(self, cfg, params, monkeypatch):
        """kv_mode "scan": every step runs K8 4L + 1 times and K9 L
        times (the plain versions on the CPU), the fused head never."""
        _, teng = _engines(cfg, *params, "scan")
        assert teng._qf_mode is None
        calls = dict.fromkeys(["qmatvec_stacked", "ffn_fused",
                               "qmatvec_greedy_head"], 0)
        for name in calls:
            real = getattr(tqm, name)

            def spy(*a, _real=real, _name=name, **kw):
                calls[_name] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(tqm, name, spy)
        res = teng.transcribe(_audio(8_000, seed=1), TranscribeOptions(**OPTS))
        P = len(teng.get_initial_tokens("en"))
        steps = len(res.tokens) - P - 1
        L = cfg.n_text_layer
        assert calls == {"qmatvec_stacked": (4 * L + 1) * steps,
                         "ffn_fused": L * steps, "qmatvec_greedy_head": 0}

    def test_sampling_same_seed_same_tokens(self, cfg, params):
        _, teng = _engines(cfg, *params, "cross8")
        kw = dict(OPTS, temperature=0.8, top_k=40, top_p=0.95, seed=3)
        audio = _audio(8_000, seed=7)
        a = teng.transcribe(audio, TranscribeOptions(**kw))
        b = teng.transcribe(audio, TranscribeOptions(**kw))
        assert a.tokens == b.tokens and a.avg_logprob == b.avg_logprob
        assert a.temperature == 0.8

    def test_top_k_one_is_greedy(self, cfg, params):
        _, teng = _engines(cfg, *params, "cross8")
        audio = _audio(8_000, seed=8)
        g = teng.transcribe(audio, TranscribeOptions(**OPTS))
        s = teng.transcribe(audio, TranscribeOptions(
            **OPTS, strategy="sampling", temperature=0.7, top_k=1,
            best_of=3))
        assert s.tokens == g.tokens

    def test_batch_fallback_matches_per_clip(self, cfg, params):
        """transcribe_batch_with_fallback gives each clip what
        transcribe_with_fallback gives it alone (greedy temperatures)."""
        _, teng = _engines(cfg, *params, "cross8")
        opts = TranscribeOptions(**OPTS)
        audios = [_audio(6_000, seed=9), _audio(9_000, seed=10)]
        batch = teng.transcribe_batch_with_fallback(audios, opts,
                                                    temperatures=(0.0, 0.0))
        for r, a in zip(batch.results, audios):
            alone = teng.transcribe_with_fallback(a, opts,
                                                  temperatures=(0.0, 0.0))
            assert r.tokens == alone.tokens

    def test_beam_of_several_clips_matches_single_clips(self, cfg, params):
        """Beam search over three clips (9 rows through the batched step)
        gives each clip what a beam search of it alone gives."""
        _, teng = _engines(cfg, *params, "cross8")
        opts = TranscribeOptions(**OPTS, strategy="beam", beam_size=3)
        audios = [_audio(5_000 + 2_000 * i, seed=11 + i) for i in range(3)]
        batch = teng.transcribe_batch(audios, opts)
        for r, a in zip(batch.results, audios):
            alone = teng.transcribe(a, opts)
            assert r.tokens == alone.tokens
            assert r.avg_logprob == pytest.approx(alone.avg_logprob,
                                                  abs=1e-5)

    def test_mel_helpers_default_to_the_card(self, cfg, params,
                                             monkeypatch):
        """The mel helpers take the card unless asked for the CPU, as the
        engine does; compute_30s (the host variant) asks for the CPU."""
        import inspect
        from whisper_apr_tpu_torch.audio.mel import MelFilterbank
        for name in ("constants", "compute_device", "compute_30s_device"):
            default = inspect.signature(getattr(MelFilterbank, name)) \
                .parameters["device"].default
            assert default == "cuda", name
        fb = MelFilterbank.create(80)
        mel = fb.compute_30s(np.zeros(1600, np.float32), n_frames=64)
        assert mel.shape == (64, 80) and isinstance(mel, np.ndarray)
