"""The port's `.apr` surface against the JAX package's, on the CPU: v2
containers written by the JAX ``AprWriterV2`` (f32 and int8, with a
vocabulary and a mel filterbank) load in the port with the JAX load's
params and greedy tokens; the port's v2 writer gives the JAX writer's
bytes; the validator's checks; CRC and magic rejection; and the load
progress sequence of ``load_from_apr(progress=...)``.

Weights are the port's ``params_to_apr_tensors`` of seed-0
``init_params`` (the same numpy draws as the JAX package's), a
700-token config with explicit special tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

from whisper_apr_tpu.audio.mel import mel_filterbank as jmel_filterbank
from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.engine import TranscribeOptions as JOptions
from whisper_apr_tpu.engine import WhisperApr as JWhisperApr
from whisper_apr_tpu.errors import FormatError as JFormatError
from whisper_apr_tpu.format import AprReader as JAprReader
from whisper_apr_tpu.format import AprValidator as JAprValidator
from whisper_apr_tpu.format import AprWriter as JAprWriter
from whisper_apr_tpu.format import AprWriterV2 as JAprWriterV2
from whisper_apr_tpu.format import MelFilterbankData as JMelData
from whisper_apr_tpu.tokenizer import SpecialTokens
from whisper_apr_tpu.tokenizer import Vocabulary as JVocabulary
from whisper_apr_tpu_torch import ModelConfig as TModelConfig
from whisper_apr_tpu_torch import TranscribeOptions, WhisperApr
from whisper_apr_tpu_torch.errors import FormatError, ModelError
from whisper_apr_tpu_torch.format import (QUANT_F32, QUANT_INT8, AprReader,
                                          AprReaderV2, AprValidator,
                                          AprWriter, AprWriterV2,
                                          MelFilterbankData, is_v2)
from whisper_apr_tpu_torch.model.params import (from_jax_params,
                                                init_params,
                                                load_params_from_apr,
                                                params_to_apr_tensors)
from whisper_apr_tpu_torch.tokenizer import SpecialTokens as TSpecials

OPTS = dict(language="en", max_tokens=6)


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
def cfg():
    return ModelConfig(
        model_type="tiny", n_vocab=700, n_audio_ctx=32, n_audio_state=128,
        n_audio_head=2, n_audio_layer=2, n_text_ctx=48, n_text_state=128,
        n_text_head=2, n_text_layer=2, n_mels=80)


def _tcfg(cfg):
    return TModelConfig(**dataclasses.asdict(cfg))


def _specials(cls):
    return cls(eot=500, sot=501, lang_base=390, transcribe=502,
               no_timestamps=503, timestamp_base=1700,
               is_multilingual=False, translate=504, no_speech=505,
               speaker_turn=506, prev=507)


@pytest.fixture(scope="module")
def tensors(cfg):
    return params_to_apr_tensors(init_params(_tcfg(cfg), seed=0))


@pytest.fixture(scope="module")
def vocab_bytes(cfg):
    v = JVocabulary.with_base_tokens()
    while len(v) < cfg.n_vocab:
        v.add_token(b"<|tok%d|>" % len(v))
    return v.to_bytes()


def _write(writer_cls, fb_cls, cfg, tensors, vocab_bytes, quant):
    w = writer_cls.from_config(cfg, quantization=quant)
    for name, arr in tensors.items():
        w.add_tensor(name, arr)
    w.set_vocabulary(vocab_bytes)
    w.set_mel_filterbank(fb_cls(80, 201, jmel_filterbank(80)))
    return w.to_bytes()


@pytest.fixture(scope="module")
def files(cfg, tensors, vocab_bytes):
    """{(version, quant): bytes}, every file written by the JAX package."""
    out = {}
    for quant, code in (("f32", QUANT_F32), ("int8", QUANT_INT8)):
        out[("v2", quant)] = _write(JAprWriterV2, JMelData, cfg, tensors,
                                    vocab_bytes, code)
        out[("v1", quant)] = _write(JAprWriter, JMelData, cfg, tensors,
                                    vocab_bytes, code)
    return out


def _jax_bytes(files, key):
    """The file the JAX engine loads for ``key``: its own v2 int8 load
    raises (its v2 reader has no ``find_tensor``, which the int8 load
    path calls; ROADMAP.md queue 3), so an int8 v2 file is held against
    the JAX load of its v1 twin: the same tensors, quantized the same
    way (``TestV2Load.test_v2_equals_its_v1_twin``)."""
    return files[("v1", "int8")] if key == ("v2", "int8") else files[key]


def _audio(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    return (0.3 * np.sin(2 * np.pi * 330 * t)
            + rng.normal(0, 0.05, n)).astype(np.float32)


def _assert_same_tree(got, want, path="params"):
    """Same structure, and every tensor (QTensor q / scale / zero and
    metadata too) equal bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
        return
    if hasattr(want, "q"):
        for f in ("int4", "orig_last", "group", "kpack"):
            assert getattr(got, f) == getattr(want, f), f"{path}.{f}"
        for f in ("q", "scale", "zero"):
            w, g = getattr(want, f), getattr(got, f)
            assert (g is None) == (w is None), f"{path}.{f}"
            if w is not None:
                _assert_same_tree(g, w, f"{path}.{f}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(got, want), path


class TestV2Load:
    """JAX ``AprWriterV2`` bytes in the port (the test the v2 fault
    owed)."""

    @pytest.mark.parametrize("quant", ["f32", "int8"])
    def test_params_equal_the_jax_load(self, cfg, files, quant):
        data = files[("v2", quant)]
        assert is_v2(data)
        jeng = JWhisperApr.load_from_apr(_jax_bytes(files, ("v2", quant)),
                                         specials=_specials(SpecialTokens))
        teng = WhisperApr.load_from_apr(data, specials=_specials(TSpecials),
                                        device="cpu")
        _assert_same_tree(teng.params, from_jax_params(jeng.params))
        assert teng.config == _tcfg(cfg)
        assert len(teng.tokenizer.vocab) == cfg.n_vocab
        np.testing.assert_array_equal(teng.mel_filters.filters,
                                      np.asarray(jeng.mel_filters.filters))

    @pytest.mark.parametrize("quant", ["f32", "int8"])
    def test_greedy_tokens_equal_the_jax_engine(self, files, quant):
        data = files[("v2", quant)]
        jeng = JWhisperApr.load_from_apr(_jax_bytes(files, ("v2", quant)),
                                         specials=_specials(SpecialTokens))
        teng = WhisperApr.load_from_apr(data, specials=_specials(TSpecials),
                                        device="cpu")
        audio = _audio(12_000, seed=3)
        want = jeng.transcribe(audio, JOptions(**OPTS))
        got = teng.transcribe(audio, TranscribeOptions(**OPTS))
        assert len(got.tokens) > 4
        assert got.tokens == want.tokens

    @pytest.mark.parametrize("quant", ["f32", "int8"])
    def test_v2_equals_its_v1_twin(self, files, quant):
        """The same tensors through both containers give the same
        engine: identical params and greedy tokens."""
        engs = [WhisperApr.load_from_apr(files[(v, quant)],
                                         specials=_specials(TSpecials),
                                         device="cpu") for v in ("v1", "v2")]
        _assert_same_tree(engs[1].params, engs[0].params)
        audio = _audio(8_000, seed=4)
        toks = [e.transcribe(audio, TranscribeOptions(**OPTS)).tokens
                for e in engs]
        assert toks[0] == toks[1]

    def test_jax_int8_v2_load_raises(self, files):
        """The reference fault the int8 comparisons work around."""
        from whisper_apr_tpu.errors import ModelError as JModelError
        with pytest.raises(JModelError, match="find_tensor"):
            JWhisperApr.load_from_apr(files[("v2", "int8")],
                                      specials=_specials(SpecialTokens))

    def test_loads_from_a_path(self, files, tmp_path):
        p = tmp_path / "m.apr"
        p.write_bytes(files[("v2", "int8")])
        eng = WhisperApr.load_from_apr(str(p), specials=_specials(TSpecials),
                                       device="cpu")
        assert eng.params["decoder"]["blocks"]["fc1"]["w"].q.dtype \
            == torch.int8

    def test_corrupt_v2_is_refused(self, files):
        data = bytearray(files[("v2", "f32")])
        data[-10] ^= 0xFF
        with pytest.raises(ModelError, match="CRC32"):
            WhisperApr.load_from_apr(bytes(data), device="cpu")

    def test_loader_reads_a_v2_reader(self, cfg, files):
        """``load_params_from_apr`` takes the v2 reader directly and
        fires ``on_tensor`` once a tensor read."""
        seen = []
        params = load_params_from_apr(
            AprReaderV2(files[("v2", "f32")]),
            on_tensor=lambda name, i: seen.append((name, i)))
        assert [i for _, i in seen] == list(range(1, len(seen) + 1))
        assert len(seen) == 7 + 16 * cfg.n_audio_layer \
            + 4 + 26 * cfg.n_text_layer
        assert params["encoder"]["conv1"]["w"].dtype == torch.float32


class TestWriterAndReader:
    @pytest.mark.parametrize("quant", [QUANT_F32, QUANT_INT8],
                             ids=["f32", "int8"])
    def test_writer_bytes_equal_jax(self, cfg, tensors, vocab_bytes, quant):
        want = _write(JAprWriterV2, JMelData, cfg, tensors, vocab_bytes,
                      quant)
        got = _write(AprWriterV2, MelFilterbankData, _tcfg(cfg), tensors,
                     vocab_bytes, quant)
        assert got == want

    def test_reader_surface(self, files):
        r = AprReaderV2(files[("v2", "int8")])
        name = "decoder.layers.0.fc1.weight"
        d = r.find_tensor(name)
        assert d is not None and d.dims == d.shape and d.n_elements == \
            int(np.prod(d.shape))
        assert r.find_tensor("absent") is None
        q, s = r.load_tensor_quantized(name)
        assert q.dtype == np.int8 and s.shape == (1,)
        np.testing.assert_array_equal(r.load_raw(name), q)
        assert r.scale_for(name) == float(s[0])
        np.testing.assert_allclose(r.load_tensor(name),
                                   q.astype(np.float32) * s[0])
        assert r.read_vocabulary_bytes() is not None
        assert r.read_mel_filterbank().data.shape == (80, 201)
        assert r.verify_crc()

    def test_crc_detects_corruption(self, cfg):
        w = AprWriterV2.from_config(_tcfg(cfg))
        w.add_tensor("t", np.ones((4, 4), np.float32))
        data = bytearray(w.to_bytes())
        assert AprReaderV2(bytes(data)).verify_crc()
        data[-10] ^= 0xFF
        assert not AprReaderV2(bytes(data)).verify_crc()

    @pytest.mark.parametrize("data", [b"APR1" + b"\x00" * 100, b"nope"],
                             ids=["v1", "garbage"])
    def test_rejects_v1_and_garbage(self, data):
        with pytest.raises(FormatError):
            AprReaderV2(data)
        with pytest.raises(JFormatError):
            from whisper_apr_tpu.format import AprReaderV2 as J
            J(data)


class TestValidator:
    @pytest.mark.parametrize("quant", ["f32", "int8"])
    def test_checks_equal_jax_on_v1(self, files, quant):
        data = files[("v1", quant)]
        want = JAprValidator(JAprReader(data)).validate_all()
        got = AprValidator(AprReader(data)).validate_all()
        assert [(c.id, c.category, c.passed, c.message) for c in got.checks] \
            == [(c.id, c.category, c.passed, c.message) for c in want.checks]
        assert got.critical_failures == want.critical_failures
        assert got.passed == want.passed

    @pytest.mark.parametrize("quant", ["f32", "int8"])
    def test_v2_checks_equal_its_v1_twin(self, files, quant):
        """The port validates a v2 reader (its descriptors carry the v1
        ``dims`` view) with the outcomes of the v1 twin; the JAX
        validator raises on a v2 reader (a reference fault, recorded in
        ROADMAP.md queue 3)."""
        v1 = AprValidator(AprReader(files[("v1", quant)])).validate_all()
        v2 = AprValidator(AprReaderV2(files[("v2", quant)])).validate_all()
        assert [(c.id, c.passed) for c in v2.checks] == \
            [(c.id, c.passed) for c in v1.checks]
        from whisper_apr_tpu.format import AprReaderV2 as J
        with pytest.raises(AttributeError, match="dims"):
            JAprValidator(J(files[("v2", quant)])).validate_all()


class TestProgress:
    @pytest.mark.parametrize("key", [("v1", "f32"), ("v1", "int8"),
                                     ("v2", "f32"), ("v2", "int8")],
                             ids=lambda k: "-".join(k))
    def test_sequence_equals_jax(self, files, key):
        """The same updates (phase, phase fraction, message) as the JAX
        engine's; the overall fraction within an ulp of JAX's (the
        port's tracker does not step back entering a phase,
        ``utils/progress.py``), monotone, ending at 1.0."""
        want, got = [], []
        JWhisperApr.load_from_apr(_jax_bytes(files, key),
                                  specials=_specials(SpecialTokens),
                                  progress=want.append)
        WhisperApr.load_from_apr(files[key], specials=_specials(TSpecials),
                                 progress=got.append, device="cpu")
        assert [(p.phase, p.phase_progress, p.message) for p in got] == \
            [(p.phase, p.phase_progress, p.message) for p in want]
        np.testing.assert_allclose([p.overall for p in got],
                                   [p.overall for p in want], rtol=0,
                                   atol=1e-15)
        overall = [p.overall for p in got]
        assert overall == sorted(overall) and overall[-1] == 1.0
        assert [p.phase for p in got][:2] == ["read", "parse"]
        assert got[-1].phase == "finalize"

    def test_jax_tracker_steps_back(self):
        """The JAX fraction entering "finalize" is below the decoder
        phase's last value; the port's is equal to it."""
        from whisper_apr_tpu.utils.progress import ProgressTracker as J
        from whisper_apr_tpu_torch.utils.progress import ProgressTracker
        ends = []
        for cls in (J, ProgressTracker):
            t = cls.model_loading()
            t.start_phase("decoder")
            t.update_phase_progress(1.0)
            before = t.to_progress().overall
            t.start_phase("finalize")
            ends.append((before, t.to_progress().overall))
        assert ends[0][1] < ends[0][0]
        assert ends[1][1] == ends[1][0]

    def test_no_callback_no_tracker(self, files):
        WhisperApr.load_from_apr(files[("v1", "f32")],
                                 specials=_specials(TSpecials),
                                 progress=None, device="cpu")
