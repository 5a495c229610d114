"""The port's host layer: import hygiene, the copied host modules against
their JAX-package originals, the .apr container in both directions, the
int8 loader, and the kernel build helpers (which run without a GPU)."""

import dataclasses
import io
import re
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from whisper_apr_tpu import format as jfmt
from whisper_apr_tpu.audio.resample import SincResampler as JResampler
from whisper_apr_tpu.audio.wav import parse_wav as j_parse_wav
from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.detection import LanguageProbs as JLanguageProbs
from whisper_apr_tpu.inference.processors import suppression_bias as j_bias
from whisper_apr_tpu.model.params import init_params
from whisper_apr_tpu.model.params import load_params_from_apr as j_load
from whisper_apr_tpu.tokenizer import BpeTokenizer as JBpe
from whisper_apr_tpu.tokenizer import Vocabulary as JVocab
from whisper_apr_tpu_torch import format as tfmt
from whisper_apr_tpu_torch.audio.resample import SincResampler as TResampler
from whisper_apr_tpu_torch.audio.wav import parse_wav as t_parse_wav
from whisper_apr_tpu_torch.config import ModelConfig as TModelConfig
from whisper_apr_tpu_torch.detection import LanguageProbs as TLanguageProbs
from whisper_apr_tpu_torch.inference.processors import \
    suppression_bias as t_bias
from whisper_apr_tpu_torch.model.params import (from_jax_params,
                                                load_params_from_apr,
                                                params_to_apr_tensors)
from whisper_apr_tpu_torch.ops import _build
from whisper_apr_tpu_torch.ops.quant import QTensor
from whisper_apr_tpu_torch.tokenizer import BpeTokenizer as TBpe
from whisper_apr_tpu_torch.tokenizer import Vocabulary as TVocab


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "whisper_apr_tpu_torch"


def _cfg():
    return ModelConfig(
        model_type="tiny", n_vocab=300, n_audio_ctx=16, n_audio_state=64,
        n_audio_head=1, n_audio_layer=1, n_text_ctx=12, n_text_state=64,
        n_text_head=1, n_text_layer=2, n_mels=80)


class TestImportHygiene:
    def test_port_imports_no_jax(self):
        """Importing the port (and its kernel modules) loads neither jax
        nor the JAX package: the GPU machine has no JAX."""
        code = ("import sys, whisper_apr_tpu_torch, "
                "whisper_apr_tpu_torch.pipeline, "
                "whisper_apr_tpu_torch.ops.decode_blocks, "
                "whisper_apr_tpu_torch.ops.qmatvec, "
                "whisper_apr_tpu_torch.parallel.serving, "
                "whisper_apr_tpu_torch.model.kv_variants, "
                "whisper_apr_tpu_torch.native; "
                "bad = [m for m in sys.modules if m == 'jax' or "
                "m.startswith('jax.') or m == 'whisper_apr_tpu' or "
                "m.startswith('whisper_apr_tpu.')]; print(bad)")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]"

    def test_no_jax_import_in_sources(self):
        bad = re.compile(r"^\s*(import|from)\s+(jax|whisper_apr_tpu)\b"
                         r"(?!_torch)", re.M)
        for p in PORT.rglob("*.py"):
            assert not bad.search(p.read_text()), p

    def test_copies_name_their_original(self):
        copies = ["config.py", "errors.py", "detection.py", "timestamps.py",
                  "format/checksum.py", "format/compress.py",
                  "format/container.py", "tokenizer/bpe.py",
                  "tokenizer/special_tokens.py", "inference/processors.py",
                  "audio/wav.py", "audio/resample.py"]
        for c in copies:
            first = (PORT / c).read_text().splitlines()[0]
            assert first.startswith(f"# Copied from whisper_apr_tpu/{c}"), c


def _model_apr(quant, jax_writer: bool, seed: int = 1) -> bytes:
    cfg = _cfg()
    tensors = params_to_apr_tensors(from_jax_params(init_params(cfg, seed)))
    mod = jfmt if jax_writer else tfmt
    w = mod.AprWriter.from_config(cfg, quantization=quant)
    for name, arr in tensors.items():
        w.add_tensor(name, arr)
    v = (JVocab if jax_writer else TVocab).with_base_tokens()
    v.add_merge_rule(b"a", b"b")
    w.set_vocabulary(v.to_bytes())
    fb = np.abs(np.random.default_rng(seed).normal(size=(80, 201)))
    w.set_mel_filterbank(mod.MelFilterbankData(80, 201, fb.astype(np.float32)))
    return w.to_bytes()


class TestAprRoundTrip:
    @pytest.mark.parametrize("quant", [0, 2])
    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_written_by_one_read_by_the_other(self, quant, writer):
        """Same bytes from both writers; each reader reads the other's."""
        data = _model_apr(quant, jax_writer=writer == "jax")
        assert data == _model_apr(quant, jax_writer=writer != "jax")
        reader = (tfmt if writer == "jax" else jfmt).AprReader(data)
        other = (jfmt if writer == "jax" else tfmt).AprReader(data)
        assert reader.verify_crc() and other.verify_crc()
        assert dataclasses.astuple(reader.header.to_model_config()) == \
            dataclasses.astuple(_cfg())
        assert reader.tensor_names() == other.tensor_names()
        for name in reader.tensor_names():
            np.testing.assert_array_equal(reader.load_tensor(name),
                                          other.load_tensor(name))
        assert reader.read_vocabulary_bytes() == other.read_vocabulary_bytes()
        np.testing.assert_array_equal(reader.read_mel_filterbank().data,
                                      other.read_mel_filterbank().data)

    @pytest.mark.parametrize("keep", [False, True])
    def test_load_params_matches_jax_loader(self, keep):
        data = _model_apr(2, jax_writer=True)
        j = from_jax_params(j_load(jfmt.AprReader(data), keep_quantized=keep))
        t = load_params_from_apr(tfmt.AprReader(data), keep_quantized=keep)

        def walk(a, b):
            if isinstance(a, dict):
                assert a.keys() == b.keys()
                for k in a:
                    walk(a[k], b[k])
            elif isinstance(a, QTensor):
                assert isinstance(b, QTensor)
                assert torch.equal(a.q, b.q)
                assert torch.equal(a.scale.reshape(-1), b.scale.reshape(-1))
            else:
                assert torch.equal(a, b)
        walk(j, t)

    @pytest.mark.parametrize("code", [4, 5, 6])
    def test_kquant_files_name_slice_4(self, code):
        """The k-quant files of slice 4 (header quantization 4, 5, 6):
        the port's writer gives the JAX writer's bytes, and both readers
        give the same dequantized tensor."""
        cfg = _cfg()
        x = np.random.default_rng(code).normal(0, 0.1, (64, 96)).astype(
            np.float32)
        blobs = []
        for fmt in (tfmt, jfmt):
            w = fmt.AprWriter.from_config(cfg, quantization=code)
            w.add_tensor("x", x)
            blobs.append(w.to_bytes())
        assert blobs[0] == blobs[1]
        got = tfmt.AprReader(blobs[0]).load_tensor("x")
        want = jfmt.AprReader(blobs[0]).load_tensor("x")
        np.testing.assert_array_equal(got, want)
        # within one 4-bit step of a 32-value group (range ~0.6 here)
        assert got.shape == x.shape and np.abs(got - x).max() < 0.05


class TestCopiedHostModules:
    def test_config_presets(self):
        for name in ("tiny", "base", "large-v3", "large-v3-turbo"):
            assert dataclasses.astuple(ModelConfig.from_name(name)) == \
                dataclasses.astuple(TModelConfig.from_name(name))

    def test_tokenizer_round_trip(self):
        jv, tv = JVocab.with_base_tokens(), TVocab.with_base_tokens()
        for v in (jv, tv):
            for a, b in ((b"h", b"e"), (b"l", b"l")):
                v.add_token(a + b)
                v.add_merge_rule(a, b)
        assert jv.to_bytes() == tv.to_bytes()
        text = "hello world"
        ids = TBpe(tv).encode(text)
        assert ids == JBpe(jv).encode(text)
        assert TBpe(tv).decode(ids) == text

    def test_suppression_bias(self):
        np.testing.assert_array_equal(t_bias(51865), j_bias(51865))

    def test_language_probs(self):
        logits = np.random.default_rng(0).normal(size=51865)
        assert TLanguageProbs.from_logits(logits).best == \
            JLanguageProbs.from_logits(logits).best

    def test_wav_and_resample(self):
        rng = np.random.default_rng(3)
        pcm = (rng.normal(0, 0.2, 4410).clip(-1, 1) * 32767).astype(np.int16)
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(44_100)
            w.writeframes(pcm.tobytes())
        a, sr_a = t_parse_wav(buf.getvalue())
        b, sr_b = j_parse_wav(buf.getvalue())
        assert sr_a == sr_b == 44_100
        np.testing.assert_array_equal(a, b)
        ra = TResampler(44_100, 16_000).resample(a)
        rb = JResampler(44_100, 16_000).resample(b)
        assert ra.shape == rb.shape
        np.testing.assert_allclose(ra, rb, atol=1e-5, rtol=0)


class TestKernelBuild:
    def test_library_path_keys_on_sources(self):
        p = _build.library_path()
        assert p.parent == REPO / "build" / "kernels"
        assert p == _build.library_path()
        names = {s.name for s in _build._sources()}
        assert {"decode_blocks.cu", "decode_blocks_batched.cu",
                "int8_matmul.cu", "common.cuh", "attention.cuh",
                "kquant.cuh"} <= names

    def test_check_maps_return_codes(self):
        _build.check(0, "k")
        with pytest.raises(ValueError, match="dtype"):
            _build.check(-1, "k")
        with pytest.raises(ValueError, match="shape"):
            _build.check(-2, "k")
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            _build.check(700, "k")

    def test_ptr_offsets_in_elements(self):
        t = torch.zeros(8, dtype=torch.float32)
        assert _build.ptr(t, 3) == t.data_ptr() + 12
        assert _build.ptr(None) is None

    def test_signatures_cover_the_c_entries(self):
        src = "".join(p.read_text() for p in _build._sources())
        for name in _build._SIGNATURES:
            assert f'extern "C" int {name}(' in src
