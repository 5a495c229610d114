"""The port's host runtime (``whisper_apr_tpu_torch.native``) against the
JAX package's (``whisper_apr_tpu.native``), on the CPU.

Both build the same C++ (the port's ``aprcore.cpp`` is a copy) with the
same compiler and flags, so every binding must equal the JAX package's bit
for bit; each must also equal its plain version (zlib, NumPy or Python):
exactly, or within 1e-6 for the resampler and the frame energy, whose sums
run in another order. Then the three callers (``SincResampler``, the LZ4
decoding of compressed ``.apr`` files, the DTW of word timestamps) against
the JAX package's, with ``CALLS`` showing that the library ran; the build
(keyed on source and command, atomic across processes, raising on a
missing or failing compiler); the copy of the source; and
``chip_smoke.phase_native`` at a small size.
"""

import importlib.util
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from whisper_apr_tpu import native as jnative
from whisper_apr_tpu.alignment import AlignmentConfig as JAlignConfig
from whisper_apr_tpu.alignment import CrossAttentionAlignment as JAligner
from whisper_apr_tpu.audio.resample import SincResampler as JResampler
from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.errors import FormatError as JFormatError
from whisper_apr_tpu.format import AprReader as JAprReader
from whisper_apr_tpu.format import compress as jcompress
from whisper_apr_tpu.model.params import init_params
from whisper_apr_tpu_torch import native
from whisper_apr_tpu_torch.alignment import AlignmentConfig
from whisper_apr_tpu_torch.alignment import CrossAttentionAlignment
from whisper_apr_tpu_torch.audio.resample import SincResampler
from whisper_apr_tpu_torch.errors import FormatError
from whisper_apr_tpu_torch.format import QUANT_F32, AprReader, AprWriter
from whisper_apr_tpu_torch.format import compress as tcompress
from whisper_apr_tpu_torch.model.params import (from_jax_params,
                                                params_to_apr_tensors)

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-6   # the resampler's and the frame energy's plain versions


@pytest.fixture(scope="module", autouse=True)
def _jax_library():
    """The JAX package's bindings fall back to Python without their
    library, which would compare the port with another algorithm."""
    assert jnative.available(), "the JAX package's libaprcore did not build"


@pytest.fixture
def calls():
    native.reset_calls()
    return native.CALLS


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# the six bindings
# ---------------------------------------------------------------------------

CRC_CASES = {
    "empty": (b"", 0),
    "hello": (b"Hello, World!", 0),
    "range": (bytes(range(256)) * 100, 0),
    "seeded": (np.random.default_rng(5).bytes(10_001), 0x1234ABCD),
}


@pytest.mark.parametrize("case", sorted(CRC_CASES))
def test_crc32(case, calls):
    data, seed = CRC_CASES[case]
    got = native.crc32(data, seed)
    assert got == jnative.crc32(data, seed) == native.crc32_plain(data, seed)
    assert calls["crc32"] == 1
    if case == "hello":
        assert got == 0xEC4AC3D0   # the reference's pinned value


@pytest.mark.parametrize("length", [1, 2, 33, 4410])
@pytest.mark.parametrize("rate", [44_100, 48_000, 22_050, 8_000, 16_000])
def test_resample_sinc(rate, length, calls):
    x = np.random.default_rng(length).normal(0, 0.3, length).astype(
        np.float32)
    got = native.resample_sinc(x, rate, 16_000)
    _same(got, jnative.resample_sinc(x, rate, 16_000))
    assert len(got) == int(np.ceil(length * 16_000 / rate))
    np.testing.assert_allclose(
        got, native.resample_sinc_plain(x, rate, 16_000), rtol=0, atol=TOL)
    if rate == 16_000:
        _same(got, x)
    assert calls["resample_sinc"] == 1


@pytest.mark.parametrize("tail", [0, 1])
@pytest.mark.parametrize("channels", [1, 2, 6])
def test_pcm16_to_f32_mono(channels, tail, calls):
    pcm = np.random.default_rng(channels).integers(
        -32768, 32768, 257 * channels + tail * (channels > 1)).astype(
        np.int16)
    got = native.pcm16_to_f32_mono(pcm, channels)
    assert len(got) == 257
    _same(got, jnative.pcm16_to_f32_mono(pcm, channels))
    _same(got, native.pcm16_to_f32_mono_plain(pcm, channels))
    assert calls["pcm16_to_f32_mono"] == 1


@pytest.mark.parametrize("frame", [160, 480])
def test_frame_energy_zcr(frame, calls):
    x = np.random.default_rng(frame).normal(0, 0.2, 7 * frame + 37).astype(
        np.float32)
    x[frame: 2 * frame] = 0.0          # a silent frame: no crossing
    energy, zcr = native.frame_energy_zcr(x, frame)
    je, jz = jnative.frame_energy_zcr(x, frame)
    _same(energy, je)
    _same(zcr, jz)
    pe, pz = native.frame_energy_zcr_plain(x, frame)
    assert energy.shape == zcr.shape == pe.shape == (7,)
    np.testing.assert_allclose(energy, pe, rtol=0, atol=TOL)
    _same(zcr, pz)
    assert energy[1] == 0.0 and zcr[1] == 0.0
    assert calls["frame_energy_zcr"] == 1


def _lz4_cases():
    """Hand-made raw LZ4 blocks: (block, decoded bytes or None)."""
    lit280 = bytes(range(256)) + bytes(24)
    return {
        "literals": (b"\x50hello", b"hello"),
        "long_literals": (b"\xf0\xff\x0a" + lit280, lit280),
        "long_match": (b"\x4f" + b"abcd" + b"\x04\x00\xff\x03"
                       + b"\x50tail!", (b"abcd" * 71)[:4 + 277] + b"tail!"),
        "overlap": (b"\x16a\x01\x00\x50xyzzy", b"a" * 11 + b"xyzzy"),
        "offset_0": (b"\x10a\x00\x00\x50xyzzy", None),
        "offset_past": (b"\x10a\x02\x00\x50xyzzy", None),
        "cut_literal_len": (b"\xf0\xff", None),
        "cut_literals": (b"\x50hel", None),
        "cut_offset": (b"\x16a\x01", None),
        "cut_match_len": (b"\x4fabcd\x04\x00\xff", None),
    }


@pytest.mark.parametrize("case", sorted(_lz4_cases()))
def test_lz4_decompress_block(case, calls):
    block, want = _lz4_cases()[case]
    got = native.lz4_decompress_block(block, 1 << 16)
    assert got == jnative.lz4_decompress_block(block, 1 << 16) == want
    assert calls["lz4_decompress_block"] == 1
    if want is None:
        with pytest.raises(FormatError):
            native.lz4_decompress_block_plain(block, 1 << 16)
    else:
        assert native.lz4_decompress_block_plain(block, 1 << 16) == want


def test_lz4_every_truncation_agrees():
    """Every prefix of a compressed block decodes to the same bytes in the
    port, the JAX package and the Python decoder, or is malformed in all
    three (None; the Python decoder raises)."""
    rng = np.random.default_rng(2)
    data = bytes(rng.integers(0, 4, 3000).astype(np.uint8)) + b"z" * 500
    block = tcompress.compress_block(data)
    assert native.lz4_decompress_block(block, len(data)) == data
    for cut in range(len(block)):
        got = native.lz4_decompress_block(block[:cut], len(data))
        assert got == jnative.lz4_decompress_block(block[:cut], len(data))
        if got is None:
            with pytest.raises(FormatError):
                native.lz4_decompress_block_plain(block[:cut], len(data))
        else:
            assert got == native.lz4_decompress_block_plain(block[:cut],
                                                            len(data))


def _dtw_cases():
    rng = np.random.default_rng(9)
    return {
        "n0": np.zeros((0, 5), np.float32),
        "m0": np.zeros((5, 0), np.float32),
        "1x1": np.ones((1, 1), np.float32),
        "n_gt_m": rng.normal(size=(20, 12)).astype(np.float32),
        "ties": rng.integers(0, 2, (12, 20)).astype(np.float32),
        "ties_n_gt_m": rng.integers(-1, 2, (20, 12)).astype(np.float32),
        "flat": np.zeros((7, 9), np.float32),
        "120x500": rng.normal(size=(120, 500)).astype(np.float32),
    }


@pytest.mark.parametrize("case", sorted(_dtw_cases()))
def test_dtw_path(case, calls):
    cost = _dtw_cases()[case]
    ti, tj = native.dtw_path(cost)
    ji, jj = jnative.dtw_path(cost)
    pi, pj = native.dtw_path_plain(cost)
    for got in (ti, tj):
        assert got.dtype == np.int32
    for a, b in ((ti, ji), (tj, jj), (ti, pi), (tj, pj)):
        np.testing.assert_array_equal(a, b)
    n, m = cost.shape
    assert calls["dtw_path"] == (n > 0 and m > 0)
    if n and m:
        assert (ti[0], tj[0], ti[-1], tj[-1]) == (0, 0, n - 1, m - 1)
    else:
        assert len(ti) == len(tj) == 0


@pytest.mark.parametrize("call", [
    lambda: native.resample_sinc(np.zeros(0, np.float32), 44_100, 16_000),
    lambda: native.resample_sinc(np.zeros(4, np.float32), 0, 16_000),
    lambda: native.pcm16_to_f32_mono(np.zeros(4, np.int16), 0),
    lambda: native.frame_energy_zcr(np.zeros(4, np.float32), 0),
    lambda: native.lz4_decompress_block(b"\x00", -1),
])
def test_bad_arguments_raise_before_the_call(call, calls):
    with pytest.raises(ValueError):
        call()
    assert not any(calls.values())


# ---------------------------------------------------------------------------
# through the callers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [44_100, 48_000, 8_000])
def test_sinc_resampler_equals_jax(rate, calls):
    x = np.random.default_rng(rate).normal(0, 0.3, rate // 4).astype(
        np.float32)
    got = SincResampler(rate, 16_000).resample(x)
    _same(got, JResampler(rate, 16_000).resample(x))
    assert calls["resample_sinc"] == 1
    SincResampler(16_000, 16_000).resample(x)        # identity: no call
    assert calls["resample_sinc"] == 1


def _small_cfg():
    return ModelConfig(
        model_type="tiny", n_vocab=300, n_audio_ctx=16, n_audio_state=64,
        n_audio_head=1, n_audio_layer=1, n_text_ctx=12, n_text_state=64,
        n_text_head=1, n_text_layer=2, n_mels=80)


def _apr(compressed: bool) -> bytes:
    cfg = _small_cfg()
    w = AprWriter.from_config(cfg, quantization=QUANT_F32)
    w.header.compressed = compressed
    for name, arr in params_to_apr_tensors(
            from_jax_params(init_params(cfg, 3))).items():
        w.add_tensor(name, arr)
    return w.to_bytes()


def test_compressed_apr_round_trip(calls):
    """A compressed f32 .apr written by the port loads through the library
    to the tensors of its uncompressed twin, in the port and in the JAX
    package."""
    data = _apr(True)
    twin = AprReader(_apr(False))
    reader = AprReader(data)
    assert calls["lz4_decompress_block"] > 0
    jreader = JAprReader(data)
    assert reader._payload == jreader._payload
    for name in twin.tensor_names():
        _same(reader.load_tensor(name), twin.load_tensor(name))


def _frame(block: bytes) -> bytes:
    """A standard LZ4 frame holding one compressed block."""
    good = tcompress.lz4_frame_compress(b"q" * 100)
    head = good[:15]                  # magic, FLG, BD, content size, HC
    return head + struct.pack("<I", len(block)) + block + struct.pack(
        "<I", 0)


@pytest.mark.parametrize("case", ["offset_0", "offset_past",
                                  "cut_literals", "cut_offset",
                                  "cut_match_len", "cut_literal_len"])
def test_malformed_blocks_raise_as_jax(case, calls):
    block = _lz4_cases()[case][0]
    with pytest.raises(JFormatError) as want:
        jcompress.decompress_block(block, 100)
    with pytest.raises(FormatError) as got:
        tcompress.decompress_block(block, 100)
    assert str(got.value) == str(want.value)
    with pytest.raises(JFormatError) as want:
        jcompress.lz4_frame_decompress(_frame(block))
    with pytest.raises(FormatError) as got:
        tcompress.lz4_frame_decompress(_frame(block))
    assert str(got.value) == str(want.value)
    assert calls["lz4_decompress_block"] == 2


def test_dtw_alignment_equals_jax(calls):
    rng = np.random.default_rng(4)
    weights = rng.random((2, 1, 2, 9, 40)).astype(np.float32)
    tokens = list(range(100, 109))
    got = CrossAttentionAlignment(AlignmentConfig(
        method="dtw")).extract_token_alignments(weights, tokens, 37)
    want = JAligner(JAlignConfig(method="dtw")).extract_token_alignments(
        weights, tokens, 37)
    assert [vars(a) for a in got] == [vars(a) for a in want]
    assert calls["dtw_path"] == 1


# ---------------------------------------------------------------------------
# the build and the copy
# ---------------------------------------------------------------------------

def test_library_path_keys_on_source_and_command(monkeypatch, tmp_path):
    p, orig = native.library_path(), native.SRC
    assert p.parent == REPO / "build" / "native"
    assert p == native.library_path()
    src = tmp_path / "aprcore.cpp"
    src.write_bytes(orig.read_bytes() + b"\n")
    monkeypatch.setattr(native, "SRC", src)
    assert native.library_path() != p
    src.write_bytes(orig.read_bytes())
    assert native.library_path() == p
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ["-g"])
    assert native.library_path() != p


@pytest.mark.parametrize("fault", ["no_compiler", "bad_source"])
def test_failed_build_raises_with_the_compiler_output(fault, monkeypatch,
                                                      tmp_path, calls):
    """No quiet fallback: with no library, every binding raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    if fault == "no_compiler":
        monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
        match = "no-such-compiler-g\\+\\+"
    else:
        src = tmp_path / "aprcore.cpp"
        src.write_text("int broken(  {\n")
        monkeypatch.setattr(native, "SRC", src)
        match = "error"
    for call in (lambda: native.crc32(b"x"),
                 lambda: native.resample_sinc(np.ones(8, np.float32),
                                              44_100, 16_000),
                 lambda: native.dtw_path(np.ones((2, 2), np.float32)),
                 lambda: tcompress._decode_block(b"\x50hello")):
        with pytest.raises(RuntimeError, match=match):
            call()
    assert not any(calls.values())
    assert list((tmp_path / "native").iterdir()) == []   # no temp left


def test_concurrent_builds_both_load(tmp_path):
    """Two processes building into one empty directory at once: both load
    a whole library, and one library is left, no temporary file."""
    code = ("import sys; from pathlib import Path; "
            "import whisper_apr_tpu_torch.native as n; "
            "n.BUILD_DIR = Path(sys.argv[1]); "
            "print(n.crc32(b'Hello, World!'))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == [str(0xEC4AC3D0)]
    assert [f.name for f in tmp_path.iterdir()] == \
        [native.library_path().name]


def test_import_builds_nothing():
    code = ("import whisper_apr_tpu_torch.native as n; "
            "print(n._lib is None, n.build_seconds is None, "
            "any(n.CALLS.values()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True", "False"]


def test_source_is_the_jax_copy():
    """Below its header the port's aprcore.cpp equals the original."""
    port = native.SRC.read_text()
    orig = (REPO / "whisper_apr_tpu" / "native" / "aprcore.cpp").read_text()
    assert port.splitlines()[0].startswith(
        "// Copied from whisper_apr_tpu/native/aprcore.cpp")
    body = lambda s: s[s.index("#include <cmath>"):]
    assert body(port) == body(orig)
    assert native.FLAGS == ["-O3", "-shared", "-fPIC", "-std=c++17"]


# ---------------------------------------------------------------------------
# chip_smoke.py's native phase, at a small size
# ---------------------------------------------------------------------------

def test_native_phase_on_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.phase_native(tmp_path, cfg=_small_cfg(), seconds=0.5,
                             crc_mb=1, dtw_shape=(12, 40))
    assert set(out["pairs"]) == {
        "crc32", "resample_sinc 44100", "resample_sinc 48000",
        "pcm16_to_f32_mono", "frame_energy_zcr", "lz4_decompress_block",
        "dtw_path"}
    assert out["resample_max_diff"] <= 1e-5
    assert out["lz4_calls"] > 0 and out["lz4_apr"].exists()
