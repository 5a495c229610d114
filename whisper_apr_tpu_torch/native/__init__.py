# Bindings copied from whisper_apr_tpu/native/__init__.py; keep them in step.
"""The host runtime in C++ (``aprcore.cpp``), bound with ctypes.

Six host loops run here, as in the JAX package: the Kaiser-sinc resampler
(``audio/resample.py``), LZ4 block decoding of compressed ``.apr`` files
(``format/compress.py``), the word-timestamp DTW (``alignment.py``), and
CRC-32, PCM16 to mono f32 and the VAD's per-frame energy and zero-crossing
rate, which have no caller yet. The bindings keep the JAX package's names,
signatures and contracts, and ``aprcore.cpp`` is its source, built with its
flags, so results are bit-equal to the JAX package's.

The library is built by ``g++`` at first use, never at import, into
``build/native/`` at the repository root, keyed by a hash of the source and
the compiler command. A build compiles to a temporary file and renames it,
so concurrent builds in several processes each load a whole library. A
failed build raises with the compiler's output: there is no quiet fallback.
The library is a ``CDLL``, so every call releases the interpreter lock.

Each binding has a plain version beside it (``*_plain``: zlib, NumPy or
Python), which the tests and ``chip_smoke.py`` hold the library against;
the main path calls none of them, except that a malformed LZ4 block is
decoded again by ``lz4_decompress_block_plain`` to raise its exact
``FormatError``. ``CALLS`` counts the library's calls per binding.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
import zlib
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..errors import AudioError, FormatError
from ..utils.trace import annotate, trace_span

SRC = Path(__file__).resolve().parent / "aprcore.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX = "g++"
# the JAX package's flags: -march=native or -ffast-math would let the
# compiler contract multiply-adds into FMAs and change the bits
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

# calls of each C entry point in this process (reset by the caller)
CALLS = {"crc32": 0, "resample_sinc": 0, "pcm16_to_f32_mono": 0,
         "frame_energy_zcr": 0, "lz4_decompress_block": 0, "dtw_path": 0}
build_seconds: Optional[float] = None   # wall time of this process's build

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64, _i32 = ctypes.c_int64, ctypes.c_int32
_SIGNATURES = {
    "aprcore_crc32": (ctypes.c_uint32,
                      [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]),
    "aprcore_resample_sinc": (_i64, [_f32p, _i64, _i32, _i32, _i32,
                                     ctypes.c_double, _f32p]),
    "aprcore_pcm16_to_f32_mono": (_i64, [ctypes.POINTER(ctypes.c_int16),
                                         _i64, _i32, _f32p]),
    "aprcore_frame_energy_zcr": (None, [_f32p, _i64, _i32, _f32p, _f32p]),
    "aprcore_lz4_decompress_block": (_i64, [ctypes.c_char_p, _i64,
                                            ctypes.POINTER(ctypes.c_char),
                                            _i64]),
    "aprcore_dtw": (_i64, [_f32p, _i64, _i64, _i32p, _i32p]),
}

_load_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        CALLS[name] += 1


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join([CXX, *FLAGS]).encode())
    return BUILD_DIR / f"libaprcore_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``aprcore.cpp`` unless a library for this source and
    command exists; raise with the compiler's output if it fails."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".tmp")
    os.close(fd)
    cmd = [CXX, *FLAGS, str(SRC), "-o", tmp]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"cannot build the host runtime: "
                               f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({proc.returncode}) building "
                               f"the host runtime:\n{' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    if _lib is None:
        with _load_lock, trace_span("native.load"):
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                annotate(build_s=build_seconds)
                _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# bindings
# ---------------------------------------------------------------------------

def crc32(data: bytes, seed: int = 0) -> int:
    """CRC-32 (IEEE 802.3) of ``data``, continuing from ``seed``."""
    data = bytes(data)
    lib = library()
    _count("crc32")
    return int(lib.aprcore_crc32(data, len(data), seed & 0xFFFFFFFF))


def resample_sinc(audio: np.ndarray, source_rate: int, target_rate: int,
                  half_len: int = 16, beta: float = 6.0) -> np.ndarray:
    """Kaiser-windowed sinc resampling of mono f32 ``audio``:
    ``ceil(len * target / source)`` samples (``len`` at equal rates)."""
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    if audio.ndim != 1 or audio.size == 0 or source_rate <= 0 \
            or target_rate <= 0:
        raise ValueError(f"resample_sinc: {audio.shape} samples at "
                         f"{source_rate} -> {target_rate} Hz")
    lib = library()
    ratio = target_rate / source_rate
    out = np.empty(int(np.ceil(len(audio) * ratio)) + 1, dtype=np.float32)
    _count("resample_sinc")
    n = lib.aprcore_resample_sinc(
        audio.ctypes.data_as(_f32p), len(audio), source_rate, target_rate,
        half_len, beta, out.ctypes.data_as(_f32p))
    return out[:n]


def pcm16_to_f32_mono(pcm: np.ndarray, n_channels: int) -> np.ndarray:
    """Interleaved int16 PCM to mono f32: the channels averaged, scaled by
    1/32768; a ragged tail of fewer than ``n_channels`` samples dropped."""
    if n_channels <= 0:
        raise ValueError(f"pcm16_to_f32_mono: {n_channels} channels")
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    lib = library()
    out = np.empty(len(pcm) // n_channels, dtype=np.float32)
    _count("pcm16_to_f32_mono")
    n = lib.aprcore_pcm16_to_f32_mono(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(pcm),
        n_channels, out.ctypes.data_as(_f32p))
    return out[:n]


def lz4_decompress_block(src: bytes, dst_cap: int) -> Optional[bytes]:
    """Decode one raw LZ4 block of at most ``dst_cap`` bytes; None if the
    block is malformed or does not fit (the caller runs the Python decoder
    for the exact error)."""
    if dst_cap < 0:
        raise ValueError(f"lz4_decompress_block: capacity {dst_cap}")
    src = bytes(src)
    lib = library()
    dst = ctypes.create_string_buffer(max(dst_cap, 1))
    _count("lz4_decompress_block")
    n = lib.aprcore_lz4_decompress_block(src, len(src), dst, dst_cap)
    if n < 0:
        return None
    return ctypes.string_at(dst, n)


def frame_energy_zcr(audio: np.ndarray, frame_size: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame (rms energy, zero-crossing rate) over ``len //
    frame_size`` whole frames."""
    if frame_size <= 0:
        raise ValueError(f"frame_energy_zcr: frame size {frame_size}")
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    lib = library()
    n_frames = len(audio) // frame_size
    energy = np.empty(n_frames, dtype=np.float32)
    zcr = np.empty(n_frames, dtype=np.float32)
    _count("frame_energy_zcr")
    lib.aprcore_frame_energy_zcr(audio.ctypes.data_as(_f32p), len(audio),
                                 frame_size, energy.ctypes.data_as(_f32p),
                                 zcr.ctypes.data_as(_f32p))
    return energy, zcr


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW path over a [n_tokens, n_frames] cost matrix; returns
    (text_indices, frame_indices) int32 arrays, empty when either side is
    0. Ties prefer the diagonal, then down, then right."""
    cost = np.ascontiguousarray(cost, dtype=np.float32)
    n, m = cost.shape
    if n == 0 or m == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    lib = library()
    ti = np.empty(n + m, dtype=np.int32)
    tj = np.empty(n + m, dtype=np.int32)
    _count("dtw_path")
    ln = lib.aprcore_dtw(cost.ctypes.data_as(_f32p), n, m,
                         ti.ctypes.data_as(_i32p), tj.ctypes.data_as(_i32p))
    return ti[:ln], tj[:ln]


# ---------------------------------------------------------------------------
# plain versions (the tests' and chip_smoke.py's reference)
# ---------------------------------------------------------------------------

def crc32_plain(data: bytes, seed: int = 0) -> int:
    return zlib.crc32(data, seed) & 0xFFFFFFFF


def resample_sinc_plain(audio: np.ndarray, source_rate: int,
                        target_rate: int, half_len: int = 16,
                        beta: float = 6.0) -> np.ndarray:
    """The resampler vectorized in NumPy (the JAX package's
    ``SincResampler.resample`` without its library): for each output
    sample, gather 2*half_len+1 input taps around ``out_idx / ratio`` and
    take a weight-normalized windowed-sinc dot product."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.size == 0:
        raise AudioError("cannot resample empty audio")
    if source_rate == target_rate:
        return audio.copy()
    ratio = float(target_rate) / float(source_rate)
    out_len = int(np.ceil(audio.size * ratio))
    if out_len == 0:
        raise AudioError("output length would be zero")

    cutoff = min(ratio, 1.0)
    in_pos = np.arange(out_len, dtype=np.float64) / ratio
    center = np.floor(in_pos).astype(np.int64)
    frac = in_pos - center

    k = np.arange(-half_len, half_len + 1, dtype=np.int64)  # [T]
    idx = center[:, None] + k[None, :]                      # [out, T]
    x = k[None, :].astype(np.float64) - frac[:, None]       # [out, T]

    # windowed sinc (reference: resampler.rs:205-226)
    sinc_arg = cutoff * x
    sinc = np.where(np.abs(sinc_arg) < 1e-10, 1.0,
                    np.sin(np.pi * sinc_arg) / np.where(
                        np.abs(sinc_arg) < 1e-10, 1.0, np.pi * sinc_arg))
    warg = x / half_len
    inside = np.abs(warg) <= 1.0
    kaiser = np.where(
        inside,
        np.i0(beta * np.sqrt(np.maximum(1.0 - warg * warg, 0.0)))
        / np.i0(beta),
        0.0)
    weights = sinc * kaiser

    # drop out-of-range taps, renormalize (reference: resampler.rs:175-196)
    valid = (idx >= 0) & (idx < audio.size)
    weights = np.where(valid, weights, 0.0)
    gathered = audio[np.clip(idx, 0, audio.size - 1)].astype(np.float64)

    num = (gathered * weights).sum(axis=1)
    den = weights.sum(axis=1)
    out = np.where(np.abs(den) > 1e-10, num / np.where(den == 0, 1.0, den),
                   0.0)
    return out.astype(np.float32)


def pcm16_to_f32_mono_plain(pcm: np.ndarray, n_channels: int) -> np.ndarray:
    pcm = np.asarray(pcm, dtype=np.int16)
    n_frames = len(pcm) // n_channels
    frames = pcm[:n_frames * n_channels].reshape(n_frames, n_channels)
    inv = np.float32(1.0) / np.float32(32768.0) / np.float32(n_channels)
    return frames.astype(np.float32).sum(axis=1, dtype=np.float32) * inv


def lz4_decompress_block_plain(compressed: bytes,
                               max_size: int = 4 * 1024 * 1024) -> bytes:
    """Decode a raw LZ4 block in Python until the input is consumed,
    raising ``FormatError`` on malformed input."""
    src = compressed
    n = len(src)
    out = bytearray()
    i = 0
    while i < n:
        token = src[i]
        i += 1
        # literals
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if i >= n:
                    raise FormatError("truncated LZ4 literal length")
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if i + lit_len > n:
            raise FormatError("truncated LZ4 literals")
        out += src[i: i + lit_len]
        i += lit_len
        if i >= n:
            break  # last sequence is literals-only
        # match
        if i + 2 > n:
            raise FormatError("truncated LZ4 match offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise FormatError(f"invalid LZ4 match offset {offset}")
        match_len = (token & 0x0F) + 4   # the minimum match
        if (token & 0x0F) == 15:
            while True:
                if i >= n:
                    raise FormatError("truncated LZ4 match length")
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        # overlapping copy (byte-by-byte semantics)
        pos = len(out) - offset
        for _ in range(match_len):
            out.append(out[pos])
            pos += 1
        if len(out) > max_size:
            raise FormatError("LZ4 output exceeds expected size")
    return bytes(out)


def frame_energy_zcr_plain(audio: np.ndarray, frame_size: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    audio = np.asarray(audio, dtype=np.float32)
    n_frames = len(audio) // frame_size
    fr = audio[:n_frames * frame_size].reshape(n_frames, frame_size)
    e = (fr.astype(np.float64) ** 2).sum(axis=1)
    energy = np.sqrt(e / frame_size).astype(np.float32)
    sign = np.signbit(fr)
    crossings = (sign[:, 1:] != sign[:, :-1]).sum(axis=1)
    zcr = crossings.astype(np.float32) / np.float32(frame_size - 1)
    return energy, zcr


def dtw_path_plain(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The DP of ``dtw_path`` in NumPy, with its tie order."""
    cost = np.ascontiguousarray(cost, dtype=np.float32)
    n, m = cost.shape
    INF = np.inf
    prev = np.full(m + 1, INF, dtype=np.float64)
    prev[0] = 0.0
    ptr = np.zeros((n, m), dtype=np.int8)
    for i in range(n):
        cur = np.full(m + 1, INF, dtype=np.float64)
        crow = cost[i]
        for j in range(1, m + 1):
            d0, d1, d2 = prev[j - 1], prev[j], cur[j - 1]
            if d0 <= d1 and d0 <= d2:
                best, p = d0, 0
            elif d1 <= d2:
                best, p = d1, 1
            else:
                best, p = d2, 2
            cur[j] = crow[j - 1] + best
            ptr[i, j - 1] = p
        prev = cur
    i, j = n, m
    ti_l, tj_l = [], []
    while i > 0 and j > 0:
        ti_l.append(i - 1)
        tj_l.append(j - 1)
        p = ptr[i - 1, j - 1]
        if p == 0:
            i -= 1
            j -= 1
        elif p == 1:
            i -= 1
        else:
            j -= 1
    return (np.asarray(ti_l[::-1], np.int32),
            np.asarray(tj_l[::-1], np.int32))
