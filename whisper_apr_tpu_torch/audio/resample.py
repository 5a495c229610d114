# Copied from whisper_apr_tpu/audio/resample.py (host side, no JAX); keep the two in step.
"""Kaiser-windowed sinc resampling to 16 kHz.

Numerically mirrors the reference resampler (reference:
src/audio/resampler.rs:32-260 SincResampler): per-output-sample windowed-sinc
interpolation with kernel half-length 16, Kaiser beta 6.0, anti-alias cutoff
``min(target/source, 1)``, and per-sample weight renormalization (which also
handles signal edges, where out-of-range taps are dropped).

The port resamples through the host runtime's C++ (``native/aprcore.cpp``,
the JAX package's source and build flags), so its samples equal the JAX
package's bit for bit. The vectorized NumPy version (gather + row-normalized
dot) is ``native.resample_sinc_plain``, the tests' reference.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..errors import AudioError

DEFAULT_KERNEL_HALF_LEN = 16  # reference: src/audio/resampler.rs:23
DEFAULT_KAISER_BETA = 6.0     # reference: src/audio/resampler.rs:26


class SincResampler:
    """High-quality arbitrary-ratio resampler (reference: resampler.rs:32)."""

    def __init__(self, source_rate: int, target_rate: int,
                 kernel_half_len: int = DEFAULT_KERNEL_HALF_LEN,
                 kaiser_beta: float = DEFAULT_KAISER_BETA) -> None:
        if source_rate <= 0 or target_rate <= 0:
            raise AudioError("sample rate must be non-zero")
        if kernel_half_len <= 0:
            raise AudioError("kernel half-length must be non-zero")
        self.source_rate = int(source_rate)
        self.target_rate = int(target_rate)
        self.ratio = float(target_rate) / float(source_rate)
        self.kernel_half_len = int(kernel_half_len)
        self.kaiser_beta = float(kaiser_beta)

    def resample(self, audio: np.ndarray) -> np.ndarray:
        """Resample to the target rate (reference: resampler.rs:136-200):
        for each output sample, a weight-normalized windowed-sinc dot
        product over 2*half_len+1 input taps around ``out_idx / ratio``,
        in the host runtime's C++."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.size == 0:
            raise AudioError("cannot resample empty audio")
        if self.source_rate == self.target_rate:
            return audio.copy()
        return native.resample_sinc(audio, self.source_rate,
                                    self.target_rate, self.kernel_half_len,
                                    self.kaiser_beta)


def resample(audio: np.ndarray, source_rate: int, target_rate: int = 16_000) -> np.ndarray:
    """One-shot resample helper."""
    return SincResampler(source_rate, target_rate).resample(audio)
