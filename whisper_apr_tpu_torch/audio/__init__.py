"""Audio front-end: WAV parsing, resampling, log-mel spectrograms, and the
streaming chunker (ring buffer, VAD, chunk state machine).

Port of ``whisper_apr_tpu/audio/`` (mel, resample, wav, ring_buffer,
streaming, batch).
"""

from ..config import HOP_LENGTH, N_FFT, N_FRAMES, N_SAMPLES_30S, SAMPLE_RATE
from .mel import (MelFilterbank, log_mel_body, log_mel_spectrogram,
                  mel_filterbank)
from .resample import SincResampler, resample
from .wav import parse_wav

N_MELS_80 = 80
N_MELS_128 = 128
N_FREQS = N_FFT // 2 + 1  # 201

__all__ = [
    "SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "N_SAMPLES_30S", "N_FRAMES",
    "N_MELS_80", "N_MELS_128", "N_FREQS",
    "MelFilterbank", "mel_filterbank", "log_mel_body", "log_mel_spectrogram",
    "SincResampler", "resample", "parse_wav",
]
