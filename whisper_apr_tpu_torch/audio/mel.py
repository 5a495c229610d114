"""Log-mel spectrogram: port of ``whisper_apr_tpu/audio/mel.py``.

The filterbank, the Hann window and the real-DFT basis are built in numpy
(copied from the JAX module, bit-identical); ``log_mel_body`` runs in
torch f32 as one GEMM against the DFT basis:

  1. frame the waveform: ``n_frames = (len - n_fft) / hop + 1`` (no centering)
  2. periodic Hann window
  3. power spectrum of the one-sided DFT (frames @ [cos | -sin] basis)
  4. slaney mel filterbank matmul
  5. ``log10(max(p, 1e-10))``
  6. whisper normalization ``x = max(x, max(x) - 8); x = (x + 4) / 4``

The matmuls are f32; on a GPU they stay full f32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import HOP_LENGTH, N_FFT, N_FRAMES
from ..errors import AudioError


# ---------------------------------------------------------------------------
# Filterbank construction (host-side numpy, copied from the JAX module)
# ---------------------------------------------------------------------------

def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above (librosa-compatible)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep,
                    mels)


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


def hz_to_mel_htk(hz: float) -> float:
    """HTK mel scale (reference: src/audio/mel.rs:201 hz_to_mel)."""
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def mel_to_hz_htk(mel: float) -> float:
    """Inverse HTK mel scale (reference: src/audio/mel.rs:210 mel_to_hz)."""
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def mel_filterbank(n_mels: int = 80, n_fft: int = N_FFT,
                   sample_rate: int = 16_000) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank ``[n_mels, n_fft//2+1]``."""
    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_freqs, dtype=np.float64)

    mel_min = _hz_to_mel_slaney(np.array(0.0))
    mel_max = _hz_to_mel_slaney(np.array(sample_rate / 2.0))
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # slaney area normalization
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def hann_window(size: int = N_FFT) -> np.ndarray:
    """Periodic Hann window."""
    n = np.arange(size, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / size))).astype(np.float32)


def _dft_basis(n_fft: int = N_FFT) -> np.ndarray:
    """Real-DFT basis ``[n_fft, 2*(n_fft//2+1)]`` (cos | -sin columns)."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# torch compute
# ---------------------------------------------------------------------------

def log_mel_body(audio: torch.Tensor, window: torch.Tensor,
                 basis: torch.Tensor, filters_t: torch.Tensor, n_fft: int,
                 hop: int) -> torch.Tensor:
    """Framing -> windowed DFT -> filterbank -> log -> normalize, f32.

    audio [N] -> ``[n_frames, n_mels]`` (frame-major).
    """
    n_freqs = n_fft // 2 + 1
    audio = audio.float()
    # frames stitched from ceil(n_fft/hop) consecutive hop-rows (slices
    # only, the same framing as the JAX module)
    n_frames = (audio.shape[0] - n_fft) // hop + 1
    rows_needed = -(-n_fft // hop)
    min_rows = n_frames + rows_needed - 1
    n_rows = audio.shape[0] // hop
    if n_rows < min_rows:
        audio = torch.nn.functional.pad(
            audio, (0, min_rows * hop - audio.shape[0]))
        n_rows = min_rows
    grid = audio[: n_rows * hop].reshape(n_rows, hop)
    frames = torch.cat([grid[k: k + n_frames] for k in range(rows_needed)],
                       dim=1)[:, :n_fft]
    frames = frames * window[None, :]

    spec = frames @ basis
    power = spec[:, :n_freqs] ** 2 + spec[:, n_freqs:] ** 2
    mel = power @ filters_t
    log_mel = torch.log10(torch.clamp_min(mel, 1e-10))
    log_mel = torch.maximum(log_mel, log_mel.max() - 8.0)
    return (log_mel + 4.0) / 4.0


class MelFilterbank:
    """Mel spectrogram computer over numpy filters; the torch constants
    (window, DFT basis, transposed filters) are made per device on use."""

    def __init__(self, filters: np.ndarray, n_fft: int = N_FFT,
                 sample_rate: int = 16_000) -> None:
        filters = np.asarray(filters, dtype=np.float32)
        if filters.ndim != 2 or filters.shape[1] != n_fft // 2 + 1:
            raise AudioError(
                f"filterbank shape {filters.shape} incompatible with n_fft={n_fft}")
        self.filters = filters
        self.n_mels = filters.shape[0]
        self.n_fft = n_fft
        self.n_freqs = n_fft // 2 + 1
        self.sample_rate = sample_rate
        self._consts: Dict[str, Tuple[torch.Tensor, ...]] = {}

    @staticmethod
    def create(n_mels: int = 80, n_fft: int = N_FFT,
               sample_rate: int = 16_000) -> "MelFilterbank":
        return MelFilterbank(mel_filterbank(n_mels, n_fft, sample_rate),
                             n_fft, sample_rate)

    @staticmethod
    def from_apr_data(data, sample_rate: int = 16_000) -> "MelFilterbank":
        n_fft = 2 * (data.n_freqs - 1)
        return MelFilterbank(data.data, n_fft, sample_rate)

    def constants(self, device="cuda") -> Tuple[torch.Tensor, ...]:
        """(window [n_fft], basis [n_fft, 2*n_freqs], filters_t
        [n_freqs, n_mels]) as f32 tensors on ``device`` (the card by
        default, as the engine)."""
        key = str(torch.device(device))
        if key not in self._consts:
            self._consts[key] = tuple(
                torch.from_numpy(a).to(device) for a in (
                    hann_window(self.n_fft), _dft_basis(self.n_fft),
                    np.ascontiguousarray(self.filters.T)))
        return self._consts[key]

    def compute_device(self, audio, hop_length: int = HOP_LENGTH,
                       device="cuda") -> torch.Tensor:
        """Log-mel of raw audio on ``device``: ``[n_frames, n_mels]``."""
        if hop_length <= 0:
            raise AudioError("hop_length must be positive")
        audio = torch.as_tensor(np.asarray(audio, dtype=np.float32),
                                device=device)
        if audio.numel() < self.n_fft:
            return torch.zeros((0, self.n_mels), device=device)
        return log_mel_body(audio, *self.constants(device), self.n_fft,
                            hop_length)

    def compute(self, audio: np.ndarray,
                hop_length: int = HOP_LENGTH) -> np.ndarray:
        """Host (numpy) variant of :meth:`compute_device`: the log-mel of
        audio of any length, ``(len - n_fft) // hop + 1`` frames, no
        padding; ``[0, n_mels]`` below one FFT window."""
        return self.compute_device(audio, hop_length, device="cpu").numpy()

    def compute_30s_device(self, audio: np.ndarray,
                           hop_length: int = HOP_LENGTH,
                           n_frames: int = N_FRAMES,
                           device="cuda") -> torch.Tensor:
        """Whisper's fixed window -> exactly ``[n_frames, n_mels]`` on
        ``device``: audio padded/truncated to ``n_frames * hop`` samples,
        mel frames padded with the silence value -1.0."""
        audio = np.asarray(audio, dtype=np.float32)
        n_samples = n_frames * hop_length
        if audio.size < n_samples:
            audio = np.pad(audio, (0, n_samples - audio.size))
        elif audio.size > n_samples:
            audio = audio[:n_samples]
        mel = self.compute_device(audio, hop_length, device)
        if mel.shape[0] < n_frames:
            mel = torch.cat([mel, torch.full(
                (n_frames - mel.shape[0], self.n_mels), -1.0,
                dtype=mel.dtype, device=mel.device)], dim=0)
        return mel[:n_frames]

    def compute_30s(self, audio: np.ndarray, hop_length: int = HOP_LENGTH,
                    n_frames: int = N_FRAMES) -> np.ndarray:
        """Host (numpy) variant of :meth:`compute_30s_device`."""
        return self.compute_30s_device(audio, hop_length, n_frames,
                                       device="cpu").numpy()


def log_mel_spectrogram(audio: np.ndarray, n_mels: int = 80,
                        filters: Optional[np.ndarray] = None,
                        pad_to_30s: bool = True) -> np.ndarray:
    """One-shot host log-mel: audio -> ``[3000, n_mels]`` (or unpadded)."""
    fb = MelFilterbank(filters, N_FFT) if filters is not None \
        else MelFilterbank.create(n_mels)
    return fb.compute_30s(audio) if pad_to_30s else fb.compute(audio)
