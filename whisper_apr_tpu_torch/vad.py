# Copied from whisper_apr_tpu/vad.py (host-side numpy, no JAX); keep the two in step.
"""Voice activity detection: energy + zero-crossing rate with hangover.

(reference: src/vad.rs — VadConfig :36 with low_latency/high_accuracy
presets :70-96, VoiceActivityDetector::process_frame :609 / detect :554,
SilenceDetector with adaptive noise floor :298, StreamingVad :711.)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class VadConfig:
    """(reference: src/vad.rs:36-63)"""

    sample_rate: int = 16_000
    frame_size: int = 480  # 30 ms at 16 kHz
    energy_threshold: float = 2.0  # relative to noise floor
    zcr_threshold: float = 0.3
    min_speech_frames: int = 3
    min_silence_frames: int = 10
    smoothing: float = 0.95

    @staticmethod
    def low_latency() -> "VadConfig":
        """10 ms frames (reference: vad.rs:77)."""
        return VadConfig(frame_size=160, min_speech_frames=5,
                         min_silence_frames=15)

    @staticmethod
    def high_accuracy() -> "VadConfig":
        """50 ms frames (reference: vad.rs:88)."""
        return VadConfig(frame_size=800, min_speech_frames=2,
                         min_silence_frames=6)


def frame_energy(frame: np.ndarray) -> float:
    """RMS energy of one frame."""
    frame = np.asarray(frame, dtype=np.float64)
    return float(np.sqrt(np.mean(frame * frame))) if frame.size else 0.0


def zero_crossing_rate(frame: np.ndarray) -> float:
    """Fraction of sign changes (reference: vad.rs compute_zcr)."""
    frame = np.asarray(frame)
    if frame.size < 2:
        return 0.0
    signs = np.signbit(frame)
    return float(np.mean(signs[1:] != signs[:-1]))


class VoiceActivityDetector:
    """Frame-level VAD with hangover state machine
    (reference: src/vad.rs:609 process_frame, :554 detect).

    Speech when energy exceeds ``noise_floor * energy_threshold``; unvoiced
    fricatives are admitted by a high ZCR + moderate energy path. The
    hangover logic requires ``min_speech_frames`` consecutive active frames
    to enter speech and ``min_silence_frames`` to leave it.
    """

    def __init__(self, config: Optional[VadConfig] = None) -> None:
        self.config = config or VadConfig()
        self.noise_floor = 1e-4
        self.in_speech = False
        self._speech_run = 0
        self._silence_run = 0

    def reset(self) -> None:
        self.noise_floor = 1e-4
        self.in_speech = False
        self._speech_run = 0
        self._silence_run = 0

    def _frame_active(self, frame: np.ndarray) -> bool:
        e = frame_energy(frame)
        z = zero_crossing_rate(frame)
        active = e > self.noise_floor * self.config.energy_threshold
        # unvoiced consonants: high ZCR with energy clearly above the floor
        active = active or (z > self.config.zcr_threshold
                            and e > self.noise_floor * 1.5)
        # adapt noise floor on inactive frames (reference smoothing 0.95)
        if not active:
            s = self.config.smoothing
            self.noise_floor = s * self.noise_floor + (1 - s) * max(e, 1e-6)
        return active

    def process_frame(self, frame: np.ndarray) -> bool:
        """Returns whether the detector is (now) in speech."""
        active = self._frame_active(np.asarray(frame, dtype=np.float32))
        if active:
            self._speech_run += 1
            self._silence_run = 0
            if not self.in_speech and self._speech_run >= self.config.min_speech_frames:
                self.in_speech = True
        else:
            self._silence_run += 1
            self._speech_run = 0
            if self.in_speech and self._silence_run >= self.config.min_silence_frames:
                self.in_speech = False
        return self.in_speech

    def detect(self, audio: np.ndarray) -> List[Tuple[int, int]]:
        """Whole-clip segmentation -> list of (start_sample, end_sample)
        speech spans (reference: vad.rs:554 detect)."""
        self.reset()
        fs = self.config.frame_size
        audio = np.asarray(audio, dtype=np.float32)
        segments: List[Tuple[int, int]] = []
        start: Optional[int] = None
        n_frames = len(audio) // fs
        for i in range(n_frames):
            in_speech = self.process_frame(audio[i * fs:(i + 1) * fs])
            if in_speech and start is None:
                # backdate to the start of the qualifying run
                start = max(0, (i - self.config.min_speech_frames + 1)) * fs
            elif not in_speech and start is not None:
                segments.append((start, i * fs))
                start = None
        if start is not None:
            segments.append((start, n_frames * fs))
        return segments


@dataclasses.dataclass
class SilenceConfig:
    """(reference: src/vad.rs:203 SilenceConfig)"""

    silence_threshold: float = 0.01
    min_silence_duration: float = 0.5
    max_silence_duration: float = 30.0
    adaptive: bool = True


@dataclasses.dataclass
class SilenceSegment:
    start: float
    end: float
    noise_floor: float

    def duration(self) -> float:
        return self.end - self.start


class SilenceDetector:
    """Silence spans with adaptive noise floor (reference: src/vad.rs:298)."""

    def __init__(self, config: Optional[SilenceConfig] = None,
                 sample_rate: int = 16_000) -> None:
        self.config = config or SilenceConfig()
        self.sample_rate = sample_rate
        self.noise_floor = 0.0
        self.samples_processed = 0
        self._silence_start: Optional[float] = None

    def _current_time(self) -> float:
        return self.samples_processed / self.sample_rate

    def _update_noise_floor(self, energy: float) -> None:
        self.noise_floor = 0.95 * self.noise_floor + 0.05 * energy

    def process_frame(self, frame: np.ndarray) -> Optional[SilenceSegment]:
        """(reference: vad.rs process_frame state machine)"""
        energy = frame_energy(frame)
        now = self._current_time()
        if self.config.adaptive:
            self._update_noise_floor(energy)
            threshold = self.noise_floor * 2.0 + self.config.silence_threshold
        else:
            threshold = self.config.silence_threshold
        is_silence = energy < threshold
        self.samples_processed += len(frame)

        if self._silence_start is None and is_silence:
            self._silence_start = now
            return None
        if self._silence_start is not None and not is_silence:
            seg = SilenceSegment(self._silence_start, now, self.noise_floor)
            self._silence_start = None
            return seg if seg.duration() >= self.config.min_silence_duration else None
        if self._silence_start is not None and is_silence:
            if now - self._silence_start >= self.config.max_silence_duration:
                seg = SilenceSegment(self._silence_start, now, self.noise_floor)
                self._silence_start = now
                return seg
        return None


class StreamingVad:
    """Pass-through filter that zeroes non-speech (reference: vad.rs:711)."""

    def __init__(self, config: Optional[VadConfig] = None) -> None:
        self.vad = VoiceActivityDetector(config)

    def filter(self, audio: np.ndarray) -> np.ndarray:
        fs = self.vad.config.frame_size
        audio = np.asarray(audio, dtype=np.float32)
        out = np.zeros_like(audio)
        for i in range(0, len(audio) - fs + 1, fs):
            if self.vad.process_frame(audio[i:i + fs]):
                out[i:i + fs] = audio[i:i + fs]
        return out
