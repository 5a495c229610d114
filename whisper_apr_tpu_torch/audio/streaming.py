# Copied from whisper_apr_tpu/audio/streaming.py (host-side numpy, no JAX); keep the two in step.
"""Streaming audio processor: the chunking state machine.

(reference: src/audio/streaming.rs — ProcessorState :304-318, StreamingEvent
:322, StreamingConfig w/ latency presets :69-301, StreamingProcessor :358:
push_audio :674, process :682, update_state :726, get_chunk :843, flush :875,
partials :575-615, overlap carry-over :746-748,849-853.)

Host-side pure logic, ported semantics-level: ring buffer -> 30 ms frames ->
resample -> VAD -> chunk accumulation with overlap carry-over + event queue.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

from ..config import SAMPLE_RATE
from ..errors import AudioError
from ..vad import VadConfig, VoiceActivityDetector
from .resample import SincResampler
from .ring_buffer import RingBuffer

DEFAULT_CHUNK_DURATION = 30.0
DEFAULT_CHUNK_OVERLAP = 1.0
MIN_SPEECH_DURATION_MS = 300
LOW_LATENCY_CHUNK_DURATION = 0.5
LOW_LATENCY_CHUNK_OVERLAP = 0.05
LOW_LATENCY_MIN_SPEECH_MS = 100
LOW_LATENCY_BUFFER_DURATION = 5.0


class LatencyMode(enum.Enum):
    """(reference: streaming.rs:69 LatencyMode)"""

    STANDARD = "standard"
    LOW_LATENCY = "low_latency"
    ULTRA_LOW = "ultra_low"
    CUSTOM = "custom"


class ProcessorState(enum.Enum):
    """(reference: streaming.rs:304-318 ProcessorState)"""

    WAITING_FOR_SPEECH = "waiting_for_speech"
    ACCUMULATING_SPEECH = "accumulating_speech"
    PARTIAL_RESULT_READY = "partial_result_ready"
    CHUNK_READY = "chunk_ready"
    PROCESSING = "processing"
    ERROR = "error"


@dataclasses.dataclass
class StreamingEvent:
    """(reference: streaming.rs:322 StreamingEvent)"""

    kind: str  # speech_started | speech_ended | chunk_ready | partial_ready | error
    time: float
    detail: str = ""


@dataclasses.dataclass
class StreamingConfig:
    """(reference: streaming.rs:85-301 StreamingConfig)"""

    input_sample_rate: int = 44_100
    output_sample_rate: int = SAMPLE_RATE
    chunk_duration: float = DEFAULT_CHUNK_DURATION
    chunk_overlap: float = DEFAULT_CHUNK_OVERLAP
    enable_vad: bool = True
    vad_threshold: float = 0.5
    min_speech_duration_ms: int = MIN_SPEECH_DURATION_MS
    buffer_duration: float = 120.0
    latency_mode: LatencyMode = LatencyMode.STANDARD

    @staticmethod
    def with_sample_rate(input_sample_rate: int) -> "StreamingConfig":
        return StreamingConfig(input_sample_rate=input_sample_rate)

    @staticmethod
    def low_latency() -> "StreamingConfig":
        """500 ms chunks / 50 ms overlap (reference: streaming.rs:146)."""
        return StreamingConfig(
            chunk_duration=LOW_LATENCY_CHUNK_DURATION,
            chunk_overlap=LOW_LATENCY_CHUNK_OVERLAP,
            min_speech_duration_ms=LOW_LATENCY_MIN_SPEECH_MS,
            buffer_duration=LOW_LATENCY_BUFFER_DURATION,
            latency_mode=LatencyMode.LOW_LATENCY)

    @staticmethod
    def ultra_low_latency() -> "StreamingConfig":
        """250 ms chunks / 25 ms overlap (reference: streaming.rs:177)."""
        return StreamingConfig(
            chunk_duration=0.25, chunk_overlap=0.025,
            min_speech_duration_ms=50, buffer_duration=2.0,
            latency_mode=LatencyMode.ULTRA_LOW)

    @staticmethod
    def custom_latency(chunk_duration: float, chunk_overlap: float,
                       min_speech_duration_ms: int,
                       buffer_duration: float) -> "StreamingConfig":
        return StreamingConfig(
            chunk_duration=chunk_duration, chunk_overlap=chunk_overlap,
            min_speech_duration_ms=min_speech_duration_ms,
            buffer_duration=buffer_duration, latency_mode=LatencyMode.CUSTOM)


class StreamingProcessor:
    """Chunking state machine (reference: streaming.rs:358)."""

    FRAME_MS = 30  # process in 30 ms frames (reference: streaming.rs:693)

    def __init__(self, config: Optional[StreamingConfig] = None) -> None:
        self.config = config or StreamingConfig()
        self.state = ProcessorState.WAITING_FOR_SPEECH
        self.ring = RingBuffer.for_duration(
            self.config.buffer_duration, self.config.input_sample_rate)
        self._resampler = (
            None if self.config.input_sample_rate == self.config.output_sample_rate
            else SincResampler(self.config.input_sample_rate,
                               self.config.output_sample_rate))
        self._vad = VoiceActivityDetector(VadConfig())
        self._chunk: List[np.ndarray] = []   # accumulated 16k speech
        self._chunk_samples = 0
        self._overlap: Optional[np.ndarray] = None  # carried across chunks
        self._ready_chunks: List[np.ndarray] = []  # FIFO of finalized chunks
        self.events: List[StreamingEvent] = []
        self._time = 0.0
        self._in_speech = False
        self._frame_in = int(self.config.input_sample_rate * self.FRAME_MS / 1000)
        # first-partial threshold (reference: streaming.rs:390
        # DEFAULT_PARTIAL_THRESHOLD_SECS = 3.0); set_partial_threshold
        # overrides
        self._partial_threshold = int(
            3.0 * self.config.output_sample_rate)
        self._partial_emitted = False

    # -- input -----------------------------------------------------------------
    def push_audio(self, samples: np.ndarray) -> int:
        """Append raw input-rate audio (reference: streaming.rs:674)."""
        dropped = self.ring.write_overwrite(np.asarray(samples, np.float32))
        if dropped:
            self._emit("error", f"ring overflow, dropped {dropped} samples")
        return dropped

    # -- processing --------------------------------------------------------------
    def process(self) -> List[StreamingEvent]:
        """Drain the ring in 30 ms frames (reference: streaming.rs:682)."""
        if self.state == ProcessorState.ERROR:
            return self._drain_events()
        while self.ring.available >= self._frame_in:
            frame = self.ring.read(self._frame_in)
            if self._resampler is not None:
                frame = self._resampler.resample(frame)
            self._time += self.FRAME_MS / 1000.0
            speech = (self._vad.process_frame(frame)
                      if self.config.enable_vad else True)
            self._update_state(frame, speech)
        return self._drain_events()

    def _update_state(self, frame16k: np.ndarray, speech: bool) -> None:
        """(reference: streaming.rs:726 update_state)"""
        if speech and not self._in_speech:
            self._in_speech = True
            self._emit("speech_started", "")
            if self.state == ProcessorState.WAITING_FOR_SPEECH:
                self.state = ProcessorState.ACCUMULATING_SPEECH
                # prepend carried overlap for cross-chunk context
                if self._overlap is not None:
                    self._chunk.append(self._overlap)
                    self._chunk_samples += len(self._overlap)
                    self._overlap = None
        elif not speech and self._in_speech:
            self._in_speech = False
            self._emit("speech_ended", "")

        if self.state in (ProcessorState.ACCUMULATING_SPEECH,
                          ProcessorState.PARTIAL_RESULT_READY):
            if self._in_speech or self.config.latency_mode != LatencyMode.STANDARD:
                self._chunk.append(frame16k)
                self._chunk_samples += len(frame16k)
            # first partial ready: enough audio for an interim transcription
            # (reference: streaming.rs:760-769 PartialReady + :801 state)
            if (not self._partial_emitted
                    and self.state == ProcessorState.ACCUMULATING_SPEECH
                    and self._chunk_samples >= self._partial_threshold):
                self._partial_emitted = True
                self.state = ProcessorState.PARTIAL_RESULT_READY
                self._emit("partial_ready", f"{self._chunk_samples} samples")
            target = int(self.config.chunk_duration * self.config.output_sample_rate)
            min_speech = int(self.config.min_speech_duration_ms
                             * self.config.output_sample_rate / 1000)
            if self._chunk_samples >= target:
                self._finalize_chunk()
            elif (not self._in_speech and self._chunk_samples >= min_speech
                  and self.config.latency_mode == LatencyMode.STANDARD):
                # end-of-utterance flush in standard mode
                self._finalize_chunk()

    def set_partial_threshold(self, seconds: float) -> None:
        """(reference: streaming.rs:607)"""
        self._partial_threshold = int(
            seconds * self.config.output_sample_rate)

    def _finalize_chunk(self) -> None:
        chunk = np.concatenate(self._chunk) if self._chunk else np.zeros(0, np.float32)
        self._chunk = []
        self._chunk_samples = 0
        self._partial_emitted = False
        # carry overlap tail into the next chunk (reference: streaming.rs:849)
        overlap_n = int(self.config.chunk_overlap * self.config.output_sample_rate)
        if overlap_n > 0 and len(chunk) > overlap_n:
            self._overlap = chunk[-overlap_n:].copy()
        self._ready_chunks.append(chunk)
        self.state = ProcessorState.CHUNK_READY
        self._emit("chunk_ready", f"{len(chunk)} samples")

    # -- output ------------------------------------------------------------------
    def has_chunk(self) -> bool:
        return bool(self._ready_chunks)

    def get_chunk(self) -> Optional[np.ndarray]:
        """Pop the oldest finalized chunk (reference: streaming.rs:843;
        FIFO so no chunk is lost if the consumer polls slower than audio
        arrives)."""
        if not self._ready_chunks:
            return None
        chunk = self._ready_chunks.pop(0)
        if not self._ready_chunks and self.state == ProcessorState.CHUNK_READY:
            self.state = (ProcessorState.ACCUMULATING_SPEECH if self._in_speech
                          else ProcessorState.WAITING_FOR_SPEECH)
        return chunk

    def has_partial(self) -> bool:
        """(reference: streaming.rs:575)"""
        return (self.state in (ProcessorState.ACCUMULATING_SPEECH,
                               ProcessorState.PARTIAL_RESULT_READY)
                and self._chunk_samples > 0)

    def get_partial(self) -> Optional[np.ndarray]:
        """Copy of the accumulating buffer (reference: streaming.rs:586)."""
        if not self.has_partial():
            return None
        return np.concatenate(self._chunk)

    def flush(self) -> Optional[np.ndarray]:
        """Force out whatever has accumulated (reference: streaming.rs:875)."""
        self.process()
        # drain remaining sub-frame audio
        rest = self.ring.read(self.ring.available)
        if len(rest):
            if self._resampler is not None:
                rest = self._resampler.resample(rest)
            self._chunk.append(rest)
            self._chunk_samples += len(rest)
        if self._chunk_samples > 0:
            self._finalize_chunk()
        # return everything left as one final chunk
        if not self._ready_chunks:
            return None
        chunks = self._ready_chunks
        self._ready_chunks = []
        if self.state == ProcessorState.CHUNK_READY:
            self.state = (ProcessorState.ACCUMULATING_SPEECH if self._in_speech
                          else ProcessorState.WAITING_FOR_SPEECH)
        return np.concatenate(chunks)

    # -- error recovery (reference: streaming.rs:645-658) -------------------------
    def mark_error(self, detail: str) -> None:
        self.state = ProcessorState.ERROR
        self._emit("error", detail)

    def recover_from_error(self) -> None:
        self._chunk = []
        self._chunk_samples = 0
        self._ready_chunks = []
        self._partial_emitted = False
        self.state = ProcessorState.WAITING_FOR_SPEECH

    def set_overlap_buffer(self, audio: np.ndarray) -> None:
        """Inject context audio (reference: streaming.rs:522)."""
        self._overlap = np.asarray(audio, np.float32).copy()

    # -- events --------------------------------------------------------------------
    def _emit(self, kind: str, detail: str) -> None:
        self.events.append(StreamingEvent(kind, self._time, detail))

    def _drain_events(self) -> List[StreamingEvent]:
        ev, self.events = self.events, []
        return ev
