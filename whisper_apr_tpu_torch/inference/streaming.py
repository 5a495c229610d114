# Copied from whisper_apr_tpu/inference/streaming.py (host-side numpy, no JAX); keep the two in step.
"""Streaming transcription: couples the audio chunker with the engine.

(reference: src/inference/streaming.rs:121 StreamingTranscriber —
max_tokens_per_chunk=224, overlap_tokens=10 at :41-63, process() :197,
finalize() :276; and the engine-level StreamingSession at src/lib.rs:1555.)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..audio.streaming import StreamingConfig, StreamingProcessor
from ..config import SAMPLE_RATE

MAX_TOKENS_PER_CHUNK = 224  # reference: src/inference/streaming.rs:41
OVERLAP_TOKENS = 10         # reference: src/inference/streaming.rs:63


def dedup_overlap_tokens(prev: List[int], new: List[int],
                         max_overlap: int = OVERLAP_TOKENS) -> List[int]:
    """Drop ``new``'s leading tokens that duplicate ``prev``'s tail.

    Chunk boundaries overlap in AUDIO (context carry-over), so the same
    words can be decoded twice; the longest suffix==prefix match within
    ``max_overlap`` tokens is removed (reference declares overlap_tokens=10
    for this continuity window, streaming.rs:63).
    """
    lim = min(max_overlap, len(prev), len(new))
    for k in range(lim, 0, -1):
        if prev[-k:] == new[:k]:
            return new[k:]
    return new


def _norm_word(w: str) -> str:
    return w.strip(".,!?;:\"'").lower()


def dedup_overlap_words(prev_text: str, new_text: str,
                        max_overlap: int = OVERLAP_TOKENS) -> str:
    """Word-level twin of ``dedup_overlap_tokens`` (robust to tokenizer
    misalignment across chunk boundaries): drops ``new_text``'s leading
    words that repeat ``prev_text``'s trailing words."""
    prev_w = prev_text.split()
    new_w = new_text.split()
    lim = min(max_overlap, len(prev_w), len(new_w))
    for k in range(lim, 0, -1):
        if ([_norm_word(w) for w in prev_w[-k:]]
                == [_norm_word(w) for w in new_w[:k]]):
            return " ".join(new_w[k:])
    return new_text


@dataclasses.dataclass
class StreamingResult:
    """One emitted piece of transcript."""

    kind: str  # "partial" | "chunk" | "final"
    text: str
    time: float = 0.0


class StreamingTranscriber:
    """File/mic streaming transcription (reference: streaming.rs:121)."""

    def __init__(self, engine, config: Optional[StreamingConfig] = None,
                 language: Optional[str] = None,
                 emit_partials: bool = False,
                 max_tokens: int = MAX_TOKENS_PER_CHUNK) -> None:
        from ..engine import TranscribeOptions
        self.engine = engine
        self.processor = StreamingProcessor(
            config or StreamingConfig.with_sample_rate(SAMPLE_RATE))
        self.language = language
        self.emit_partials = emit_partials
        self._opts = TranscribeOptions(
            language=language, max_tokens=max_tokens)
        self._transcript: List[str] = []

    def push(self, samples: np.ndarray) -> List[StreamingResult]:
        """Feed audio; returns any new results (reference: streaming.rs:197)."""
        self.processor.push_audio(samples)
        events = self.processor.process()
        out: List[StreamingResult] = []
        for ev in events:
            if ev.kind == "chunk_ready":
                chunk = self.processor.get_chunk()
                if chunk is not None and len(chunk) >= 400:
                    r = self.engine.transcribe(chunk, self._opts)
                    text = self._dedup(r.text)
                    if text:
                        self._transcript.append(text)
                        out.append(StreamingResult("chunk", text, ev.time))
        if self.emit_partials and self.processor.has_partial():
            partial = self.processor.get_partial()
            if partial is not None and len(partial) >= 400:
                r = self.engine.transcribe(partial, self._opts)
                if r.text:
                    out.append(StreamingResult("partial", r.text))
        return out

    def _dedup(self, text: str) -> str:
        """Merge a new chunk against the transcript tail: audio overlap can
        re-decode boundary words (reference overlap_tokens=10 continuity
        window, streaming.rs:63)."""
        if not text or not self._transcript:
            return text
        return dedup_overlap_words(self._transcript[-1], text)

    def finalize(self) -> str:
        """Flush and return the full transcript (reference: streaming.rs:276)."""
        chunk = self.processor.flush()
        if chunk is not None and len(chunk) >= 400:
            r = self.engine.transcribe(chunk, self._opts)
            text = self._dedup(r.text)
            if text:
                self._transcript.append(text)
        return " ".join(self._transcript)

    @property
    def transcript(self) -> str:
        return " ".join(self._transcript)


class StreamingSession:
    """Engine-level session facade (reference: src/lib.rs:1555
    create_streaming_session / :1640 push / :1686 finalize).

    ``partial_reuse`` (default on) decodes each partial by forcing the
    PREVIOUS partial's tokens (minus a small revision tail) as a prefix —
    engine.transcribe_prefixed — so only the new suffix decodes
    sequentially. The reference re-transcribes the whole growing prefix
    per partial (SURVEY §3.3); its StreamingKVCache::warm_up machinery
    (decoder.rs:739) is the intent this realizes soundly.
    """

    REVISE_TAIL = 5  # trailing tokens re-decoded each partial (frontier
    #                  words may change as more audio arrives)

    def __init__(self, engine, options=None, input_sample_rate: int = 44_100,
                 config: Optional[StreamingConfig] = None,
                 partial_reuse: bool = True) -> None:
        cfg = config or StreamingConfig.with_sample_rate(input_sample_rate)
        self._t = StreamingTranscriber(
            engine, cfg,
            language=getattr(options, "language", None) if options else None,
            emit_partials=True,
            max_tokens=(getattr(options, "max_tokens", None)
                        or MAX_TOKENS_PER_CHUNK) if options
            else MAX_TOKENS_PER_CHUNK)
        self.partial_reuse = partial_reuse
        self._partial_tokens: List[int] = []
        self.results: List[StreamingResult] = []

    def push(self, samples: np.ndarray) -> List[StreamingResult]:
        res = self._t.push(samples)
        for r in res:
            if r.kind == "chunk":
                # chunk boundary: the accumulating buffer restarts, so the
                # partial prefix no longer describes the buffered audio
                self._partial_tokens = []
        self.results.extend(res)
        return res

    def has_partial(self) -> bool:
        return self._t.processor.has_partial()

    def get_partial(self) -> Optional[str]:
        if not self.has_partial():
            return None
        partial = self._t.processor.get_partial()
        if partial is None or len(partial) < 400:
            return None
        engine = self._t.engine
        if not self.partial_reuse:
            return engine.transcribe(partial, self._t._opts).text
        initial = engine.get_initial_tokens(
            self._t._opts.language or "en", self._t._opts.task)
        prev_gen = [t for t in self._partial_tokens[len(initial):]
                    if t != engine.specials.eot]
        prefix = prev_gen[: max(0, len(prev_gen) - self.REVISE_TAIL)]
        r = engine.transcribe_prefixed(partial, prefix, self._t._opts)
        self._partial_tokens = list(r.tokens)
        return r.text

    def finalize(self) -> str:
        return self._t.finalize()
