# Copied from whisper_apr_tpu/alignment.py (host side, no JAX); keep the two in step.
"""Word-level timestamps via cross-attention alignment.

(reference: src/timestamps/ — CrossAttentionAlignment::extract_token_alignments
at alignment.rs:223: average cross-attention over selected layers/heads, peak
frame per token, end = next token's peak; WordTimestampExtractor at :370
groups BPE tokens into words; boundary refinement by silence in
boundaries.rs.)

Encoder positions are 20 ms apart (1500 positions / 30 s), so
``time_s = frame * 0.02``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .native import dtw_path

FRAME_SECONDS = 0.02  # one encoder position = 2 mel hops = 20 ms


@dataclasses.dataclass
class AlignmentConfig:
    """(reference: src/timestamps/alignment.rs AlignmentConfig)"""

    layers: Optional[Sequence[int]] = None  # None = all layers
    heads: Optional[Sequence[int]] = None   # None = all heads
    monotonic: bool = True                  # enforce non-decreasing peaks
    # "peak" (default): the reference's per-token argmax (alignment.rs:223
    # — start = peak frame, end = next token's peak). "dtw": globally
    # optimal monotonic token->frame assignment via dynamic time warping
    # over the averaged attention (``dtw_path``, openai/whisper-style
    # timing) — spans PARTITION the frame axis instead of peak-to-peak.
    method: str = "peak"


@dataclasses.dataclass
class TokenAlignment:
    """(reference: alignment.rs:93 TokenAlignment)"""

    token_index: int
    token_id: int
    start_frame: int
    end_frame: int
    confidence: float

    @property
    def start_time(self) -> float:
        return self.start_frame * FRAME_SECONDS

    @property
    def end_time(self) -> float:
        return self.end_frame * FRAME_SECONDS


@dataclasses.dataclass
class WordTimestamp:
    word: str
    start: float
    end: float
    confidence: float
    tokens: List[int]


class CrossAttentionAlignment:
    """Token-level alignment from decoder cross-attention weights."""

    def __init__(self, config: Optional[AlignmentConfig] = None) -> None:
        self.config = config or AlignmentConfig()

    def average_attention(self, weights: np.ndarray) -> np.ndarray:
        """weights [L, B, H, T_text, T_audio] -> averaged [T_text, T_audio]
        over the configured layers/heads, batch item 0
        (reference: alignment.rs average_attention)."""
        weights = np.asarray(weights, dtype=np.float32)
        L, B, H = weights.shape[:3]
        layers = self.config.layers if self.config.layers is not None else range(L)
        heads = self.config.heads if self.config.heads is not None else range(H)
        acc = np.zeros(weights.shape[3:], dtype=np.float32)
        count = 0
        for li in layers:
            for hi in heads:
                acc += weights[li, 0, hi]
                count += 1
        return acc / max(count, 1)

    def extract_token_alignments(self, weights: np.ndarray,
                                 token_ids: Sequence[int],
                                 num_frames: Optional[int] = None
                                 ) -> List[TokenAlignment]:
        """(reference: alignment.rs:223)"""
        avg = self.average_attention(weights)  # [T_text, T_audio]
        if num_frames is not None:
            avg = avg[:, :num_frames]
        n = min(len(token_ids), avg.shape[0])
        if self.config.method == "dtw":
            return self._extract_dtw(avg[:n], token_ids[:n])
        peaks = avg[:n].argmax(axis=1)
        if self.config.monotonic:
            peaks = np.maximum.accumulate(peaks)
        out: List[TokenAlignment] = []
        for i in range(n):
            peak = int(peaks[i])
            row = avg[i]
            total = float(row.sum())
            conf = float(row[peak] / total) if total > 0 else 0.0
            end = int(peaks[i + 1]) if i + 1 < n else avg.shape[1]
            out.append(TokenAlignment(i, int(token_ids[i]), peak,
                                      max(end, peak + 1), conf))
        return out

    def _extract_dtw(self, avg: np.ndarray,
                     token_ids: Sequence[int]) -> List[TokenAlignment]:
        """DTW alignment: cost = -(row-standardized attention); the path's
        frames on row i are token i's span. Globally optimal and monotonic
        by construction (vs the per-token argmax, which the ``monotonic``
        clamp can drag forward on noisy rows)."""
        n, m = avg.shape
        std = avg.std(axis=1, keepdims=True)
        z = (avg - avg.mean(axis=1, keepdims=True)) / np.maximum(std, 1e-9)
        ti, tj = dtw_path(-z.astype(np.float32))
        out: List[TokenAlignment] = []
        for i in range(n):
            frames = tj[ti == i]
            start = int(frames[0]) if len(frames) else (
                out[-1].end_frame if out else 0)
            end = int(frames[-1]) + 1 if len(frames) else start + 1
            row = avg[i]
            total = float(row.sum())
            # end >= start + 1 in both branches above, so no clamp needed
            conf = (float(row[start:end].max() / total)
                    if total > 0 else 0.0)
            out.append(TokenAlignment(i, int(token_ids[i]), start,
                                      end, conf))
        return out


class WordTimestampExtractor:
    """Groups BPE token alignments into words (reference: alignment.rs:370).

    GPT-2 byte-level BPE marks word starts with a leading space in the
    decoded token text.
    """

    def __init__(self, tokenizer,
                 config: Optional[AlignmentConfig] = None) -> None:
        self.tokenizer = tokenizer
        self.aligner = CrossAttentionAlignment(config)

    def extract(self, weights: np.ndarray, token_ids: Sequence[int],
                num_frames: Optional[int] = None) -> List[WordTimestamp]:
        aligns = self.aligner.extract_token_alignments(
            weights, token_ids, num_frames)
        words: List[WordTimestamp] = []
        cur_tokens: List[TokenAlignment] = []
        cur_text = ""

        def flush():
            if not cur_tokens or not cur_text.strip():
                return
            words.append(WordTimestamp(
                word=cur_text.strip(),
                start=cur_tokens[0].start_time,
                end=cur_tokens[-1].end_time,
                confidence=float(np.mean([t.confidence for t in cur_tokens])),
                tokens=[t.token_id for t in cur_tokens]))

        for al in aligns:
            piece = self.tokenizer.decode_with_options([al.token_id],
                                                       skip_special=True)
            if piece.startswith(" ") and cur_tokens:
                flush()
                cur_tokens, cur_text = [], ""
            cur_tokens.append(al)
            cur_text += piece
        flush()
        return words


def refine_boundaries_by_silence(words: List[WordTimestamp],
                                 audio: np.ndarray,
                                 sample_rate: int = 16_000,
                                 window_s: float = 0.1) -> List[WordTimestamp]:
    """Snap word boundaries toward local energy minima
    (reference: src/timestamps/boundaries.rs)."""
    audio = np.asarray(audio, dtype=np.float32)
    hop = max(1, int(sample_rate * 0.01))
    n_frames = max(1, len(audio) // hop)
    energy = np.array([
        float(np.mean(audio[i * hop:(i + 1) * hop] ** 2))
        for i in range(n_frames)])

    def snap(t: float) -> float:
        c = int(t * 100)  # 10 ms energy frames
        lo = max(0, c - int(window_s * 100))
        hi = min(len(energy), c + int(window_s * 100) + 1)
        if lo >= hi:
            return t
        return (lo + int(np.argmin(energy[lo:hi]))) / 100.0

    out = []
    for w in words:
        s, e = snap(w.start), snap(w.end)
        if e <= s:
            e = w.end
        out.append(dataclasses.replace(w, start=s, end=e))
    return out
