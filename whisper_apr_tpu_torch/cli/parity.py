# Copied from whisper_apr_tpu/cli/parity.py (host-side Python, no JAX); keep the two in step.
"""WER / parity utilities.

(reference: src/cli/parity.rs — ``calculate_wer`` via word-level Levenshtein
at :209, ``ParityBenchmark`` RTF comparison at :301.)
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Sequence


def normalize_text(text: str) -> List[str]:
    """Lowercase, strip punctuation, split into words."""
    return re.findall(r"[a-z0-9']+", text.lower())


def levenshtein(a: Sequence[str], b: Sequence[str]) -> int:
    """Word-level edit distance (reference: parity.rs:209)."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, wa in enumerate(a, start=1):
        cur = [i] + [0] * len(b)
        for j, wb in enumerate(b, start=1):
            cost = 0 if wa == wb else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[-1]


def calculate_wer(reference: str, hypothesis: str) -> float:
    """Word error rate in [0, inf) (reference: parity.rs:209)."""
    ref_words = normalize_text(reference)
    hyp_words = normalize_text(hypothesis)
    if not ref_words:
        return 0.0 if not hyp_words else 1.0
    return levenshtein(ref_words, hyp_words) / len(ref_words)


@dataclasses.dataclass
class ParityResult:
    """RTF + WER comparison row (reference: parity.rs:301 ParityBenchmark)."""

    wer: float
    rtf: float
    audio_seconds: float
    processing_seconds: float
    text: str

    def summary(self) -> str:
        return (f"WER {self.wer:.3f} | RTF {self.rtf:.4f} "
                f"({self.processing_seconds:.2f}s for {self.audio_seconds:.1f}s)")
