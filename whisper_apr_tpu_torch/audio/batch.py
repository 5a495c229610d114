# Copied from whisper_apr_tpu/audio/batch.py (host-side numpy, no JAX); keep the two in step.
"""Batch audio preprocessing.

(reference: src/audio/batch.rs — BatchPreprocessor::process_batch :158,
to_padded_tensor :107, split_into_chunks :219.)
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..config import HOP_LENGTH, N_SAMPLES_30S, SAMPLE_RATE
from .mel import MelFilterbank


@dataclasses.dataclass
class BatchConfig:
    """(reference: src/audio/batch.rs:10 BatchConfig)"""

    n_mels: int = 80
    max_batch: int = 32
    pad_value: float = -1.0  # HF silence value (reference: src/lib.rs:434)


class BatchPreprocessor:
    """Audio batch -> padded mel tensor (reference: batch.rs:132)."""

    def __init__(self, config: Optional[BatchConfig] = None,
                 mel_filters: Optional[MelFilterbank] = None) -> None:
        self.config = config or BatchConfig()
        self.mel_filters = mel_filters or MelFilterbank.create(self.config.n_mels)

    def process_batch(self, audios: List[np.ndarray],
                      n_frames: int = 3000) -> np.ndarray:
        """[clips] -> [B, n_frames, n_mels] (reference: batch.rs:158)."""
        mels = [self.mel_filters.compute_30s(a, n_frames=n_frames)
                for a in audios]
        return np.stack(mels)

    def to_padded_tensor(self, mels: List[np.ndarray],
                         n_frames: Optional[int] = None) -> np.ndarray:
        """Variable-length mels -> one padded [B, T, M] tensor
        (reference: batch.rs:107)."""
        if not mels:
            return np.zeros((0, 0, self.config.n_mels), np.float32)
        T = n_frames or max(m.shape[0] for m in mels)
        out = np.full((len(mels), T, mels[0].shape[1]),
                      self.config.pad_value, np.float32)
        for i, m in enumerate(mels):
            n = min(m.shape[0], T)
            out[i, :n] = m[:n]
        return out


def split_into_chunks(audio: np.ndarray,
                      chunk_samples: int = N_SAMPLES_30S,
                      overlap_samples: int = 0) -> List[np.ndarray]:
    """Long audio -> fixed windows with optional overlap
    (reference: src/audio/batch.rs:219)."""
    audio = np.asarray(audio, dtype=np.float32)
    if len(audio) <= chunk_samples:
        return [audio]
    step = max(1, chunk_samples - overlap_samples)
    chunks = []
    for start in range(0, len(audio), step):
        chunk = audio[start: start + chunk_samples]
        if len(chunk) == 0:
            break
        chunks.append(chunk)
        if start + chunk_samples >= len(audio):
            break
    return chunks
