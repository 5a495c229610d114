# Copied from whisper_apr_tpu/diarization.py (host-side numpy, no JAX); keep the two in step.
"""Speaker diarization: who-spoke-when.

(reference: src/diarization/ — sliding-window mel-statistics speaker
embeddings via EmbeddingExtractor::extract at embedding.rs:277,
agglomerative/k-means clustering at clustering.rs:18, segmentation +
Diarizer::process at mod.rs:236.)

Embeddings are mel-statistics vectors (mean + std + delta-mean per mel band)
over sliding windows — deliberately lightweight, matching the reference's
non-neural approach. Clustering: agglomerative with cosine distance, or
k-means with a fixed speaker count.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .audio.mel import MelFilterbank


@dataclasses.dataclass
class DiarizationConfig:
    """(reference: src/diarization/mod.rs DiarizationConfig)"""

    window_seconds: float = 1.5
    hop_seconds: float = 0.75
    max_speakers: int = 4
    num_speakers: Optional[int] = None  # fixed count -> k-means
    distance_threshold: float = 0.35    # agglomerative merge cutoff (cosine)
    min_segment_seconds: float = 0.5


@dataclasses.dataclass
class SpeakerSegment:
    """(reference: src/diarization/mod.rs SpeakerSegment)"""

    speaker: int
    start: float
    end: float

    def duration(self) -> float:
        return self.end - self.start


class EmbeddingExtractor:
    """Mel-statistics speaker embeddings (reference: embedding.rs:277)."""

    def __init__(self, n_mels: int = 40, sample_rate: int = 16_000) -> None:
        self.n_mels = n_mels
        self.sample_rate = sample_rate
        self._fb = MelFilterbank.create(n_mels)

    def extract(self, window: np.ndarray) -> Optional[np.ndarray]:
        """One window -> [3 * n_mels] embedding (mean, std, delta-mean)."""
        mel = self._fb.compute(np.asarray(window, np.float32))
        if mel.shape[0] < 2:
            return None
        mean = mel.mean(axis=0)
        std = mel.std(axis=0)
        delta = np.abs(np.diff(mel, axis=0)).mean(axis=0)
        emb = np.concatenate([mean, std, delta])
        norm = np.linalg.norm(emb)
        return emb / norm if norm > 0 else emb


def cosine_distance(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 1.0
    return float(1.0 - (a @ b) / (na * nb))


def agglomerative_cluster(embeddings: np.ndarray, threshold: float,
                          max_clusters: int) -> np.ndarray:
    """Average-linkage agglomerative clustering with cosine distance
    (reference: clustering.rs:18)."""
    n = len(embeddings)
    if n == 0:
        return np.zeros(0, dtype=int)
    clusters = [[i] for i in range(n)]
    centroids = [embeddings[i].copy() for i in range(n)]

    while len(clusters) > 1:
        best = (None, None, np.inf)
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                d = cosine_distance(centroids[i], centroids[j])
                if d < best[2]:
                    best = (i, j, d)
        i, j, d = best
        if d > threshold and len(clusters) <= max_clusters:
            break
        clusters[i] = clusters[i] + clusters[j]
        centroids[i] = embeddings[clusters[i]].mean(axis=0)
        del clusters[j], centroids[j]

    labels = np.zeros(n, dtype=int)
    for label, members in enumerate(clusters):
        for m in members:
            labels[m] = label
    return labels


def kmeans_cluster(embeddings: np.ndarray, k: int, n_iter: int = 20,
                   seed: int = 0) -> np.ndarray:
    """k-means with k-means++-style init (reference: clustering.rs kmeans)."""
    n = len(embeddings)
    if n == 0:
        return np.zeros(0, dtype=int)
    k = min(k, n)
    rng = np.random.default_rng(seed)
    centroids = [embeddings[rng.integers(n)]]
    for _ in range(k - 1):
        d = np.min([np.sum((embeddings - c) ** 2, axis=1) for c in centroids],
                   axis=0)
        probs = d / d.sum() if d.sum() > 0 else np.full(n, 1.0 / n)
        centroids.append(embeddings[rng.choice(n, p=probs)])
    centroids = np.stack(centroids)

    labels = np.zeros(n, dtype=int)
    for _ in range(n_iter):
        dists = np.stack([np.sum((embeddings - c) ** 2, axis=1)
                          for c in centroids])
        new_labels = dists.argmin(axis=0)
        if (new_labels == labels).all():
            break
        labels = new_labels
        for c in range(k):
            members = embeddings[labels == c]
            if len(members):
                centroids[c] = members.mean(axis=0)
    return labels


class Diarizer:
    """Sliding-window diarization (reference: src/diarization/mod.rs:236)."""

    def __init__(self, config: Optional[DiarizationConfig] = None) -> None:
        self.config = config or DiarizationConfig()
        self.extractor = EmbeddingExtractor()

    def process(self, audio: np.ndarray,
                sample_rate: int = 16_000) -> List[SpeakerSegment]:
        cfg = self.config
        audio = np.asarray(audio, dtype=np.float32)
        win = int(cfg.window_seconds * sample_rate)
        hop = int(cfg.hop_seconds * sample_rate)
        if len(audio) < win:
            return [SpeakerSegment(0, 0.0, len(audio) / sample_rate)] \
                if len(audio) else []

        embeddings, times = [], []
        for start in range(0, len(audio) - win + 1, hop):
            emb = self.extractor.extract(audio[start:start + win])
            if emb is not None:
                embeddings.append(emb)
                times.append(start / sample_rate)
        if not embeddings:
            return []
        embeddings = np.stack(embeddings)

        if cfg.num_speakers is not None:
            labels = kmeans_cluster(embeddings, cfg.num_speakers)
        else:
            labels = agglomerative_cluster(
                embeddings, cfg.distance_threshold, cfg.max_speakers)

        # merge consecutive windows of the same speaker into segments
        segments: List[SpeakerSegment] = []
        for t, label in zip(times, labels):
            end = t + cfg.window_seconds
            if segments and segments[-1].speaker == label \
                    and t <= segments[-1].end:
                segments[-1].end = end
            else:
                segments.append(SpeakerSegment(int(label), t, end))
        return [s for s in segments
                if s.duration() >= cfg.min_segment_seconds]

    def speaker_count(self, segments: List[SpeakerSegment]) -> int:
        return len({s.speaker for s in segments})
