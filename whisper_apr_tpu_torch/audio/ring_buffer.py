# Copied from whisper_apr_tpu/audio/ring_buffer.py (host-side numpy, no JAX); keep the two in step.
"""Circular audio buffer (reference: src/audio/ring_buffer.rs:55 RingBuffer).

Single-producer/single-consumer ring with overwrite-oldest semantics
(reference: write_overwrite :190, read/peek/skip :219-273).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..errors import AudioError


class RingBuffer:
    """Fixed-capacity f32 ring buffer."""

    def __init__(self, capacity: int) -> None:
        if capacity <= 0:
            raise AudioError("ring buffer capacity must be positive")
        self._buf = np.zeros(capacity, dtype=np.float32)
        self.capacity = capacity
        self._read = 0   # absolute sample index of read head
        self._write = 0  # absolute sample index of write head

    @staticmethod
    def for_duration(seconds: float, sample_rate: int = 16_000) -> "RingBuffer":
        """(reference: ring_buffer.rs:114 for_duration)"""
        return RingBuffer(max(1, int(seconds * sample_rate)))

    def __len__(self) -> int:
        return self._write - self._read

    @property
    def available(self) -> int:
        return len(self)

    @property
    def free(self) -> int:
        return self.capacity - len(self)

    def is_empty(self) -> bool:
        return self._read == self._write

    def is_full(self) -> bool:
        return len(self) == self.capacity

    def write(self, data: np.ndarray) -> int:
        """Write up to ``free`` samples; returns count written."""
        data = np.asarray(data, dtype=np.float32)
        n = min(len(data), self.free)
        self._write_at(self._write, data[:n])
        self._write += n
        return n

    def write_overwrite(self, data: np.ndarray) -> int:
        """Write all samples, dropping oldest on overflow
        (reference: ring_buffer.rs:190). Returns samples dropped."""
        data = np.asarray(data, dtype=np.float32)
        if len(data) >= self.capacity:
            # only the final `capacity` samples survive
            dropped = len(self) + len(data) - self.capacity
            self._buf[:] = 0
            tail = data[-self.capacity:]
            self._read = 0
            self._write = 0
            self._write_at(0, tail)
            self._write = self.capacity
            return max(0, dropped)
        overflow = max(0, len(data) - self.free)
        self._read += overflow  # drop oldest
        self._write_at(self._write, data)
        self._write += len(data)
        return overflow

    def _write_at(self, abs_pos: int, data: np.ndarray) -> None:
        pos = abs_pos % self.capacity
        first = min(len(data), self.capacity - pos)
        self._buf[pos: pos + first] = data[:first]
        if first < len(data):
            self._buf[: len(data) - first] = data[first:]

    def _read_at(self, abs_pos: int, n: int) -> np.ndarray:
        pos = abs_pos % self.capacity
        first = min(n, self.capacity - pos)
        out = np.empty(n, dtype=np.float32)
        out[:first] = self._buf[pos: pos + first]
        if first < n:
            out[first:] = self._buf[: n - first]
        return out

    def read(self, n: int) -> np.ndarray:
        """Consume up to n samples (reference: ring_buffer.rs:219)."""
        n = min(n, len(self))
        out = self._read_at(self._read, n)
        self._read += n
        return out

    def peek(self, n: int) -> np.ndarray:
        """Read without consuming (reference: ring_buffer.rs:248)."""
        n = min(n, len(self))
        return self._read_at(self._read, n)

    def skip(self, n: int) -> int:
        """Drop up to n samples (reference: ring_buffer.rs:273)."""
        n = min(n, len(self))
        self._read += n
        return n

    def clear(self) -> None:
        self._read = self._write = 0
