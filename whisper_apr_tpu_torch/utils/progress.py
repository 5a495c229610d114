"""Phase-based progress tracking for model loading (port of the JAX
package's ``utils/progress.py``).

One repair: a phase starts at exactly the overall fraction its
predecessor reported when complete (the finished phases' weights added
in order, as that report adds them). The JAX tracker sums them with
``sum``, which Python 3.12 compensates, so the fraction could step back
by one ulp entering a phase (0.9, then 0.8999999999999999 entering
"finalize"); here it never decreases, and each value is within an ulp
of the JAX tracker's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional


@dataclasses.dataclass
class Phase:
    name: str
    weight: float


@dataclasses.dataclass
class Progress:
    phase: str
    phase_progress: float  # 0..1 within phase
    overall: float         # 0..1 across all phases
    message: str = ""


ProgressCallback = Callable[[Progress], None]


class ProgressTracker:
    """Weighted multi-phase progress (reference: src/progress.rs)."""

    def __init__(self, phases: List[Phase]) -> None:
        total = sum(p.weight for p in phases) or 1.0
        self.phases = phases
        self._total = total
        self._idx = 0
        self._phase_progress = 0.0

    @staticmethod
    def model_loading() -> "ProgressTracker":
        """(reference: progress.rs ProgressTracker::model_loading)"""
        return ProgressTracker([
            Phase("read", 0.1),
            Phase("parse", 0.1),
            Phase("encoder", 0.35),
            Phase("decoder", 0.35),
            Phase("finalize", 0.1),
        ])

    def start_phase(self, name: str) -> None:
        for i, p in enumerate(self.phases):
            if p.name == name:
                self._idx = i
                self._phase_progress = 0.0
                return

    def update_phase_progress(self, progress: float) -> None:
        self._phase_progress = min(max(progress, 0.0), 1.0)

    def advance(self) -> None:
        self._phase_progress = 1.0
        if self._idx < len(self.phases) - 1:
            self._idx += 1
            self._phase_progress = 0.0

    def to_progress(self, message: str = "") -> Progress:
        done = 0.0
        for p in self.phases[: self._idx]:
            done = done + p.weight

        cur = self.phases[self._idx]
        overall = (done + cur.weight * self._phase_progress) / self._total
        # completing the last phase is exactly 1.0 (float weight sums round)
        if self._idx == len(self.phases) - 1 and self._phase_progress >= 1.0:
            overall = 1.0
        return Progress(cur.name, self._phase_progress, overall, message)


def format_bytes(n: int) -> str:
    """(reference: src/progress.rs format_bytes)"""
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n} B"
