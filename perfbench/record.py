"""What a run records, for the metric readers: the benchmark's own spans
and counts, the scheduler's counters, and the traced window's summary.

Times are ``time.perf_counter()`` seconds. Each metric reader
(``metrics/<name>.py``) takes a ``Record`` and returns its value or None.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from . import roofline
from .spec import Dims
from .trace import Summary

HAND_KERNELS = ("batched_block_kernel", "ffn_mma_kernel",
                "int8_mv_mma_kernel", "head_block_kernel", "ffn_block_kernel")


def is_hand_kernel(name: str) -> bool:
    return any(k in name for k in HAND_KERNELS)


@dataclasses.dataclass
class Req:
    """One request of a serve cell (``due``, ``submitted`` and ``done``
    from the window's opening)."""

    due: float
    submitted: float
    tokens: int                       # drawn (and asked for)
    audio_s: float
    in_window: bool
    done: Optional[float] = None
    emitted: Optional[int] = None
    ok: bool = False
    admit_step: Optional[int] = None
    done_step: Optional[int] = None

    @property
    def latency(self) -> float:
        """Due to completion; a failed or unfinished request misses every
        limit."""
        if not self.ok or self.done is None:
            return float("inf")
        return self.done - self.due


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    admitted: int


@dataclasses.dataclass
class File:
    """One file of a longform cell."""

    t0: float
    t1: float
    audio_s: float
    windows: int
    max_tokens: int
    ok: bool


@dataclasses.dataclass
class Record:
    kind: str                         # "serve" | "longform"
    dims: Dims
    seconds: float
    setup_s: float
    prompt_len: int
    kv: Dict[str, object]             # self / cross cache bytes and scales
    head: str                         # the vocab head's kernel
    requests: List[Req] = dataclasses.field(default_factory=list)
    steps: List[Step] = dataclasses.field(default_factory=list)
    measured_steps: range = range(0)
    traced_steps: range = range(0)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    files: List[File] = dataclasses.field(default_factory=list)
    traced_files: range = range(0)
    window_end: float = 0.0           # last completion, from the opening
    trace: Optional[Summary] = None

    # -- serve ---------------------------------------------------------------
    def tick_positions(self, steps: range) -> Dict[int, List[int]]:
        """Per step, the positions of the rows its tick decoded for live
        requests (from each request's admission step and token count)."""
        out: Dict[int, List[int]] = {s: [] for s in steps}
        last = len(self.steps) - 1
        for r in self.requests:
            if r.admit_step is None:
                continue
            end = r.done_step if r.done_step is not None else last
            for s in range(max(r.admit_step, steps.start),
                           min(end, steps.stop - 1) + 1):
                out[s].append(self.prompt_len + s - r.admit_step)
        return out

    def step_flops(self, steps: range) -> float:
        adm = roofline.admission_flops(self.dims, self.prompt_len)
        total = adm * sum(self.steps[s].admitted for s in steps)
        for pos in self.tick_positions(steps).values():
            total += sum(roofline.decoder_token_flops(self.dims, p)
                         for p in pos)
        return total

    def tick_floor_s(self, steps: range) -> float:
        return sum(roofline.tick_floor_s(self.dims, pos, head=self.head,
                                         **self.kv)
                   for pos in self.tick_positions(steps).values())

    # -- longform ------------------------------------------------------------
    def file_steps(self, f: File) -> range:
        """The greedy loop's positions of a file (every window decodes to
        ``max_tokens``, the prompt included)."""
        return range(self.prompt_len, f.max_tokens - 1)

    def file_flops(self, f: File) -> float:
        adm = roofline.admission_flops(self.dims, self.prompt_len)
        dec = sum(roofline.decoder_token_flops(self.dims, p)
                  for p in self.file_steps(f))
        return f.windows * (adm + dec)

    def file_floor_s(self, f: File) -> float:
        return sum(roofline.tick_floor_s(self.dims, [p] * f.windows,
                                         head=self.head, **self.kv)
                   for p in self.file_steps(f))

    def hand_kernel_s(self, label: str) -> Optional[float]:
        if self.trace is None:
            return None
        ops = self.trace.range_ops.get(label, {})
        return sum(v for k, v in ops.items() if is_hand_kernel(k))
