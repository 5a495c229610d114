"""Timing helpers of the port's measuring tools (port of the JAX package's
``tools/profile_decode.py:34-82``).

- ``timeit(fn, *args)``: best wall time of ``reps`` calls after a warm-up
  call, each ended by ``torch.cuda.synchronize`` on a CUDA device (the
  JAX helper fetched one element as its barrier).
- ``P(lo, hi).per_step(body, env, init)``: the slope timer. ``body(i,
  env, carry) -> carry`` runs ``lo`` and then ``hi`` times in a Python
  loop; the time per step is (t(hi) - t(lo)) / (hi - lo), so whatever a
  run pays once (the first launch, the final synchronisation) cancels.
  PyTorch runs eagerly: there is no ``jit`` or ``while_loop`` to compile,
  and each step's host work (Python, launches) is part of the slope.
- ``graph_ms(fn)``: the device time of one call of ``fn`` by CUDA-graph
  replay (``reps`` calls captured, replayed between CUDA events), with no
  host launch cost.

A time taken on the CPU is a host time: callers label results with the
device they ran on.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch


def sync(device: "torch.device | str") -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timeit(fn: Callable, *args, reps: int = 3,
           device: "torch.device | str" = "cuda") -> float:
    """Best of ``reps`` wall-clock seconds of ``fn(*args)`` (after one
    warm-up call), synchronised on ``device``."""
    fn(*args)
    sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def stepped(body: Callable[[int, Any, Any], Any]) -> Callable:
    """``run(steps, env, state)``: ``state = body(i, env, state)`` for i
    in range(steps)."""
    def run(steps: int, env, state):
        for i in range(steps):
            state = body(i, env, state)
        return state
    return run


class P:
    """Slope timer between ``lo`` and ``hi`` steps."""

    def __init__(self, lo: int, hi: int,
                 device: "torch.device | str" = "cuda") -> None:
        if not 0 <= lo < hi:
            raise ValueError(f"need 0 <= lo < hi, got {lo}, {hi}")
        self.lo, self.hi, self.device = lo, hi, device

    def per_step(self, body: Callable, env, init) -> float:
        """Seconds per step of ``body``."""
        fn = stepped(body)
        t_lo = timeit(fn, self.lo, env, init, device=self.device)
        t_hi = timeit(fn, self.hi, env, init, device=self.device)
        return (t_hi - t_lo) / (self.hi - self.lo)


def graph_ms(fn: Callable[[], Any], reps: int = 20,
             replays: int = 10) -> float:
    """Device ms of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)
