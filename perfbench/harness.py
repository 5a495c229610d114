"""One run of a cell: set-up, the measured window, the comparison that
decides ``correct``, the metrics, and the result line.

``execute`` takes the device it is given: ``run.py`` passes the card after
checking that there is one; the CPU tests pass the CPU and a small
configuration, to drive everything else a run does.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Callable, Dict, Optional, TextIO

import torch

from . import check, spec, traffic, weights
from .record import Record

FOREIGN = ("jax", "jaxlib", "flax", "whisper_apr_tpu")


class Context:
    """What a driver is told: the cell, the seed, the window's length,
    whether this run is traced, the device; it reports when the window
    opens (``mark_open``), which ends set-up."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 trace: bool, device: torch.device, t_start: float,
                 age_at_start: float = 0.0) -> None:
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device = trace, device
        self.t_start, self.age = t_start, age_at_start
        self.setup_s = float("nan")

    def mark_open(self, t_open: float) -> None:
        self.setup_s = t_open - self.t_start + self.age


def foreign_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process (top-level
    names compared whole)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FOREIGN})


def attempted_failed(rec: Record):
    if rec.kind == "serve":
        win = [r for r in rec.requests if r.in_window]
        return (len(win), sum(not r.ok for r in win),
                sum(r.done is None for r in win))
    return len(rec.files), sum(not f.ok for f in rec.files), 0


@dataclasses.dataclass
class Comparison:
    """What the check read after the window: the numbers compared, each
    with its limit, and whether every one held."""

    correct: bool
    attempted: int
    failed: int
    compared: Dict[str, dict]
    gaps: check.Gaps
    n_items: int
    check_s: float


def compare(cell: spec.Cell, run, rec: Record, seed: int,
            device: torch.device) -> Comparison:
    """The comparison that decides ``correct``, once the window has closed:
    the sampled finished requests' served tokens against the f32
    reference (the program freed first), and the float8 control read at
    the same positions. The control has to read above the limit: a sample
    on which it would pass cannot tell a fault from a sound run, so such a
    run is not counted correct."""
    items = run.check_items(rec, **cell.traffic["check"])
    attempted, failed, unfinished = attempted_failed(rec)
    run.free()
    t0 = time.perf_counter()
    audio = traffic.recording(seed, cell.traffic["recording_s"], device)
    gaps = check.gaps(weights.draw(cell.dims, seed, device), cell.dims,
                      [check.Item(audio[o: o + n], toks, P)
                       for o, n, toks, P in items],
                      allowed=cell.dims.sot)
    limit = cell.limits.get("logit_gap_max", {}).get("limit")
    lim = limit if limit is not None else 0.0
    compared = {
        "logit_gap_max": {"value": gaps.widest, "limit": lim},
        "control_gap_max": {"value": gaps.control_widest, "limit": lim,
                            "above": True},
        "failed": {"value": failed, "limit": 0},
        "unfinished": {"value": unfinished, "limit": 0},
    }
    held = all((v["value"] > v["limit"]) if v.get("above")
               else (v["value"] <= v["limit"]) for v in compared.values())
    return Comparison(limit is not None and attempted > 0 and bool(items)
                      and held, attempted, failed, compared, gaps,
                      len(items), time.perf_counter() - t0)


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float, age: float = 0.0,
            out: TextIO = sys.stdout, err: TextIO = sys.stderr,
            after_setup: Optional[Callable] = None) -> int:
    drv = spec.driver(cell.traffic["driver"])
    ctx = Context(cell, seed, seconds, trace, device, t_start, age)
    run = drv.run(ctx)
    if after_setup is not None:
        after_setup(run)
    rec = run.window()
    foreign = foreign_modules()
    if foreign:
        print(f"modules of JAX or the JAX package are loaded: {foreign}",
              file=err)
        return 3
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    c = compare(cell, run, rec, seed, device)
    print(f"checked {c.n_items} requests, {c.gaps.n_tokens} served tokens "
          f"against the reference and the control in {c.check_s:.3f} s; "
          f"widest gap per request {c.gaps.per_item}", file=err)

    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end,
                                rec)
    dev: Dict[str, object] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": int(cell.entry["chips"]),
        "memory_peak_bytes": int(peak)}
    result: Dict[str, object] = {"correct": c.correct,
                                 "attempted": c.attempted,
                                 "failed": c.failed, "metrics": metrics,
                                 "device": dev}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in rec.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in rec.trace.idle_gaps]}
        print(f"idle by host span (s): {rec.trace.idle_by_label}", file=err)
        print(f"device s by range: {rec.trace.range_device_s}", file=err)
    result["compared"] = c.compared
    for name, v in c.compared.items():
        rule = "must exceed" if v.get("above") else "limit"
        print(f"compared {name} {v['value']} {rule} {v['limit']}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
