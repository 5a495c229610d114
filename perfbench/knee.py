"""The knee of a serve cell: the highest Poisson rate at which the
scheduler completes, within the window, as many requests as arrived,
with no growing backlog.

    python3 -m perfbench.knee --workload <cell> --seed <n> --seconds <s> --rates 6,8,10

One process, on the card: the cell's weights and warm-up once, then for
each rate a fresh scheduler serving the cell's mix at that rate for the
window. Prints one JSON line a rate (arrived, completed in the window,
backlog at the opening and the close, p50 / p95 latency) and writes them
to ``--out`` too. The rate a mix file states is 0.8 times the knee found
so, once, on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import spec

DRAIN_S = 10.0   # past the close, the unfinished are counted, not awaited


def measure(run, rate: float) -> dict:
    """One window at ``rate`` over the set-up ``run`` (a serve driver's
    ``Run``)."""
    from whisper_apr_tpu_torch.parallel.serving import BatchScheduler
    from . import traffic
    mix = run.ctx.cell.traffic
    run.reqs = traffic.serve_requests(mix, run.ctx.seed,
                                      run.ctx.seconds + 60.0, rate)
    run.sched = BatchScheduler(run.eng, n_slots=int(mix["n_slots"]))
    run.completed = {}
    run.drain_limit_s = DRAIN_S
    rec = run.window()
    win = [r for r in rec.requests if r.in_window]
    close = rec.seconds
    arrived = len(win)
    done_in = sum(1 for r in rec.requests
                  if r.done is not None and 0.0 <= r.done < close)
    lat = np.array([r.latency for r in win]) * 1e3

    def backlog(t):
        return sum(1 for r in rec.requests
                   if r.submitted == r.submitted and r.submitted <= t
                   and (r.done is None or r.done > t))
    return {"rate_rps": rate, "arrived": arrived,
            "completed_in_window": done_in,
            "backlog_open": backlog(0.0), "backlog_close": backlog(close),
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "drain_s": rec.window_end - close,
            "failed": sum(not r.ok for r in win)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", required=True)
    p.add_argument("--preroll", type=float, default=0.0,
                   help="seconds of traffic before each window (default: "
                        "the mix's)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    from . import harness
    cell = spec.resolve(args.workload)
    if args.preroll:
        cell.traffic["preroll_s"] = args.preroll
    if not torch.cuda.is_available():
        print("the knee is measured on a card", file=sys.stderr)
        return 2
    ctx = harness.Context(cell, args.seed, args.seconds, False,
                          torch.device("cuda", 0), time.perf_counter())
    run = spec.driver(cell.traffic["driver"]).run(ctx)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        row = measure(run, rate)
        row["workload"] = args.workload
        row["card"] = torch.cuda.get_device_name(0)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
