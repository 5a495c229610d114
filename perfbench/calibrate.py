"""The two readings a cell's limit is set from, over many seeds in one
process: the program's widest logit gap (sound runs at the cell's own
size and load, with a short window) and the control's, where the f32
reference computed with float8 (e4m3) activations takes the program's
place at the same positions.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 \
        --seconds 8 --out readings.jsonl

One JSON line a seed. The limit in ``limits/<cell>.json`` lies between
the largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness, spec


def readings(cell: spec.Cell, seed: int, seconds: float, device) -> dict:
    """One short run of the cell at ``seed`` and ``harness.compare``'s
    readings of it: the program's widest gap and the control's."""
    ctx = harness.Context(cell, seed, seconds, False, device,
                          time.perf_counter())
    run = spec.driver(cell.traffic["driver"]).run(ctx)
    rec = run.window()
    c = harness.compare(cell, run, rec, seed, device)
    return {"workload": cell.name, "seed": seed, "program": c.gaps.widest,
            "control": c.gaps.control_widest, "per_item": c.gaps.per_item,
            "tokens": c.gaps.n_tokens, "attempted": c.attempted,
            "failed": c.failed,
            "unfinished": c.compared["unfinished"]["value"],
            "correct": c.correct, "check_s": c.check_s}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on a card", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(cell, seed, args.seconds, torch.device("cuda", 0))
        row["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
