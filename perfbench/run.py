"""One run of a benchmark cell.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It exits non-zero, printing no result, when
the machine lacks the cards the cell asks for, or when JAX or the JAX
package is loaded once the window has closed. Otherwise its last line on
standard output is the result (``harness.execute``), and the numbers the
correctness check compared, each with its limit, are the last lines on
standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .spec import REPO  # noqa: E402

# the program's caches stay inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(REPO / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(REPO / "build" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")


def process_age() -> float:
    """Seconds since this process started, as the kernel counts it (0 if
    it cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE = process_age()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from . import harness, spec
    cell = spec.resolve(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START, AGE)


if __name__ == "__main__":
    sys.exit(main())
