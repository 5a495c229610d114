"""whisper.cpp-parity command-line interface: port of
``whisper_apr_tpu/cli/``, the same subcommands, flags, outputs and exit
codes, over the port's engine. Every command that loads a model takes
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions); without a CUDA device the default fails, it never falls back.

    python -m whisper_apr_tpu_torch.cli transcribe clip.wav -m model.apr

(reference: src/cli/ — args.rs, commands.rs, output.rs, parity.rs)
"""

from __future__ import annotations

import sys
from typing import List, Optional


def run(argv: Optional[List[str]] = None) -> int:
    """Dispatch a parsed command (reference: src/cli/commands.rs:126 run)."""
    from . import commands
    from .args import parse_args

    args = parse_args(argv)
    cmd = args.command

    try:
        if cmd == "transcribe":
            return commands.run_transcribe(args)
        if cmd == "translate":
            return commands.run_translate(args)
        if cmd == "batch":
            return commands.run_batch(args)
        if cmd == "stream":
            return commands.run_stream(args)
        if cmd == "detect-language":
            return commands.run_detect_language(args)
        if cmd == "model":
            return commands.run_model_info(args)
        if cmd == "validate":
            return commands.run_validate(args)
        if cmd == "quantize":
            return commands.run_quantize(args)
        if cmd == "convert":
            return commands.run_convert(args)
        if cmd == "benchmark":
            return commands.run_benchmark(args)
        if cmd == "parity":
            return commands.run_parity(args)
        if cmd == "serve":
            from .serve import run_serve
            return run_serve(args)
        if cmd == "tui":
            from .tui import run_tui
            return run_tui(args)
        if cmd == "record":
            from .record import run_record
            return run_record(args)
        if cmd == "command":
            from .record import run_command
            return run_command(args)
        if cmd == "diagnose":
            return commands.run_diagnose(args)
        if cmd == "test":
            return commands.run_diagnose(args)
        if cmd in commands.NOT_IMPLEMENTED:
            return commands.run_not_implemented(cmd)
        print(f"unknown command: {cmd}", file=sys.stderr)
        return 2
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"error: {e}", file=sys.stderr)
        return 1


def main() -> None:
    sys.exit(run())
