"""CLI argument parsing — whisper.cpp-parity flag surface: port of
``whisper_apr_tpu/cli/args.py``, the same subcommands, flags and
defaults, plus ``--device`` wherever a model is loaded.

(reference: src/cli/args.rs:110-410 — 15 subcommands and whisper.cpp
-compatible flags; @response-file expansion at :50.)
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .. import __version__
from .output import FORMATS


def expand_response_files(argv: List[str]) -> List[str]:
    """Expand @file arguments into their whitespace-separated contents
    (reference: src/cli/args.rs:50 expand_response_files)."""
    out: List[str] = []
    for arg in argv:
        if arg.startswith("@") and len(arg) > 1:
            try:
                with open(arg[1:]) as f:
                    out.extend(f.read().split())
            except OSError:
                out.append(arg)
        else:
            out.append(arg)
    return out


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (hand-written kernels; fails "
                        "without a CUDA device) or cpu (plain versions)")


def _add_common_model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", "-m", required=True, help=".apr model path")
    p.add_argument("--fp32", action="store_true",
                   help="full-precision compute (default: bfloat16 fast path)")
    _add_device_flag(p)


def _add_decode_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--language", "-l", default=None,
                   help="language code or 'auto' (default: auto-detect)")
    p.add_argument("--beam-size", "-bs", type=int, default=1,
                   help="beam size (1 = greedy)")
    p.add_argument("--best-of", type=int, default=5, help="whisper.cpp parity")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max-tokens", type=int, default=None)
    p.add_argument("--no-timestamps", action="store_true", default=True)
    p.add_argument("--timestamps", dest="no_timestamps", action="store_false",
                   help="emit segment timestamps")
    p.add_argument("--entropy-thold", type=float, default=2.4,
                   help="whisper.cpp parity")
    p.add_argument("--logprob-thold", type=float, default=-1.0,
                   help="whisper.cpp parity")
    p.add_argument("--no-speech-thold", type=float, default=0.6,
                   help="whisper.cpp parity")
    p.add_argument("--threads", "-t", type=int, default=0,
                   help="host audio-loading threads (0 = auto)")
    p.add_argument("--patience", type=float, default=1.0,
                   help="beam-search patience factor (whisper.cpp parity)")
    p.add_argument("--no-fallback", action="store_true",
                   help="disable whisper.cpp temperature fallback "
                        "(single decode, no quality-gated retries)")
    p.add_argument("--flash-attn", action="store_true",
                   help="run the encoder's attention through the flash "
                        "kernel")
    p.add_argument("--n-best", type=int, default=0, metavar="N",
                   help="with --beam-size>1: print the N best hypotheses")
    p.add_argument("--speculative", action="store_true",
                   help="EXPERIMENTAL: self-draft multi-token decode "
                        "(single stream, token-exact vs greedy); speedup "
                        "depends on draft acceptance, which is unverified "
                        "on real weights — benchmark before relying on it")
    p.add_argument("--hotword", action="append", default=None,
                   metavar="PHRASE[:BOOST]",
                   help="boost a phrase during decoding (repeatable)")


def _add_output_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--output-format", "-of", choices=FORMATS, default="txt")
    p.add_argument("--output", "-o", default=None, help="output file path")
    p.add_argument("--verbose", "-v", action="store_true")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="whisper-apr-tpu",
        description="Whisper speech recognition (PyTorch / CUDA)")
    parser.add_argument("--version", action="version",
                        version=f"whisper-apr-tpu {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    # transcribe / translate
    for name, help_ in (("transcribe", "transcribe audio in its language"),
                        ("translate", "translate audio to English")):
        p = sub.add_parser(name, help=help_)
        p.add_argument("audio", help="input WAV file")
        _add_common_model_flags(p)
        _add_decode_flags(p)
        _add_output_flags(p)

    # batch
    p = sub.add_parser("batch", help="batch-transcribe many files")
    p.add_argument("inputs", nargs="+", help="input files or globs")
    _add_common_model_flags(p)
    _add_decode_flags(p)
    _add_output_flags(p)
    p.add_argument("--processors", type=int, default=0,
                   help="max files per batched pipeline call (0 = all at once)")

    # stream (file-driven)
    p = sub.add_parser("stream", help="streaming transcription from a file")
    p.add_argument("audio")
    _add_common_model_flags(p)
    _add_decode_flags(p)
    p.add_argument("--chunk-seconds", type=float, default=5.0)

    # detect-language
    p = sub.add_parser("detect-language", help="detect spoken language")
    p.add_argument("audio")
    _add_common_model_flags(p)

    # model info
    p = sub.add_parser("model", help="inspect an .apr model")
    p.add_argument("--model", "-m", required=True)

    # validate
    p = sub.add_parser("validate", help="25-point model QA checklist")
    p.add_argument("--model", "-m", required=True)

    # quantize
    p = sub.add_parser("quantize",
                       help="quantize f32 .apr to int8 / k-quants")
    p.add_argument("--model", "-m", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--format", "-f",
                   choices=("f16", "int8", "q4k", "q5k", "q6k"),
                   default="int8",
                   help="f16 half-precision, int8 per-tensor scales, or "
                        "exact k-quant super-blocks (q4k 4.5 / q5k 5.5 / "
                        "q6k 6.5625 bits/weight)")

    # convert
    p = sub.add_parser("convert", help="convert HF checkpoint dir to .apr")
    p.add_argument("input", help="HF model directory (safetensors + vocab)")
    p.add_argument("output", help="output .apr path")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--v2", action="store_true",
                   help="write the APR v2 container (JSON metadata)")

    # benchmark
    p = sub.add_parser("benchmark", help="pipeline benchmark")
    p.add_argument("--model", "-m", default=None)
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--tokens", type=int, default=224)
    p.add_argument("--emit", choices=("text", "json", "csv"), default="text")
    _add_device_flag(p)

    # parity
    p = sub.add_parser("parity", help="WER vs a reference transcript")
    p.add_argument("audio")
    p.add_argument("reference_text")
    _add_common_model_flags(p)
    _add_decode_flags(p)

    # diagnose
    p = sub.add_parser("diagnose", help="environment + model self-checks")
    p.add_argument("--model", "-m", default=None)
    _add_device_flag(p)

    # test (smoke test like reference `test` subcommand)
    p = sub.add_parser("test", help="quick pipeline smoke test")
    p.add_argument("--model", "-m", default=None)
    _add_device_flag(p)

    # serve: HTTP API over the continuous-batching scheduler
    # (the reference stubs this; implemented here)
    p = sub.add_parser("serve", help="HTTP transcription server")
    _add_common_model_flags(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--slots", type=int, default=8,
                   help="concurrent decode slots (continuous batching)")
    p.add_argument("--single-thread", action="store_true",
                   help="one serial server whose request handlers pump "
                        "the device loop inline: a single Python thread "
                        "touches the device")
    p.add_argument("--staged-admission", action="store_true",
                   help="admit requests one slot at a time (default: "
                        "bursts admit through one fused batched program)")

    # tui dashboard (reference: src/tui/)
    p = sub.add_parser("tui", help="terminal transcription dashboard")
    p.add_argument("audio")
    _add_common_model_flags(p)
    _add_decode_flags(p)

    # record: live transcription of raw audio from stdin
    # (the reference stubs this; implemented here)
    p = sub.add_parser("record", help="transcribe raw audio from stdin")
    _add_common_model_flags(p)
    p.add_argument("--language", "-l", default=None)
    p.add_argument("--rate", type=int, default=16_000,
                   help="stdin sample rate")
    p.add_argument("--sample-format", choices=("f32le", "s16le"),
                   default="f32le")
    p.add_argument("--chunk-seconds", type=float, default=1.0)
    p.add_argument("--seconds", type=float, default=None,
                   help="stop after this much audio")

    # command: voice-command matching (the reference stubs this)
    p = sub.add_parser("command", help="match an utterance against a command list")
    p.add_argument("audio")
    p.add_argument("commands", help="text file, one command per line")
    _add_common_model_flags(p)
    _add_decode_flags(p)
    p.add_argument("--threshold", type=float, default=0.5,
                   help="max WER to accept a match")

    return parser


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    argv = expand_response_files(list(sys.argv[1:] if argv is None else argv))
    return build_parser().parse_args(argv)
