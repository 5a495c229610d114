"""`record` and `command` subcommands: port of
``whisper_apr_tpu/cli/record.py`` over the port's engine.

The reference stubs both ("not yet implemented",
reference: src/cli/commands.rs:770-790,970). Implemented here without mic
hardware: audio arrives on STDIN as raw samples (pipe from arecord/sox/
ffmpeg), flows through the streaming transcriber.

  arecord -f FLOAT_LE -r 16000 -c 1 | whisper-apr-tpu record -m model.apr
  ffmpeg -i in.mp3 -f f32le -ar 16000 -ac 1 - | whisper-apr-tpu record ...

`command` mode matches each utterance against a fixed command list by word
error rate (the whisper.cpp `command` example's semantics).
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from ..audio import SAMPLE_RATE
from ..audio.streaming import StreamingConfig
from ..inference.streaming import StreamingTranscriber
from .parity import calculate_wer


def _read_stdin_chunks(sample_format: str, chunk_seconds: float,
                       max_seconds: Optional[float]):
    """Yield float32 chunks from stdin until EOF (or max_seconds)."""
    bytes_per = 4 if sample_format == "f32le" else 2
    chunk_bytes = int(SAMPLE_RATE * chunk_seconds) * bytes_per
    total = 0.0
    stdin = sys.stdin.buffer
    while True:
        data = stdin.read(chunk_bytes)
        if not data:
            return
        if sample_format == "f32le":
            samples = np.frombuffer(data, dtype="<f4").astype(np.float32)
        else:  # s16le
            samples = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        yield samples
        total += len(samples) / SAMPLE_RATE
        if max_seconds is not None and total >= max_seconds:
            return


def run_record(args) -> int:
    """Live transcription of stdin audio (reference stub: commands.rs:770)."""
    from .commands import _load_engine, _options_from_args

    if sys.stdin.isatty():
        print("record: pipe raw audio into stdin, e.g.\n"
              "  arecord -f FLOAT_LE -r 16000 -c 1 | ... record -m model.apr",
              file=sys.stderr)
        return 2

    engine = _load_engine(args)
    st = StreamingTranscriber(
        engine,
        StreamingConfig.with_sample_rate(args.rate),
        language=args.language)
    for chunk in _read_stdin_chunks(args.sample_format, args.chunk_seconds,
                                    args.seconds):
        for res in st.push(chunk):
            print(f"[{res.kind}] {res.text}", flush=True)
    final = st.finalize()
    if final:
        print(final, flush=True)
    return 0


def run_command(args) -> int:
    """Voice-command matching (whisper.cpp `command` example semantics):
    transcribe each utterance, report the best-matching command from a list
    (reference stub: commands.rs:970)."""
    from .commands import _load_audio, _load_engine, _options_from_args

    commands: List[str] = [c.strip() for c in
                           open(args.commands).read().splitlines()
                           if c.strip()]
    if not commands:
        print("command: empty command list", file=sys.stderr)
        return 1

    engine = _load_engine(args)
    audio = _load_audio(args.audio)
    result = engine.transcribe_long(audio, _options_from_args(args, "transcribe"))

    scored = sorted(
        ((calculate_wer(cmd, result.text), cmd) for cmd in commands))
    best_wer, best_cmd = scored[0]
    matched = best_wer <= args.threshold
    print(f"heard:   {result.text}")
    print(f"command: {best_cmd if matched else '(no match)'} "
          f"(wer {best_wer:.2f})")
    return 0 if matched else 3
