# Copied from whisper_apr_tpu/cli/output.py (host-side Python, no JAX); keep the two in step.
"""Transcription output formatters.

(reference: src/cli/output.rs:59-342 — txt, srt, vtt, json, json-full, csv,
md, lrc, wts formatters with whisper.cpp-compatible layouts.)
"""

from __future__ import annotations

import json
from typing import List

from ..engine import TranscriptionResult
from ..timestamps import Segment

FORMATS = ("txt", "srt", "vtt", "json", "json-full", "csv", "md", "lrc", "wts")


def _fmt_ts_srt(seconds: float) -> str:
    """SRT timestamp HH:MM:SS,mmm."""
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"


def _fmt_ts_vtt(seconds: float) -> str:
    """VTT timestamp HH:MM:SS.mmm."""
    return _fmt_ts_srt(seconds).replace(",", ".")


def _fmt_ts_lrc(seconds: float) -> str:
    """LRC timestamp [MM:SS.cc]."""
    cs = int(round(seconds * 100))
    m, rem = divmod(cs, 6000)
    s, cs = divmod(rem, 100)
    return f"[{m:02d}:{s:02d}.{cs:02d}]"


def _segments_or_whole(result: TranscriptionResult) -> List[Segment]:
    if result.segments:
        return result.segments
    return [Segment(0.0, 0.0, result.text, result.tokens)]


def format_txt(result: TranscriptionResult) -> str:
    return result.text + "\n"


def format_srt(result: TranscriptionResult) -> str:
    out = []
    for i, seg in enumerate(_segments_or_whole(result), start=1):
        out.append(f"{i}\n{_fmt_ts_srt(seg.start)} --> {_fmt_ts_srt(seg.end)}\n"
                   f"{seg.text.strip()}\n")
    return "\n".join(out)


def format_vtt(result: TranscriptionResult) -> str:
    out = ["WEBVTT", ""]
    for seg in _segments_or_whole(result):
        out.append(f"{_fmt_ts_vtt(seg.start)} --> {_fmt_ts_vtt(seg.end)}")
        out.append(seg.text.strip())
        out.append("")
    return "\n".join(out) + "\n"


def format_json(result: TranscriptionResult) -> str:
    return json.dumps({
        "text": result.text,
        "language": result.language,
    }, ensure_ascii=False) + "\n"


def format_json_full(result: TranscriptionResult) -> str:
    return json.dumps({
        "text": result.text,
        "language": result.language,
        "segments": [{
            "start": round(s.start, 3), "end": round(s.end, 3),
            "text": s.text, "tokens": [int(t) for t in s.tokens],
        } for s in result.segments],
        "tokens": [int(t) for t in result.tokens],
    }, ensure_ascii=False, indent=2) + "\n"


def format_csv(result: TranscriptionResult) -> str:
    lines = ["start,end,text"]
    for seg in _segments_or_whole(result):
        text = seg.text.strip().replace('"', '""')
        lines.append(f'{seg.start:.3f},{seg.end:.3f},"{text}"')
    return "\n".join(lines) + "\n"


def format_md(result: TranscriptionResult) -> str:
    lines = ["| Start | End | Text |", "|---|---|---|"]
    for seg in _segments_or_whole(result):
        lines.append(f"| {seg.start:.2f} | {seg.end:.2f} | {seg.text.strip()} |")
    return "\n".join(lines) + "\n"


def format_wts(result: TranscriptionResult) -> str:
    """Karaoke script with timestamps (whisper.cpp -owts; reference:
    src/cli/output.rs:322 format_wts). Word-level times when available,
    segment-level otherwise."""
    out = []
    if result.words:
        for w in result.words:
            out.append(f"{_fmt_ts_vtt(w.start)} --> {_fmt_ts_vtt(w.end)}"
                       f" | {w.word.strip()}")
    else:
        for seg in result.segments:
            out.append(f"{_fmt_ts_vtt(seg.start)} --> {_fmt_ts_vtt(seg.end)}"
                       f" | {seg.text.strip()}")
    return "\n".join(out) + ("\n" if out else "")


def format_lrc(result: TranscriptionResult) -> str:
    out = []
    for seg in _segments_or_whole(result):
        out.append(f"{_fmt_ts_lrc(seg.start)}{seg.text.strip()}")
    return "\n".join(out) + "\n"


_FORMATTERS = {
    "txt": format_txt,
    "srt": format_srt,
    "vtt": format_vtt,
    "wts": format_wts,
    "json": format_json,
    "json-full": format_json_full,
    "csv": format_csv,
    "md": format_md,
    "lrc": format_lrc,
}


def format_result(result: TranscriptionResult, fmt: str = "txt") -> str:
    if fmt not in _FORMATTERS:
        raise ValueError(f"unknown output format: {fmt} (choose from {FORMATS})")
    return _FORMATTERS[fmt](result)
