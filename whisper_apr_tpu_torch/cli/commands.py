"""CLI subcommand implementations: port of
``whisper_apr_tpu/cli/commands.py`` over the port's engine, on the
device ``--device`` names (``_load_engine``). ``model`` prints the H100
floors of ``utils/roofline``; ``diagnose`` reports the torch device and
whether the hand-written kernels build and load.

(reference: src/cli/commands.rs — run dispatch :126, run_transcribe :147,
run_batch :337, validate/quantize/model/benchmark/diagnose handlers; the
reference stubs stream/serve/record/command as "not yet implemented",
commands.rs:770-790,970.)
"""

from __future__ import annotations

import glob as globmod
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from .. import __version__
from ..audio import SAMPLE_RATE, parse_wav
from ..audio.resample import SincResampler
from ..config import ModelConfig
from ..engine import TranscribeOptions, WhisperApr
from ..errors import WhisperError
from ..format import (
    QUANT_INT8,
    AprReader,
    AprValidator,
    AprWriter,
    MelFilterbankData,
)
from .output import FORMATS, format_result
from .parity import ParityResult, calculate_wer


def _load_audio(path: str) -> np.ndarray:
    """WAV -> 16 kHz mono f32 (reference: commands.rs:1428 load_audio_samples)."""
    samples, sr = parse_wav(open(path, "rb").read())
    if sr != SAMPLE_RATE:
        samples = SincResampler(sr, SAMPLE_RATE).resample(samples)
    return samples


def _progress_printer():
    """Phase-progress printer for --verbose model loading (reference:
    commands.rs load path + src/progress.rs phase reporting)."""
    last = {"phase": None, "quarter": -1}

    def cb(p) -> None:
        quarter = int(p.phase_progress * 4)
        if p.phase != last["phase"] or quarter != last["quarter"]:
            last["phase"], last["quarter"] = p.phase, quarter
            print(f"[load] {p.phase:<9s} {p.overall * 100:5.1f}%"
                  + (f"  {p.message}" if p.phase_progress >= 1.0 else ""),
                  file=sys.stderr)
    return cb


def _load_engine(args) -> WhisperApr:
    """The engine of ``args.model`` on ``args.device`` (``--flash-attn``
    routes every encode's self-attention through K16)."""
    from ..config import ComputeConfig
    compute = ComputeConfig(
        compute_dtype="float32" if getattr(args, "fp32", False) else "bfloat16",
        param_dtype="float32" if getattr(args, "fp32", False) else "bfloat16",
        use_flash_attention=True if getattr(args, "flash_attn", False)
        else None)
    progress = (_progress_printer()
                if getattr(args, "verbose", False) else None)
    return WhisperApr.load_from_apr(args.model, compute=compute,
                                    progress=progress, device=args.device)


def _options_from_args(args, task: str) -> TranscribeOptions:
    strategy = "beam" if getattr(args, "beam_size", 1) > 1 else "greedy"
    return TranscribeOptions(
        language=getattr(args, "language", None),
        task=task,
        strategy=strategy,
        beam_size=getattr(args, "beam_size", 5) or 5,
        best_of=getattr(args, "best_of", 1) or 1,
        patience=getattr(args, "patience", 1.0) or 1.0,
        temperature=getattr(args, "temperature", 0.0) or 0.0,
        max_tokens=getattr(args, "max_tokens", None),
        timestamps=not getattr(args, "no_timestamps", True),
        logprob_thold=getattr(args, "logprob_thold", -1.0),
        entropy_thold=getattr(args, "entropy_thold", 2.4),
        no_speech_thold=getattr(args, "no_speech_thold", 0.6),
        hotwords=getattr(args, "hotword", None),
        speculative=getattr(args, "speculative", False),
    )


def run_transcribe(args, task: str = "transcribe") -> int:
    """(reference: commands.rs:147 run_transcribe)"""
    eng = _load_engine(args)
    t_load = time.time()
    audio = _load_audio(args.audio)
    opts = _options_from_args(args, task)
    n_best = getattr(args, "n_best", 0)
    if n_best and opts.strategy == "beam":
        # N-best hypotheses (reference: beam.rs:300 decode_nbest)
        for rank, r in enumerate(eng.transcribe_nbest(audio, opts, n_best), 1):
            print(f"[{rank}] (avg_logprob {r.avg_logprob:+.3f}) {r.text}")
        return 0
    # whisper.cpp default: temperature fallback with quality gates on
    use_fallback = (not getattr(args, "no_fallback", False)
                    and opts.strategy == "greedy"
                    and opts.temperature == 0.0
                    and not opts.hotwords)
    result = eng.transcribe_long(audio, opts, fallback=use_fallback)
    elapsed = time.time() - t_load
    out = format_result(result, args.output_format)
    if getattr(args, "output", None):
        with open(args.output, "w") as f:
            f.write(out)
    else:
        sys.stdout.write(out)
    if getattr(args, "verbose", False):
        rtf = elapsed / max(len(audio) / SAMPLE_RATE, 1e-9)
        print(f"[whisper-apr-tpu] language={result.language} "
              f"tokens={len(result.tokens)} rtf={rtf:.4f}", file=sys.stderr)
    return 0


def run_translate(args) -> int:
    return run_transcribe(args, task="translate")


def run_batch(args) -> int:
    """Batch transcription of many files through ONE batched pipeline
    (reference: commands.rs:337 run_batch — which loops sequentially)."""
    files: List[str] = []
    for pattern in args.inputs:
        hits = sorted(globmod.glob(pattern))
        files.extend(hits if hits else [pattern])
    if not files:
        print("no input files", file=sys.stderr)
        return 1
    eng = _load_engine(args)
    # --threads: parallel host-side WAV load/resample (the reference's
    # rayon file pool); --processors: files per pipeline call
    n_threads = getattr(args, "threads", 0) or min(8, len(files))
    if n_threads > 1 and len(files) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            audios = list(pool.map(_load_audio, files))
    else:
        audios = [_load_audio(f) for f in files]
    opts = _options_from_args(args, "transcribe")
    group = getattr(args, "processors", 0) or len(files)
    results = []
    total = 0.0
    for i in range(0, len(audios), max(group, 1)):
        part = eng.transcribe_batch(audios[i: i + group], opts)
        results.extend(part.results)
        total += part.total_duration_secs
    from ..engine import BatchTranscriptionResult
    batch = BatchTranscriptionResult(results, total)
    for path, result in zip(files, batch.results):
        base = os.path.splitext(path)[0]
        ext = "txt" if args.output_format == "txt" else args.output_format.split("-")[0]
        out_path = f"{base}.{ext}"
        with open(out_path, "w") as f:
            f.write(format_result(result, args.output_format))
        print(f"{path} -> {out_path}")
    print(f"batch: {len(files)} files in {batch.total_duration_secs:.2f}s")
    return 0


def run_detect_language(args) -> int:
    eng = _load_engine(args)
    audio = _load_audio(args.audio)
    probs = eng.detect_language(audio)
    for lang, p in probs.top(5):
        print(f"{lang}: {p:.4f}")
    return 0


def run_model_info(args) -> int:
    """(reference: commands.rs model subcommand)"""
    from ..format.v2 import AprReaderV2, is_v2
    head = open(args.model, "rb").read(4)
    reader = (AprReaderV2.from_file(args.model) if is_v2(head)
              else AprReader.from_file(args.model))
    h = reader.header
    cfg = h.to_model_config()
    print(f"model: {cfg.model_type}")
    print(f"quantization: {h.quantization_name}")
    print(f"tensors: {h.n_tensors}")
    print(f"vocab: {h.n_vocab}  mels: {h.n_mels}")
    print(f"audio: ctx={h.n_audio_ctx} d={h.n_audio_state} "
          f"heads={h.n_audio_head} layers={h.n_audio_layer}")
    print(f"text:  ctx={h.n_text_ctx} d={h.n_text_state} "
          f"heads={h.n_text_head} layers={h.n_text_layer}")
    print(f"embedded vocab: {h.has_vocab}  filterbank: {h.has_filterbank}")
    print(f"parameters: ~{cfg.parameter_count() / 1e6:.1f}M")
    print(f"file size: {reader.file_size() if hasattr(reader, 'file_size') else len(reader.data)} bytes")
    print(f"crc32: {'ok' if reader.verify_crc() else 'MISMATCH'}")
    # H100 roofline (utils/roofline): speed-of-light bounds for this model
    from ..utils.roofline import (H100, decode_step_floor_ms, rtf_floor,
                                  streams_per_chip_floor)
    quant = {"int8": "int8", "q4k": "q4k", "q5k": "q5k",
             "q6k": "q6k"}.get(h.quantization_name, "bf16")
    print(f"{H100.name} floors ({quant}): decode "
          f"{decode_step_floor_ms(cfg, quant=quant, chip=H100):.3f} ms/step, "
          f"rtf {rtf_floor(cfg, quant=quant, chip=H100):.5f}, "
          f"<= {streams_per_chip_floor(cfg, quant=quant, chip=H100):.0f} "
          f"realtime streams/card")
    return 0


def run_validate(args) -> int:
    """25-point model QA (reference: commands.rs validate + validation.rs)."""
    reader = AprReader.from_file(args.model)
    report = AprValidator(reader).validate_all()
    print(report.summary())
    return 0 if report.passed else 1


def run_quantize(args) -> int:
    """f32 .apr -> int8 or k-quant .apr (reference: commands.rs quantize;
    k-quant formats quantized.rs:88-380)."""
    from ..format.container import QUANT_F16, QUANT_Q4K, QUANT_Q5K, QUANT_Q6K
    reader = AprReader.from_file(args.model)
    if reader.header.quantization != 0:
        print("input model is already quantized", file=sys.stderr)
        return 1
    cfg = reader.header.to_model_config()
    quant = {"f16": QUANT_F16, "q4k": QUANT_Q4K, "q5k": QUANT_Q5K,
             "q6k": QUANT_Q6K}.get(getattr(args, "format", "int8"),
                                   QUANT_INT8)
    writer = AprWriter.from_config(cfg, quantization=quant)
    for desc in reader.tensors:
        writer.add_tensor(desc.name, reader.load_tensor(desc.name))
    vb = reader.read_vocabulary_bytes()
    if vb is not None:
        writer.set_vocabulary(vb)
    fb = reader.read_mel_filterbank()
    if fb is not None:
        writer.set_mel_filterbank(fb)
    writer.write_file(args.output)
    in_size = len(reader.data)
    out_size = os.path.getsize(args.output)
    print(f"quantized: {in_size} -> {out_size} bytes "
          f"({100 * (1 - out_size / in_size):.1f}% smaller)")
    return 0


def run_benchmark(args) -> int:
    """Pipeline benchmark with component breakdown
    (reference: commands.rs benchmark + src/benchmark.rs)."""
    from ..utils.benchmark import run_pipeline_benchmark
    result = run_pipeline_benchmark(
        model_path=getattr(args, "model", None),
        audio_seconds=args.duration,
        decode_tokens=args.tokens,
        emit=args.emit,
        device=args.device)
    print(result)
    return 0


def run_parity(args) -> int:
    """WER vs a reference transcript (reference: src/cli/parity.rs)."""
    eng = _load_engine(args)
    audio = _load_audio(args.audio)
    ref_text = open(args.reference_text).read().strip()
    t0 = time.time()
    result = eng.transcribe(audio, _options_from_args(args, "transcribe"))
    dt = time.time() - t0
    pr = ParityResult(
        wer=calculate_wer(ref_text, result.text),
        rtf=dt / (len(audio) / SAMPLE_RATE),
        audio_seconds=len(audio) / SAMPLE_RATE,
        processing_seconds=dt,
        text=result.text)
    print(pr.summary())
    print(f"ref: {ref_text}")
    print(f"hyp: {result.text}")
    return 0


def run_diagnose(args) -> int:
    """Self-checks (reference: commands.rs:999 run_diagnose): the torch
    device, and on a CUDA device whether the kernels build and load."""
    import torch
    checks = []
    device_name = args.device

    def check(name, fn):
        try:
            detail = fn()
            checks.append((name, True, detail))
        except Exception as e:  # noqa: BLE001
            checks.append((name, False, str(e)))

    def device_check():
        from ..ops.dispatch import resolve_device
        dev = resolve_device(device_name, "diagnose")
        if dev.type != "cuda":
            return str(dev)
        major, minor = torch.cuda.get_device_capability(dev)
        return (f"{torch.cuda.get_device_name(dev)} (sm_{major}{minor}, "
                f"{torch.cuda.device_count()} device(s))")
    check("torch device", device_check)

    def kernels_check():
        if torch.device(device_name).type != "cuda":
            return f"skipped (device {device_name})"
        from ..ops import _build
        _build.library()
        return f"{_build.library_path().name} loaded"
    check("kernels", kernels_check)
    check("version", lambda: __version__)

    def mel_check():
        from ..audio.mel import MelFilterbank
        fb = MelFilterbank.create(80)
        mel = fb.compute(np.zeros(16_000, np.float32))
        assert mel.shape == (98, 80)
        return "mel pipeline ok"
    check("mel pipeline", mel_check)

    def model_check():
        if not getattr(args, "model", None):
            return "skipped (no --model)"
        reader = AprReader.from_file(args.model)
        assert reader.verify_crc(), "CRC mismatch"
        return f"{reader.header.n_tensors} tensors, CRC ok"
    check("model file", model_check)

    ok = all(passed for _, passed, _ in checks)
    for name, passed, detail in checks:
        print(f"[{'OK' if passed else 'FAIL'}] {name}: {detail}")
    return 0 if ok else 1


def run_convert(args) -> int:
    """HF checkpoint dir -> .apr (reference: tools/convert.rs)."""
    from ..tools.convert import convert_hf_to_apr
    out = convert_hf_to_apr(
        args.input, args.output,
        quantization=QUANT_INT8 if args.int8 else 0,
        container_version=2 if getattr(args, "v2", False) else 1)
    print(f"wrote {out}")
    return 0


def run_stream(args) -> int:
    """Simulated real-time streaming from a file (reference stubs this,
    commands.rs:770; we implement file-driven streaming)."""
    from ..inference.streaming import StreamingTranscriber
    eng = _load_engine(args)
    audio = _load_audio(args.audio)
    st = StreamingTranscriber(eng)
    chunk = int(SAMPLE_RATE * args.chunk_seconds)
    for i in range(0, len(audio), chunk):
        events = st.push(audio[i: i + chunk])
        for ev in events:
            print(f"[{ev.kind}] {ev.text}")
    final = st.finalize()
    if final:
        print(f"[final] {final}")
    return 0


NOT_IMPLEMENTED = ()  # every reference subcommand is implemented


def run_not_implemented(name: str) -> int:
    # parity with the reference's own stubs (commands.rs:770-790,970)
    print(f"'{name}' is not yet implemented", file=sys.stderr)
    return 2
