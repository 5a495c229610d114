"""Closed-loop transcription of whole files through the port's
``WhisperApr.transcribe_long``: one file at a time, every 30 s window of a
file in one ``transcribe_batch``. The window closes with the file in
flight when ``--seconds`` ends, so no file is cut.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from perfbench import port, traffic, weights
from perfbench.record import File, Record
from perfbench.trace import Tracer

N_FILES = 64             # files drawn; the window cycles through them
WINDOW = 480_000         # samples of a 30 s window at 16 kHz

GAP_LABELS = {"bench.encode": "encoder", "bench.loop": "greedy.loop",
              "bench.greedy": "greedy.prefill", "bench.batch": "batch.host",
              "bench.file": "file.host", "bench.host": "generator"}


def n_windows(n_samples: int, overlap: int) -> int:
    """Windows of ``WINDOW`` samples every ``WINDOW - overlap``."""
    if n_samples <= WINDOW:
        return 1
    step = WINDOW - overlap
    return -(-(n_samples - WINDOW) // step) + 1


class Run:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.eng = self.w = None
        self.results = {}        # file index -> per-window token lists

    def setup(self) -> None:
        ctx, mix, dims = self.ctx, self.ctx.cell.traffic, self.ctx.cell.dims
        self.w = weights.draw(dims, ctx.seed, ctx.device)
        self.eng = port.engine(self.w, dims, ctx.cell.config["served"],
                               ctx.device)
        self.prompt = port.prompt(self.eng, mix["language"])
        self.rec = traffic.recording(ctx.seed, mix["recording_s"],
                                     ctx.device)
        self.files = traffic.files(mix, ctx.seed, N_FILES)
        self.overlap = int(mix["overlap_s"] * traffic.SAMPLE_RATE)
        self._captured = None
        orig = self.eng.transcribe_batch

        def capture(audios, options=None):
            out = orig(audios, options)
            self._captured = [list(r.tokens) for r in out.results]
            return out
        self.eng.transcribe_batch = capture
        self._warm()
        self.tracer = Tracer() if ctx.trace else None
        if self.tracer is not None:
            self.tracer.warm()

    def _options(self, max_tokens: int):
        from whisper_apr_tpu_torch.engine import TranscribeOptions
        return TranscribeOptions(language=self.ctx.cell.traffic["language"],
                                 max_tokens=max_tokens)

    def _warm(self) -> None:
        """The largest and the smallest batch of windows the files hold,
        each through a short greedy decode; the kernels build on the
        first."""
        sizes = sorted({n_windows(f.n_samples, self.overlap)
                        for f in self.files})
        for b in (sizes[-1], sizes[0]):
            f = max(self.files, key=lambda f: (
                n_windows(f.n_samples, self.overlap) == b, f.n_samples))
            self.eng.transcribe_long(traffic.clip(self.rec, f),
                                     self._options(len(self.prompt) + 3),
                                     overlap_seconds=self.ctx.cell.traffic[
                                         "overlap_s"])

    def window(self) -> Record:
        ctx, mix = self.ctx, self.ctx.cell.traffic
        tracing = self.tracer is not None
        spans = port.Spans()
        if tracing:
            import whisper_apr_tpu_torch.model.decoder as decoder
            import whisper_apr_tpu_torch.pipeline as pipeline
            spans.wrap_method(self.eng, "transcribe_batch", "bench.batch")
            spans.wrap_attr(pipeline, "encode", "bench.encode")
            spans.wrap_attr(pipeline, "greedy_generate_body", "bench.greedy")
            spans.wrap_attr(decoder, "decode_loop", "bench.loop")
        span = port.span if tracing else (lambda _: contextlib.nullcontext())
        trace = mix.get("trace", {})
        tr0 = float(trace.get("start_s", 0.0))
        n_traced = int(trace.get("files", 0))
        files, traced_from = [], None
        P = len(self.prompt)
        t_open = time.perf_counter()
        ctx.mark_open(t_open)
        k = 0
        while True:
            f = self.files[k % len(self.files)]
            audio = traffic.clip(self.rec, f)
            if tracing and traced_from is None and \
                    time.perf_counter() - t_open >= tr0:
                traced_from = len(files)
                self.tracer.start()
            t0 = time.perf_counter()
            with span("bench.file"):
                self.eng.transcribe_long(audio, self._options(f.tokens),
                                         overlap_seconds=mix["overlap_s"])
            t1 = time.perf_counter()
            got = self._captured
            self.results[k] = got
            ok = len(got) == n_windows(f.n_samples, self.overlap) and all(
                len(t) == f.tokens for t in got)
            files.append(File(t0 - t_open, t1 - t_open, f.audio_s, len(got),
                              f.tokens, ok))
            k += 1
            if tracing and traced_from is not None and \
                    len(files) == traced_from + n_traced:
                self.tracer.stop()
            if t1 - t_open >= ctx.seconds:
                break
        if tracing and traced_from is not None and \
                len(files) < traced_from + n_traced:
            self.tracer.stop()
        spans.close()
        rec = Record(
            kind="longform", dims=ctx.cell.dims, seconds=ctx.seconds,
            setup_s=ctx.setup_s, prompt_len=P,
            kv=dict(self_bytes=2, self_scales=False, cross_bytes=1,
                    cross_scales=True),
            head="qmatvec_greedy_head", files=files,
            window_end=files[-1].t1,
            traced_files=(range(traced_from, min(len(files),
                                                 traced_from + n_traced))
                          if traced_from is not None else range(0)))
        if tracing and traced_from is not None:
            rec.trace = self.tracer.summary(GAP_LABELS)
        return rec

    def check_items(self, rec: Record, files: int, windows_per_file: int):
        """Windows of files drawn from the seed (the file with the most
        tokens among them), ``per_file`` windows each, the last always."""
        from perfbench import check
        done = [k for k, f in enumerate(rec.files) if f.ok]
        pick = check.sample(self.ctx.seed, len(done),
                            [rec.files[k].max_tokens for k in done], files)
        rng = np.random.default_rng([int(self.ctx.seed) & (2 ** 64 - 1), 7])
        out = []
        step = WINDOW - self.overlap
        for p in pick:
            k = done[p]
            f = self.files[k % len(self.files)]
            n = rec.files[k].windows
            idx = sorted({n - 1, *rng.permutation(n - 1)[: windows_per_file - 1]})
            for i in idx:
                out.append((f.offset + i * step,
                            min(WINDOW, f.n_samples - i * step),
                            self.results[k][i], rec.prompt_len))
        return out

    def free(self) -> None:
        self.eng = self.w = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def run(ctx) -> Run:
    r = Run(ctx)
    r.setup()
    return r
