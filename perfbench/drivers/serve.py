"""Open-loop serving through the port's continuous-batching scheduler
(``parallel/serving.BatchScheduler``, dense slots).

One thread: before each ``step()`` every request whose due time has
passed is submitted. A preroll of the same traffic fills the slots before
the window opens; every request due in the window is then served to its
end while later arrivals keep coming, and its latency runs from its due
time to the end of the step that completed it.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import sys
import time
from typing import Optional

import numpy as np
import torch

from perfbench import port, traffic, weights
from perfbench.record import Record, Req, Step
from perfbench.trace import Tracer

DRAIN_LIMIT_S = 60.0     # a request still unfinished this long after the
#                          window closed is reported unfinished
IDLE_SLEEP_S = 0.0005

GAP_LABELS = {"bench.encode": "admit.encoder",
              "bench.admit_step": "admit.prefill",
              "bench.admit": "admit.host", "bench.decode": "tick.decode",
              "bench.tick": "tick.host", "bench.step": "step.bookkeeping",
              "bench.host": "generator"}


class Run:
    """One serve run: set-up, the window, and what the check needs."""

    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.eng = None
        self.sched = None
        self.w = None
        self.completed = {}              # request index -> served tokens
        self.drain_limit_s = DRAIN_LIMIT_S

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        from whisper_apr_tpu_torch.parallel.serving import BatchScheduler
        ctx, mix, dims = self.ctx, self.ctx.cell.traffic, self.ctx.cell.dims
        self.w = weights.draw(dims, ctx.seed, ctx.device)
        self.eng = port.engine(self.w, dims, ctx.cell.config["served"],
                               ctx.device)
        self.prompt = port.prompt(self.eng, mix["language"])
        self.rec = traffic.recording(ctx.seed, mix["recording_s"],
                                     ctx.device)
        self.reqs = traffic.serve_requests(mix, ctx.seed,
                                           ctx.seconds + DRAIN_LIMIT_S)
        self.sched = BatchScheduler(self.eng, n_slots=int(mix["n_slots"]))
        self._warm(mix)
        self.tracer = Tracer() if ctx.trace else None
        if self.tracer is not None:
            self.tracer.warm()

    def _warm(self, mix: dict) -> None:
        """Every admission bucket the mix can hit (a burst of that many
        requests admitted in one step), then ticks at the full slot
        array; the kernels build on the first."""
        for b in mix["warm_buckets"]:
            for r in self.reqs[:b]:
                self.sched.submit(traffic.clip(self.rec, r), mix["language"],
                                  max_tokens=2)
            self.sched.run_until_drained()

    # -- the window ----------------------------------------------------------
    def window(self) -> Record:
        ctx, mix, sched = self.ctx, self.ctx.cell.traffic, self.sched
        lang = mix["language"]
        tracing = self.tracer is not None
        spans = port.Spans()
        if tracing:
            import whisper_apr_tpu_torch.parallel.serving as serving
            import whisper_apr_tpu_torch.pipeline as pipeline
            spans.wrap_method(sched, "_fill_slots", "bench.admit")
            spans.wrap_method(sched, "_dense_tick", "bench.tick")
            spans.wrap_attr(pipeline, "fused_admit_step", "bench.admit_step")
            spans.wrap_attr(pipeline, "encode", "bench.encode")
            spans.wrap_attr(serving, "decode_steps_multi", "bench.decode")
        span = port.span if tracing else (lambda _: contextlib.nullcontext())
        pre = float(mix["preroll_s"])
        seconds = ctx.seconds
        trace = mix.get("trace", {})
        tr0 = float(trace.get("start_s", 0.0))
        tr1 = tr0 + float(trace.get("seconds", 0.0))
        reqs = self.reqs
        recs = [Req(r.due, float("nan"), r.tokens, r.audio_s,
                    0.0 <= r.due < seconds) for r in reqs]
        n_window = sum(r.in_window for r in recs)
        pending = {}                       # request id -> index
        unadmitted = []                    # indices in submission order
        steps = []
        base = sched.stats()
        t_open = time.perf_counter() + pre
        ctx.mark_open(t_open)
        i, done_in_window, first_measured = 0, 0, None
        counters0: Optional[dict] = None
        traced_from = traced_to = None
        while True:
            with span("bench.host"):
                now = time.perf_counter()
                while i < len(reqs) and t_open + reqs[i].due <= now:
                    rid = sched.submit(traffic.clip(self.rec, reqs[i]), lang,
                                       max_tokens=reqs[i].tokens)
                    recs[i].submitted = time.perf_counter() - t_open
                    pending[rid] = i
                    unadmitted.append(i)
                    i += 1
                if done_in_window == n_window and now >= t_open + seconds:
                    break
                if now > t_open + seconds + self.drain_limit_s:
                    break
                if sched.pending() == 0:
                    if i < len(reqs):
                        time.sleep(min(IDLE_SLEEP_S, max(
                            0.0, t_open + reqs[i].due - now)))
                    continue
            rel = now - t_open
            if first_measured is None and rel >= 0:
                first_measured = len(steps)
                counters0 = sched.stats()
            if tracing and traced_from is None and rel >= tr0:
                traced_from = len(steps)
                self.tracer.start()
            adm0 = sched.stats()["admitted"]
            s0 = time.perf_counter()
            with span("bench.step"):
                sched.step()
            s1 = time.perf_counter()
            admitted = sched.stats()["admitted"] - adm0
            k = len(steps)
            steps.append(Step(s0 - t_open, s1 - t_open, admitted))
            for j in unadmitted[:admitted]:
                recs[j].admit_step = k
            del unadmitted[:admitted]
            for rid in [r for r in pending if sched.result(r) is not None]:
                c = sched.result(rid)
                j = pending.pop(rid)
                rr = recs[j]
                rr.done, rr.done_step = s1 - t_open, k
                rr.emitted = len(c.tokens) - c.prompt_len
                rr.ok = c.status == "ok" and rr.emitted == rr.tokens
                self.completed[j] = c.tokens
                if rr.in_window:
                    done_in_window += 1
            if tracing and traced_from is not None and traced_to is None \
                    and (s1 - t_open >= tr1 or done_in_window == n_window):
                self.tracer.stop()
                traced_to = len(steps)
        if tracing and traced_from is not None and traced_to is None:
            self.tracer.stop()
            traced_to = len(steps)
        spans.close()
        end = max((r.done for r in recs if r.in_window and r.done is not None),
                  default=seconds)
        last = max((k for k, s in enumerate(steps) if s.t1 <= end + 1e-9),
                   default=len(steps) - 1)
        burst = collections.Counter(steps[k].admitted for k in range(
            first_measured or 0, last + 1))
        print(f"requests admitted per step over the measured steps: "
              f"{dict(sorted(burst.items()))}", file=sys.stderr)
        late = [r.submitted - r.due for r in recs if r.in_window]
        print(f"generator lateness over {len(late)} window requests: "
              f"mean {1e3 * float(np.mean(late)):.4f} ms, max "
              f"{1e3 * float(np.max(late)):.4f} ms", file=sys.stderr)
        counters1 = sched.stats()
        rec = Record(
            kind="serve", dims=ctx.cell.dims, seconds=seconds,
            setup_s=ctx.setup_s, prompt_len=len(self.prompt),
            kv=dict(self_bytes=1, self_scales=True, cross_bytes=1,
                    cross_scales=True),
            head="qmatvec_stacked", requests=recs, steps=steps,
            measured_steps=range(first_measured or 0, last + 1),
            traced_steps=(range(traced_from, traced_to) if tracing
                          and traced_from is not None else range(0)),
            counters={k: counters1[k] - (counters0 or base)[k]
                      for k in ("queue_seconds_sum", "completed_ok",
                                "cancelled", "timeout", "admitted", "ticks")},
            window_end=end)
        if tracing and traced_from is not None:
            rec.trace = self.tracer.summary(GAP_LABELS)
        return rec

    # -- after the window ----------------------------------------------------
    def check_items(self, rec: Record, sample: int):
        """The sampled finished window requests, the longest among them,
        with what each carried and emitted."""
        from perfbench import check
        done = [j for j, r in enumerate(rec.requests)
                if r.in_window and r.ok]
        pick = check.sample(self.ctx.seed, len(done),
                            [rec.requests[j].tokens for j in done], sample)
        out = []
        for p in pick:
            j = done[p]
            out.append((self.reqs[j].offset, self.reqs[j].n_samples,
                        list(self.completed[j]), rec.prompt_len))
        return out

    def free(self) -> None:
        self.sched = self.eng = self.w = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def run(ctx) -> Run:
    r = Run(ctx)
    r.setup()
    return r
