"""Multi-stream batched serving with continuous batching: port of
``whisper_apr_tpu/parallel/serving.py``.

A fixed number of SLOTS share one decode step. Each slot holds one
request's cache rows, token buffer and position. Every scheduler tick
admits queued requests into free slots (``pipeline.fused_admit_step``:
log-mel, encoder, cross K/V, prompt prefill, suppressed first token; then
one scatter into the slot cache) and advances ALL slots by one token in
one step (``kv_variants.decode_steps_multi``), bias + argmax; finished
slots are refilled from the queue at the next tick. The engine picks the
slot cache and the step, as in the JAX scheduler:

- int8 weights and a fused-step cache mode: a ``QKVCache`` and
  ``decode_step_qf`` (K5-K7 per layer, K8 for the vocab logits); k-quant
  weights take the same step over the engine's int8 transcode
  (``engine._qd_for``), one slot the k-quant blocks K12-K14. A cache
  mode of "cross8" (the transcription default, whether from "auto" or
  explicit) is served as full int8 KV, kept from the JAX scheduler on
  purpose; every other non-int8 mode holds compute-dtype rows;
- int8 weights with kv_mode "scan": a dense ``KVCache`` and the scan step
  ``decode_step_q`` (K8 four times and K9 once per layer, K8 for the
  vocab logits; over k-quant weights K10 or K11 six times a layer);
- f32 weights: a dense ``KVCache`` and the plain ``decode_step_multi``.

With ``paged=True`` the slots share one pool of 16-token pages
(``kv_variants.PagedKVCache``, ``n_pages`` defaulting to
``n_slots * ceil(max_len / 16) + 1``) instead of dense [n_slots,
max_len] rows, and only the cross K/V stay dense per slot. A sentinel
sequence owns the pool's first page handed out, the garbage page that
inactive slots write into and that pads every table. Admission reserves
the prompt and the first token; batched admission pads a burst by
repeating the last real slot (identical writes); a finished slot's pages
go back to the pool. Each tick extends every active slot's table by one
token, fills the rest with the garbage page, cuts the tables to the next
power of two of the widest (at most ``ceil(max_len / 16)`` pages) and
runs ``paged_decode.paged_decode_steps`` over the engine's params: K15
once per layer, and K17 for every int8 linear when
``int8_matmul.USE_PALLAS_INT8`` is on.

The tick advances one token, as the dense one; the JAX scheduler's
``steps_per_tick`` and ``admit_buckets`` are not taken.

Every time the scheduler stamps (submission, deadlines, the admission
and decode starts) is ``time.perf_counter()``: monotonic, one clock with
the trace spans (``utils/trace.py``: ``serve.step``, ``serve.admit``,
``serve.tick``, ``serve.finish``). ``stats()`` counts, besides
completions and tokens: the wait from submission to the start of
admission (``wait_seconds_sum``), the time admission takes
(``admit_seconds_sum``), the rows admission ran and how many of them
were bucket padding (``admit_rows``, ``admit_rows_padded``), and the
slot-rows every tick stepped and how many of them held a live request
(``tick_rows``, ``tick_live_rows``).

With ``mesh`` (``parallel/mesh.make_mesh``) the slots split over the
mesh's dp dim, as the JAX scheduler's slot caches do; its params stay
whole on every rank, and the tick is the plain dense step (no fused or
scan kernels, no pages), as in JAX. One process runs per rank, so the
JAX multi-controller contract holds: every rank runs the same scheduler
program and makes the same ``submit`` / ``cancel`` / ``step`` calls in
the same order, synchronously (``start``, whose thread would step each
rank at its own pace, is refused on a mesh). Each rank holds on its
device only its dp index's slots (its tp peers hold the same slots as
replicas) and admits only the requests that land in them; the host
mirrors (queue, slot table, tokens, positions) are identical on every
rank. Each tick decodes the local slots, and the ``[n_slots]`` next
tokens (and the first tokens of an admission) reach every rank by one
sum over the dp group of a zero buffer that each rank fills at its own
slots, so the mirrors cannot drift. Every cancel and deadline decision,
at admission and at each tick, is agreed by a max over the mesh before
it acts, so a clock or a cancel seen on one rank first still acts on
all of them at once.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..inference.processors import WhisperTokenSuppressor
from ..model.decoder import KVCache, init_cache, prefill
from ..model.kv_variants import PAGE_SIZE, PagedKVCache, decode_steps_multi
from ..model.qdecode import CROSS_BLOCK_T, SELF_BLOCK_T, QKVCache
from ..ops.decode_attention import quantize_rows
from ..utils.trace import annotate, trace_span
from .mesh import coordinate, mesh_shape


def _scatter_dense_slots(cache: KVCache, slots: torch.Tensor,
                         new: KVCache) -> KVCache:
    """Write freshly-admitted sequences into their dense slots, in place:
    the self rows [:P] of ``new`` ([L, n, P, D]) and its full cross K/V
    [L, n, S, D], cast to the cache's dtype."""
    P = new.self_k.shape[2]
    dt = cache.self_k.dtype
    cache.self_k[:, slots, :P] = new.self_k.to(dt)
    cache.self_v[:, slots, :P] = new.self_v.to(dt)
    cache.cross_k[:, slots] = new.cross_k.to(dt)
    cache.cross_v[:, slots] = new.cross_v.to(dt)
    return cache


def _scatter_qf_slots(cache: QKVCache, slots: torch.Tensor, new: KVCache,
                      int8: bool) -> QKVCache:
    """Write freshly-admitted sequences into their slots, in place: the
    self rows [:P] and cross rows [:S] of ``new`` ([L, n, P or S, D]),
    quantized per row (``quantize_rows``) for an int8 cache, else cast to
    the cache's dtype."""
    P = new.self_k.shape[2]
    S = new.cross_k.shape[2]
    if int8:
        sk, sks = quantize_rows(new.self_k)
        sv, svs = quantize_rows(new.self_v)
        ck, cks = quantize_rows(new.cross_k)
        cv, cvs = quantize_rows(new.cross_v)
        cache.self_ks[:, slots, :P] = sks
        cache.self_vs[:, slots, :P] = svs
        cache.cross_ks[:, slots, :S] = cks
        cache.cross_vs[:, slots, :S] = cvs
    else:
        dt = cache.self_kq.dtype
        sk, sv = new.self_k.to(dt), new.self_v.to(dt)
        ck, cv = new.cross_k.to(dt), new.cross_v.to(dt)
    cache.self_kq[:, slots, :P] = sk
    cache.self_vq[:, slots, :P] = sv
    cache.cross_kq[:, slots, :S] = ck
    cache.cross_vq[:, slots, :S] = cv
    return cache


def _scatter_cross_slots(cache: KVCache, slots: torch.Tensor,
                         new: KVCache) -> KVCache:
    """Write only the cross K/V [L, n, S, D] of admitted sequences into
    their slots, in place (paged slots keep their self K/V in the
    pool)."""
    dt = cache.cross_k.dtype
    cache.cross_k[:, slots] = new.cross_k.to(dt)
    cache.cross_v[:, slots] = new.cross_v.to(dt)
    return cache


@dataclasses.dataclass
class Request:
    """One transcription request submitted to the scheduler."""

    request_id: int
    audio: np.ndarray
    prompt: Optional[List[int]]  # None -> language auto-detect at admission
    max_tokens: int = 224
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    deadline: Optional[float] = None  # time.perf_counter(); None = no limit
    task: str = "transcribe"  # used to build the prompt when auto-detecting


@dataclasses.dataclass
class Completion:
    request_id: int
    tokens: List[int]
    queue_seconds: float
    decode_seconds: float
    # "ok" | "cancelled" | "timeout" — cancelled/timed-out requests still
    # carry whatever tokens were decoded before the stop (partial result)
    status: str = "ok"
    prompt_len: int = 0  # tokens[:prompt_len] is the forced prompt


class BatchScheduler:
    """Continuous-batching scheduler over a fixed slot array.

    Synchronous core (``submit`` + ``run_until_drained``) with an optional
    background thread (``start``/``stop``). The slots live on the engine's
    device; on a CUDA engine every tick runs the kernels.

    ``mesh``: a (dp, tp) ``DeviceMesh``; the slots split over dp (module
    docstring: every rank makes the same calls in the same order, and
    ``n_slots`` must divide over dp). Dense slots only, served
    synchronously.
    """

    def __init__(self, engine, n_slots: int = 8,
                 max_len: Optional[int] = None,
                 paged: bool = False,
                 n_pages: Optional[int] = None,
                 mesh=None,
                 batched_admission: bool = True) -> None:
        if mesh is not None:
            if paged:
                raise ValueError("paged serving is per-device; use dense "
                                 "slots with a mesh")
            dp = mesh_shape(mesh)["dp"]
            if n_slots % dp:
                raise ValueError(
                    f"n_slots={n_slots} not divisible by dp={dp}")
        self.mesh = mesh
        self.engine = engine
        self.config: ModelConfig = engine.config
        self.n_slots = n_slots
        self.max_len = max_len or self.config.n_text_ctx
        self.paged = paged
        # bursts of queued requests admit through ONE fused admission plus
        # one slot scatter; buckets bound the batch sizes, a burst pads up
        # to the next bucket using spare free slots as write targets
        self.batched_admission = batched_admission
        self.admit_buckets = tuple(sorted({1, n_slots} | {
            b for b in (2, 4, 8, 16) if b < n_slots}))
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self._completions: Dict[int, Completion] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # ids cancelled via cancel(); honored at the next tick (all slot
        # mutation stays on the scheduler thread)
        self._cancelled: set = set()
        self._counters = {
            "completed_ok": 0, "cancelled": 0, "timeout": 0,
            "tokens_generated": 0, "queue_seconds_sum": 0.0,
            "decode_seconds_sum": 0.0, "admitted": 0, "ticks": 0,
            "wait_seconds_sum": 0.0, "admit_seconds_sum": 0.0,
            "admit_rows": 0, "admit_rows_padded": 0, "tick_rows": 0,
            "tick_live_rows": 0}

        D = self.config.n_text_state
        S = self.config.n_audio_ctx
        L = self.config.n_text_layer
        dt = engine._compute_dtype
        dev = engine.device
        # this rank's slots: all of them without a mesh
        B = n_slots
        if mesh is not None:
            B = n_slots // mesh_shape(mesh)["dp"]
        self._lo = 0 if mesh is None else coordinate(mesh)[0] * B
        self._here = range(self._lo, self._lo + B)

        def z(shape, d):
            return torch.zeros(shape, dtype=d, device=dev)

        # dense slots: the JAX scheduler's cache forms (module docstring);
        # paged slots: the page pool, and dense cross K/V only
        self._qf = None if paged or mesh is not None else engine._qf_mode
        if self._qf == "cross8":
            # the reference serves cross8 as FULL int8 KV at B > 1
            self._qf = "int8"
        # a k-quant engine serves B > 1 slots through its int8 transcode
        self._qd = None if paged or mesh is not None else (
            engine._qd_for(n_slots) if self._qf else engine._qdecode)
        Tp = -(-self.max_len // SELF_BLOCK_T) * SELF_BLOCK_T
        Sp = -(-S // CROSS_BLOCK_T) * CROSS_BLOCK_T
        kv8 = self._qf == "int8"
        rdt = torch.int8 if kv8 else dt
        f32 = torch.float32
        if paged:
            self._p_max = -(-self.max_len // PAGE_SIZE)
            self._paged_kv = PagedKVCache(
                self.config, n_pages or (B * self._p_max + 1),
                compute_dtype=dt, device=dev)
            self._paged_kv.alloc(-1, 1)   # sentinel: the garbage page
            self._garbage_page = self._paged_kv._tables[-1][0]
            self._cache = KVCache(
                z((L, 1, 1, D), dt), z((L, 1, 1, D), dt),   # unused (paged)
                z((L, B, S, D), dt), z((L, B, S, D), dt))
        elif self._qf:
            self._cache = QKVCache(
                z((L, B, Tp, D), rdt), z((L, B, Tp, 1), f32) if kv8 else None,
                z((L, B, Tp, D), rdt), z((L, B, Tp, 1), f32) if kv8 else None,
                z((L, B, Sp, D), rdt), z((L, B, Sp, 1), f32) if kv8 else None,
                z((L, B, Sp, D), rdt), z((L, B, Sp, 1), f32) if kv8 else None)
        else:
            self._cache = KVCache(
                z((L, B, self.max_len, D), dt), z((L, B, self.max_len, D), dt),
                z((L, B, S, D), dt), z((L, B, S, D), dt))
        # host mirrors of every slot (identical on every rank of a mesh)
        self._tokens = np.full((n_slots, self.max_len), engine.specials.eot,
                               dtype=np.int32)
        self._pos = np.zeros(n_slots, dtype=np.int32)
        self._active = np.zeros(n_slots, dtype=bool)
        self._req: List[Optional[Request]] = [None] * n_slots
        self._decode_start = np.zeros(n_slots, dtype=np.float64)
        # the ENGINE's special tokens (English-only models and test rigs
        # shift them), not the vocab-size default
        self._bias = torch.from_numpy(WhisperTokenSuppressor(
            n_vocab=self.config.n_vocab, tokens=engine.specials).bias()).to(
            dev)
        self._params = engine.params

    # -- public API -----------------------------------------------------------
    def submit(self, audio: np.ndarray, language: str = "en",
               task: str = "transcribe", max_tokens: int = 224,
               timeout_s: Optional[float] = None) -> int:
        """Enqueue a request; returns its id. ``timeout_s`` sets a
        deadline — a request still queued or decoding past it
        completes with status "timeout" and whatever tokens it has.
        ``language`` None or "auto" detects the language at admission."""
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        prompt = (None if language in (None, "auto")
                  else self.engine.get_initial_tokens(language, task))
        deadline = (None if timeout_s is None
                    else time.perf_counter() + timeout_s)
        self._queue.put(Request(rid, np.asarray(audio, np.float32),
                                prompt, max_tokens, deadline=deadline,
                                task=task))
        return rid

    def cancel(self, request_id: int) -> bool:
        """Abort a queued or in-flight request, honored at the next tick;
        its completion carries status "cancelled" and the tokens decoded
        so far. Returns False if it already completed."""
        with self._lock:
            if request_id in self._completions:
                return False
            self._cancelled.add(request_id)
            return True

    def result(self, request_id: int) -> Optional[Completion]:
        return self._completions.get(request_id)

    def pending(self) -> int:
        return self._queue.qsize() + int(self._active.sum())

    def stats(self) -> Dict[str, float]:
        """Cumulative serving counters and instantaneous gauges."""
        with self._lock:
            out = dict(self._counters)
        out["queue_depth"] = self._queue.qsize()
        out["active_slots"] = int(self._active.sum())
        out["n_slots"] = self.n_slots
        done = out["completed_ok"] + out["cancelled"] + out["timeout"]
        out["completed_total"] = done
        out["tokens_per_decode_second"] = (
            out["tokens_generated"] / out["decode_seconds_sum"]
            if out["decode_seconds_sum"] > 0 else 0.0)
        return out

    # -- scheduling core --------------------------------------------------------
    def _fill_slots(self) -> None:
        """Admit queued requests into free slots (prefill their caches)."""
        free = [s for s in range(self.n_slots) if not self._active[s]]
        if not free or self._queue.empty():
            return
        with trace_span("serve.admit"):
            self._admit(free)

    def _admit(self, free: List[int]) -> None:
        reqs: List[Request] = []
        now = time.perf_counter()
        while len(reqs) < len(free):
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            # cancelled / deadline-expired while queued: complete without
            # ever touching a slot
            stop = self._stop(req, now)
            if stop:
                self._complete_unadmitted(req, stop, now)
            else:
                if req.prompt is None:   # language "auto"
                    lang = self.engine.detect_language(req.audio).best[0]
                    req.prompt = self.engine.get_initial_tokens(
                        lang, req.task)
                reqs.append(req)
        if not reqs:
            return
        # slots assigned in order, leftovers spare. This rank admits the
        # requests that land in its own slots (all of them without a
        # mesh), at its local slot indices: one fused admission per prompt
        # length (prompts in a batch must stack rectangularly), or one
        # request at a time without batched admission
        slots = free[: len(reqs)]
        lo = self._lo
        spare = [s - lo for s in free[len(reqs):] if s in self._here]
        groups: Dict[int, List[Tuple[Request, int]]] = {}
        for req, slot in zip(reqs, slots):
            if slot in self._here:
                key = len(req.prompt) if self.batched_admission else slot
                groups.setdefault(key, []).append((req, slot))
        annotate(ids=[r.request_id for r in reqs])
        first = torch.zeros(self.n_slots, dtype=torch.long,
                            device=self.engine.device)
        for group in groups.values():
            rs, at = [r for r, _ in group], [s for _, s in group]
            if self.batched_admission:
                first[at] = self._admit_batch(rs, [s - lo for s in at],
                                              spare)
            else:
                first[at] = self._admit_one(at[0] - lo, rs[0])
        first = self._dp_sum(first)
        with trace_span("sync"):
            first = first.cpu().numpy()
        with trace_span("admit.host"):
            self._admitted(reqs, slots, first[slots], now)

    def _admit_batch(self, reqs: List[Request], slots: List[int],
                     spare: List[int]) -> torch.Tensor:
        """Admit ``reqs`` into ``slots`` via fused_admit_step and one slot
        scatter; pads the batch up to the smallest admissible bucket with
        ``spare`` free slots as write targets (the next occupant's
        admission overwrites them). Returns the first tokens (on the
        device)."""
        from ..pipeline import fused_admit_step, pad_audio_batch

        n = len(reqs)
        b = n
        for cand in self.admit_buckets:
            if cand >= n and (self.paged or (cand - n) <= len(spare)):
                b = cand
                break
        pad = b - n
        annotate(bucket=b, padded=pad)
        self._counters["admit_rows"] += b
        self._counters["admit_rows_padded"] += pad
        # paged pads repeat the last real slot (identical duplicate
        # writes: spare slots own no pages)
        targets = (slots + [slots[-1]] * pad if self.paged
                   else slots + spare[:pad])
        eng = self.engine
        dev = eng.device
        n_samples = 2 * self.config.n_audio_ctx * 160
        audio = pad_audio_batch(
            [r.audio for r in reqs] + [reqs[-1].audio] * pad, n_samples)
        prompt = np.asarray([list(r.prompt) for r in reqs]
                            + [list(reqs[-1].prompt)] * pad, np.int64)
        first, new = fused_admit_step(
            self._params, torch.from_numpy(audio).to(dev),
            *eng.mel_filters.constants(dev), torch.from_numpy(prompt).to(dev),
            self._bias, self.config, compute_dtype=eng._compute_dtype,
            use_flash=eng._use_flash)
        with trace_span("scatter"):
            slots_t = torch.tensor(targets, dtype=torch.long, device=dev)
            if self.paged:
                from ..model.paged_decode import write_prefills_to_pool
                pk = self._paged_kv
                Pn = prompt.shape[1]
                for slot in slots:
                    pk.free(slot)           # clear any previous occupant
                    pk.alloc(slot, Pn + 1)  # prompt + first generated token
                    pk._lengths[slot] = Pn
                positions = np.arange(Pn)
                pages = np.stack([np.asarray(pk._tables[s], np.int64)[
                    positions // PAGE_SIZE] for s in targets])   # [b, Pn]
                offs = np.tile(positions % PAGE_SIZE, (b, 1))
                write_prefills_to_pool(
                    pk.k_pool, pk.v_pool, new.self_k, new.self_v,
                    torch.from_numpy(pages).to(dev),
                    torch.from_numpy(offs).to(dev))
                self._cache = _scatter_cross_slots(self._cache, slots_t, new)
            else:
                self._scatter(slots_t, new)
        return first[:n].long()

    def _admitted(self, reqs: List[Request], slots: List[int],
                  first: np.ndarray, started: float) -> None:
        """Host bookkeeping of admitted requests: prompt and first token
        into the mirrors, slots active (finished at once on an EOT);
        ``started`` is when their admission began."""
        now = time.perf_counter()
        eot = self.engine.specials.eot
        c = self._counters
        c["admitted"] += len(reqs)
        c["wait_seconds_sum"] += sum(started - r.submitted_at for r in reqs)
        c["admit_seconds_sum"] += now - started
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            P = len(req.prompt)
            self._tokens[slot] = eot
            self._tokens[slot, :P] = req.prompt
            self._tokens[slot, P] = first[i]
            self._pos[slot] = P
            self._active[slot] = True
            self._req[slot] = req
            self._decode_start[slot] = now
            if first[i] == eot:
                self._finish(slot)

    def _dp_sum(self, buf: torch.Tensor) -> torch.Tensor:
        """Sum over the mesh's dp group (each slot's value comes from the
        one dp index that holds it); ``buf`` itself without a mesh."""
        if self.mesh is not None and mesh_shape(self.mesh)["dp"] > 1:
            import torch.distributed as dist
            dist.all_reduce(buf, group=self.mesh.get_group("dp"))
        return buf

    def _stop(self, req: Request, now: float) -> Optional[str]:
        """Whether a request stops now: "cancelled", "timeout" or None,
        agreed over the mesh."""
        flag = (1 if req.request_id in self._cancelled
                else 2 if req.deadline is not None and now > req.deadline
                else 0)
        flag = int(self._agree(np.asarray([flag]))[0])
        return (None, "cancelled", "timeout")[flag]

    def _agree(self, flags: np.ndarray) -> np.ndarray:
        """Host decisions taken from each rank's clock and cancel calls,
        agreed by a max over the whole mesh (a no-op without one)."""
        if self.mesh is None:
            return flags
        import torch.distributed as dist
        t = torch.from_numpy(flags.astype(np.int64)).to(self.engine.device)
        for dim in ("dp", "tp"):
            if mesh_shape(self.mesh)[dim] > 1:
                dist.all_reduce(t, op=dist.ReduceOp.MAX,
                                group=self.mesh.get_group(dim))
        with trace_span("sync"):
            return t.cpu().numpy()

    def _admit_one(self, slot: int, req: Request) -> int:
        """Staged per-slot admission (batched_admission off): mel ->
        encode -> prefill as separate calls. Returns the first token."""
        eng = self.engine
        enc = eng.encode(eng.compute_mel(req.audio))   # [1, S, D]
        one = init_cache(eng.params, enc, self.config, max_len=self.max_len,
                         compute_dtype=eng._compute_dtype)
        prompt = torch.tensor([req.prompt], dtype=torch.long,
                              device=eng.device)
        logits, one = prefill(eng.params, prompt, enc, one, self.config,
                              compute_dtype=eng._compute_dtype)
        with trace_span("sync"):
            first = int(torch.argmax(logits[0] + self._bias))
        self._counters["admit_rows"] += 1
        P = len(req.prompt)
        with trace_span("scatter"):
            slot_t = torch.tensor([slot], dtype=torch.long,
                                  device=eng.device)
            if self.paged:
                from ..model.paged_decode import write_prefill_to_pool
                pk = self._paged_kv
                pk.free(slot)               # clear any previous occupant
                pk.alloc(slot, P + 1)       # prompt + first generated token
                write_prefill_to_pool(
                    pk.k_pool, pk.v_pool, one.self_k, one.self_v,
                    np.asarray(pk._tables[slot], np.int64), P)
                pk._lengths[slot] = P
                self._cache = _scatter_cross_slots(self._cache, slot_t, one)
            else:
                self._scatter(slot_t, one)
        return first

    def _scatter(self, slots: torch.Tensor, new: KVCache) -> None:
        """Write admitted sequences' caches into ``slots``."""
        if self._qf:
            self._cache = _scatter_qf_slots(self._cache, slots, new,
                                            int8=self._qf == "int8")
        else:
            self._cache = _scatter_dense_slots(self._cache, slots, new)

    def _complete_unadmitted(self, req: Request, status: str,
                             now: float) -> None:
        """Finish a request that never reached a slot (cancelled or expired
        in the queue): no tokens, queue time only."""
        with self._lock:
            self._completions[req.request_id] = Completion(
                request_id=req.request_id, tokens=[],
                queue_seconds=now - req.submitted_at,
                decode_seconds=0.0, status=status)
            self._cancelled.discard(req.request_id)
            self._counters[status] += 1
            self._counters["queue_seconds_sum"] += now - req.submitted_at

    def _finish(self, slot: int, status: str = "ok") -> None:
        req = self._req[slot]
        if req is None:
            return
        P = len(req.prompt)
        # length: prompt + generated up to (and incl.) EOT
        end = self._pos[slot] + 1
        seq = self._tokens[slot, :end].tolist()
        now = time.perf_counter()
        queue_s = self._decode_start[slot] - req.submitted_at
        decode_s = now - self._decode_start[slot]
        with self._lock:
            self._completions[req.request_id] = Completion(
                request_id=req.request_id, tokens=[int(t) for t in seq],
                queue_seconds=queue_s, decode_seconds=decode_s,
                status=status, prompt_len=P)
            self._cancelled.discard(req.request_id)
            c = self._counters
            c["completed_ok" if status == "ok" else status] += 1
            c["tokens_generated"] += max(0, int(end) - P)
            c["queue_seconds_sum"] += queue_s
            c["decode_seconds_sum"] += decode_s
        self._active[slot] = False
        self._req[slot] = None
        if self.paged:
            self._paged_kv.free(slot)

    def step(self) -> int:
        """One scheduler tick: admit, then advance every slot by one token
        in one step. Returns the number of active slots."""
        with trace_span("serve.step"):
            return self._step()

    def _step(self) -> int:
        # honor aborts and deadlines on in-flight slots before a step (on
        # a mesh at every tick: another rank may have seen one)
        if self.mesh is not None or self._cancelled or any(
                r is not None and r.deadline is not None for r in self._req):
            now = time.perf_counter()
            stop = np.zeros(self.n_slots, np.int64)  # 1 cancel, 2 timeout
            for slot in range(self.n_slots):
                req = self._req[slot]
                if req is None or not self._active[slot]:
                    continue
                if req.request_id in self._cancelled:
                    stop[slot] = 1
                elif req.deadline is not None and now > req.deadline:
                    stop[slot] = 2
            stop = self._agree(stop)
            for slot in np.flatnonzero(stop):
                self._finish(int(slot), status=("cancelled" if stop[slot] == 1
                                                else "timeout"))
        admitted = self._counters["admitted"]
        self._fill_slots()
        live = int(self._active.sum())
        annotate(admitted=self._counters["admitted"] - admitted, live=live)
        if not live:
            return 0
        self._counters["ticks"] += 1

        toks = self._paged_tick() if self.paged else self._dense_tick()

        eot = self.engine.specials.eot
        with trace_span("serve.finish"):
            for slot in range(self.n_slots):
                if not self._active[slot]:
                    continue
                req = self._req[slot]
                limit = min(len(req.prompt) + req.max_tokens, self.max_len)
                self._pos[slot] += 1
                p = self._pos[slot]
                if p >= self.max_len:
                    self._pos[slot] = self.max_len - 1
                    self._finish(slot)
                    continue
                self._tokens[slot, p] = toks[slot]
                if toks[slot] == eot or p + 1 >= limit:
                    self._finish(slot)
        return int(self._active.sum())

    def _dense_tick(self) -> np.ndarray:
        """One token for every slot over the dense slots. On a mesh this
        rank steps its own slots (none if they are all idle) and the dp
        sum brings every slot's token to every rank."""
        with trace_span("serve.tick"):
            dev = self.engine.device
            rows = np.asarray(self._here)
            toks = None
            live = int(self._active[rows].sum())
            if live:
                self._count_tick(len(rows), live)
                token = torch.from_numpy(
                    self._tokens[rows, self._pos[rows]]).to(dev)
                toks, self._cache = decode_steps_multi(
                    self._params, token, self._pos[rows], self._bias,
                    self._cache, self.config, n_steps=1,
                    compute_dtype=self.engine._compute_dtype, qd=self._qd)
                toks = toks[:, 0]
            if self.mesh is not None:
                buf = torch.zeros(self.n_slots, dtype=torch.long, device=dev)
                if toks is not None:
                    buf[self._lo: self._lo + len(rows)] = toks.long()
                toks = self._dp_sum(buf)
            with trace_span("sync"):
                return toks.cpu().numpy()

    def _count_tick(self, rows: int, live: int) -> None:
        """A tick stepped ``rows`` slot-rows, ``live`` of them a request's."""
        self._counters["tick_rows"] += rows
        self._counters["tick_live_rows"] += live
        annotate(rows=rows, live=live)

    def _paged_tick(self) -> np.ndarray:
        """Advance every slot one token over the shared page pool."""
        from ..model.paged_decode import paged_decode_steps
        with trace_span("serve.tick"):
            self._count_tick(self.n_slots, int(self._active.sum()))
            token = torch.from_numpy(
                self._tokens[np.arange(self.n_slots), self._pos]).to(
                self.engine.device)
            pk = self._paged_kv
            # host: extend each active slot's table to cover the new token
            tables = np.full((self.n_slots, self._p_max), self._garbage_page,
                             dtype=np.int32)
            used = 1
            for slot in range(self.n_slots):
                if not self._active[slot]:
                    continue
                pk.extend(slot, 1)
                t = pk._tables[slot]
                tables[slot, : len(t)] = t[: self._p_max]
                used = max(used, min(len(t), self._p_max))
            # the kernel reads exactly the pages in use; a power-of-two
            # width keeps the table shapes few
            width = 1
            while width < used:
                width *= 2
            width = min(width, self._p_max)
            dev = self.engine.device
            toks, pk.k_pool, pk.v_pool = paged_decode_steps(
                self._params, token, torch.from_numpy(self._pos).to(dev),
                self._bias, torch.from_numpy(tables[:, :width].copy()).to(dev),
                pk.k_pool, pk.v_pool, self._cache.cross_k,
                self._cache.cross_v, self.config, n_steps=1,
                compute_dtype=self.engine._compute_dtype)
            with trace_span("sync"):
                return toks[:, 0].cpu().numpy()

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and self._queue.empty():
                return

    # -- background serving thread ----------------------------------------------
    def start(self) -> None:
        if self.mesh is not None:
            raise ValueError(
                "a mesh is served synchronously: every rank calls step / "
                "run_until_drained in lockstep (a thread a rank would step "
                "each at its own pace)")
        self._running = True

        def loop():
            while self._running:
                try:
                    if self.step() == 0 and self._queue.empty():
                        time.sleep(0.001)
                except Exception:  # noqa: BLE001 — interpreter teardown races
                    if self._running:
                        raise
                    return

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def decode_text(self, completion: Completion,
                    prompt_len: Optional[int] = None) -> str:
        if prompt_len is None:
            prompt_len = completion.prompt_len
        gen = completion.tokens[prompt_len:]
        return self.engine.tokenizer.decode_with_options(gen, skip_special=True)
