#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--detail OUT.json]

Phases, in order; any failure raises and the script exits non-zero:

1. device   - require CUDA; print the card, its power limit, torch/CUDA.
2. build    - build (or load) the hand-written kernels from csrc/, one
              nvcc per source, all started together.
2b. native  - build the host runtime (native/aprcore.cpp, g++ with the JAX
              package's flags) and hold its six functions against their
              plain versions on the host at the sizes users run: CRC-32
              of 64 MB (zlib), the resampler on 75 s at 44.1 and 48 kHz
              to 16 kHz (NumPy, within 1e-5; the identity exact), PCM16
              of 75 s of stereo (exact), the VAD's frame features
              (within 1e-6), LZ4 decoding of the e2e whisper-tiny int8
              .apr written compressed (the Python decoder's bytes, the
              uncompressed twin's tensors), the DTW on a 224 x 1500 cost
              (the same path); each pair's host-clock times as data.
3. kernels  - K1-K4 at batch 1, K5-K8 and K4 at M > 1 (up to 40 rows: the
              32-row chunking) and K9 against their plain PyTorch versions
              on the card, in bf16 at the whisper-tiny and large-v3 decoder
              shapes (and in f32), over bf16 / int8 / fp8 cache
              rows, single and per-slot mixed positions (0 ... 447),
              planted argmax ties and suppressed columns; K1 and K3 (one
              launch each: clusters of blocks; K1 two on int8 rows) in bf16
              and f32 at both widths, K1 at every SELF_EDGES position over
              bf16 / f32, int8 and fp8 rows, K3 at layers 0, L/2 and L-1,
              each call twice and bit-identical; K8 (K17's decode-row
              kernel) at K8_EDGES (1-40 rows, split and whole K, a part
              strip, bf16 and f32 out), each call twice and
              bit-identical; K2 (one launch,
              a cluster per head) also at every cache dtype it takes (int8,
              bf16, f32, fp8) and enc_len 0, 1, 63, 64, 65, 1499, 1500, in
              bf16 and f32 at both widths, each call twice and
              bit-identical (check_cross); K5 and K6 (one cluster per
              head and tile of slots; K5 two launches on int8 rows) at
              B = 2, 5, 8, 32, 40 over int8, bf16, f32 and fp8 rows, K5 at
              SLOT_POS positions mixed within the batch, K6 at every
              CROSS_EDGES length, in bf16 and f32 at both widths, each
              call twice and bit-identical (check_batched_edges); K7 and
              K9 (one tensor-core kernel) at FFN_EDGES rows (1 ... 40),
              layers 0 and L-1, in bf16 and f32 at both widths, each call
              twice and bit-identical (check_ffn_edges); K4 (K8's
              decode-row kernel with a head epilogue) at HEAD_ROWS rows
              (1 ... 40) over ties within and across 128-column strips
              (HEAD_TIES), a winner in the last real column and all -inf
              logits, in bf16 and f32 at both widths, each call twice and
              bit-identical, its scratch left zero (check_head_edges),
              and in a CUDA graph over new x (check_head_graph); then
              CUDA-graph times of kernel and plain version at B=1 and B=8
              (K8 also at the scan step's D x 3D and D x D projections),
              of the large-v3 B=8 serving tick, and of the large-v3 scan
              step (decode_step_q) beside the fused step (decode_step_qf).
4. e2e      - write a random-weight full-width whisper-tiny .apr with the
              port's AprWriter, load it through WhisperApr.load_from_apr
              (int8 weights, bf16 compute) and transcribe 30 s of noise, a
              5 s tone and silence; check the kernel launch counts; check
              f32 tokens through the kernels equal the plain path's; time
              bench.py's protocol (30 s, 224 forced tokens, EOT
              suppressed, B=1).
5. serve    - BatchScheduler(n_slots=8) drains a dozen clips (3-30 s) in
              two bursts: every tick launches K5-K7 L times and K8 once,
              K1-K4 never; then, in f32 with int8 KV, the scheduler's tokens
              through the kernels equal those through the plain versions
              and follow per-clip transcribe (a difference only where the
              top two logits are within 1e-4). Then the same over a
              kv_mode "scan" engine: K8 4L+1 and K9 L times per tick.
6. batch    - transcribe_batch of 4 clips: K5-K7 L times and K4 once per
              step; f32 tokens as in phase 5.
6b. longform - the long-audio and streaming entry points on the e2e
              engines: transcribe_file on a 75 s 44.1 kHz WAV (3 windows
              in one transcribe_batch: K5-K7 L times and K4 once a
              step; segment offsets multiples of 29 s), transcribe_with_vad
              on three tone bursts (one batch of three), a StreamingSession
              at 44.1 kHz in 0.5 s blocks with partial reuse on and off
              (K1-K4 for every partial and chunk decode; per-partial
              latency p50 / p95, host clock), transcribe_prefixed
              continuing a decode's own prefix (near-tie rule), hotwords
              at boost 0 against the fused greedy path (near-tie rule)
              and a boosted run (ms per host-stepped token), word
              timestamps on a 10 s clip (monotone words within the clip;
              the traced forward's and the DTW's ms); each path's
              launches held to the decodes it ran; in f32 tokens, texts
              and words through the kernels == plain versions. The
              host runtime's calls held: one resample per file, one per
              30 ms frame of a 44.1 kHz session (and one at finalize),
              one DTW per word-timestamp decode, none elsewhere.
6c. cli     - the port's CLI and HTTP server on the e2e .apr, as a user
              runs them: cli.run of transcribe (json, srt), batch of 4
              WAVs, detect-language, model (H100 floors), validate and
              diagnose (the card, the kernels loaded), each command's
              launches held to its decodes; --fp32 tokens == the engine's
              transcribe_long through the plain versions; the same
              transcribe as a subprocess (python -m
              whisper_apr_tpu_torch.cli), its stdout the in-process one;
              TranscribeServer(n_slots=8), threaded, the device loop on
              the main thread: 12 clips posted at once, an OpenAI
              multipart request of 2 s at 44.1 kHz, an async request
              polled, a cancelled one, then a 30 s clip alone and a 20 s
              streaming session in
              0.5 s blocks and /metrics (every answer 2xx, completions
              "ok" but the cancelled one, no session error event; ticks
              K5-K8, session decodes K1-K4, counts held); f32 HTTP tokens
              behind --single-thread follow per-clip transcribe
              (near-tie rule); per-request latency, queue / decode ms,
              HTTP overhead, resample ms, per-partial ms as data lines;
              the server run makes one resample (the 44.1 kHz request)
              and no other host-runtime call.
7. decoders - the other decoders through the engine's entry points: greedy
              in kv_mode "scan" (K8 4L+1 and K9 L times per token), beam
              search (5 beams on one clip and on 8 clips: 40 rows),
              transcribe_nbest, sampling (T=0 is greedy; T=0.8, top_k=40,
              seed 0 twice gives the same tokens; best_of 3 with top_p),
              timestamp tokens (K8 tail, no K4) and the temperature
              fallback; in f32 each gives
              the same tokens through the kernels as through the plain
              versions (near-tie rule).
7d. mesh (after 7) - serving and decoding on a (dp, tp) mesh, each run
              a launch of parallel/dryrun.py's ranks (no kernel: the mesh
              path is the plain step, as in JAX): (a) one rank, NCCL, a
              1 x 1 mesh, whisper-tiny at full width, f32: sharded greedy
              over 2 clips == single-device greedy, the scheduler drains;
              (b) two ranks, gloo (NCCL refuses two ranks on one GPU; the
              tensors stay on the card), dp=2 x tp=1, whisper-tiny: greedy
              over 4 clips (2 a rank) == single-device, BatchScheduler(
              n_slots=4, mesh) drains 5 clips with the single-device
              scheduler's tokens; (c) two ranks, gloo, dp=1 x tp=2 at
              large-v3's widths (4 + 4 layers, vocab 51866, the only
              released one that splits over 2), f32: teacher-forced logits
              within 1e-4 of the largest single-device magnitude, 24
              greedy tokens equal (near-tie rule); ms per token sharded
              and single, as data (one card over gloo predicts nothing of
              a run across cards).
7e. speculative (after 7d) - transcribe(speculative=True) on an f32
              engine over the e2e .apr (int8 weights, f32 rows: kv_mode
              "bf16") at (draft_tokens, draft_layers) = (2, 1), (4, 1),
              (4, L): tokens == the same engine's plain greedy through
              K1-K4 (near-tie rule), no kernel launched on the
              speculative path; at draft_layers = L every draft accepted;
              the bf16 engine's mismatches counted, not failed; verify
              passes, accepted drafts and ms per emitted token against
              plain greedy's, as data.
8. large-v3 - a large-v3-shaped model built in memory (random int8
              weights): 30 s of noise through encoder, prefill and decode
              at full width, f32 tokens through the kernels against the
              plain versions (near-tie rule); transcribe_long of 45 s of
              noise (2 windows: K5-K7 at large-v3 width).
3b. kquant kernels (after phase 3) - K10-K14 against their plain versions
              in Q4_K, Q5_K and Q6_K at the whisper-base and large-v3
              decoder shapes (bf16; f32 at base), K12 (K1's head-cluster
              kernel over k-quant weights; two launches on int8 rows) at
              KQ_SELF_EDGES positions (0 ... 447) over int8, bf16, f32 and
              fp8 self rows, each call twice and bit-identical, K13 and
              K14 over int8 cross rows (cross8), K10/K11 at M = 1, 8 and
              40; K13 (K2's head-cluster kernel over k-quant weights) in
              every format at enc_len 0, 1, 31, 32, 33, 1500 and 1536 over
              int8, bf16, f32 and fp8 cross rows, bf16 and f32 x, both
              widths, each call twice and bit-identical (check_cross_kq);
              K10 and K11 (q5k, q6k) at the scan step's four shapes and
              odd group counts against part strips, M 1-40, bf16 and f32,
              each call twice and bit-identical (check_q4k_edges,
              check_kq_edges); their times and bounds; the large-v3
              32-layer B=1 k-quant steps, fused and scan (q4k, q5k,
              q6k).
7b. kquant (after phase 7) - whisper-base .apr files with header
              quantization q4k, q5k and q6k written by the port and loaded
              by load_from_apr: 30 s of noise at B=1 (K12-K14 L times and
              K4 once per step), the bench protocol's RTF, f32 tokens
              through the kernels == plain; kv_mode "scan" (K10 over q4k,
              K11 over q5k; K8 for the logits); over the q4k engine
              transcribe_batch of 4 and BatchScheduler(n_slots=4) on the
              int8 transcode (K5-K8), f32 tokens following per-clip
              decoding through the transcode (near-tie rule).
3c. optin kernels (after 3b) - K15 (paged attention: 8 slots, lengths
              1-460 over tables of 28 scattered pages, a table cut to 2
              pages; then 16 slots over tables of 1, 2, 28 and 29 pages:
              an empty slot, lengths either side of paged_plan's run
              boundaries, the table's end and past it, an out-of-range
              page id, NaN in every row past a non-empty slot's length;
              each call twice and bit-identical: check_paged_edges),
              K16 (flash attention over 1500 frames at B=1 and 4,
              causal, kv_valid 1000; the ragged edges of its key ring,
              split and combine: Tk 1, 63, 65, 448, Tq 1 and 100 over
              1500 keys, kv_valid 1024 and 1025, causal at 448, an
              uneven split over 1300 keys, mha_flash's strided heads,
              rows that are not 16-byte aligned: FLASH_UNALIGNED),
              K17 and K18 (int8 / packed-int4 matmuls at M = 1, 8, 1500,
              odd widths for K18; K17 also at INT8_MM_EDGES, K18 at
              INT4_EDGES, each call twice and bit-identical) against
              their plain versions at the
              tiny and large-v3 shapes in bf16 and f32 (f32 through the
              three-term tensor-core kernels; their errors also apart,
              as <name>_f32); their times, bounds and library yardsticks
              (SDPA for K16, torch._weight_int8pack_mm for K17,
              torch._weight_int4pack_mm for K18), K16's time / SDPA; the
              same in f32 (time_optin_f32: K16 at B = 1 and 4, K17 at
              M = 1500 and 224, K18 at 1500 and 64, each beside its f32
              bound, tensor-core floor, yardstick and a dense f32
              matmul; the SDPA backend that ran).
5b. paged (after 5) - BatchScheduler(paged=True, n_slots=8) over the
              e2e .apr: the serve phase's 12 clips in two bursts with
              batched and with staged admission (K15 L times per tick,
              nothing else; wall and device ms per tick), f32 tokens
              through the kernels == plain versions and following
              per-clip decoding; then again with use_flash_attention and
              USE_PALLAS_INT8 on (admission K16 and K17, the tick K15 and
              K17; counts held exactly).
8b. opt-in at full width (after 7b and 8) - a whisper-tiny int4 engine
              with USE_PALLAS_INT4 (K18 in every linear, B=1, 30 s noise;
              f32 tokens == plain, its launches held too: the 1500-row
              linears through the f32 tile kernel); large-v3 with flash
              and the int8 switch (K16, K17 in the encoder, cross K/V and
              prefill; f32 tokens == plain; the f32 launches of K16 and
              of K17's tile kernel held) and its encoder ms, host wall and
              device by CUDA events, with and without K16, in f32 and
              bf16, with K17 off and on.

3d. probes (after 3c) - P1-P3, the lowering probes of the JAX kernel
              tool (csrc/probe_mma.cu), on the tool's inputs: P1 (int8 .
              int8 -> int32) exact, P2 (int8 . bf16) and P3's contractions
              within 2e-5, its transposes exact, against their plain
              versions; their times, bounds and yardsticks
              (torch._int_mm for P1, an f32 torch.matmul for P3 (a),
              .t().contiguous() for P3 (d)) and time / yardstick; then
              P1 at ragged shapes, K staged whole and through its
              ring, unaligned rows (INT8_EDGES; exact, two runs
              identical); P2's kernel at ragged shapes (MIXED_EDGES: K
              not a multiple of 16, K past one panel, M and N of 33 and
              65, both tiles) and in P3 (b)'s and (i)'s operand forms
              and kin, within 2e-5, two runs identical; then
              P3's contraction at shapes the tool does not reach (K =
              1281, M and N of 33 and 65, a batch of 3 with split K, a
              transposed int8 A, the 2-stage ring) within 2e-5.
3e. probe_tool (after 3d) - the port's probe tool, the slice's entry
              point, as a user runs it: python -m whisper_apr_tpu_torch.
              tools.probe_layer_kernel --int8dot --tricks --large (a
              subprocess; it must exit 0 and print every case); its
              launch counts are the P1-P3 launches of the kernels line,
              and its large-v3 slope ms/step is printed beside the
              CUDA-graph step time of phase 3.
7c. formats (after 8b) - the tiny seed-0 weights written by the port as
              v1 and v2 .apr files in f32 and int8, each loaded on the card
              with a progress callback (monotone, ending at 1.0) and
              validated (AprValidator passes); f32 greedy tokens over 30 s
              of noise through K1-K4 from each v2 file equal its v1 twin's;
              so do phase 2b's compressed v1 int8 file's, its LZ4 blocks
              decoded by the host runtime (load time printed).
9. utils    - device_memory_stats on the card, the large-v3 H100 roofline
              floors beside the measured steps, run_pipeline_benchmark's
              mel / encode / decode split, and the trace_span events of
              phases 3d-9.

Before them a ``[native]`` line gives the host runtime's calls on the
main path (the held runs of 6b, 6c and 7c). The last three lines of
stdout are the kernel summary JSON, the card's
``nvidia-smi --query-gpu=name,power.limit`` line, and
``{"ok": true, "device": {...}}``. Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOKENS_FORCED = 224          # bench.py's protocol
AUDIO_SECONDS = 30.0
# bf16 outputs: kernel and plain version round the same f32 sums taken in
# another order, so they may land one or two bf16 ulps apart (ulp <= 2^-7
# of a value): tolerance 2^-6 of the reference's largest magnitude
TOL_BF16 = 2.0 ** -6
# f32 outputs: summation order only
TOL_F32 = 2e-5
# K16-K18's f32 tensor-core kernels against an f64 reference
# (F32_TERM_FLASH, F32_TERM_ROWS): their three-term splits keep every
# product above 2^-24 of it, so what is left is f32's rounding of the sums
# (under 6e-7 in a numpy emulation, 4.5e-7 at most on an H100 in
# chip_ab.py --f32, where the plain f32 versions come to 1.7e-6); a split
# short of one product (hi.lo, lo.hi or mid.mid), or of x's lo term, is
# 1.8e-6 or more away (tests/test_torch_optin_kernels.py
# TestFlashF32Terms, test_f32_matmul_terms_against_f64)
TOL_F32_TERMS = 1e-6
# fp8 rows: one e4m3 ulp is 2^-3 of the value
TOL_FP8 = 2.0 ** -3
# per-slot positions of the batched checks: both sides of every 64-row
# attention split, a slot with no history, and the last rows of a window
SLOT_POS = (0, 1, 63, 64, 127, 128, 129, 447)
# near-tie rule: K8 logits + argmax and K4's fused head sum in other
# orders, so a token may differ from per-clip transcribe only where the
# top two logits are closer than this
NEAR_TIE = 1e-4
# H100 SXM peaks for the bounds: HBM bytes/s and
# dense bf16 / f32 (CUDA cores) flop/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    if not (ROOT / "whisper_apr_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository "
                         "(whisper_apr_tpu_torch/ not found next to it)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} | CUDA {torch.version.cuda} | python "
        f"{sys.version.split()[0]}")
    return smi


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    import re
    from whisper_apr_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.library()
    ptxas = _build.library_path().with_suffix(".log")
    text = ptxas.read_text() if ptxas.exists() else ""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", text))
    log(f"[build] {_build.library_path().name}: "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{'%.2f s' % _build.build_seconds if _build.build_seconds else 'cached'}"
        f"); ptxas: {len(regs)} kernels, at most {max(regs, default=0)} "
        f"registers, {spills} bytes of spill stores in all")
    return lib


# ---------------------------------------------------------------------------
# phase 2b: the host runtime against its plain versions
# ---------------------------------------------------------------------------

# the resampler: the library's f64 taps against NumPy's, summed in another
# order; the frame energy: f64 sums in another order, rounded to f32
RESAMPLE_TOL = 1e-5
ENERGY_TOL = 1e-6


@contextlib.contextmanager
def lz4_plain():
    """Compressed .apr files decode their LZ4 blocks with the Python
    decoder: the library's binding answers None, as for a malformed
    block, and is not called."""
    from whisper_apr_tpu_torch import native
    real = native.lz4_decompress_block
    native.lz4_decompress_block = lambda src, cap: None
    try:
        yield
    finally:
        native.lz4_decompress_block = real


def phase_native(workdir: Path, cfg=None, seconds: float = 75.0,
                 crc_mb: int = 64, dtw_shape=(224, 1500)) -> dict:
    """Build the host runtime (native/aprcore.cpp, g++) and hold each of
    its six functions against its plain version on this machine's host,
    at the sizes users run: CRC-32 of ``crc_mb`` MB (zlib), the resampler
    on ``seconds`` at 44.1 and 48 kHz (NumPy, within RESAMPLE_TOL; the
    16 kHz identity exact), PCM16 of ``seconds`` of stereo (exact), the
    VAD's frame features (within ENERGY_TOL), LZ4 decoding of the e2e
    int8 model (``cfg``, whisper-tiny by default) written compressed (the
    same bytes as through the Python decoder and as its uncompressed
    twin's tensors) and the DTW over a ``dtw_shape`` cost (the same path).
    Each pair's host-clock times are data lines."""
    from whisper_apr_tpu_torch import ModelConfig, native
    from whisper_apr_tpu_torch.format import AprReader
    t0 = time.perf_counter()
    native.library()
    built = native.build_seconds
    log(f"[native] {native.library_path().name}: "
        f"{time.perf_counter() - t0:.2f} s (g++ "
        f"{'%.2f s' % built if built else 'cached'}, "
        f"{' '.join(native.FLAGS)})")
    rng = np.random.default_rng(31)
    pairs = {}

    def pair(name: str, what: str, lib_fn, plain_fn):
        t1 = time.perf_counter()
        got = lib_fn()
        t2 = time.perf_counter()
        want = plain_fn()
        t3 = time.perf_counter()
        pairs[name] = {"ms": 1e3 * (t2 - t1), "plain_ms": 1e3 * (t3 - t2)}
        log(f"[native] {name} ({what}): library {1e3 * (t2 - t1):.2f} ms, "
            f"plain {1e3 * (t3 - t2):.2f} ms (host clock)")
        return got, want

    data = rng.bytes(crc_mb << 20)
    got, want = pair("crc32", f"{crc_mb} MB, plain zlib",
                     lambda: native.crc32(data),
                     lambda: native.crc32_plain(data))
    assert got == want, f"[native] crc32 {got:#x} != zlib {want:#x}"
    del data

    diffs = []
    for rate in (44_100, 48_000):
        x = tone_noise(seconds, rate, seed=rate)
        got, want = pair(
            f"resample_sinc {rate}", f"{seconds:g} s to 16 kHz, plain NumPy",
            lambda: native.resample_sinc(x, rate, 16_000),
            lambda: native.resample_sinc_plain(x, rate, 16_000))
        assert got.shape == want.shape, (got.shape, want.shape)
        diffs.append(float(np.abs(got - want).max()))
        assert diffs[-1] <= RESAMPLE_TOL, f"[native] resample {rate}: " \
            f"max difference {diffs[-1]}"
    x = tone_noise(seconds, 16_000, seed=16)
    assert np.array_equal(native.resample_sinc(x, 16_000, 16_000), x)
    log(f"[native] resample_sinc max difference to NumPy {diffs} (tolerance"
        f" {RESAMPLE_TOL}); 16 kHz identity exact")

    pcm = rng.integers(-32768, 32768, 2 * int(seconds * 44_100),
                       dtype=np.int16)
    got, want = pair("pcm16_to_f32_mono", f"{seconds:g} s of 44.1 kHz "
                     "stereo, plain NumPy",
                     lambda: native.pcm16_to_f32_mono(pcm, 2),
                     lambda: native.pcm16_to_f32_mono_plain(pcm, 2))
    assert np.array_equal(got, want), "[native] pcm16 differs"

    (energy, zcr), (p_energy, p_zcr) = pair(
        "frame_energy_zcr", f"{seconds:g} s at 16 kHz, 30 ms frames, "
        "plain NumPy", lambda: native.frame_energy_zcr(x, 480),
        lambda: native.frame_energy_zcr_plain(x, 480))
    e_diff = float(np.abs(energy - p_energy).max())
    assert e_diff <= ENERGY_TOL and np.array_equal(zcr, p_zcr), \
        f"[native] frame energy differs by {e_diff} or zcr differs"

    cfg = cfg or ModelConfig.tiny()
    lz4_apr = workdir / f"whisper-{cfg.model_type}-random-int8-lz4.apr"
    twin_apr = workdir / f"whisper-{cfg.model_type}-random-int8.apr"
    t1 = time.perf_counter()
    write_random_apr(lz4_apr, cfg, compressed=True)
    write_s = time.perf_counter() - t1
    write_random_apr(twin_apr, cfg)
    data = lz4_apr.read_bytes()
    # the blocks a load hands the library, then each block's decode and
    # the whole load, through the library and through the Python decoder
    blocks = []
    real = native.lz4_decompress_block
    native.lz4_decompress_block = lambda src, cap: (
        blocks.append((src, cap)), real(src, cap))[1]
    try:
        t1 = time.perf_counter()
        got = AprReader(data)
        load_s = time.perf_counter() - t1
    finally:
        native.lz4_decompress_block = real
    with lz4_plain():
        t1 = time.perf_counter()
        want = AprReader(data)
        plain_load_s = time.perf_counter() - t1
    dec, plain_dec = pair(
        "lz4_decompress_block", f"the {len(blocks)} compressed blocks of a "
        f"{len(data) / 1e6:.1f} MB {cfg.model_type} int8 .apr, plain Python",
        lambda: [native.lz4_decompress_block(b, c) for b, c in blocks],
        lambda: [native.lz4_decompress_block_plain(b, c) for b, c in blocks])
    twin = AprReader(twin_apr.read_bytes())
    assert blocks and dec == plain_dec and got._payload == want._payload \
        and all(np.array_equal(got.load_raw(n), twin.load_raw(n))
                for n in twin.tensor_names()), "[native] LZ4 payload differs"
    log(f"[native] lz4: blocks == Python decoder's, payload too, tensors == "
        f"the uncompressed twin's ({len(twin.tensor_names())}); the whole "
        f"load {load_s * 1e3:.2f} ms through the library, "
        f"{plain_load_s * 1e3:.2f} ms through the Python decoder (host "
        f"clock); the Python compressor wrote the file in {write_s:.1f} s")

    cost = rng.normal(size=dtw_shape).astype(np.float32)
    got, want = pair("dtw_path", f"{dtw_shape[0]} x {dtw_shape[1]} cost, "
                     "plain NumPy DP", lambda: native.dtw_path(cost),
                     lambda: native.dtw_path_plain(cost))
    assert all(np.array_equal(a, b) for a, b in zip(got, want)), \
        "[native] DTW paths differ"
    return {"build_s": native.build_seconds, "pairs": pairs,
            "resample_max_diff": max(diffs), "energy_max_diff": e_diff,
            "lz4_calls": len(blocks), "lz4_apr": lz4_apr,
            "lz4_load_ms": 1e3 * load_s,
            "lz4_plain_load_ms": 1e3 * plain_load_s,
            "lz4_write_s": write_s}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of one call, CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    replayed ``replays`` times between CUDA events (no host launch cost)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref| (floats compared in f32)."""
    g, r = got.float(), ref.float()
    return float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))


def abs_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def make_blk(D: int, L: int, gen, device):
    """Random int8 decoder stacks in the prepare_qdecode layout (checked
    by ``check_blk``, as prepare_qdecode checks its own)."""
    import torch
    from whisper_apr_tpu_torch.ops.decode_blocks import check_blk
    H4 = 4 * D

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device,
                             dtype=torch.int8)

    def f32(*shape, lo=0.5, hi=1.5):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    s = 1.0 / (127.0 * np.sqrt(D))          # keeps matvec outputs O(1)
    blk = {
        "ln1_w": f32(L, 1, D), "ln1_b": f32(L, 1, D, lo=-0.1, hi=0.1),
        "ln2_w": f32(L, 1, D), "ln2_b": f32(L, 1, D, lo=-0.1, hi=0.1),
        "ln3_w": f32(L, 1, D), "ln3_b": f32(L, 1, D, lo=-0.1, hi=0.1),
        "wqkv": i8(L, D, 3 * D), "sqkv": f32(L, 1, 3 * D) * s * 4,
        "bqkv": f32(L, 1, 3 * D, lo=-0.1, hi=0.1),
        "self_wo": i8(L, D, D), "self_wos": f32(L, 1, D) * s,
        "self_wob": f32(L, 1, D, lo=-0.1, hi=0.1),
        "wcq": i8(L, D, D), "scq": f32(L, 1, D) * s * 4,
        "bcq": f32(L, 1, D, lo=-0.1, hi=0.1),
        "cross_wo": i8(L, D, D), "cross_wos": f32(L, 1, D) * s,
        "cross_wob": f32(L, 1, D, lo=-0.1, hi=0.1),
        "w1": i8(L, D, H4), "s1": f32(L, 1, H4) * s,
        "b1": f32(L, 1, H4, lo=-0.1, hi=0.1),
        "w2": i8(L, H4, D), "fc2_s": f32(L, 1, D) / (127.0 * np.sqrt(H4)),
        "fc2_b": f32(L, 1, D, lo=-0.1, hi=0.1),
    }
    check_blk(blk)
    return blk


def make_cache(mode: str, L: int, T: int, D: int, gen, device, cdt,
               B: int = 1):
    """(kq, ks, vq, vs) of one [L, B, T, D] cache in ``mode``: "rows"
    (compute dtype), "int8" (rows + f32 scales) or "fp8"; checked by
    ``check_cache``, as quantize_cache checks its own."""
    import torch
    from whisper_apr_tpu_torch.ops.decode_attention import quantize_rows
    from whisper_apr_tpu_torch.ops.decode_blocks import check_cache
    rows = [torch.randn((L, B, T, D), generator=gen, device=device)
            for _ in range(2)]
    if mode == "int8":
        (kq, ks), (vq, vs) = quantize_rows(rows[0]), quantize_rows(rows[1])
    else:
        dt = torch.float8_e4m3fn if mode == "fp8" else cdt
        kq, ks, vq, vs = rows[0].to(dt), None, rows[1].to(dt), None
    check_cache(kq, ks, vq, vs)
    return kq, ks, vq, vs


def head_case(n_vocab: int, x, gen, tie=None):
    """K4's operands for x [M, D]: the vocab lane-padded to 128, a planted
    tie (bias 1e6 on two equal columns, above any random logit; by default
    across strips far apart, else the columns ``tie``), real
    suppressions, and padding columns that would win for the first row if
    not masked. Returns (wq, bias, (first, second)) of the tie."""
    import torch
    dev, D = x.device, x.shape[1]
    v_pad = n_vocab + (-n_vocab) % 128
    wq = torch.randint(-127, 128, (1, D, v_pad), generator=gen, device=dev,
                       dtype=torch.int8)
    first, second = tie or (n_vocab // 40, n_vocab * 3 // 4)
    wq[0, :, second] = wq[0, :, first]
    wq[0, :, n_vocab:] = (127 * torch.sign(x[0].float())).to(torch.int8)[:, None]
    bias = torch.zeros((1, v_pad), device=dev)
    bias[0, [first, second]] = 1e6
    bias[0, n_vocab - 100:n_vocab - 50] = float("-inf")
    return wq, bias, (first, second)


# K4's rows: one, either side of an 8-row tile, one launch's 32 and the
# 32-row chunking above; its ties within one 128-column strip and across
# strips
HEAD_ROWS = (1, 8, 9, 32, 33, 40)
HEAD_TIES = ((5, 120), (127, 128), (255, 256))


def check_head_edges(D: int, n_vocab: int, cdt, label: str,
                     seed: int) -> float:
    """K4 against its plain version at every ``HEAD_ROWS`` row count: a
    planted tie at each ``HEAD_TIES`` pair (every row takes the first),
    the winner in the last real column beside padding columns that would
    win if not masked, and every logit -inf (token 0, max and lse -inf),
    each call twice: the two runs must give the same bits. Tokens exact,
    max and lse within 1e-5 of max(1, |plain|). Returns the max abs error
    of max and lse (finite rows)."""
    import torch
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    for M in HEAD_ROWS:
        x = torch.randn((M, D), generator=gen, device=dev).to(cdt)
        cases = []
        for tie in HEAD_TIES:
            wq, bias, (first, _) = head_case(n_vocab, x, gen, tie)
            cases.append((f"tie {tie}", wq, bias, first))
        bias = torch.zeros_like(bias)
        bias[0, n_vocab - 1] = 1e6
        bias[0, n_vocab:] = 2e6
        cases.append(("last column", wq, bias, n_vocab - 1))
        cases.append(("all -inf", wq, torch.full_like(bias, float("-inf")),
                      0))
        for what, wq, bias, want in cases:
            name = f"[{label}] head M={M} {what}"
            got = qm.qmatvec_greedy_head(x, wq, bias, n_vocab)
            again = qm.qmatvec_greedy_head(x, wq, bias, n_vocab)
            ref = qm.qmatvec_greedy_head_plain(x, wq, bias, n_vocab)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (
                f"{name}: two runs differ")
            assert got[0].tolist() == ref[0].tolist() == [want] * M, (
                f"{name}: kernel {got[0].tolist()}, plain "
                f"{ref[0].tolist()}, want {want}")
            for i in (1, 2):
                if what == "all -inf":
                    assert torch.equal(got[i], ref[i]) and bool(
                        (got[i] == float("-inf")).all()), (
                        f"{name}: output {i} {got[i].tolist()}")
                    continue
                e = float(((got[i] - ref[i]).abs()
                           / ref[i].abs().clamp_min(1.0)).max())
                assert e <= 1e-5, f"{name}: output {i} rel err {e:.3g}"
                worst = max(worst, abs_err(got[i], ref[i]))
        del cases
    check_head_scratch(label)
    log(f"[kernels] {label}: K4 at M in {list(HEAD_ROWS)}, ties "
        f"{list(HEAD_TIES)}, the last real column and all -inf agrees with "
        f"the plain version, two runs bit-identical, its scratch left zero; "
        f"max abs err {worst:.3g}")
    return worst


def check_head_scratch(label: str) -> None:
    """K4 leaves its partials and ticket zero (its workspaces on every
    stream), as the next launch, a grown buffer and a CUDA graph's replay
    rely on."""
    import torch
    from whisper_apr_tpu_torch.ops import _build
    torch.cuda.synchronize()
    for (_, name, _), buf in _build._workspaces.items():
        if name in ("head_part", "head_ticket"):
            assert not bool(buf.any()), f"[{label}] K4 left its {name} nonzero"


def check_head_graph(D: int, n_vocab: int, cdt, label: str, seed: int,
                     M: int = 8, replays: int = 4) -> None:
    """K4 captured in a CUDA graph on a stream that first meets it there
    (its scratch allocated, and zeroed, inside the capture, so that each
    replay zeroes it again) and replayed over new x: every replay agrees
    with the plain version (tokens exact, max and lse within 1e-5 of
    max(1, |plain|)) and leaves the scratch zero."""
    import torch
    from whisper_apr_tpu_torch.ops import _build
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, D), generator=gen, device=dev).to(cdt)
    wq, bias, _ = head_case(n_vocab, x, gen)
    bias[bias == 1e6] = 0.0             # no planted tie: tokens follow x
    side = torch.cuda.Stream()
    for key in [k for k in _build._workspaces
                if k[0] == side.cuda_stream and k[1].startswith("head_")]:
        del _build._workspaces[key]     # a pooled stream K4 met before
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = qm.qmatvec_greedy_head(x, wq, bias, n_vocab)
    for r in range(replays):
        x.copy_(torch.randn((M, D), generator=gen, device=dev))
        graph.replay()
        ref = qm.qmatvec_greedy_head_plain(x, wq, bias, n_vocab)
        torch.cuda.synchronize()
        name = f"[{label}] head graph replay {r}"
        assert got[0].tolist() == ref[0].tolist(), (
            f"{name}: kernel {got[0].tolist()}, plain {ref[0].tolist()}")
        for i in (1, 2):
            e = float(((got[i] - ref[i]).abs()
                       / ref[i].abs().clamp_min(1.0)).max())
            assert e <= 1e-5, f"{name}: output {i} rel err {e:.3g}"
    check_head_scratch(label)
    log(f"[kernels] {label}: K4 in a CUDA graph (scratch allocated in the "
        f"capture) agrees with the plain version over {replays} replays of "
        f"new x, its scratch left zero")


def check_row(name, got, ref, floor: float = 0.0):
    """Emitted cache rows / scales: int8 within one step, fp8 within one
    e4m3 ulp, floats as the outputs; float rows within at least ``floor``
    (the tolerance of the activations they were computed from: f32 rows
    of bf16 activations carry the bf16 LayerNorm output's rounding)."""
    import torch
    if got.dtype == torch.int8:
        d = (got.int() - ref.int()).abs().max().item()
        assert d <= 1, f"{name}: int8 rows differ by {d}"
        return
    tol = max(floor, TOL_FP8 if got.dtype == torch.float8_e4m3fn else (
        TOL_BF16 if got.dtype == torch.bfloat16 else TOL_F32))
    e = rel_err(got, ref)
    assert e <= tol, f"{name}: rel err {e:.3g} > {tol:.3g}"


# K1's positions: no history, one row, either side of one and two rows a
# block of its cluster (8 blocks a head at large-v3, 16 at whisper-tiny),
# either side of 128, and the last row of a 448-token window
SELF_EDGES = (0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 127, 128, 129, 447)


def check_kernels(D: int, H: int, L: int, n_vocab: int, T_self: int,
                  T_cross: int, enc_len: int, cdt, label: str, seed: int):
    """K1-K4 against the plain versions at one shape, K1 at every
    ``SELF_EDGES`` position and K3 at layers 0, L/2 and L-1, each of their
    calls twice: the two runs must give the same bits. Returns the max abs
    error of each kernel's block output."""
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    blk = make_blk(D, L, gen, dev)
    tol = TOL_BF16 if cdt == torch.bfloat16 else TOL_F32
    worst = {"self_block": 0.0, "cross_block": 0.0, "ffn_block": 0.0,
             "qmatvec_greedy_head": 0.0}

    def x_in():
        return torch.randn((1, D), generator=gen, device=dev).to(cdt)

    modes = ("rows", "int8", "fp8")
    ties = 0
    for mode in modes:
        kq, ks, vq, vs = make_cache(mode, L, T_self, D, gen, dev, cdt)
        for pos in SELF_EDGES:
            layer = (pos * 7) % L
            x = x_in()
            got = db.self_block(x, blk, kq, ks, vq, vs, pos, layer, H)
            again = db.self_block(x, blk, kq, ks, vq, vs, pos, layer, H)
            with quantized_rows(db) as pre:
                ref = db.self_block_plain(x, blk, kq, ks, vq, vs, pos, layer,
                                          H)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (
                f"[{label}] self_block {mode} pos {pos}: two runs differ")
            for i, what in ((1, "k_row"), (3, "v_row"), (2, "k_scale"),
                            (4, "v_scale")):
                check_row(f"[{label}] self_block {mode} pos {pos} {what}",
                          got[i], ref[i])
            if mode == "int8":
                # elements of the new rows a step off at a rounding tie
                # take the kernel's side; any other stays the plain's
                exact = exact_qkv(db, x, blk, layer)
                tie = [rounding_ties(got[i], ref[i], pre[j],
                                     exact[:, (j + 1) * D:(j + 2) * D],
                                     f"[{label}] self_block pos {pos}")
                       for j, i in enumerate((1, 3))]
                if any(t.any() for t in tie):
                    ties += int(sum(t.sum() for t in tie))
                    rows = [torch.where(t, got[i], ref[i])
                            for t, i in zip(tie, (1, 3))]
                    with quantized_rows(db, rows):
                        ref = db.self_block_plain(x, blk, kq, ks, vq, vs, pos,
                                                  layer, H)
            e = rel_err(got[0], ref[0])
            assert e <= tol, (f"[{label}] self_block {mode} pos {pos}: rel "
                              f"err {e:.3g} > {tol:.3g}")
            worst["self_block"] = max(worst["self_block"],
                                      abs_err(got[0], ref[0]))
        kq, ks, vq, vs = make_cache(mode, L, T_cross, D, gen, dev, cdt)
        for layer in (0, L - 1):
            x = x_in()
            got = db.cross_block(x, blk, kq, ks, vq, vs, enc_len, layer, H)
            ref = db.cross_block_plain(x, blk, kq, ks, vq, vs, enc_len,
                                       layer, H)
            e = rel_err(got, ref)
            assert e <= tol, (f"[{label}] cross_block {mode} layer {layer}:"
                              f" rel err {e:.3g} > {tol:.3g}")
            worst["cross_block"] = max(worst["cross_block"],
                                       abs_err(got, ref))
    for layer in (0, L // 2, L - 1):
        x = x_in()
        got, ref = db.ffn_block(x, blk, layer), db.ffn_block_plain(x, blk,
                                                                   layer)
        again = db.ffn_block(x, blk, layer)
        torch.cuda.synchronize()
        assert torch.equal(got, again), (
            f"[{label}] ffn_block layer {layer}: two runs differ")
        e = rel_err(got, ref)
        assert e <= tol, f"[{label}] ffn_block layer {layer}: rel err {e:.3g}"
        worst["ffn_block"] = max(worst["ffn_block"], abs_err(got, ref))

    x = x_in()
    wq, bias, (first, second) = head_case(n_vocab, x, gen)
    got = qm.qmatvec_greedy_head(x, wq, bias, n_vocab)
    ref = qm.qmatvec_greedy_head_plain(x, wq, bias, n_vocab)
    assert int(got[0]) == int(ref[0]) == first, (
        f"[{label}] head tie: kernel {int(got[0])}, plain {int(ref[0])}, "
        f"want {first}")
    bias[0, [first, second]] = 0.0
    for _ in range(3):
        x = x_in()
        got = qm.qmatvec_greedy_head(x, wq, bias, n_vocab)
        ref = qm.qmatvec_greedy_head_plain(x, wq, bias, n_vocab)
        assert int(got[0]) == int(ref[0]), f"[{label}] head argmax differs"
        for i in (1, 2):
            e = abs_err(got[i], ref[i]) / max(1.0, float(ref[i].abs()))
            assert e <= 1e-5, f"[{label}] head output {i}: rel err {e:.3g}"
            worst["qmatvec_greedy_head"] = max(worst["qmatvec_greedy_head"],
                                               abs_err(got[i], ref[i]))
    torch.cuda.synchronize()
    log(f"[kernels] {label}: K1-K4 agree with the plain versions, K1 and K3 "
        f"two runs bit-identical ({ties} K1 int8 elements a step off at a "
        f"rounding tie); max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return worst, blk


@contextlib.contextmanager
def quantized_rows(db, rows=None):
    """K1's and K5's plain version (module ``db``) rounds the new k and v
    rows through ``db.quantize_row`` (int8 rows) or ``db.cast_row``
    (float rows): the yielded list collects what they are given (the f32
    k, then v, before rounding); with ``rows`` (k_row, v_row) the call
    returns those rows (int8: at its own scales)."""
    seen = []
    quantize_row, cast_row = db.quantize_row, db.cast_row

    def record(t):
        q, scale = quantize_row(t)
        seen.append(t)
        return (q if rows is None else rows[len(seen) - 1]), scale

    def record_cast(t, dtype):
        seen.append(t)
        return cast_row(t, dtype) if rows is None else rows[len(seen) - 1]

    db.quantize_row, db.cast_row = record, record_cast
    try:
        yield seen
    finally:
        db.quantize_row, db.cast_row = quantize_row, cast_row


def exact_qkv(db, x, blk, layer: int):
    """K1's and K5's projection in f64 from the plain version's LayerNorm
    output (rounded to x's dtype as it is): [B, 3D], the sums all but
    exact."""
    l = layer
    h = db.layer_norm(x.float(), blk["ln1_w"][l, 0], blk["ln1_b"][l, 0])
    h = h.to(x.dtype).double()
    return (h @ blk["wqkv"][l].double()) * blk["sqkv"][l].double() \
        + blk["bqkv"][l].double()


# a rounding tie: the plain version's value before rounding (in steps)
# within TIE_SPAN times its row's largest f32 error of a half step; at most
# TIE_MAX of them a row. K12's k-quant projection takes each group's
# S (h . q) - Z sum(h), two terms of about the result's size, so its f32
# error is several times an int8 projection's and more of a row's
# elements sit that near a boundary (9 of 1280 seen in a large-v3 bf16
# row): at most KQ_TIE_MAX of them
TIE_SPAN, TIE_MAX, KQ_TIE_MAX = 8.0, 4, 32


def float_ties(got, ref, pre, exact, name: str, max_ties: int = TIE_MAX):
    """As ``rounding_ties`` for rows of a float cache narrower than f32
    (bf16, fp8): the elements where K5's new row ``got`` and the plain
    version's ``ref`` are neighbours with the plain version's value before
    rounding, ``pre``, within ``TIE_SPAN`` times the row's largest f32
    error (against the f64 ``exact``) of the rounding boundary between
    them. A bool mask like ``got``; raises past ``max_ties`` such
    elements in a row."""
    mid = (got.double() + ref.double()) / 2
    err = (pre.double() - exact).abs().amax()
    tie = (got != ref) & ((pre.double() - mid).abs() <= TIE_SPAN * err)
    n = int(tie.sum(-1).max())
    assert n <= max_ties, (f"{name}: {n} elements of a row a step off at "
                           f"rounding ties, more than {max_ties}")
    return tie


def rounding_ties(got, ref, pre, exact, name: str, max_ties: int = TIE_MAX):
    """The elements where K1's new int8 row ``got`` and the plain
    version's ``ref`` differ (by one step: ``check_row``) at a rounding
    tie: the plain version's value before rounding, ``pre`` / its row
    scale, lies within ``TIE_SPAN`` times the row's largest f32 error
    (against the f64 ``exact``, in steps) of a half step, so another f32
    summation order may round it the other way. A bool mask like
    ``got``; raises past ``max_ties`` such elements in a row."""
    def steps(v):
        return v / (v.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 127)

    q = steps(pre.float())                 # as quantize_rows divides
    err = (q.double() - steps(exact)).abs().amax()
    half = (q.abs() - q.abs().floor() - 0.5).abs().double()
    tie = (got != ref) & (half <= TIE_SPAN * err)
    n = int(tie.sum(-1).max())
    assert n <= max_ties, (f"{name}: {n} int8 elements of a row a step off "
                           f"at rounding ties, more than {max_ties}")
    return tie


# K2's edges: no valid row (every padded row at NEG), one row, either side
# of 64 (a row group's span), and the last rows of 1500 frames; each cache
# dtype K2 takes, in its own name: int8 (+ f32 row scales), bf16, f32, fp8
CROSS_EDGES = (0, 1, 63, 64, 65, 1499, 1500)
CROSS_CACHES = (("int8", "int8", None), ("bf16", "rows", "bfloat16"),
                ("f32", "rows", "float32"), ("fp8", "fp8", None))


def check_cross(D: int, H: int, cdt, label: str, seed: int, L: int = 2,
                T: int = 1536) -> float:
    """K2 against its plain version at every cache dtype and every
    ``CROSS_EDGES`` length over a [L, 1, T, D] cache, each call twice: the
    two runs must give the same bits. Returns the max abs error."""
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    blk = make_blk(D, L, gen, dev)
    tol = TOL_BF16 if cdt == torch.bfloat16 else TOL_F32
    worst = 0.0
    for name, mode, rows_dt in CROSS_CACHES:
        dt = cdt if rows_dt is None else getattr(torch, rows_dt)
        kq, ks, vq, vs = make_cache(mode, L, T, D, gen, dev, dt)
        for enc_len in CROSS_EDGES:
            layer = enc_len % L
            x = torch.randn((1, D), generator=gen, device=dev).to(cdt)
            got = db.cross_block(x, blk, kq, ks, vq, vs, enc_len, layer, H)
            again = db.cross_block(x, blk, kq, ks, vq, vs, enc_len, layer,
                                   H)
            ref = db.cross_block_plain(x, blk, kq, ks, vq, vs, enc_len,
                                       layer, H)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (
                f"[{label}] cross_block {name} enc_len {enc_len}: two runs "
                f"differ")
            e = rel_err(got, ref)
            assert e <= tol, (f"[{label}] cross_block {name} enc_len "
                              f"{enc_len}: rel err {e:.3g} > {tol:.3g}")
            worst = max(worst, abs_err(got, ref))
        del kq, ks, vq, vs
    log(f"[kernels] {label}: K2 at enc_len {list(CROSS_EDGES)} over "
        f"{', '.join(n for n, *_ in CROSS_CACHES)} rows agrees with the "
        f"plain version, two runs bit-identical; max abs err {worst:.3g}")
    return worst


# K5's and K6's slot counts: a pair, odd, a full tile of the serving tick,
# a full launch and two launches (32 + 8)
BATCH_EDGES = (2, 5, 8, 32, 40)


def check_batched_edges(D: int, H: int, cdt, label: str, seed: int,
                        L: int = 2, T_self: int = 512,
                        T_cross: int = 1536) -> dict:
    """K5 and K6 against their plain versions at every ``BATCH_EDGES``
    slot count and cache dtype (``CROSS_CACHES``): K5 with the
    ``SLOT_POS`` positions mixed within the batch, K6 at every
    ``CROSS_EDGES`` length, each call twice: the two runs must give the
    same bits. Elements of K5's new rows a step off at a rounding tie
    (int8, bf16 and fp8 rows) take the kernel's side, as in
    ``check_kernels``. Returns the max abs error of each kernel's block
    output."""
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    blk = make_blk(D, L, gen, dev)
    tol = TOL_BF16 if cdt == torch.bfloat16 else TOL_F32
    worst = {"self_block_batched": 0.0, "cross_block_batched": 0.0}
    ties = 0

    def agree(name, got, ref, what):
        e = rel_err(got, ref)
        assert e <= tol, (f"[{label}] {name} {what}: rel err {e:.3g} > "
                          f"{tol:.3g}")
        worst[name] = max(worst[name], abs_err(got, ref))

    for name, mode, rows_dt in CROSS_CACHES:
        dt = cdt if rows_dt is None else getattr(torch, rows_dt)
        for B in BATCH_EDGES:
            pos = torch.tensor([SLOT_POS[(3 * i + B) % len(SLOT_POS)]
                                for i in range(B)], dtype=torch.int32,
                               device=dev)
            kq, ks, vq, vs = make_cache(mode, L, T_self, D, gen, dev, dt, B)
            layer = B % L
            x = torch.randn((B, D), generator=gen, device=dev).to(cdt)
            what = f"{name} B {B}"
            got = db.self_block_batched(x, blk, kq, ks, vq, vs, pos, layer,
                                        H)
            again = db.self_block_batched(x, blk, kq, ks, vq, vs, pos,
                                          layer, H)
            with quantized_rows(db) as pre:
                ref = db.self_block_plain(x, blk, kq, ks, vq, vs, pos, layer,
                                          H)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (
                f"[{label}] self_block_batched {what}: two runs differ")
            for i, row in ((1, "k_row"), (3, "v_row"), (2, "k_scale"),
                           (4, "v_scale")):
                check_row(f"[{label}] self_block_batched {what} {row}",
                          got[i], ref[i], tol)
            if got[1].dtype != torch.float32:     # rows rounded from f32
                exact = exact_qkv(db, x, blk, layer)
                ties_of = rounding_ties if mode == "int8" else float_ties
                tie = [ties_of(got[i], ref[i], pre[j],
                               exact[:, (j + 1) * D:(j + 2) * D],
                               f"[{label}] self_block_batched {what}")
                       for j, i in enumerate((1, 3))]
                if any(t.any() for t in tie):
                    ties += int(sum(t.sum() for t in tie))
                    rows = [torch.where(t, got[i], ref[i])
                            for t, i in zip(tie, (1, 3))]
                    with quantized_rows(db, rows):
                        ref = db.self_block_plain(x, blk, kq, ks, vq, vs, pos,
                                                  layer, H)
            agree("self_block_batched", got[0], ref[0],
                  f"{what} pos {pos.tolist()}")
            del kq, ks, vq, vs
            kq, ks, vq, vs = make_cache(mode, L, T_cross, D, gen, dev, dt, B)
            for enc_len in CROSS_EDGES:
                layer = enc_len % L
                x = torch.randn((B, D), generator=gen, device=dev).to(cdt)
                got = db.cross_block_batched(x, blk, kq, ks, vq, vs, enc_len,
                                             layer, H)
                again = db.cross_block_batched(x, blk, kq, ks, vq, vs,
                                               enc_len, layer, H)
                ref = db.cross_block_plain(x, blk, kq, ks, vq, vs, enc_len,
                                           layer, H)
                torch.cuda.synchronize()
                assert torch.equal(got, again), (
                    f"[{label}] cross_block_batched {what} enc_len "
                    f"{enc_len}: two runs differ")
                agree("cross_block_batched", got, ref,
                      f"{what} enc_len {enc_len}")
            del kq, ks, vq, vs
            torch.cuda.empty_cache()
    log(f"[kernels] {label}: K5 and K6 at B in {list(BATCH_EDGES)} over "
        f"{', '.join(n for n, *_ in CROSS_CACHES)} rows (K5 at per-slot "
        f"positions from {list(SLOT_POS)}, K6 at enc_len "
        f"{list(CROSS_EDGES)}) agree with the plain versions, two runs "
        f"bit-identical ({ties} elements of K5's new rows a step off at a "
        f"rounding tie); max abs err " + ", ".join(f"{k} {v:.3g}"
                                          for k, v in worst.items()))
    return worst


def time_kernels(blk, D: int, H: int, L: int, n_vocab: int, T_self: int,
                 T_cross: int, enc_len: int, pos: int, label: str, seed: int):
    """Kernel and plain times (ms per call) at the main path's shapes:
    bf16 activations, compute-dtype self rows, int8 cross rows (cross8).
    "ms"/"plain_ms" are device times (CUDA-graph replay); "eager_*" are
    CUDA-event times of eager calls, host launch cost included."""
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cdt = torch.bfloat16
    sk, _, sv, _ = make_cache("rows", L, T_self, D, gen, dev, cdt)
    ck, cks, cv, cvs = make_cache("int8", L, T_cross, D, gen, dev, cdt)
    x = torch.randn((1, D), generator=gen, device=dev).to(cdt)
    v_pad = n_vocab + (-n_vocab) % 128
    wq = torch.randint(-127, 128, (1, D, v_pad), generator=gen, device=dev,
                       dtype=torch.int8)
    bias = torch.zeros((1, v_pad), device=dev)
    ones = torch.ones((1, 1, v_pad), device=dev)
    layer = L - 1
    cases = {
        "self_block": (
            lambda: db.self_block(x, blk, sk, None, sv, None, pos, layer, H),
            lambda: db.self_block_plain(x, blk, sk, None, sv, None, pos,
                                        layer, H)),
        "cross_block": (
            lambda: db.cross_block(x, blk, ck, cks, cv, cvs, enc_len, layer,
                                   H),
            lambda: db.cross_block_plain(x, blk, ck, cks, cv, cvs, enc_len,
                                         layer, H)),
        "ffn_block": (lambda: db.ffn_block(x, blk, layer),
                      lambda: db.ffn_block_plain(x, blk, layer)),
        "qmatvec_greedy_head": (
            lambda: qm.qmatvec_greedy_head(x, wq, bias, n_vocab),
            lambda: qm.qmatvec_greedy_head_plain(x, wq, bias, n_vocab)),
        # the logits tail of beam, sampling and timestamps at one row
        "qmatvec_stacked": (
            lambda: qm.qmatvec_stacked(x, wq, ones, 0,
                                       out_dtype=torch.float32),
            lambda: qm.qmatvec_stacked_plain(x, wq, ones, 0,
                                             out_dtype=torch.float32)),
        "ffn_fused": (
            lambda: qm.ffn_fused(x, blk["w1"], blk["s1"], blk["b1"],
                                 blk["w2"], layer),
            lambda: qm.ffn_fused_plain(x, blk["w1"], blk["s1"], blk["b1"],
                                       blk["w2"], layer)),
        **k8_scan_cases(x, blk, layer),
    }

    def stack(kernels: bool):
        """The decode step's kernel part: L x (K1, K2, K3), then K4."""
        sb, cb, fb, hd = ((db.self_block, db.cross_block, db.ffn_block,
                           qm.qmatvec_greedy_head) if kernels else
                          (db.self_block_plain, db.cross_block_plain,
                           db.ffn_block_plain, qm.qmatvec_greedy_head_plain))

        def run():
            y = x
            for lyr in range(L):
                y = sb(y, blk, sk, None, sv, None, pos, lyr, H)[0]
                y = cb(y, blk, ck, cks, cv, cvs, enc_len, lyr, H)
                y = fb(y, blk, lyr)
            return hd(y, wq, bias, n_vocab)
        return run

    cases["layer_stack"] = (stack(True), stack(False))
    shapes = {"self_block": dict(rows=pos, cache_bytes=2),
              "cross_block": dict(rows=enc_len, cache_bytes=1, scales=True),
              "ffn_block": {}, "qmatvec_greedy_head": {},
              "qmatvec_stacked": {}, "ffn_fused": {},
              "qmatvec_stacked_qkv": {}, "qmatvec_stacked_dd": {}}
    out = {}
    for name, (kern, plain) in cases.items():
        # plain, kernel, kernel, plain: report the better of each pair
        p1, k1, k2, p2 = (graph_ms(plain), graph_ms(kern), graph_ms(kern),
                          graph_ms(plain))
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "eager_ms": cuda_ms(kern), "eager_plain_ms": cuda_ms(plain)}
        if name in shapes:
            out[name]["bound_ms"], out[name]["bound_by"] = bound(
                name, D, 1, n_vocab, **shapes[name])
            out[name]["library_ms"] = None
    out["qmatvec_stacked"]["library_ms"] = library_int8_mm(x, wq)
    k8_scan_library(out, x, blk, layer)
    log(f"[time] {label} (pos {pos}, cross8 rows, bf16), device ms per call "
        f"(eager ms): " + ", ".join(
            f"{k} {v['ms']:.4f} ({v['eager_ms']:.4f}) vs plain "
            f"{v['plain_ms']:.4f} ({v['eager_plain_ms']:.4f})"
            for k, v in out.items()))
    return out


def check_batched(blk, D: int, H: int, L: int, n_vocab: int, T_self: int,
                  T_cross: int, enc_len: int, cdt, label: str, seed: int,
                  batches=(2, 4, 8)):
    """K5-K8 and K4 at M = B against the plain versions at one shape, for
    each B: per-slot positions mixed within the batch (SLOT_POS), every
    cache form, a layer > 0 of the stacks; returns the max abs error of
    each kernel's output."""
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tol = TOL_BF16 if cdt == torch.bfloat16 else TOL_F32
    worst = dict.fromkeys(["self_block_batched", "cross_block_batched",
                           "ffn_block_batched", "qmatvec_stacked",
                           "qmatvec_greedy_head"], 0.0)

    def x_in(B):
        return torch.randn((B, D), generator=gen, device=dev).to(cdt)

    def agree(name, got, ref, what):
        e = rel_err(got, ref)
        assert e <= tol, (f"[{label}] {name} {what}: rel err {e:.3g} > "
                          f"{tol:.3g}")
        worst[name] = max(worst[name], abs_err(got, ref))

    for B in batches:
        pos = torch.tensor([SLOT_POS[(i * len(SLOT_POS)) // B]
                            for i in range(B)], dtype=torch.int32, device=dev)
        for mode in ("rows", "int8", "fp8"):
            kq, ks, vq, vs = make_cache(mode, L, T_self, D, gen, dev, cdt, B)
            layer = (B * 3) % L
            x = x_in(B)
            got = db.self_block_batched(x, blk, kq, ks, vq, vs, pos, layer,
                                        H)
            ref = db.self_block_plain(x, blk, kq, ks, vq, vs, pos, layer, H)
            agree("self_block_batched", got[0], ref[0],
                  f"B {B} {mode} pos {pos.tolist()}")
            for i, what in ((1, "k_row"), (3, "v_row"), (2, "k_scale"),
                            (4, "v_scale")):
                check_row(f"[{label}] self_block_batched B {B} {mode} "
                          f"{what}", got[i], ref[i])
            del kq, ks, vq, vs
            kq, ks, vq, vs = make_cache(mode, L, T_cross, D, gen, dev, cdt, B)
            for layer in (0, L - 1):
                x = x_in(B)
                got = db.cross_block_batched(x, blk, kq, ks, vq, vs, enc_len,
                                             layer, H)
                ref = db.cross_block_plain(x, blk, kq, ks, vq, vs, enc_len,
                                           layer, H)
                agree("cross_block_batched", got, ref,
                      f"B {B} {mode} layer {layer}")
            del kq, ks, vq, vs
            torch.cuda.empty_cache()
        for layer in (0, L - 1):
            x = x_in(B)
            agree("ffn_block_batched", db.ffn_block_batched(x, blk, layer),
                  db.ffn_block_plain(x, blk, layer), f"B {B} layer {layer}")
        # K8: a layer > 0 of the stacked fc1 (x.dtype out), and the vocab
        # logits (f32 out), as the serving tail runs it
        x = x_in(B) * 0.05
        agree("qmatvec_stacked",
              qm.qmatvec_stacked(x, blk["w1"], blk["s1"], L - 1),
              qm.qmatvec_stacked_plain(x, blk["w1"], blk["s1"], L - 1),
              f"B {B} fc1 layer {L - 1}")
        x = x_in(B)
        wq, bias, (first, second) = head_case(n_vocab, x, gen)
        ones = torch.ones((1, 1, wq.shape[2]), device=dev)
        agree("qmatvec_stacked",
              qm.qmatvec_stacked(x, wq, ones, 0, out_dtype=torch.float32),
              qm.qmatvec_stacked_plain(x, wq, ones, 0,
                                       out_dtype=torch.float32),
              f"B {B} vocab logits")
        # K4 at M = B: the planted tie wins every row, first index first
        got = qm.qmatvec_greedy_head(x, wq, bias, n_vocab)
        ref = qm.qmatvec_greedy_head_plain(x, wq, bias, n_vocab)
        assert got[0].tolist() == ref[0].tolist() == [first] * B, (
            f"[{label}] head tie at M={B}: kernel {got[0].tolist()}, plain "
            f"{ref[0].tolist()}, want {first}")
        bias[0, [first, second]] = 0.0
        x = x_in(B)
        got = qm.qmatvec_greedy_head(x, wq, bias, n_vocab)
        ref = qm.qmatvec_greedy_head_plain(x, wq, bias, n_vocab)
        assert got[0].tolist() == ref[0].tolist(), \
            f"[{label}] head argmax differs at M={B}"
        for i in (1, 2):
            e = float(((got[i] - ref[i]).abs()
                       / ref[i].abs().clamp_min(1.0)).max())
            assert e <= 1e-5, f"[{label}] head output {i} at M={B}: {e:.3g}"
            worst["qmatvec_greedy_head"] = max(
                worst["qmatvec_greedy_head"], abs_err(got[i], ref[i]))
    torch.cuda.synchronize()
    log(f"[kernels] {label}: K5-K8, K4 at M in {list(batches)} agree with "
        f"the plain versions; max abs err " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()))
    return worst


def bound(name: str, D: int, B: int, n_vocab: int = 0, rows: int = 0,
          cache_bytes: int = 2, scales: bool = False, act_bytes: int = 2,
          compute: str = "bfloat16"):
    """(bound_ms, "bytes" or "operations") of one call: each input byte
    read once and each output byte written once over HBM_BPS, against
    the operations over the peak for the compute type. ``rows`` is the
    cache rows the call attends to, summed over its slots."""
    v_pad = n_vocab + (-n_vocab) % 128
    w_bytes, n_f32, flops = {
        "self_block": (4 * D * D, 10 * D, 8 * B * D * D),
        "cross_block": (2 * D * D, 6 * D, 4 * B * D * D),
        "ffn_block": (8 * D * D, 12 * D, 16 * B * D * D),
        "qmatvec_greedy_head": (D * v_pad, v_pad, 2 * B * D * v_pad),
        "qmatvec_stacked": (D * v_pad, v_pad, 2 * B * D * v_pad),
        "qmatvec_stacked_qkv": (3 * D * D, 3 * D, 6 * B * D * D),
        "qmatvec_stacked_dd": (D * D, D, 2 * B * D * D),
        "ffn_fused": (8 * D * D, 8 * D, 16 * B * D * D),
    }[name.replace("_batched", "")]
    row_bytes = D * cache_bytes + (4 if scales else 0)
    nbytes = w_bytes + 4 * n_f32 + 2 * rows * row_bytes \
        + 2 * B * D * act_bytes
    flops += 4 * rows * D
    if name.startswith("self_block"):
        nbytes += 2 * B * (row_bytes + 4)        # the new k/v rows
    if name == "qmatvec_stacked":
        nbytes += B * v_pad * 4 - B * D * act_bytes   # f32 logits out
    if name == "qmatvec_stacked_qkv":
        nbytes += 2 * B * D * act_bytes               # [B, 3D] out
    if name == "qmatvec_greedy_head":
        nbytes += B * 12 - B * D * act_bytes          # token, max, lse
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[compute]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_int8_mm(x, wq) -> "float | None":
    """Time of torch._weight_int8pack_mm for K8's product (x @ wq[0], unit
    scales), where the card's torch has a CUDA path for it; else None.
    A yardstick only: the port never calls it."""
    import torch
    w_nk = wq[0].t().contiguous()
    sc = torch.ones(w_nk.shape[0], dtype=x.dtype, device=x.device)
    try:
        return graph_ms(lambda: torch._weight_int8pack_mm(x, w_nk, sc))
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        log(f"[time] torch._weight_int8pack_mm has no CUDA path here: "
            f"{str(e).splitlines()[0][:120]}")
        torch.cuda.synchronize()
        return None


def k8_scan_cases(x, blk, layer: int) -> dict:
    """K8 at the scan step's projections (``qdecode._qmv``): ``qkv`` D x 3D
    and ``dd`` D x D (self_o, cross_q and cross_o have this shape), at
    ``layer`` of a stack, x's dtype out; kernel and plain calls."""
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    return {f"qmatvec_stacked_{k}": (
        lambda w=w, s=s: qm.qmatvec_stacked(x, blk[w], blk[s], layer),
        lambda w=w, s=s: qm.qmatvec_stacked_plain(x, blk[w], blk[s], layer))
        for k, w, s in (("qkv", "wqkv", "sqkv"), ("dd", "wcq", "scq"))}


def k8_scan_library(out: dict, x, blk, layer: int) -> None:
    """torch._weight_int8pack_mm beside K8's scan-projection rows."""
    for k, w in (("qkv", "wqkv"), ("dd", "wcq")):
        out[f"qmatvec_stacked_{k}"]["library_ms"] = library_int8_mm(
            x, blk[w][layer:layer + 1])


def time_batched(blk, D: int, H: int, L: int, n_vocab: int, T_self: int,
                 T_cross: int, enc_len: int, B: int, pos: int, label: str,
                 seed: int):
    """Kernel and plain times (ms per call) at a serving tick's shapes: B
    slots at ``pos``, bf16 activations, int8 self and cross rows (the
    serving cache); "tick" is L x (K5, K6, K7) + K8 for the vocab
    logits. "ms"/"plain_ms" are device times (CUDA-graph replay);
    "eager_*" are CUDA-event times of eager calls, host launch cost
    included. Also the bound and, for K8, the library call."""
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cdt = torch.bfloat16
    sk, sks, sv, svs = make_cache("int8", L, T_self, D, gen, dev, cdt, B)
    ck, cks, cv, cvs = make_cache("int8", L, T_cross, D, gen, dev, cdt, B)
    x = torch.randn((B, D), generator=gen, device=dev).to(cdt)
    pos_d = torch.full((B,), pos, dtype=torch.int32, device=dev)
    v_pad = n_vocab + (-n_vocab) % 128
    wq = torch.randint(-127, 128, (1, D, v_pad), generator=gen, device=dev,
                       dtype=torch.int8)
    ones = torch.ones((1, 1, v_pad), device=dev)
    bias = torch.zeros((1, v_pad), device=dev)
    layer = L - 1
    cases = {
        "self_block_batched": (
            lambda: db.self_block_batched(x, blk, sk, sks, sv, svs, pos_d,
                                          layer, H),
            lambda: db.self_block_plain(x, blk, sk, sks, sv, svs, pos_d,
                                        layer, H)),
        "cross_block_batched": (
            lambda: db.cross_block_batched(x, blk, ck, cks, cv, cvs, enc_len,
                                           layer, H),
            lambda: db.cross_block_plain(x, blk, ck, cks, cv, cvs, enc_len,
                                         layer, H)),
        "ffn_block_batched": (lambda: db.ffn_block_batched(x, blk, layer),
                              lambda: db.ffn_block_plain(x, blk, layer)),
        "qmatvec_stacked": (
            lambda: qm.qmatvec_stacked(x, wq, ones, 0,
                                       out_dtype=torch.float32),
            lambda: qm.qmatvec_stacked_plain(x, wq, ones, 0,
                                             out_dtype=torch.float32)),
        "qmatvec_greedy_head": (
            lambda: qm.qmatvec_greedy_head(x, wq, bias, n_vocab),
            lambda: qm.qmatvec_greedy_head_plain(x, wq, bias, n_vocab)),
        "ffn_fused": (
            lambda: qm.ffn_fused(x, blk["w1"], blk["s1"], blk["b1"],
                                 blk["w2"], layer),
            lambda: qm.ffn_fused_plain(x, blk["w1"], blk["s1"], blk["b1"],
                                       blk["w2"], layer)),
        **k8_scan_cases(x, blk, layer),
    }

    def tick(kernels: bool):
        sb, cb, fb, lg = ((db.self_block_batched, db.cross_block_batched,
                           db.ffn_block_batched, qm.qmatvec_stacked)
                          if kernels else
                          (db.self_block_plain, db.cross_block_plain,
                           db.ffn_block_plain, qm.qmatvec_stacked_plain))

        def run():
            y = x
            for lyr in range(L):
                y = sb(y, blk, sk, sks, sv, svs, pos_d, lyr, H)[0]
                y = cb(y, blk, ck, cks, cv, cvs, enc_len, lyr, H)
                y = fb(y, blk, lyr)
            return lg(y, wq, ones, 0, out_dtype=torch.float32)
        return run

    cases["tick"] = (tick(True), tick(False))
    out = {}
    for name, (kern, plain) in cases.items():
        # a tick is L layers long: few calls per graph keep the plain
        # version's temporaries small
        g = dict(reps=3, replays=5) if name == "tick" else {}
        n = 10 if name == "tick" else 50
        p1, k1, k2, p2 = (graph_ms(plain, **g), graph_ms(kern, **g),
                          graph_ms(kern, **g), graph_ms(plain, **g))
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "eager_ms": cuda_ms(kern, iters=n),
                     "eager_plain_ms": cuda_ms(plain, iters=n)}
        if name != "tick":
            rows = {"self_block_batched": B * pos,
                    "cross_block_batched": B * enc_len}.get(name, 0)
            out[name]["bound_ms"], out[name]["bound_by"] = bound(
                name, D, B, n_vocab, rows, cache_bytes=1, scales=True)
            out[name]["library_ms"] = None
    out["qmatvec_stacked"]["library_ms"] = library_int8_mm(x, wq)
    k8_scan_library(out, x, blk, layer)
    log(f"[time] {label} B={B} (pos {pos}, int8 self and cross rows, bf16), "
        f"device ms per call (eager ms) vs plain, bound: " + "; ".join(
            f"{k} {v['ms']:.4f} ({v['eager_ms']:.4f}) vs {v['plain_ms']:.4f} "
            f"({v['eager_plain_ms']:.4f})"
            + (f", bound {v['bound_ms']:.4f}" if "bound_ms" in v else "")
            for k, v in out.items()))
    return out


def check_k8_edges(cdt, seed: int) -> float:
    """K8 against its plain version at K8_EDGES, layer 1 of a stack of
    two, f32 and bf16 out, each call twice and bit-identical; returns the
    max abs error."""
    import torch
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tol = TOL_BF16 if cdt == torch.bfloat16 else TOL_F32
    worst = 0.0
    for M, K, N in K8_EDGES:
        w = torch.randint(-128, 128, (2, K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        s = (0.001 + 0.01 * torch.rand((2, 1, N), generator=gen,
                                       device=dev)) / np.sqrt(K)
        x = torch.randn((M, K), generator=gen, device=dev).to(cdt)
        for out in (torch.float32, torch.bfloat16):
            got = qm.qmatvec_stacked(x, w, s, 1, out_dtype=out)
            ref = qm.qmatvec_stacked_plain(x, w, s, 1, out_dtype=out)
            what = f"M={M} K={K} N={N} out {str(out)[6:]}"
            assert got.dtype == out and got.shape == (M, N), what
            t = TOL_BF16 if out == torch.bfloat16 else tol
            e = rel_err(got, ref)
            assert e <= t, (f"[kernels] {str(cdt)[6:]} qmatvec_stacked "
                            f"{what}: rel err {e:.3g} > {t:.3g}")
            assert torch.equal(got, qm.qmatvec_stacked(
                x, w, s, 1, out_dtype=out)), \
                f"[kernels] qmatvec_stacked {what}: two runs differ"
            worst = max(worst, abs_err(got, ref))
    torch.cuda.synchronize()
    log(f"[kernels] {str(cdt)[6:]}: K8 at {len(K8_EDGES)} edges x 2 out "
        f"dtypes agrees with the plain version, two runs identical; max "
        f"abs err {worst:.3g}")
    return worst


# K7's and K9's row counts: one row, a pair, odd, a full 8-slot tile, one
# past it, two tiles, one past them, a full launch and two launches (32 + 8)
FFN_EDGES = (1, 2, 5, 8, 9, 16, 17, 32, 40)


def check_ffn_edges(blk, D: int, L: int, cdt, label: str) -> dict:
    """K7 and K9 (one kernel, csrc/ffn_batched.cu) against their plain
    versions at every ``FFN_EDGES`` row count, the first and last layer,
    each call twice: the two runs must give the same bits. The outputs are
    held to the dtype's tolerance and no rounding-tie rule is taken: a
    hidden unit or an output that the kernel's f32 sums (in another order)
    round to the other bf16 neighbour moves the output by about one bf16
    ulp of it, within TOL_BF16. The plan's shared memory by the Python
    mirror (``ffn_smem``) must equal the kernel's own layout's
    (``wa_ffn_b_smem``). Returns the max abs error of each."""
    import torch
    from whisper_apr_tpu_torch.ops import _build
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(D + L)
    tol = TOL_BF16 if cdt == torch.bfloat16 else TOL_F32
    worst = {"ffn_block_batched": 0.0, "ffn_fused": 0.0}
    size = torch.empty((), dtype=cdt).element_size()
    for M in FFN_EDGES:
        plan = db.ffn_plan(D, 4 * D, min(M, _build.MAX_ROWS), size)
        smem = _build.library().wa_ffn_b_smem(D, *plan,
                                              _build.DTYPE_CODES[cdt])
        assert smem == db.ffn_smem(D, *plan, size), (
            f"[{label}] K7/K9 plan {tuple(plan)}: the kernel lays out "
            f"{smem} bytes, ffn_smem says {db.ffn_smem(D, *plan, size)}")
        for layer in (0, L - 1):
            x = torch.randn((M, D), generator=gen, device=dev).to(cdt)
            args = (x, blk["w1"], blk["s1"], blk["b1"], blk["w2"], layer)
            for name, kern, plain in (
                    ("ffn_block_batched",
                     lambda: db.ffn_block_batched(x, blk, layer),
                     lambda: db.ffn_block_plain(x, blk, layer)),
                    ("ffn_fused", lambda: qm.ffn_fused(*args),
                     lambda: qm.ffn_fused_plain(*args))):
                got, again, ref = kern(), kern(), plain()
                torch.cuda.synchronize()
                what = f"[{label}] {name} M {M} layer {layer}"
                assert got.dtype == cdt and got.shape == (M, D), what
                assert torch.equal(got, again), f"{what}: two runs differ"
                e = rel_err(got, ref)
                assert e <= tol, f"{what}: rel err {e:.3g} > {tol:.3g}"
                worst[name] = max(worst[name], abs_err(got, ref))
    log(f"[kernels] {label}: K7 and K9 at M in {list(FFN_EDGES)}, layers 0 "
        f"and {L - 1}, agree with the plain versions, two runs "
        f"bit-identical; max abs err " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()))
    return worst


def scan_case(blk, D: int, L: int, n_vocab: int, B: int, gen, device,
              cdt, T: int = 448, S: int = 1500):
    """Random operands of both decode steps at B rows: a params dict with
    the parts a step reads (token and position embeddings, final
    LayerNorm), a qd over ``blk``, and a dense KVCache (self rows T,
    cross rows S) in the compute dtype."""
    import torch
    from whisper_apr_tpu_torch.model.decoder import KVCache
    from whisper_apr_tpu_torch.ops.quant import QTensor
    v_pad = n_vocab + (-n_vocab) % 128
    wq = torch.randint(-127, 128, (1, D, v_pad), generator=gen,
                       device=device, dtype=torch.int8)
    ks = torch.full((1, D), 1.0 / (127 * np.sqrt(D)), device=device)
    params = {"decoder": {
        "token_emb": QTensor(wq[0, :, :n_vocab].t().contiguous(), ks),
        "pos_emb": torch.randn((T, D), generator=gen, device=device) * 0.1,
        "ln_post": {"w": torch.ones(D, device=device),
                    "b": torch.zeros(D, device=device)}}}
    qd = {"blk": blk, "vocab_qT": wq,
          "vocab_ones": torch.ones((1, 1, v_pad), device=device),
          "vocab_k_scale": ks}
    kv = KVCache(*(torch.randn((L, B, t, D), generator=gen, device=device,
                               dtype=cdt) for t in (T, T, S, S)))
    return params, qd, kv


def time_scan_steps(blk, D: int, H: int, L: int, n_vocab: int, label: str,
                    seed: int, pos: int = 128) -> dict:
    """Device time of one decode step (CUDA-graph replay; eager in
    brackets) through the scan step decode_step_q (K8 and K9, attention
    in torch over the dense cache) and through the fused step
    decode_step_qf with the logits tail (K1-K3 + K8 at B=1 over a cross8
    cache, K5-K7 + K8 at B=8 over an int8 cache, the serving form), bf16,
    at ``pos`` for every row."""
    import torch
    from whisper_apr_tpu_torch.config import ModelConfig
    from whisper_apr_tpu_torch.model import qdecode
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = ModelConfig("timing", n_vocab, 1500, D, H, L, 448, D, H, L, 80)
    out = {}
    for B, mode in ((1, "cross8"), (8, "int8")):
        params, qd, kv = scan_case(blk, D, L, n_vocab, B, gen, dev,
                                   torch.bfloat16)
        qkv = qdecode.quantize_cache(kv, mode)
        tok = torch.randint(0, n_vocab, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        p = pos if B == 1 else torch.full((B,), pos, dtype=torch.int32,
                                          device=dev)
        steps = {
            "scan": lambda: qdecode.decode_step_q(
                params, qd, tok, p, kv, cfg, compute_dtype=torch.bfloat16),
            "fused": lambda: qdecode.decode_step_qf(
                params, qd, tok, p, qkv, cfg, compute_dtype=torch.bfloat16)}
        for name, fn in steps.items():
            out[f"{name}_b{B}"] = {
                "ms": min(graph_ms(fn, reps=3, replays=5),
                          graph_ms(fn, reps=3, replays=5)),
                "eager_ms": cuda_ms(fn, iters=10)}
        del params, qd, kv, qkv
        torch.cuda.empty_cache()
    log(f"[time] {label} decode step, device ms (eager ms), pos {pos}, bf16: "
        + ", ".join(f"{k} {v['ms']:.4f} ({v['eager_ms']:.4f})"
                    for k, v in out.items()))
    return out


def phase_kernels():
    """K1-K4 at batch 1, K5-K8 and K4 at M > 1 and K9 against their plain
    versions, then their times. Returns (max abs errors at tiny bf16,
    {shape label: times})."""
    import torch
    tiny = dict(D=384, H=6, L=4, n_vocab=51865, T_self=512, T_cross=1536,
                enc_len=1500)
    large = dict(D=1280, H=20, L=32, n_vocab=51866, T_self=512,
                 T_cross=1536, enc_len=1500)
    errs, blk_tiny = check_kernels(**tiny, cdt=torch.bfloat16,
                                   label="tiny bf16", seed=1)
    edges = {}
    for D, H, lbl in ((384, 6, "tiny"), (1280, 20, "large-v3")):
        for seed, cdt in ((31, torch.bfloat16), (32, torch.float32)):
            e = check_cross(D, H, cdt, f"{lbl} {str(cdt)[6:]}", seed + D)
            if lbl == "tiny" and cdt == torch.bfloat16:
                errs["cross_block"] = max(errs["cross_block"], e)
            e = check_batched_edges(D, H, cdt, f"{lbl} {str(cdt)[6:]}",
                                    seed + 2 * D)
            if lbl == "tiny" and cdt == torch.bfloat16:
                edges = e
    # B=1: K8 with f32 out is the logits tail of beam, sampling and
    # timestamps; B=40: two 32-row chunks per launch
    errs_b = check_batched(blk_tiny, **tiny, cdt=torch.bfloat16,
                           label="tiny bf16", seed=11,
                           batches=(1, 2, 4, 8, 40))
    errs["qmatvec_greedy_head"] = max(errs["qmatvec_greedy_head"],
                                      errs_b.pop("qmatvec_greedy_head"))
    errs.update(errs_b)
    for k, v in edges.items():
        errs[k] = max(errs[k], v)
    errs["qmatvec_stacked"] = max(errs["qmatvec_stacked"],
                                  check_k8_edges(torch.bfloat16, seed=14))
    for (D, n_vocab, lbl), (seed, cdt) in itertools.product(
            ((384, 51865, "tiny"), (1280, 51866, "large-v3")),
            ((16, torch.bfloat16), (17, torch.float32))):
        e = check_head_edges(D, n_vocab, cdt, f"{lbl} {str(cdt)[6:]}",
                             seed + D)
        check_head_graph(D, n_vocab, cdt, f"{lbl} {str(cdt)[6:]}", seed)
        if lbl == "tiny" and cdt == torch.bfloat16:
            errs["qmatvec_greedy_head"] = max(errs["qmatvec_greedy_head"], e)
    check_k8_edges(torch.float32, seed=15)
    ffn = check_ffn_edges(blk_tiny, 384, 4, torch.bfloat16, "tiny bf16")
    errs["ffn_fused"] = ffn["ffn_fused"]
    errs["ffn_block_batched"] = max(errs["ffn_block_batched"],
                                    ffn["ffn_block_batched"])
    _, blk32 = check_kernels(**tiny, cdt=torch.float32, label="tiny f32",
                             seed=2)
    check_batched(blk32, **tiny, cdt=torch.float32, label="tiny f32",
                  seed=12, batches=(1, 2, 4, 8, 40))
    check_ffn_edges(blk32, 384, 4, torch.float32, "tiny f32")
    del blk32
    _, blk32 = check_kernels(**large, cdt=torch.float32,
                             label="large-v3 f32", seed=9)
    check_ffn_edges(blk32, 1280, 32, torch.float32, "large-v3 f32")
    del blk32
    torch.cuda.empty_cache()
    _, blk_large = check_kernels(**large, cdt=torch.bfloat16,
                                 label="large-v3 bf16", seed=3)
    check_batched(blk_large, **large, cdt=torch.bfloat16,
                  label="large-v3 bf16", seed=13)
    check_ffn_edges(blk_large, 1280, 32, torch.bfloat16, "large-v3 bf16")
    times = {
        "tiny_b1": time_kernels(blk_tiny, **tiny, pos=128, label="tiny",
                                seed=4),
        "large_v3_b1": time_kernels(blk_large, **large, pos=128,
                                    label="large-v3", seed=5),
        "tiny_b8": time_batched(blk_tiny, **tiny, B=8, pos=128,
                                label="tiny", seed=6),
        "large_v3_b8": time_batched(blk_large, **large, B=8, pos=128,
                                    label="large-v3", seed=7),
        "large_v3_steps": time_scan_steps(
            blk_large, 1280, 20, 32, 51866, label="large-v3", seed=8)}
    del blk_large
    torch.cuda.empty_cache()
    return errs, times


# ---------------------------------------------------------------------------
# phase 4: end to end
# ---------------------------------------------------------------------------

def _kernel_modules():
    """The modules of the kernel wrappers, each with its LAUNCHES."""
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    from whisper_apr_tpu_torch.ops import decode_blocks_kq as dbk
    from whisper_apr_tpu_torch.ops import (flash_attention, int4_matmul,
                                           int8_matmul, kquants,
                                           paged_attention, q4k)
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    return (db, qm, q4k, kquants, dbk, paged_attention, flash_attention,
            int8_matmul, int4_matmul)


@contextlib.contextmanager
def plain_kernels():
    """Route the decode step through the plain versions (same device):
    every wrapper of every kernel module is swapped for its plain
    version, K5-K7 for K1-K3's (which take any B). A count of a
    wrapper's f32 launches (``<name>_f32`` beside ``<name>``) names no
    function; any other count names its wrapper."""
    swaps = []
    for mod in _kernel_modules():
        for name in mod.LAUNCHES:
            if name.endswith("_f32") and name[:-4] in mod.LAUNCHES:
                continue
            plain = getattr(mod, name.replace("_batched", "") + "_plain")
            swaps.append((mod, name, getattr(mod, name)))
            setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)


def _counted_modules():
    """Every module with kernel launch counts: the model's and the
    probes'."""
    from whisper_apr_tpu_torch.ops import probe_mma
    return (*_kernel_modules(), probe_mma)


def launches():
    return {k: v for mod in _counted_modules()
            for k, v in mod.LAUNCHES.items()}


def reset_launches():
    for mod in _counted_modules():
        mod.reset_launches()


def write_random_apr(path: Path, cfg, compressed: bool = False) -> None:
    """Random-weight (seed 0) int8 .apr of ``cfg`` via the port's writer
    (``compressed``: its tensor data an LZ4 frame)."""
    from whisper_apr_tpu_torch.format import QUANT_INT8, AprWriter
    from whisper_apr_tpu_torch.model.params import (init_params,
                                                    params_to_apr_tensors)
    w = AprWriter.from_config(cfg, quantization=QUANT_INT8)
    w.header.compressed = compressed
    for name, arr in params_to_apr_tensors(init_params(cfg, seed=0)).items():
        w.add_tensor(name, arr)
    w.write_file(str(path))


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_e2e(workdir: Path, cfg=None, device="cuda", specials=None) -> dict:
    """The main path through the engine's entry points; ``cfg`` defaults to
    whisper-tiny (``device``/``specials`` let a CPU rehearsal run it at a
    small width through the plain versions). Returns the engine, the
    clips, the launch counts (``check_launches`` holds them to the path)
    and the timings."""
    from whisper_apr_tpu_torch import (ComputeConfig, ModelConfig,
                                       TranscribeOptions, WhisperApr)
    cfg = cfg or ModelConfig.tiny()
    apr = workdir / f"whisper-{cfg.model_type}-random-int8.apr"
    t0 = time.perf_counter()
    write_random_apr(apr, cfg)
    eng = WhisperApr.load_from_apr(
        str(apr), ComputeConfig(quantization="int8",
                                compute_dtype="bfloat16"),
        specials=specials, device=device)
    cfg = eng.config
    log(f"[e2e] wrote and loaded {apr.name} ({apr.stat().st_size / 1e6:.1f}"
        f" MB) in {time.perf_counter() - t0:.1f} s; kv mode "
        f"{eng._qf_mode}, compute bf16, device {eng.device}")
    rng = np.random.default_rng(0)
    sr = 16_000
    t = np.arange(5 * sr) / sr
    clips = {
        "noise_30s": rng.normal(0, 0.1, 30 * sr).astype(np.float32),
        "tone_5s": (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
        "silence_10s": np.zeros(10 * sr, np.float32),
    }
    opts = TranscribeOptions(language="en")
    eng.transcribe(clips["tone_5s"], opts)          # warm-up
    sync(device)

    prompt_len = len(eng.get_initial_tokens("en"))
    L = cfg.n_text_layer
    reset_launches()
    requests = []
    for name, audio in clips.items():
        before = launches()
        t0 = time.perf_counter()
        res = eng.transcribe(audio, opts)
        sync(device)
        dt = time.perf_counter() - t0
        after = launches()
        delta = {k: after[k] - before[k] for k in after}
        steps = len(res.tokens) - prompt_len - 1
        toks = np.asarray(res.tokens)
        assert toks.size > prompt_len and toks.min() >= 0 \
            and toks.max() < cfg.n_vocab
        assert np.isfinite(res.avg_logprob) and 0 <= res.no_speech_prob <= 1
        requests.append({
            "clip": name, "seconds": dt, "decode_steps": steps,
            "ms_per_step": 1e3 * dt / max(steps, 1),
            "avg_logprob": res.avg_logprob,
            "no_speech_prob": res.no_speech_prob, "launches": delta,
            "want_launches": want_counts(
                self_block=L * steps, cross_block=L * steps,
                ffn_block=L * steps, qmatvec_greedy_head=steps)})
        log(f"[e2e] {name}: {dt * 1e3:.1f} ms, {steps} decode steps, "
            f"{len(res.tokens)} tokens, avg_logprob {res.avg_logprob:.4f}, "
            f"no_speech {res.no_speech_prob:.4g}, launches {delta}")
    total = launches()
    lang = eng.detect_language(clips["noise_30s"]).best[0]
    log(f"[e2e] detect_language on noise: {lang!r}")

    # f32 through the kernels vs the plain versions, same card
    eng32 = WhisperApr.load_from_apr(
        str(apr), ComputeConfig(quantization="int8", compute_dtype="float32"),
        specials=specials, device=device)
    r_kern = eng32.transcribe(clips["tone_5s"], opts)
    with plain_kernels():
        r_plain = eng32.transcribe(clips["tone_5s"], opts)
    assert r_kern.tokens == r_plain.tokens, (
        f"[e2e] f32 tokens differ: kernels {r_kern.tokens[:20]}..., plain "
        f"{r_plain.tokens[:20]}...")
    dlp = abs(r_kern.avg_logprob - r_plain.avg_logprob)
    log(f"[e2e] f32 kernels == plain: {len(r_kern.tokens)} tokens identical "
        f"(lengths equal), |d avg_logprob| {dlp:.3g}")

    rtf = bench_rtf(eng, clips["noise_30s"])
    with plain_kernels():
        rtf_plain = bench_rtf(eng, clips["noise_30s"])
    log(f"[e2e] bench protocol (30 s, {TOKENS_FORCED} forced tokens, B=1, "
        f"int8, bf16, cross8): RTF {rtf['rtf']:.6f} ({rtf['seconds'] * 1e3:.1f}"
        f" ms; runs {rtf['runs_ms']}), plain versions RTF "
        f"{rtf_plain['rtf']:.6f} ({rtf_plain['seconds'] * 1e3:.1f} ms)")
    return {"engine": eng, "engine_f32": eng32, "apr": apr, "clips": clips,
            "total": total, "requests": requests, "rtf": rtf,
            "rtf_plain": rtf_plain}


def want_counts(**counts) -> dict:
    """Launch counts of every kernel: the given ones, 0 for the rest."""
    return {**dict.fromkeys(launches(), 0), **counts}


def check_launches(total: dict, requests: list) -> None:
    """The main path ran K1-K4: each request launched K1-K3 exactly
    L x steps times, K4 steps times and no batched kernel, and each of
    K1-K4's count over the requests is above 0."""
    for r in requests:
        assert r["launches"] == r["want_launches"], (
            f"[e2e] {r['clip']}: launches {r['launches']}, want "
            f"{r['want_launches']}")
    assert all(total[k] > 0 for k in ("self_block", "cross_block",
                                      "ffn_block", "qmatvec_greedy_head")), \
        total


def near_tie_gap(eng, audio: np.ndarray, prefix: list) -> float:
    """Gap between the two largest suppressed f32 logits after ``prefix``
    for this clip (a plain teacher-forced prefill)."""
    import torch
    from whisper_apr_tpu_torch.inference.processors import \
        WhisperTokenSuppressor
    from whisper_apr_tpu_torch.model.decoder import init_cache, prefill
    enc = eng.encode(eng.compute_mel(audio))
    cache = init_cache(eng.params, enc, eng.config, max_len=len(prefix),
                       compute_dtype=torch.float32)
    logits, _ = prefill(eng.params, torch.tensor([prefix], device=eng.device),
                        enc, cache, eng.config, compute_dtype=torch.float32)
    bias = torch.from_numpy(WhisperTokenSuppressor(
        n_vocab=eng.config.n_vocab, tokens=eng.specials).bias()).to(
        eng.device)
    top = torch.topk(logits[0].float() + bias, 2).values
    return float(top[0] - top[1])


def check_follows(eng, audio, got: list, want: list, what: str):
    """``got`` starts with ``want`` (per-clip transcribe), or first differs
    where the top two logits are within NEAR_TIE. Returns the gap there,
    or None where they agree."""
    i = next((k for k in range(min(len(got), len(want)))
              if got[k] != want[k]), None)
    if i is None and len(got) < len(want):
        i = len(got)
    if i is None:
        return None
    gap = near_tie_gap(eng, audio, want[:i])
    log(f"[{what}] tokens differ from per-clip transcribe at {i} "
        f"({got[i:i + 3]} vs {want[i:i + 3]}); top-two logit gap there "
        f"{gap:.3g}")
    assert gap < NEAR_TIE, f"[{what}] tokens differ at {i}, gap {gap:.3g}"
    return gap


def make_clips(seconds, seed: int) -> list:
    """Tone-plus-noise clips of the given lengths (16 kHz)."""
    rng = np.random.default_rng(seed)
    sr = 16_000
    out = []
    for i, sec in enumerate(seconds):
        t = np.arange(int(sec * sr)) / sr
        out.append((0.3 * np.sin(2 * np.pi * (200 + 40 * i) * t)
                    + rng.normal(0, 0.05, t.size)).astype(np.float32))
    return out


SERVE_SECONDS = (3, 30, 5, 20, 8, 12, 4, 25, 6, 15, 10, 30)


def phase_serve(apr: Path, eng, device="cuda", specials=None,
                n_slots: int = 8) -> dict:
    """Continuous batching through BatchScheduler: a dozen clips in two
    bursts on ``eng``; the launch counts per tick; then the f32 token
    checks on an int8-KV engine. Returns the launch counts, the tick
    times and stats()."""
    import torch
    from whisper_apr_tpu_torch import (ComputeConfig, TranscribeOptions,
                                       WhisperApr)
    from whisper_apr_tpu_torch.parallel.serving import BatchScheduler
    cfg = eng.config
    L = cfg.n_text_layer
    clips = make_clips(SERVE_SECONDS, seed=1)
    sched = BatchScheduler(eng, n_slots=n_slots)
    ids = [sched.submit(c, "en") for c in clips[:8]]
    ticks = []                      # (wall s, requests admitted)

    def tick() -> int:
        admitted = sched.stats()["admitted"]
        sync(device)
        t0 = time.perf_counter()
        n = sched.step()
        sync(device)
        ticks.append((time.perf_counter() - t0,
                      sched.stats()["admitted"] - admitted))
        return n

    reset_launches()
    for _ in range(16):
        tick()
    ids += [sched.submit(c, "en") for c in clips[8:]]
    while tick() or sched.pending():
        pass
    counts = launches()
    st = sched.stats()
    n_ticks = st["ticks"]
    want = want_counts(self_block_batched=L * n_ticks,
                       cross_block_batched=L * n_ticks,
                       ffn_block_batched=L * n_ticks,
                       qmatvec_stacked=n_ticks)
    comps = [sched.result(i) for i in ids]
    for c in comps:
        assert c is not None and c.status == "ok", c
        t = np.asarray(c.tokens)
        assert t.size > c.prompt_len and t.min() >= 0 \
            and t.max() < cfg.n_vocab
    pure = [w for w, a in ticks if a == 0]
    decoded = st["tokens_generated"] - st["admitted"]
    wall_s = sum(w for w, _ in ticks)
    # device time: only a run on the card has one
    device_ms = (serve_device_ms(eng, clips[:n_slots], n_slots)
                 if torch.device(device).type == "cuda" else float("nan"))
    out = {"ticks": n_ticks, "launches": counts, "want_launches": want,
           "stats": st, "wall_s": wall_s,
           "ms_per_tick_median": 1e3 * float(np.median(pure)),
           "ms_per_tick_mean": 1e3 * wall_s / n_ticks,
           "ms_per_slot_token": 1e3 * wall_s / max(decoded, 1),
           "device_ms_per_tick": device_ms,
           "device_ms_per_slot_token": device_ms / n_slots}
    log(f"[serve] {len(clips)} clips, n_slots {n_slots}: {n_ticks} ticks in "
        f"{wall_s:.3f} s; wall ms per tick {out['ms_per_tick_mean']:.4f} "
        f"(median without admission {out['ms_per_tick_median']:.4f}); wall "
        f"ms per slot-token {out['ms_per_slot_token']:.4f}; device ms per "
        f"tick {device_ms:.4f} (per slot-token "
        f"{out['device_ms_per_slot_token']:.4f}); launches {counts}; "
        f"stats {st}")

    # f32, int8 KV: kernels == plain (strict); follows transcribe
    eng32 = WhisperApr.load_from_apr(
        str(apr), ComputeConfig(quantization="int8", compute_dtype="float32",
                                kv_mode="int8"),
        specials=specials, device=device)
    short = clips[:4]
    max_tokens = 48

    def serve_tokens():
        s = BatchScheduler(eng32, n_slots=n_slots)
        rid = [s.submit(c, "en", max_tokens=max_tokens) for c in short]
        s.run_until_drained()
        return [s.result(i).tokens for i in rid]

    kern = serve_tokens()
    with plain_kernels():
        plain = serve_tokens()
    assert kern == plain, (f"[serve] f32 tokens differ: kernels "
                           f"{[k[:12] for k in kern]}, plain "
                           f"{[p[:12] for p in plain]}")
    P = len(eng32.get_initial_tokens("en"))
    opts = TranscribeOptions(language="en", max_tokens=P + max_tokens)
    gaps = [check_follows(eng32, c, k, eng32.transcribe(c, opts).tokens,
                          "serve") for c, k in zip(short, kern)]
    out["f32_gaps"] = gaps
    log(f"[serve] f32 int8-KV: scheduler tokens through the kernels == "
        f"plain versions ({sum(map(len, kern))} tokens); against per-clip "
        f"transcribe: {sum(g is None for g in gaps)} of {len(gaps)} "
        f"identical, near-tie gaps {[g for g in gaps if g is not None]}")
    out["scan"] = serve_scan(apr, clips, device, specials, n_slots)
    return out


def serve_scan(apr: Path, clips: list, device="cuda", specials=None,
               n_slots: int = 8) -> dict:
    """BatchScheduler over a kv_mode "scan" engine (dense slots, the scan
    step): the same clips in two bursts, every tick K8 4L+1 and K9 L
    times; then in f32 the tokens through the kernels equal the plain
    versions' and follow per-clip scan transcribe (near-tie rule)."""
    import torch
    from whisper_apr_tpu_torch import (ComputeConfig, TranscribeOptions,
                                       WhisperApr)
    from whisper_apr_tpu_torch.parallel.serving import BatchScheduler

    def engine(dtype):
        return WhisperApr.load_from_apr(
            str(apr), ComputeConfig(quantization="int8", compute_dtype=dtype,
                                    kv_mode="scan"),
            specials=specials, device=device)
    eng = engine("bfloat16")
    L = eng.config.n_text_layer
    sched = BatchScheduler(eng, n_slots=n_slots)
    assert sched._qf is None
    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    ids = [sched.submit(c, "en") for c in clips[:8]]
    for _ in range(16):
        sched.step()
    ids += [sched.submit(c, "en") for c in clips[8:]]
    sched.run_until_drained()
    sync(device)
    wall_s = time.perf_counter() - t0
    counts = launches()
    st = sched.stats()
    n_ticks = st["ticks"]
    want = want_counts(qmatvec_stacked=(4 * L + 1) * n_ticks,
                       ffn_fused=L * n_ticks)
    assert all(sched.result(i).status == "ok" for i in ids)
    log(f"[serve] scan engine: {len(clips)} clips in {n_ticks} ticks, "
        f"{wall_s:.3f} s wall ({1e3 * wall_s / n_ticks:.4f} ms per tick, "
        f"admission included); launches {counts}")
    assert counts == want or torch.device(device).type == "cpu", \
        f"[serve] scan launches {counts}, want {want}"

    eng32 = engine("float32")
    short, max_tokens = clips[:4], 48

    def serve_tokens():
        s = BatchScheduler(eng32, n_slots=n_slots)
        rid = [s.submit(c, "en", max_tokens=max_tokens) for c in short]
        s.run_until_drained()
        return [s.result(i).tokens for i in rid]

    kern = serve_tokens()
    with plain_kernels():
        plain = serve_tokens()
    gaps = [check_follows(eng32, c, k, p, "serve scan")
            for c, k, p in zip(short, kern, plain)]
    P = len(eng32.get_initial_tokens("en"))
    opts = TranscribeOptions(language="en", max_tokens=P + max_tokens)
    gaps += [check_follows(eng32, c, k, eng32.transcribe(c, opts).tokens,
                           "serve scan") for c, k in zip(short, kern)]
    log(f"[serve] scan f32: scheduler tokens through the kernels against "
        f"the plain versions and per-clip scan transcribe: "
        f"{sum(g is None for g in gaps)} of {len(gaps)} identical, near-tie "
        f"gaps {[g for g in gaps if g is not None]}")
    return {"ticks": n_ticks, "launches": counts, "wall_s": wall_s,
            "f32_gaps": gaps}


def serve_device_ms(eng, clips: list, n_slots: int, n: int = 20) -> float:
    """Kernel time on the card per pure decode tick (torch.profiler over
    ``n`` ticks of a full scheduler after its admission)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from whisper_apr_tpu_torch.parallel.serving import BatchScheduler
    sched = BatchScheduler(eng, n_slots=n_slots)
    for c in clips:
        sched.submit(c, "en")
    for _ in range(2):
        sched.step()
    sync(eng.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            sched.step()
        sync(eng.device)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy / n


def phase_batch(eng, eng32, device="cuda") -> dict:
    """transcribe_batch of 4 clips: launch counts, then the f32 token
    checks (kernels == plain; follows per-clip transcribe)."""
    from whisper_apr_tpu_torch import TranscribeOptions
    cfg = eng.config
    L = cfg.n_text_layer
    clips = make_clips((4, 9, 17, 30), seed=2)
    opts = TranscribeOptions(language="en")
    P = len(eng.get_initial_tokens("en"))
    eng.transcribe_batch(clips[:2], opts)          # warm-up
    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    res = eng.transcribe_batch(clips, opts)
    sync(device)
    dt = time.perf_counter() - t0
    counts = launches()
    steps = max(len(r.tokens) for r in res.results) - P - 1
    want = want_counts(self_block_batched=L * steps,
                       cross_block_batched=L * steps,
                       ffn_block_batched=L * steps,
                       qmatvec_greedy_head=steps)
    for r in res.results:
        t = np.asarray(r.tokens)
        assert t.size > P and t.min() >= 0 and t.max() < cfg.n_vocab
    log(f"[batch] transcribe_batch of {len(clips)} clips: {dt * 1e3:.1f} ms, "
        f"{steps} decode steps ({1e3 * dt / max(steps, 1):.4f} ms per step), "
        f"launches {counts}")
    kern = [r.tokens for r in eng32.transcribe_batch(clips, opts).results]
    with plain_kernels():
        plain = [r.tokens for r in
                 eng32.transcribe_batch(clips, opts).results]
    assert kern == plain, "[batch] f32 tokens differ: kernels vs plain"
    gaps = [check_follows(eng32, c, k, eng32.transcribe(c, opts).tokens,
                          "batch") for c, k in zip(clips, kern)]
    log(f"[batch] f32: tokens through the kernels == plain versions "
        f"({sum(map(len, kern))} tokens); against per-clip transcribe: "
        f"{sum(g is None for g in gaps)} of {len(gaps)} identical, "
        f"near-tie gaps {[g for g in gaps if g is not None]}")
    assert counts == want, f"[batch] launches {counts}, want {want}"
    return {"launches": counts, "want_launches": want, "steps": steps,
            "seconds": dt, "f32_gaps": gaps}


def check_same(eng, audio, got: list, want: list, what: str):
    """Kernels against plain versions: identical token lists, or a first
    difference where the top two logits are within NEAR_TIE."""
    if got == want:
        return None
    return check_follows(eng, audio, got, want, what)


# ---------------------------------------------------------------------------
# phase 6b: long audio, VAD, streaming, prefix reuse, hotwords, words
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def decode_log():
    """Record every greedy decode of the fused pipeline (the decoder of
    transcribe_batch, transcribe_prefixed and the streaming partials) as
    (rows, prompt length, decode steps), in the yielded list."""
    from whisper_apr_tpu_torch import pipeline
    real = pipeline.greedy_generate_body
    calls = []

    def logged(params, enc_out, prompt, *a, **kw):
        res = real(params, enc_out, prompt, *a, **kw)
        P = prompt.shape[1]
        calls.append((prompt.shape[0], P, int(res.lengths.max()) - P - 1))
        return res
    pipeline.greedy_generate_body = logged
    try:
        yield calls
    finally:
        pipeline.greedy_generate_body = real


def want_decodes(calls: list, L: int) -> dict:
    """The launches of those decodes in kv_mode cross8: per step K1-K3 L
    times (one row) or K5-K7 L times (several), and K4 once."""
    one = sum(n for b, _, n in calls if b == 1)
    many = sum(n for b, _, n in calls if b > 1)
    return want_counts(self_block=L * one, cross_block=L * one,
                       ffn_block=L * one, self_block_batched=L * many,
                       cross_block_batched=L * many,
                       ffn_block_batched=L * many,
                       qmatvec_greedy_head=one + many)


def write_wav(path: Path, audio: np.ndarray, sr: int) -> None:
    """16-bit mono WAV through Python's ``wave``."""
    import wave
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2")
                      .tobytes())


def tone_noise(seconds: float, sr: int, seed: int, freq: float = 220.0
               ) -> np.ndarray:
    """make_clips' tone and noise at any rate."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * freq * t)
            + rng.normal(0, 0.05, t.size)).astype(np.float32)


def bursts(plan, sr: int, seed: int) -> np.ndarray:
    """(seconds, frequency or 0 for near-silence) pieces, concatenated."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        tone_noise(sec, sr, seed + i, f) if f else
        rng.normal(0, 1e-4, int(sec * sr)).astype(np.float32)
        for i, (sec, f) in enumerate(plan)])


# the NumPy resampler and DTW the host runtime replaced, on an NVIDIA H100
# 80GB HBM3 machine (700.00 W), host clock: 75 s at 44.1 kHz resampled,
# transcribe_file of it, DTW and words on 10 s
NUMPY_RESAMPLE_MS, NUMPY_FILE_MS, NUMPY_DTW_MS = 16682.0, 15735.0, 28.2
VAD_PLAN = ((3, 0), (8, 250), (5, 0), (8, 330), (5, 0), (8, 410), (3, 0))
STREAM_PLAN = ((1, 0), (8, 230), (2, 0), (7, 290), (2, 0))
STREAM_RATE = 44_100


def percentile_ms(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else 0.0


def run_session(eng, audio: np.ndarray, opts, reuse: bool,
                block_s: float = 0.5) -> dict:
    """A StreamingSession at STREAM_RATE: ``audio`` pushed in blocks, the
    partial after each push when there is one, then finalize. Returns
    the chunk texts, the partial texts, the final transcript and each
    get_partial's host-clock seconds."""
    from whisper_apr_tpu_torch.inference.streaming import StreamingSession
    sess = StreamingSession(eng, opts, input_sample_rate=STREAM_RATE,
                            partial_reuse=reuse)
    block = int(block_s * STREAM_RATE)
    chunks, partials, lat = [], [], []
    for i in range(0, len(audio), block):
        chunks += [r.text for r in sess.push(audio[i:i + block])
                   if r.kind == "chunk"]
        if sess.has_partial():
            t0 = time.perf_counter()
            p = sess.get_partial()
            sync(eng.device)
            lat.append(time.perf_counter() - t0)
            partials.append(p)
    final = sess.finalize()
    return {"chunks": chunks, "partials": partials, "final": final,
            "latency_s": lat}


def phase_longform(eng, eng32, workdir: Path, device="cuda",
                   max_tokens: int = 64, stream_tokens: int = 32,
                   long_seconds: float = 75.0) -> dict:
    """The long-audio and streaming entry points on the e2e engines (int8
    weights, bf16; ``eng32`` the f32 twin), each path's launches counted
    from 0 just before it and held to the decodes it ran (``decode_log``):
    (a) transcribe_file on a ``long_seconds`` 44.1 kHz WAV (every window
    in one transcribe_batch), (b) transcribe_with_vad on three tone bursts
    (one batch of three), (c) a StreamingSession at 44.1 kHz with
    partial reuse on and off, ``stream_tokens`` a decode (per-partial
    host latency), (d)
    transcribe_prefixed continuing a decode's own prefix, (e) hotwords
    (the host-stepped plain step) against the fused greedy path, (f)
    word timestamps (the traced forward and DTW). In f32, tokens, texts
    and words through the kernels equal the plain versions'. On the CPU
    (a rehearsal through the plain versions) nothing launches and the
    counts are not held."""
    import torch
    from whisper_apr_tpu_torch import (ComputeConfig, TranscribeOptions,
                                       WhisperApr, native)
    from whisper_apr_tpu_torch.alignment import (AlignmentConfig,
                                                 WordTimestampExtractor)
    from whisper_apr_tpu_torch.audio.resample import SincResampler
    from whisper_apr_tpu_torch.audio.streaming import StreamingProcessor
    from whisper_apr_tpu_torch.audio.wav import parse_wav
    from whisper_apr_tpu_torch.model.traced import decoder_forward_traced
    from whisper_apr_tpu_torch.vad import VoiceActivityDetector
    check_counts = torch.device(device).type == "cuda"
    cfg = eng.config
    L = cfg.n_text_layer
    sr = 16_000
    window = 2 * cfg.n_audio_ctx * 160
    overlap = min(sr, window // 4)
    step_s = (window - overlap) / sr
    opts = TranscribeOptions(language="en", max_tokens=max_tokens)
    out = {"paths": {}}

    def path(name, fn, rows=None, lib=None):
        """Run ``fn`` from zeroed counts; hold them to its decodes, and
        the host runtime's calls to ``lib(decodes)`` (none by default)."""
        reset_launches()
        native.reset_calls()
        sync(device)
        with decode_log() as calls:
            t0 = time.perf_counter()
            res = fn()
            sync(device)
            dt = time.perf_counter() - t0
        counts = launches()
        ncalls = dict(native.CALLS)
        want = want_decodes(calls, L)
        out["paths"][name] = {"seconds": dt, "launches": counts,
                              "decodes": calls, "native": ncalls}
        log(f"[longform] {name}: {dt * 1e3:.1f} ms, {len(calls)} decodes "
            f"(rows, prompt, steps) {calls[:4]}{'...' if len(calls) > 4 else ''}"
            f", launches { {k: v for k, v in counts.items() if v} }, host "
            f"runtime calls { {k: v for k, v in ncalls.items() if v} }")
        if rows is not None:
            assert [b for b, _, _ in calls] == rows, (name, calls)
        if check_counts:
            assert counts == want, f"[longform] {name}: launches {counts}, " \
                f"want {want}"
        want_lib = dict.fromkeys(ncalls, 0)
        want_lib.update(lib(calls) if lib else {})
        assert ncalls == want_lib, f"[longform] {name}: host runtime calls " \
            f"{ncalls}, want {want_lib}"
        return res

    # (a) a long 44.1 kHz WAV: every window in one transcribe_batch, one
    # resample; the f32 checks and the decode's own time on the resampled
    # samples (transcribe_file's second half)
    wav = workdir / "long.wav"
    write_wav(wav, tone_noise(long_seconds, STREAM_RATE, seed=5),
              STREAM_RATE)
    n16 = int(np.ceil(long_seconds * sr))
    n_win = max(1, -(-(n16 - overlap) // (window - overlap)))
    res = path("transcribe_file", lambda: eng.transcribe_file(str(wav),
                                                              opts),
               rows=[n_win], lib=lambda calls: {"resample_sinc": 1})
    offs = [s.start / step_s for s in res.segments]
    assert res.segments and all(abs(o - round(o)) < 1e-9 for o in offs), offs
    t0 = time.perf_counter()
    samples, rate = parse_wav(wav.read_bytes())
    samples = SincResampler(rate, sr).resample(samples)
    resample_s = time.perf_counter() - t0
    assert eng.transcribe_long(samples, opts).tokens == res.tokens
    sync(device)
    t0 = time.perf_counter()
    eng.transcribe_long(samples, opts)
    sync(device)
    long_s = time.perf_counter() - t0
    kern = eng32.transcribe_long(samples, opts)
    with plain_kernels():
        plain = eng32.transcribe_long(samples, opts)
    assert kern.tokens == plain.tokens, "[longform] file: f32 tokens differ"
    out["file"] = {"resample_s": resample_s, "transcribe_long_s": long_s}
    log(f"[longform] (a) {long_seconds:g} s at {STREAM_RATE} Hz: {n_win} "
        f"windows in one batch, {len(res.segments)} segments at offsets "
        f"{[round(s.start, 3) for s in res.segments]} s; of it the WAV "
        f"read and resampling (the host runtime) {resample_s * 1e3:.1f} ms "
        f"(through NumPy {NUMPY_RESAMPLE_MS} ms, transcribe_file "
        f"{NUMPY_FILE_MS} ms), "
        f"transcribe_long (warm) {long_s * 1e3:.1f} ms; f32 kernels == "
        f"plain ({len(kern.tokens)} tokens)")

    # (b) VAD: three bursts, one batch of three
    vad_audio = bursts(VAD_PLAN, sr, seed=7)
    spans = VoiceActivityDetector().detect(vad_audio)
    assert len(spans) == 3, spans
    vres = path("transcribe_with_vad",
                lambda: eng.transcribe_with_vad(vad_audio, opts), rows=[3])
    kern = eng32.transcribe_with_vad(vad_audio, opts)
    with plain_kernels():
        plain = eng32.transcribe_with_vad(vad_audio, opts)
    assert kern.tokens == plain.tokens, "[longform] vad: f32 tokens differ"
    log(f"[longform] (b) VAD spans {[(s / sr, e / sr) for s, e in spans]} s"
        f", {len(vres.segments)} segments; f32 kernels == plain")

    # (c) streaming sessions, partial reuse on and off: one resample per
    # 30 ms frame, and one of the rest at finalize
    stream = bursts(STREAM_PLAN, STREAM_RATE, seed=9)
    sopts = TranscribeOptions(language="en", max_tokens=stream_tokens)
    frame_in = int(STREAM_RATE * StreamingProcessor.FRAME_MS / 1000)
    frames = -(-len(stream) // frame_in)
    out["stream"] = {}
    for reuse in (True, False):
        name = f"session reuse={'on' if reuse else 'off'}"
        s = path(name, lambda: run_session(eng, stream, sopts, reuse),
                 lib=lambda calls: {"resample_sinc": frames})
        assert s["final"] and s["partials"], s
        p50 = percentile_ms(s["latency_s"], 50)
        p95 = percentile_ms(s["latency_s"], 95)
        out["stream"][name] = {"partials": len(s["partials"]),
                               "chunks": len(s["chunks"]),
                               "partial_p50_ms": p50, "partial_p95_ms": p95}
        log(f"[longform] (c) {name}: {len(s['partials'])} partials, "
            f"{len(s['chunks'])} chunks; per-partial latency (host clock) "
            f"p50 {p50:.2f} ms, p95 {p95:.2f} ms")
    # chunks and the final transcript do not depend on the push size, so
    # the f32 check pushes 2 s blocks (fewer partial decodes)
    kern = run_session(eng32, stream, sopts, True, block_s=2.0)
    with plain_kernels():
        plain = run_session(eng32, stream, sopts, True, block_s=2.0)
    assert (kern["chunks"], kern["final"]) == (plain["chunks"],
                                               plain["final"]), \
        "[longform] session: f32 texts differ"
    log(f"[longform] (c) f32 reuse=on, 2 s blocks: {len(kern['chunks'])} "
        f"chunk texts and the final transcript through the kernels == "
        f"plain versions")

    # (d) prefix reuse continues a decode's own prefix
    clip = tone_noise(12, sr, seed=11)
    full = eng32.transcribe(clip, opts)
    initial = eng32.get_initial_tokens("en")
    gen = [t for t in full.tokens[len(initial):] if t != eng32.specials.eot]
    assert len(gen) > eng32.PREFIX_BUCKET, gen
    pre = path("transcribe_prefixed", lambda: eng32.transcribe_prefixed(
        clip, gen[:-2], opts), rows=[1])
    gap_d = check_follows(eng32, clip, pre.tokens, full.tokens,
                          "longform prefixed")
    log(f"[longform] (d) f32 prefix of {len(gen) - 2} tokens "
        f"({(len(gen) - 2) // 8 * 8} forced): continuation "
        f"{'== full decode' if gap_d is None else f'near tie {gap_d:.3g}'}")

    # (e) hotwords: the host-stepped plain step against the fused path
    # (f32 self and cross rows, so that only rounding differs)
    rows32 = WhisperApr(cfg, eng32.params, eng32.tokenizer,
                        eng32.mel_filters, ComputeConfig(
                            quantization="int8", compute_dtype="float32",
                            kv_mode="bf16"), eng32.specials, device=device)
    clips = make_clips((6, 11), seed=13)
    hw = TranscribeOptions(language="en", max_tokens=max_tokens,
                           hotwords=[("zzzz_not_present_zzzz", 0.0)])
    got = rows32.transcribe_batch(clips, hw).results
    fused = path("hotwords reference (fused greedy)",
                 lambda: rows32.transcribe_batch(clips, opts).results,
                 rows=[2])
    gaps_e = [check_follows(rows32, c, g.tokens, f.tokens, "hotwords")
              for c, g, f in zip(clips, got, fused)]
    boosted = TranscribeOptions(language="en", max_tokens=max_tokens,
                                hotwords=["hello world:4", ("tok", 2.0)])
    sync(device)
    t0 = time.perf_counter()
    b = eng.transcribe_batch(clips, boosted).results
    sync(device)
    dt = time.perf_counter() - t0
    P = len(initial)
    hw_steps = max(len(r.tokens) for r in b) - P - 1
    out["hotword_ms_per_step"] = 1e3 * dt / max(hw_steps, 1)
    log(f"[longform] (e) hotwords at boost 0 (f32) follow the fused greedy "
        f"path, near-tie gaps {[g for g in gaps_e if g is not None]}; a "
        f"boosted batch of 2 in bf16: {dt * 1e3:.1f} ms, {hw_steps} host "
        f"steps, {out['hotword_ms_per_step']:.3f} ms per host-stepped token")

    # (f) word timestamps on a 10 s clip, over a vocabulary of words (the
    # random .apr carries none: its fallback tokens hold no space)
    from whisper_apr_tpu_torch.tokenizer import BpeTokenizer, Vocabulary
    vocab = Vocabulary.with_base_tokens()
    while len(vocab) < cfg.n_vocab:
        vocab.add_token(b" w%d" % len(vocab))
    eng, eng32 = (WhisperApr(cfg, e.params, BpeTokenizer(vocab),
                             e.mel_filters, e.compute, e.specials,
                             device=device) for e in (eng, eng32))
    clip = tone_noise(10, sr, seed=17)
    wt = TranscribeOptions(language="en", max_tokens=max_tokens,
                           word_timestamps=True)
    r = path("word timestamps", lambda: eng.transcribe(clip, wt), rows=[1],
             lib=lambda calls: {"dtw_path": len(calls)})
    starts = [w.start for w in r.words]
    assert r.words and starts == sorted(starts) and all(
        0 <= w.start and w.end <= 10.0 for w in r.words), r.words
    kern = eng32.transcribe(clip, wt)
    with plain_kernels():
        plain = eng32.transcribe(clip, wt)
    assert kern.tokens == plain.tokens and [
        dataclasses.astuple(w) for w in kern.words] == [
        dataclasses.astuple(w) for w in plain.words], \
        "[longform] words: f32 kernels differ from plain"
    enc = eng.encode(eng.compute_mel(clip))
    toks = torch.tensor([r.tokens], device=eng.device)
    sync(device)
    t0 = time.perf_counter()
    _, _, weights = decoder_forward_traced(eng.params, toks, enc, cfg)
    weights = weights.float().cpu().numpy()
    t1 = time.perf_counter()
    WordTimestampExtractor(eng.tokenizer, AlignmentConfig(
        method="dtw")).extract(weights, r.tokens, min(500, enc.shape[1]))
    t2 = time.perf_counter()
    out["words"] = {"n": len(r.words), "tokens": len(r.tokens),
                    "traced_ms": 1e3 * (t1 - t0), "dtw_ms": 1e3 * (t2 - t1),
                    "weights_mb": weights.nbytes / 1e6}
    log(f"[longform] (f) {len(r.words)} words over {len(r.tokens)} tokens, "
        f"monotone, within [0, 10] s; f32 kernels == plain (tokens and "
        f"words); traced forward {out['words']['traced_ms']:.1f} ms "
        f"({out['words']['weights_mb']:.1f} MB of weights), DTW (the host "
        f"runtime) and words {out['words']['dtw_ms']:.1f} ms (through "
        f"NumPy {NUMPY_DTW_MS} ms)")
    return out


# ---------------------------------------------------------------------------
# phase 6c: the CLI and the HTTP server
# ---------------------------------------------------------------------------

def cli_run(argv: list) -> tuple:
    """(exit code, stdout, stderr) of ``whisper_apr_tpu_torch.cli.run``."""
    import io
    from whisper_apr_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.run(argv)
    return rc, out.getvalue(), err.getvalue()


def http(base: str, method: str, path: str, body: bytes = None,
         headers: dict = None) -> tuple:
    """(status, body, host-clock seconds) of one request; an answer
    other than 2xx raises."""
    import urllib.request
    req = urllib.request.Request(base + path, data=body,
                                 headers=headers or {}, method=method)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        data = r.read()
        code = r.status
    return code, data, time.perf_counter() - t0


def multipart(fields: dict, boundary: str = "smoke0boundary") -> tuple:
    """(content type, body) of a multipart/form-data request; ``file`` is
    WAV bytes, the other fields text."""
    body = b""
    for name, value in fields.items():
        body += f"--{boundary}\r\n".encode()
        if name == "file":
            body += (b'Content-Disposition: form-data; name="file"; '
                     b'filename="clip.wav"\r\nContent-Type: audio/wav'
                     b"\r\n\r\n" + value)
        else:
            body += (f'Content-Disposition: form-data; name="{name}"'
                     f"\r\n\r\n{value}").encode()
        body += b"\r\n"
    return (f"multipart/form-data; boundary={boundary}",
            body + f"--{boundary}--\r\n".encode())


def serve_with_clients(server, clients) -> dict:
    """``server.serve_forever()`` on THIS thread (the device loop) while
    ``clients(base)`` runs on another; the server is shut down when the
    clients end, however they end. Returns what ``clients`` returned;
    what it raised is raised here."""
    import threading
    res = {}

    def run():
        base = None
        try:
            deadline = time.time() + 120
            while server._httpd is None and time.time() < deadline:
                time.sleep(0.01)
            base = f"http://127.0.0.1:{server._httpd.server_address[1]}"
            res["out"] = clients(base)
        except BaseException as e:  # noqa: BLE001 — raised on this thread
            res["error"] = e
        finally:
            server.shutdown()
            if server.single_thread and base is not None:
                # wake the blocked handle_request
                with contextlib.suppress(OSError):
                    http(base, "GET", "/healthz")
    t = threading.Thread(target=run, daemon=True)
    t.start()
    server.serve_forever()
    t.join(timeout=600)
    assert not t.is_alive(), "[cli] server clients did not finish"
    if "error" in res:
        raise res["error"]
    return res["out"]


def phase_cli(apr: Path, workdir: Path, card: str, device="cuda",
              max_tokens: int = 64, clip_seconds: float = 12.0,
              serve_seconds=SERVE_SECONDS, session_seconds: float = 20.0,
              f32_clips: int = 4, f32_tokens: int = 48) -> dict:
    """The port's CLI and HTTP server over the e2e ``.apr`` (int8 weights;
    bf16, cross8 unless ``--fp32``), as a user runs them: (a) ``cli.run``
    of transcribe (json, srt; 1 decode), batch of 4 WAVs (1 decode of 4
    rows), detect-language, model (H100 floors), validate and diagnose,
    each command's launches counted from 0 and held to its decodes; the
    ``--fp32`` tokens against the same engine's ``transcribe_long``
    through the plain versions; (b) ``python -m whisper_apr_tpu_torch.cli
    transcribe`` in a subprocess on the built kernels, its stdout (a)'s;
    (c) ``TranscribeServer(n_slots=8)``, threaded, the device loop on this
    thread and clients on a thread pool: the ``serve_seconds`` clips
    posted at once, an OpenAI multipart request of a 2 s 44.1 kHz WAV, an
    async request with a poll and a cancelled one; then the second clip
    alone (the HTTP overhead without contention), a streaming session
    (``session_seconds`` at 16 kHz in 0.5 s blocks, finalize) and
    ``/metrics``: every answer 2xx, every completion "ok" but the
    cancelled one, no session "error" event, the ticks' launches (K5-K7 L
    times and K8 once a tick) and the session's decodes' (K1-K4); then an
    f32 int8-KV engine behind a ``--single-thread`` server, whose HTTP
    tokens follow per-clip transcribe (near-tie rule); (d) latency data
    lines, each with ``card``. On the CPU (a rehearsal through the plain
    versions) nothing launches and the counts are not held."""
    import argparse
    import urllib.parse
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from whisper_apr_tpu_torch import (ComputeConfig, TranscribeOptions,
                                       WhisperApr, native)
    from whisper_apr_tpu_torch.audio.resample import SincResampler
    from whisper_apr_tpu_torch.audio.wav import parse_wav
    from whisper_apr_tpu_torch.cli import commands
    from whisper_apr_tpu_torch.cli.args import parse_args
    from whisper_apr_tpu_torch.cli.serve import TranscribeServer
    from whisper_apr_tpu_torch.format import AprReader
    check_counts = torch.device(device).type == "cuda"
    header = AprReader.from_file(str(apr)).header
    L = header.n_text_layer
    sr = 16_000
    window = 2 * header.n_audio_ctx * 160
    overlap = min(sr, window // 4)
    n16 = int(clip_seconds * sr)
    # transcribe_long: every window of the clip in one decode
    n_win = 1 if n16 <= window else -(-(n16 - overlap) // (window - overlap))
    out = {"commands": {}, "launches": []}

    def held(name: str, counts: dict, want: dict) -> None:
        out["launches"].append(counts)
        if check_counts:
            assert counts == want, f"[cli] {name}: launches {counts}, " \
                f"want {want}"

    def command(name: str, argv: list, rows=None) -> str:
        """``cli.run(argv)`` from zeroed counts; exit 0, launches equal
        its decodes'; returns its stdout."""
        reset_launches()
        sync(device)
        with decode_log() as calls:
            t0 = time.perf_counter()
            rc, stdout, stderr = cli_run(argv)
            sync(device)
            dt = time.perf_counter() - t0
        counts = launches()
        out["commands"][name] = {"seconds": dt, "decodes": calls}
        log(f"[cli] (a) {name}: exit {rc}, {dt * 1e3:.1f} ms with the load, "
            f"decodes (rows, prompt, steps) {calls}, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        assert rc == 0, f"[cli] {name}: exit {rc}\n{stderr[-3000:]}"
        if rows is not None:
            assert [b for b, _, _ in calls] == rows, (name, calls)
        held(name, counts, want_decodes(calls, L))
        return stdout

    # (a) the commands in process
    wav = workdir / "cli_clip.wav"
    write_wav(wav, tone_noise(clip_seconds, sr, seed=21), sr)
    dec = ["-l", "en", "--no-fallback", "--max-tokens", str(max_tokens),
           "--device", device]
    as_json = command("transcribe json", ["transcribe", str(wav), "-m",
                                          str(apr), "-of", "json"] + dec,
                      rows=[n_win])
    text = json.loads(as_json)["text"]
    srt = command("transcribe srt", ["transcribe", str(wav), "-m", str(apr),
                                     "-of", "srt"] + dec, rows=[n_win])
    assert srt.startswith("1\n00:00:00,000 --> ") and text.strip() in srt, \
        srt[:300]
    batch_wavs = []
    for i, sec in enumerate((3, 7, 12, 25)):
        batch_wavs.append(workdir / f"cli_batch_{i}.wav")
        write_wav(batch_wavs[-1], tone_noise(sec, sr, seed=30 + i,
                                             freq=200 + 50 * i), sr)
    listing = command("batch", ["batch", *map(str, batch_wavs), "-m",
                                str(apr), "-of", "json"] + dec, rows=[4])
    for w in batch_wavs:
        assert f"{w} -> {w.with_suffix('.json')}" in listing, listing
        json.loads(w.with_suffix(".json").read_text())["text"]
    langs = command("detect-language", ["detect-language", str(wav), "-m",
                                        str(apr), "--device", device],
                    rows=[])
    assert len(langs.splitlines()) == 5, langs
    info = command("model", ["model", "-m", str(apr)], rows=[])
    assert "nvidia-h100-sxm floors (int8)" in info and \
        "v5e" not in info.lower(), info
    report = command("validate", ["validate", "-m", str(apr)], rows=[])
    assert "25/25 checks passed" in report, report
    diag = command("diagnose", ["diagnose", "-m", str(apr), "--device",
                                device], rows=[])
    if check_counts:
        assert (f"[OK] torch device: {torch.cuda.get_device_name(0)} (sm_"
                in diag and "[OK] kernels: libwhisper_kernels_" in diag), \
            diag
    else:
        assert "[OK] kernels: skipped (device cpu)" in diag, diag

    argv32 = ["transcribe", str(wav), "-m", str(apr), "-of", "json-full",
              "--fp32"] + dec
    cli32 = json.loads(command("transcribe --fp32", argv32, rows=[n_win]))
    args32 = parse_args(argv32)
    eng32 = commands._load_engine(args32)
    with plain_kernels():
        plain = eng32.transcribe_long(commands._load_audio(str(wav)),
                                      commands._options_from_args(
                                          args32, "transcribe"))
    assert cli32["tokens"] == plain.tokens, (
        f"[cli] --fp32 tokens {cli32['tokens'][:12]}..., plain "
        f"{plain.tokens[:12]}...")
    log(f"[cli] (a) --fp32: {len(plain.tokens)} tokens through the kernels "
        f"== the engine's transcribe_long through the plain versions")

    # (b) one subprocess, as a user starts it
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_apr_tpu_torch.cli", "transcribe",
         str(wav), "-m", str(apr), "-of", "json"] + dec, cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    out["subprocess_s"] = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout == as_json, (proc.stdout[:300], as_json[:300])
    log(f"[cli] (b) python -m whisper_apr_tpu_torch.cli transcribe: exit 0 "
        f"in {out['subprocess_s']:.2f} s (process start, load, decode), "
        f"the text of (a)")

    # (c) the server, as run_serve builds it
    args = parse_args(["serve", "-m", str(apr), "--port", "0", "--slots",
                       "8", "--device", device])
    server = TranscribeServer(
        commands._load_engine(args), host=args.host, port=args.port,
        n_slots=args.slots, single_thread=args.single_thread,
        batched_admission=not args.staged_admission)
    clips = make_clips(serve_seconds, seed=23)
    wav44 = workdir / "cli_44k.wav"
    write_wav(wav44, tone_noise(2.0, STREAM_RATE, seed=25), STREAM_RATE)
    samples44, _ = parse_wav(wav44.read_bytes())
    t0 = time.perf_counter()
    SincResampler(STREAM_RATE, sr).resample(samples44)
    resample_ms = 1e3 * (time.perf_counter() - t0)
    session_audio = bursts(((2, 0), (7, 240), (2, 0), (6, 300), (3, 0)),
                           sr, seed=27)[: int(session_seconds * sr)]
    push_s = []        # (seconds, emitted a partial) of each session push
    f32le = {"X-Sample-Format": "f32le"}
    q = f"?language=en&max_tokens={max_tokens}"

    def clients(base: str) -> dict:
        def clip(audio):
            code, data, s = http(base, "POST", "/v1/transcribe" + q,
                                 audio.astype("<f4").tobytes(), f32le)
            return code, json.loads(data), s

        def openai():
            ctype, body = multipart({"file": wav44.read_bytes(),
                                     "language": "en",
                                     "response_format": "verbose_json"})
            code, data, s = http(base, "POST", "/v1/audio/transcriptions",
                                 body, {"Content-Type": ctype})
            return code, json.loads(data), s

        def job(rid):
            while True:
                code, data, _ = http(base, "GET", f"/v1/jobs/{rid}")
                body = json.loads(data)
                if body["status"] != "pending":
                    return code, body
                time.sleep(0.005)

        def async_poll():
            code, data, _ = http(base, "POST", "/v1/transcribe" + q
                                 + "&async=1", clips[0].astype("<f4")
                                 .tobytes(), f32le)
            assert code == 202, code
            return job(json.loads(data)["id"])

        def cancelled():
            code, data, _ = http(base, "POST", "/v1/transcribe?language=en"
                                 "&max_tokens=224&async=1",
                                 clips[1].astype("<f4").tobytes(), f32le)
            rid = json.loads(data)["id"]
            c, ack, _ = http(base, "POST", f"/v1/cancel?id={rid}", b"")
            assert (code, c, json.loads(ack)) == (
                202, 200, {"id": rid, "cancelled": True}), ack
            return job(rid)

        res = {}
        with ThreadPoolExecutor(max_workers=len(clips) + 3) as pool:
            futs = [pool.submit(clip, c) for c in clips]
            extra = {name: pool.submit(fn) for name, fn in (
                ("openai", openai), ("async", async_poll),
                ("cancel", cancelled))}
            res["clips"] = [f.result() for f in futs]
            res.update({k: f.result() for k, f in extra.items()})
        # one 30 s clip alone, the device loop otherwise idle: the HTTP
        # overhead without contention for the interpreter
        res["alone"] = clip(clips[1])
        # the session, after the burst: its partials serialize with ticks
        code, data, _ = http(base, "POST", "/v1/sessions?language=en"
                             f"&rate={sr}")
        assert code == 201, code
        sid = json.loads(data)["session"]
        sess = server._sessions[sid].session
        real_push = sess.push

        def timed_push(chunk):
            t0 = time.perf_counter()
            r = real_push(chunk)
            sync(device)
            push_s.append((time.perf_counter() - t0,
                           any(e.kind == "partial" for e in r)))
            return r
        sess.push = timed_push
        for i in range(0, len(session_audio), sr // 2):
            code, _, _ = http(base, "POST", f"/v1/sessions/{sid}/audio",
                              session_audio[i:i + sr // 2].astype("<f4")
                              .tobytes())
            assert code == 200
        code, _, _ = http(base, "POST", f"/v1/sessions/{sid}/finalize", b"")
        assert code == 202
        while True:
            code, data, _ = http(base, "GET",
                                 f"/v1/sessions/{sid}/events?since=0")
            events = json.loads(data)
            if events["final"] is not None:
                break
            time.sleep(0.01)
        code, data, _ = http(base, "DELETE", f"/v1/sessions/{sid}")
        assert code == 200 and json.loads(data) == {"deleted": True}
        res["session"] = events
        res["metrics"] = http(base, "GET", "/metrics")[1].decode()
        return res

    reset_launches()
    native.reset_calls()
    sync(device)
    with decode_log() as calls:
        t0 = time.perf_counter()
        res = serve_with_clients(server, clients)
        wall_s = time.perf_counter() - t0
    counts = launches()
    # the host runtime: one resample, of the 44.1 kHz multipart request
    out["native"] = dict(native.CALLS)
    assert out["native"] == {**dict.fromkeys(native.CALLS, 0),
                             "resample_sinc": 1}, \
        f"[cli] serve: host runtime calls {out['native']}"
    st = server.scheduler.stats()
    for code, body, _ in res["clips"]:
        assert code == 200 and body["status"] == "ok", body
        t = np.asarray(body["tokens"])
        assert t.size > 1 and t.min() >= 0 and t.max() < server.engine \
            .config.n_vocab, body
    code, body, openai_s = res["openai"]
    assert code == 200 and body["task"] == "transcribe" and \
        abs(body["duration"] - 2.0) < 1e-3, body
    assert res["async"][0] == 200 and res["async"][1]["status"] == "ok"
    assert res["cancel"][1]["status"] == "cancelled", res["cancel"]
    events = res["session"]["events"]
    errors = [e for e in events if e["kind"] == "error"]
    assert not errors, f"[cli] session error events: {errors}"
    partials = [e for e in events if e["kind"] == "partial"]
    assert partials and events[-1]["kind"] == "final" and \
        res["session"]["final"], events[-3:]
    metrics = dict(line.split() for line in res["metrics"].splitlines()
                   if not line.startswith("#"))
    code, body, _ = res["alone"]
    assert code == 200 and body["status"] == "ok", body
    n_ok = len(clips) + 3
    assert (int(metrics["whisper_apr_completed_ok"]),
            int(metrics["whisper_apr_cancelled"])) == (n_ok, 1), metrics
    want = want_decodes(calls, L)
    assert all(b == 1 for b, _, _ in calls), calls
    for k in ("self_block_batched", "cross_block_batched",
              "ffn_block_batched"):
        want[k] += L * st["ticks"]
    want["qmatvec_stacked"] += st["ticks"]
    held("serve", counts, want)
    if check_counts:
        assert all(counts[k] > 0 for k in (
            "self_block", "cross_block", "ffn_block", "qmatvec_greedy_head",
            "self_block_batched", "cross_block_batched",
            "ffn_block_batched", "qmatvec_stacked")), counts

    # (d) the data lines
    lat = [1e3 * s for _, _, s in res["clips"]]
    queue = [b["queue_ms"] for _, b, _ in res["clips"]]
    decode = [b["decode_ms"] for _, b, _ in res["clips"]]
    over = [a - b - c for a, b, c in zip(lat, queue, decode)]
    _, body, s_alone = res["alone"]
    alone = {"latency_ms": 1e3 * s_alone, "queue_ms": body["queue_ms"],
             "decode_ms": body["decode_ms"]}
    alone["http_overhead_ms"] = (alone["latency_ms"] - alone["queue_ms"]
                                 - alone["decode_ms"])
    part = [s for s, p in push_s if p]
    pct = lambda xs, p: float(np.percentile(xs, p))
    out["server"] = {
        "requests": len(clips), "wall_s": wall_s, "ticks": st["ticks"],
        "latency_ms_p50": pct(lat, 50), "latency_ms_p95": pct(lat, 95),
        "queue_ms_p50": pct(queue, 50), "queue_ms_p95": pct(queue, 95),
        "decode_ms_p50": pct(decode, 50), "decode_ms_p95": pct(decode, 95),
        "http_overhead_ms_p50": pct(over, 50),
        "http_overhead_ms_p95": pct(over, 95),
        "http_overhead_ms_max": max(over), "alone": alone,
        "resample_ms_2s_44k": resample_ms,
        "openai_request_ms": 1e3 * openai_s,
        "tokens_per_decode_second": float(
            metrics["whisper_apr_tokens_per_decode_second"]),
        "session_pushes": len(push_s), "session_partials": len(part),
        "partial_ms_p50": percentile_ms(part, 50),
        "partial_ms_p95": percentile_ms(part, 95),
        "stats": st}
    s = out["server"]
    log(f"[cli] (c) {card}: {len(clips)} clips at once + multipart + async "
        f"+ cancel, one clip alone, then a {session_seconds:g} s session: {wall_s:.2f} s, "
        f"{st['ticks']} ticks, completed_ok {n_ok}, cancelled 1, no session "
        f"error event, {len(partials)} partial events; launches held "
        f"(ticks K5-K8, session decodes K1-K4)")
    log(f"[cli] (d) {card}: per-request latency (host clock, "
        f"{len(clips)} concurrent /v1/transcribe, {max_tokens} tokens) p50 "
        f"{s['latency_ms_p50']:.2f} ms, p95 {s['latency_ms_p95']:.2f}; "
        f"server queue_ms p50 {s['queue_ms_p50']:.1f} / p95 "
        f"{s['queue_ms_p95']:.1f}, decode_ms p50 {s['decode_ms_p50']:.1f} / "
        f"p95 {s['decode_ms_p95']:.1f}")
    log(f"[cli] (d) {card}: HTTP overhead (latency - queue - decode) p50 "
        f"{s['http_overhead_ms_p50']:.2f} ms, p95 "
        f"{s['http_overhead_ms_p95']:.2f}, max "
        f"{s['http_overhead_ms_max']:.2f}; one {serve_seconds[1]:g} s clip "
        f"alone afterwards: latency {alone['latency_ms']:.2f} ms, queue "
        f"{alone['queue_ms']:.1f}, decode {alone['decode_ms']:.1f}, "
        f"overhead {alone['http_overhead_ms']:.2f}")
    log(f"[cli] (d) {card}: resampling the 2 s 44.1 kHz request on the "
        f"host (the host runtime, once in the server run) "
        f"{resample_ms:.1f} ms; the multipart request "
        f"{s['openai_request_ms']:.1f} ms in all")
    log(f"[cli] (d) {card}: tokens_per_decode_second "
        f"{s['tokens_per_decode_second']:.1f}; session: {len(push_s)} "
        f"pushes, {len(part)} with a partial, per-partial push p50 "
        f"{s['partial_ms_p50']:.2f} ms, p95 {s['partial_ms_p95']:.2f}")

    # f32 (int8 KV, as the scheduler serves cross8) behind --single-thread
    eng_f32 = WhisperApr.load_from_apr(
        str(apr), ComputeConfig(quantization="int8", compute_dtype="float32",
                                kv_mode="int8"), device=device)
    server32 = TranscribeServer(eng_f32, port=0, n_slots=8,
                                single_thread=True)
    short = clips[:f32_clips]

    def clients32(base: str) -> list:
        ids = [json.loads(http(base, "POST", f"/v1/transcribe?language=en"
                               f"&max_tokens={f32_tokens}&async=1",
                               c.astype("<f4").tobytes(), f32le)[1])["id"]
               for c in short]
        toks = []
        for rid in ids:
            while True:
                body = json.loads(http(base, "GET", f"/v1/jobs/{rid}")[1])
                if body["status"] != "pending":
                    assert body["status"] == "ok", body
                    toks.append(body["tokens"])
                    break
        return toks

    reset_launches()
    got = serve_with_clients(server32, clients32)
    out["launches"].append(launches())
    P = len(eng_f32.get_initial_tokens("en"))
    opts = TranscribeOptions(language="en", max_tokens=P + f32_tokens)
    gaps = [check_follows(eng_f32, c, g, eng_f32.transcribe(c, opts).tokens,
                          "cli serve f32") for c, g in zip(short, got)]
    out["f32_gaps"] = gaps
    log(f"[cli] (c) f32 int8-KV, --single-thread: HTTP tokens of "
        f"{len(short)} clips against per-clip transcribe: "
        f"{sum(g is None for g in gaps)} identical, near-tie gaps "
        f"{[g for g in gaps if g is not None]}")
    return out


def phase_decoders(apr: Path, device="cuda", specials=None,
                   max_tokens: int = 64) -> dict:
    """The logits-tail decoders and the scan step through the engine's
    entry points at full width (whisper-tiny), each path's launches
    counted from 0 just before it: greedy in kv_mode "scan", beam search
    (one clip, and 8 clips x 5 beams = 40 rows), n-best, sampling,
    timestamp tokens, the temperature fallback; then in f32 every path
    through the kernels against the plain versions, beam_size=1 and
    sampling at T=0 against greedy (near-tie rule). Returns the launch
    counts and the times. On the CPU (a rehearsal through the plain
    versions) nothing launches and the counts are not held."""
    import torch
    from whisper_apr_tpu_torch import (ComputeConfig, TranscribeOptions,
                                       WhisperApr)

    def engine(dtype, kv_mode="auto"):
        return WhisperApr.load_from_apr(
            str(apr), ComputeConfig(quantization="int8", compute_dtype=dtype,
                                    kv_mode=kv_mode),
            specials=specials, device=device)
    eng, scan = engine("bfloat16"), engine("bfloat16", "scan")
    check_counts = torch.device(device).type == "cuda"
    cfg = eng.config
    L = cfg.n_text_layer
    sp = eng.specials
    P = len(eng.get_initial_tokens("en"))
    clips = make_clips((30, 5, 12, 8, 20, 4, 25, 10), seed=3)
    base = dict(language="en", max_tokens=P + max_tokens)
    out = {"paths": {}}

    def path(name, fn, want=None):
        """Run ``fn`` from zeroed counts; hold them to ``want(result)``."""
        reset_launches()
        sync(device)
        t0 = time.perf_counter()
        res = fn()
        sync(device)
        dt = time.perf_counter() - t0
        counts = launches()
        out["paths"][name] = {"seconds": dt, "launches": counts}
        log(f"[decoders] {name}: {dt * 1e3:.1f} ms, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if want is not None and check_counts:
            w = want(res, counts)
            assert counts == w, f"[decoders] {name}: launches {counts}, " \
                f"want {w}"
        return res

    def steps(r, prompt_len=P):
        return len(r.tokens) - prompt_len - 1

    def tail(prompt_len=P):  # K1-K3 per layer and K8 per step, B = 1
        def want(r, _):
            n = steps(r, prompt_len)
            return want_counts(self_block=L * n, cross_block=L * n,
                               ffn_block=L * n, qmatvec_stacked=n)
        return want

    def batched(r, c):       # K5-K7 L times per K8 launch, nothing else
        k8 = c["qmatvec_stacked"]
        assert k8 > 0, c
        return want_counts(self_block_batched=L * k8,
                           cross_block_batched=L * k8,
                           ffn_block_batched=L * k8, qmatvec_stacked=k8)

    opts = TranscribeOptions(**base)
    path("scan greedy", lambda: scan.transcribe(
        clips[0], TranscribeOptions(language="en")),
        lambda r, _: want_counts(qmatvec_stacked=(4 * L + 1) * steps(r),
                                 ffn_fused=L * steps(r)))
    beam = TranscribeOptions(**base, strategy="beam", beam_size=5)
    path("beam 5, 1 clip", lambda: eng.transcribe(clips[1], beam), batched)
    res8 = path("beam 5, 8 clips (40 rows)",
                lambda: eng.transcribe_batch(clips, beam), batched)
    # two 32-row chunks a step
    assert out["paths"]["beam 5, 8 clips (40 rows)"]["launches"][
        "qmatvec_stacked"] % 2 == 0
    assert len(res8.results) == 8
    nbest = path("nbest 5", lambda: eng.transcribe_nbest(clips[2], beam),
                 batched)
    assert len(nbest) == 5
    samp = TranscribeOptions(**base, temperature=0.8, top_k=40, seed=0)
    s1 = path("sampling T=0.8 top_k 40", lambda: eng.transcribe(clips[3],
                                                                samp), tail())
    s2 = eng.transcribe(clips[3], samp)
    assert s1.tokens == s2.tokens, "[decoders] same seed, other tokens"
    best_of = TranscribeOptions(**base, temperature=0.8, top_p=0.95,
                                best_of=3, seed=1)
    path("sampling best_of 3, top_p 0.95",
         lambda: eng.transcribe(clips[3], best_of), batched)
    P_ts = len(eng.get_initial_tokens("en", timestamps=True))
    ts = path("timestamps", lambda: eng.transcribe(
        clips[4], TranscribeOptions(**base, timestamps=True)), tail(P_ts))
    gen = ts.tokens[P_ts:]
    stamps = [t for t in gen if sp.timestamp_base <= t < cfg.n_vocab]
    assert sp.timestamp_base <= gen[0] <= sp.timestamp_base + 50, gen[:4]
    assert stamps == sorted(stamps), stamps
    fb = path("fallback", lambda: eng.transcribe_with_fallback(clips[5],
                                                               opts))
    log(f"[decoders] timestamps: first {gen[0] - sp.timestamp_base} steps "
        f"after base, {len(stamps)} timestamps, non-decreasing; fallback "
        f"ends at T={fb.temperature}; same seed, same {len(s1.tokens)} "
        f"tokens")

    # f32: through the kernels against the plain versions, same card
    e32, s32 = engine("float32"), engine("float32", "scan")
    checks = {
        "scan greedy": lambda: s32.transcribe(clips[0], opts).tokens,
        "beam 5": lambda: e32.transcribe(clips[1], beam).tokens,
        "beam 5, 8 clips": lambda: [
            r.tokens for r in e32.transcribe_batch(clips, beam).results],
        "nbest 5": lambda: [r.tokens for r in
                            e32.transcribe_nbest(clips[2], beam)],
        "sampling": lambda: e32.transcribe(clips[3], samp).tokens,
        "sampling best_of 3": lambda: e32.transcribe(clips[3],
                                                     best_of).tokens,
        "fallback": lambda: e32.transcribe_with_fallback(clips[5],
                                                         opts).tokens,
        "timestamps": lambda: e32.transcribe(
            clips[4], TranscribeOptions(**base, timestamps=True)).tokens,
        "scan beam 5": lambda: s32.transcribe(clips[1], beam).tokens}
    gaps = {}
    for name, fn in checks.items():
        kern = fn()
        with plain_kernels():
            plain = fn()
        if isinstance(kern[0], list):
            audios = clips if len(kern) == len(clips) else [clips[2]] * 5
            g = [check_same(e32, a, k, p, name)
                 for a, k, p in zip(audios, kern, plain)]
        else:
            audio = clips[{"scan greedy": 0, "beam 5": 1, "sampling": 3,
                           "sampling best_of 3": 3, "fallback": 5,
                           "timestamps": 4, "scan beam 5": 1}[name]]
            g = [check_same(e32, audio, kern, plain, name)]
        gaps[name] = [x for x in g if x is not None]
    greedy = e32.transcribe(clips[1], opts).tokens
    gaps["beam_size=1 vs greedy"] = [check_follows(
        e32, clips[1], e32.transcribe(clips[1], TranscribeOptions(
            **base, strategy="beam", beam_size=1)).tokens, greedy,
        "decoders")]
    gaps["sampling T=0 vs greedy"] = [check_follows(
        e32, clips[1], e32.transcribe(clips[1], TranscribeOptions(
            **base, strategy="sampling", temperature=0.0)).tokens, greedy,
        "decoders")]
    log(f"[decoders] f32: kernels == plain versions on every path, "
        f"beam_size=1 and sampling at T=0 == greedy; near-tie gaps "
        f"{ {k: v for k, v in gaps.items() if any(x is not None for x in v)} }")
    out["f32_gaps"] = gaps
    return out


MESH_RUNS = (
    # (name, ranks, backend, [(config, tp), ...], dryrun options)
    ("a", 1, "nccl", [("tiny", 1)], ["--clips", "2"]),
    ("b, c", 2, "gloo", [("tiny", 1), ("large-v3-4x4", 2)],
     ["--clips", "4", "--slots", "4", "--requests", "5"]),
)
# shared by every run: 24 greedy tokens a clip (3 forced), 24
# teacher-forced tokens, logits within 1e-4 of the largest magnitude;
# the scheduler's clips 3 s of noise each, up to 16 tokens a request
MESH_COMMON = ["--max-len", "24", "--tf-tokens", "24", "--tol", "1e-4",
               "--clip-samples", "48000", "--sched-len", "32",
               "--sched-tokens", "16"]


def phase_mesh(card: str, device="cuda", runs=MESH_RUNS,
               common=MESH_COMMON, timeout: float = 240.0) -> dict:
    """Phase 7d: (a) in this process (one rank: no process start), (b)
    and (c) as one launch of two ranks of ``parallel/dryrun.py`` running
    both cases in turn. The ranks check themselves: a failed rank or
    check raises. Returns each case's rank-0 report and the runs' wall
    seconds."""
    from whisper_apr_tpu_torch.parallel import dryrun
    out = {"wall_s": {}}
    for name, n, backend, cases, extra in runs:
        argv = ["--job", "mesh", "--n", str(n), "--backend", backend,
                "--device", device, "--timeout", str(timeout), "--out",
                str(ROOT / "build" / "smoke" / f"mesh_{name[0]}"),
                *(a for c, tp in cases for a in ("--case", f"{c}:{tp}")),
                *common, *extra]
        t0 = time.perf_counter()
        reports = (dryrun.run_here if n == 1 else dryrun.launch)(argv)
        out["wall_s"][name] = time.perf_counter() - t0
        for label, case in zip(name.split(", "), reports):
            r = {k: v for k, v in case[0].items() if k not in ("arrays",
                                                               "log")}
            assert all(rep["completions"] == r["completions"]
                       for rep in case), f"[mesh] ({label}) ranks " \
                "completed differently"
            r["rank_seconds"] = [rep["seconds"] for rep in case]
            out[label] = r
            ms = r["ms_per_token"]
            log(f"[mesh] ({label}) {n} rank(s), {backend}, dp x tp "
                f"{r['mesh']['dp']} x {r['mesh']['tp']}, {r['config']}: "
                f"logits max err {r['logits_max_err']:.3g} (of "
                f"{r['logits_scale']:.3g}), greedy "
                f"{'identical' if r['greedy_exact'] else 'near ties'} "
                f"{r['greedy_gaps']}, scheduler {len(r['completions'])} "
                f"requests ({len({tuple(c) for c in r['completions']})} "
                f"distinct) "
                f"{'identical' if r['serve_exact'] else 'near ties'}"
                f"; {ms['tokens']} tokens: {ms['mesh']:.3f} ms/token on the "
                f"mesh, {ms['single']:.3f} single; ranks "
                f"{max(r['rank_seconds']):.1f} s ({card})")
        log(f"[mesh] run ({name}): {out['wall_s'][name]:.1f} s with "
            f"{'the rank' if n == 1 else 'the launch'}")
    return out


SPEC_CASES = ((2, 1), (4, 1), (4, None))  # (draft_tokens, draft_layers); L


def phase_speculative(apr: Path, eng_bf16, card: str, device="cuda",
                      specials=None, max_tokens: int = 64) -> dict:
    """Phase 7e: speculative greedy through the engine's entry point on an
    f32 engine over ``apr`` (int8 weights, f32 rows), held to the same
    engine's plain greedy through the kernels (near-tie rule); the
    speculative path launches no kernel. At draft_layers = L every draft
    is accepted. The bf16 engine's mismatches are counted."""
    import torch
    from whisper_apr_tpu_torch import (ComputeConfig, TranscribeOptions,
                                       WhisperApr)
    from whisper_apr_tpu_torch.inference import speculative as spec_mod
    eng = WhisperApr.load_from_apr(
        str(apr), ComputeConfig(quantization="int8", compute_dtype="float32",
                                kv_mode="bf16"),
        specials=specials, device=device)
    L = eng.config.n_text_layer
    P = len(eng.get_initial_tokens("en"))
    clips = make_clips((8, 20), seed=11)
    base = dict(language="en", max_tokens=P + max_tokens)
    check_counts = torch.device(device).type == "cuda"
    rounds = []
    real = spec_mod.speculative_greedy_generate

    def counted(*a, **kw):
        res = real(*a, **kw)
        rounds.append((res.n_verify_passes, res.n_accepted))
        return res

    def timed(e, audio, opts):
        sync(device)
        t0 = time.perf_counter()
        r = e.transcribe(audio, opts)
        sync(device)
        return r, time.perf_counter() - t0

    out = {"cases": [], "bf16_mismatches": 0}
    spec_mod.speculative_greedy_generate = counted
    try:
        for ci, audio in enumerate(clips):
            opts = TranscribeOptions(**base)
            timed(eng, audio, opts)                      # warm-up
            plain, t_plain = timed(eng, audio, opts)
            n = max(len(plain.tokens) - P, 1)
            for k, ld in SPEC_CASES:
                ld = ld or L
                sopts = TranscribeOptions(**base, speculative=True,
                                          draft_tokens=k, draft_layers=ld)
                reset_launches()
                got, t_spec = timed(eng, audio, sopts)
                counts = launches()
                assert not check_counts or counts == want_counts(), \
                    f"[speculative] launches {counts}, want none"
                n_ver, n_acc = rounds[-1]
                gap = check_follows(eng, audio, got.tokens, plain.tokens,
                                    "speculative")
                if ld == L and gap is None:
                    assert n_acc == k * n_ver, (k, n_ver, n_acc)
                case = {"clip": ci, "draft_tokens": k,
                        "draft_layers": ld, "verify_passes": n_ver,
                        "accepted": n_acc, "tokens": len(got.tokens),
                        "near_tie_gap": gap,
                        "ms_per_token": 1e3 * t_spec / n,
                        "plain_ms_per_token": 1e3 * t_plain / n}
                out["cases"].append(case)
                log(f"[speculative] clip {ci} k={k} draft_layers={ld}: "
                    f"{n_ver} verify passes, {n_acc} drafts accepted, "
                    f"{len(got.tokens) - P} tokens "
                    f"{'identical' if gap is None else f'near tie {gap:.3g}'}"
                    f"; {case['ms_per_token']:.2f} ms/token against plain "
                    f"greedy's {case['plain_ms_per_token']:.2f} (kernels) "
                    f"({card})")
            # the bf16 engine: a fidelity-f32 property, counted only
            b_plain = eng_bf16.transcribe(audio, TranscribeOptions(**base))
            b_spec = eng_bf16.transcribe(audio, TranscribeOptions(
                **base, speculative=True))
            out["bf16_mismatches"] += int(b_spec.tokens != b_plain.tokens)
    finally:
        spec_mod.speculative_greedy_generate = real
    log(f"[speculative] bf16 engine: {out['bf16_mismatches']} of "
        f"{len(clips)} clips differ from its plain greedy (not a failure)")
    del eng
    return out


def phase_large_v3(device="cuda", max_tokens: int = 24) -> dict:
    """A large-v3-shaped model built in memory (init_params seed 0 +
    int8 quantize_params, no .apr): 30 s of noise through the mel, the
    encoder, the prefill and ``max_tokens`` decode steps at full width,
    f32 compute, cross8 cache; tokens through the kernels against the
    plain versions (near-tie rule), launch counts, times; then
    transcribe_long of 45 s of noise (two windows, one batch)."""
    from whisper_apr_tpu_torch import (ComputeConfig, ModelConfig,
                                       TranscribeOptions, WhisperApr)
    from whisper_apr_tpu_torch.model.params import (init_params,
                                                    quantize_params)
    cfg = ModelConfig.large_v3()
    t0 = time.perf_counter()
    params = quantize_params(init_params(cfg, seed=0), "int8")
    eng = WhisperApr(cfg, params, compute=ComputeConfig(
        quantization="int8", compute_dtype="float32"), device=device)
    del params
    build_s = time.perf_counter() - t0
    audio = np.random.default_rng(7).normal(0, 0.1, 30 * 16_000).astype(
        np.float32)
    opts = TranscribeOptions(language="en", max_tokens=max_tokens)
    P = len(eng.get_initial_tokens("en"))
    eng.transcribe(audio, opts)                         # warm-up
    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    kern = eng.transcribe(audio, opts)
    sync(device)
    dt = time.perf_counter() - t0
    counts = launches()
    n = len(kern.tokens) - P - 1
    L = cfg.n_text_layer
    want = want_counts(self_block=L * n, cross_block=L * n, ffn_block=L * n,
                       qmatvec_greedy_head=n)
    assert counts == want, f"[large-v3] launches {counts}, want {want}"
    with plain_kernels():
        t1 = time.perf_counter()
        plain = eng.transcribe(audio, opts)
        sync(device)
        dt_plain = time.perf_counter() - t1
    gap = check_same(eng, audio, kern.tokens, plain.tokens, "large-v3")
    log(f"[large-v3] built in {build_s:.1f} s; 30 s noise, {len(kern.tokens)}"
        f" tokens ({n} decode steps), f32: {dt * 1e3:.1f} ms through the "
        f"kernels, {dt_plain * 1e3:.1f} ms through the plain versions; "
        f"tokens {'identical' if gap is None else f'near tie {gap:.3g}'}; "
        f"launches {counts}")
    out = {"build_s": build_s, "seconds": dt, "plain_seconds": dt_plain,
           "decode_steps": n, "tokens": len(kern.tokens), "launches": counts,
           "near_tie_gap": gap}

    # transcribe_long over 45 s: two windows, K5-K7 at large-v3 width
    long_audio = np.random.default_rng(8).normal(0, 0.1, 45 * 16_000).astype(
        np.float32)
    reset_launches()
    sync(device)
    with decode_log() as calls:
        t0 = time.perf_counter()
        lr = eng.transcribe_long(long_audio, opts)
        sync(device)
        dt_long = time.perf_counter() - t0
    counts = launches()
    assert [b for b, _, _ in calls] == [2], calls
    want = want_decodes(calls, L)
    assert counts == want, f"[large-v3] long: launches {counts}, want {want}"
    out["long"] = {"seconds": dt_long, "launches": counts, "decodes": calls,
                   "segments": len(lr.segments)}
    log(f"[large-v3] transcribe_long of 45 s noise: 2 windows in one batch, "
        f"{calls[0][2]} decode steps, {dt_long * 1e3:.1f} ms wall, "
        f"{len(lr.segments)} segments; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    del eng
    return out


# ---------------------------------------------------------------------------
# phase 9: k-quant models (K10-K14)
# ---------------------------------------------------------------------------

KQ_MODES = ("q4k", "q5k", "q6k")
# planar bytes a weight (values and f32 group scales and zeros)
KQ_WEIGHT_BYTES = {"q4k": 0.75, "q5k": 1.25, "q6k": 1.25}
# mean magnitude of a planar value: random values centre on 0 after the zero
KQ_AMP = {"q4k": 7.5, "q5k": 15.5, "q6k": 32.0}
KQ_MATVEC = {"q4k": "q4k_matvec_stacked", "q5k": "kq_matvec_stacked",
             "q6k": "kq_matvec_stacked"}


def make_kq_blk(fmt: str, D: int, L: int, gen, device):
    """Random planar k-quant stacks of ``fmt`` in the kq_block_operands
    layout (checked by ``check_blk_kq``, as that function checks its
    own): uniform values over the format's range, effective scales that
    keep matvec outputs O(1), zeros near the values' mean (Q4_K, Q5_K)."""
    import torch
    from whisper_apr_tpu_torch.ops.decode_blocks_kq import check_blk_kq
    sub = 16 if fmt == "q6k" else 32
    lo, hi = {"q4k": (-128, 128), "q5k": (0, 32), "q6k": (-32, 32)}[fmt]

    def f32(*shape, lo=0.5, hi=1.5):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    def tri(K, N, gain=1.0):
        rows = K // 2 if fmt == "q4k" else K
        wq = torch.randint(lo, hi, (L, rows, N), generator=gen,
                           device=device, dtype=torch.int8)
        s = f32(L, K // sub, N) * gain / (KQ_AMP[fmt] * np.sqrt(K))
        z = None if fmt == "q6k" else \
            s * KQ_AMP[fmt] * f32(L, K // sub, N, lo=0.9, hi=1.1)
        return wq, s, z

    def b(N):
        return f32(L, 1, N, lo=-0.1, hi=0.1)

    blk = {"ln1_w": f32(L, 1, D), "ln1_b": b(D), "ln2_w": f32(L, 1, D),
           "ln2_b": b(D), "ln3_w": f32(L, 1, D), "ln3_b": b(D),
           "qkv": tri(D, 3 * D, 4.0), "bqkv": b(3 * D),
           "self_o": tri(D, D), "b_self_o": b(D),
           "cross_q": tri(D, D, 4.0), "b_cross_q": b(D),
           "cross_o": tri(D, D), "b_cross_o": b(D),
           "fc1": tri(D, 4 * D), "b_fc1": b(4 * D),
           "fc2": tri(4 * D, D), "b_fc2": b(D)}
    assert check_blk_kq(blk) == fmt
    return blk


def kq_bound(name: str, fmt: str, D: int, M: int = 1, rows: int = 0,
             cache_bytes: int = 2, scales: bool = False, act_bytes: int = 2,
             K: int = 0, N: int = 0):
    """(bound_ms, "bytes" or "operations") of one K10-K14 call, as
    ``bound``: the planar weight bytes (KQ_WEIGHT_BYTES a weight), the f32
    LayerNorm and bias vectors, the activations in and out and the cache
    rows, each once, over HBM_BPS, against 2 flops a weight per row (and
    4 per cache element) over the bf16 peak. K10/K11 (``*matvec*``) take
    their [K, N] shape."""
    n_w, n_f32 = {"self_block_kq": (4 * D * D, 6 * D),
                  "cross_block_kq": (2 * D * D, 4 * D),
                  "ffn_block_kq": (8 * D * D, 7 * D)}.get(name, (K * N, 0))
    row_bytes = D * cache_bytes + (4 if scales else 0)
    acts = M * (K + N) if n_f32 == 0 else 2 * M * D
    nbytes = n_w * KQ_WEIGHT_BYTES[fmt] + 4 * n_f32 + acts * act_bytes \
        + 2 * rows * row_bytes
    if name == "self_block_kq":
        nbytes += 2 * M * (row_bytes + 4)            # the new k/v rows
    flops = 2 * M * n_w + 4 * rows * D
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS["bfloat16"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _kq_matvec(fmt: str, plain: bool = False):
    from whisper_apr_tpu_torch.ops import kquants, q4k
    mod = q4k if fmt == "q4k" else kquants
    name = KQ_MATVEC[fmt] + ("_plain" if plain else "")
    return getattr(mod, name)


def exact_qkv_kq(x, blk, layer: int, fmt: str):
    """K12's projection in f64 from the plain version's LayerNorm output
    (rounded to x's dtype as it is) over the dequantized planar QKV
    weight: [1, 3D], the sums all but exact."""
    import torch
    from whisper_apr_tpu_torch.ops.basic import layer_norm
    l = layer
    h = layer_norm(x.float(), blk["ln1_w"][l, 0], blk["ln1_b"][l, 0])
    h = h.to(x.dtype).double()
    wq, s, z = (None if t is None else t[l] for t in blk["qkv"])
    if fmt == "q4k":           # byte row r: K value 2r low, 2r + 1 high
        u = wq.to(torch.int16) & 0xFF
        q = torch.stack([u & 0x0F, u >> 4], 1).reshape(-1, wq.shape[1])
    else:
        q = wq
    sub = q.shape[0] // s.shape[0]
    w = q.double() * s.double().repeat_interleave(sub, 0)
    if z is not None:
        w = w - z.double().repeat_interleave(sub, 0)
    return h @ w + blk["bqkv"][l].double()


# K12's positions: no history, one row, either side of 64 (a row group's
# span), one of K13's cut of the rows and the last row of a 448-token
# window
KQ_SELF_EDGES = (0, 1, 63, 64, 65, 255, 447)


def check_kq(fmt: str, D: int, H: int, L: int, T_self: int, T_cross: int,
             enc_len: int, cdt, label: str, seed: int,
             rows=(1, 8, 40)) -> dict:
    """K12-K14 against their plain versions at one shape in ``fmt``: K12
    at every ``KQ_SELF_EDGES`` position over every self-row dtype
    (``CROSS_CACHES``: int8, bf16, f32, fp8), each call twice: the two
    runs must give the same bits (elements of its new rows a step off at
    a rounding tie take the kernel's side, as in ``check_kernels``); K13
    over int8 rows (cross8), the FFN, at the first and last layer; then
    K10 or K11 over fc1's and fc2's weights at M in ``rows`` (40: two
    32-row chunks). K14 too runs twice with equal bits, and in a CUDA
    graph (``check_ffn_kq_graph``). Returns each kernel's max abs
    error."""
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    from whisper_apr_tpu_torch.ops import decode_blocks_kq as dbk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    blk = make_kq_blk(fmt, D, L, gen, dev)
    tol = TOL_BF16 if cdt == torch.bfloat16 else TOL_F32
    mv = KQ_MATVEC[fmt]
    ties = 0
    worst = dict.fromkeys(["self_block_kq", "cross_block_kq",
                           "ffn_block_kq", mv], 0.0)

    def x_in(M=1, K=D):
        return torch.randn((M, K), generator=gen, device=dev).to(cdt)

    def agree(name, got, ref, what):
        e = rel_err(got, ref)
        assert e <= tol, (f"[kquant] {label} {fmt} {name} {what}: rel err "
                          f"{e:.3g} > {tol:.3g}")
        worst[name] = max(worst[name], abs_err(got, ref))

    for name, mode, rows_dt in CROSS_CACHES:
        dt = cdt if rows_dt is None else getattr(torch, rows_dt)
        kq, ks, vq, vs = make_cache(mode, L, T_self, D, gen, dev, dt)
        for pos in KQ_SELF_EDGES:
            layer = (pos * 7) % L
            x = x_in()
            args = (x, blk, kq, ks, vq, vs, pos, layer, H)
            what = f"[kquant] {label} {fmt} self_block_kq {name} pos {pos}"
            got = dbk.self_block_kq(*args)
            again = dbk.self_block_kq(*args)
            with quantized_rows(db) as pre:
                ref = dbk.self_block_kq_plain(*args)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), (
                f"{what}: two runs differ")
            for i, row in ((1, "k_row"), (3, "v_row")):
                check_row(f"{what} {row}", got[i], ref[i], tol)
            for i, row in ((2, "k_scale"), (4, "v_scale")):
                check_row(f"{what} {row}", got[i], ref[i])
            if got[1].dtype != torch.float32:     # rows rounded from f32
                exact = exact_qkv_kq(x, blk, layer, fmt)
                ties_of = rounding_ties if mode == "int8" else float_ties
                tie = [ties_of(got[i], ref[i], pre[j],
                               exact[:, (j + 1) * D:(j + 2) * D], what,
                               KQ_TIE_MAX)
                       for j, i in enumerate((1, 3))]
                if any(t.any() for t in tie):
                    ties += int(sum(t.sum() for t in tie))
                    rows_kv = [torch.where(t, got[i], ref[i])
                               for t, i in zip(tie, (1, 3))]
                    with quantized_rows(db, rows_kv):
                        ref = dbk.self_block_kq_plain(*args)
            agree("self_block_kq", got[0], ref[0], f"{name} pos {pos}")
        del kq, ks, vq, vs
    kq, ks, vq, vs = make_cache("int8", L, T_cross, D, gen, dev, cdt)
    for layer in (0, L - 1):
        x = x_in()
        agree("cross_block_kq",
              dbk.cross_block_kq(x, blk, kq, ks, vq, vs, enc_len, layer, H),
              dbk.cross_block_kq_plain(x, blk, kq, ks, vq, vs, enc_len,
                                       layer, H), f"layer {layer}")
        x = x_in()
        got = dbk.ffn_block_kq(x, blk, layer)
        assert torch.equal(got, dbk.ffn_block_kq(x, blk, layer)), (
            f"[kquant] {label} {fmt} ffn_block_kq layer {layer}: two runs "
            f"differ")
        agree("ffn_block_kq", got, dbk.ffn_block_kq_plain(x, blk, layer),
              f"layer {layer}")
    check_ffn_kq_graph(blk, L - 1, x_in, f"{label} {fmt}")
    kern, plain = _kq_matvec(fmt), _kq_matvec(fmt, plain=True)
    for M in rows:
        for w, K in (("fc1", D), ("fc2", 4 * D)):
            for layer in (0, L - 1):
                x = x_in(M, K)
                got = kern(x, *blk[w], layer)
                assert got.dtype == cdt and got.shape == (
                    M, blk[w][0].shape[2])
                agree(mv, got, plain(x, *blk[w], layer),
                      f"{w} M {M} layer {layer}")
    torch.cuda.synchronize()
    log(f"[kquant] {label} {fmt}: K12-K14 and {mv} at M in {list(rows)} "
        f"agree with the plain versions, K12 at pos {list(KQ_SELF_EDGES)} "
        f"over {', '.join(n for n, *_ in CROSS_CACHES)} rows two runs "
        f"bit-identical ({ties} elements of its new rows a step off at a "
        f"rounding tie); max abs err " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()))
    return worst


def check_ffn_kq_graph(blk, layer: int, x_in, label: str,
                       replays: int = 3) -> None:
    """K14 captured in a CUDA graph and replayed ``replays`` times over
    the same x: every replay gives the eager call's bits, so each launch
    leaves its tickets as it found them (zero) and takes no state from
    the launch before."""
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks_kq as dbk
    x = x_in()
    want = dbk.ffn_block_kq(x, blk, layer)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = dbk.ffn_block_kq(x, blk, layer)
    for r in range(replays):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want), (
            f"[kquant] {label} ffn_block_kq graph replay {r}: differs from "
            f"the eager call")


# K10's edges: rows about its 8-row tiles and 32-row chunks (M), the scan
# step's four shapes at whisper-base and large-v3 (D x 3D, D x D, fc1,
# fc2), and odd group counts against partial strips (K / 32 = 1, 3, 9; N =
# 32, 96, 160 over 128-column strips)
Q4K_ROWS = (1, 2, 8, 9, 16, 17, 32, 33, 40)
Q4K_EDGES = tuple((K, N) for D in (512, 1280)
                  for K, N in ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D))) \
    + tuple((K, N) for K in (32, 96, 288) for N in (32, 96, 160))


def check_q4k_edges(cdt, seed: int) -> float:
    """K10 against its plain version at every ``Q4K_EDGES`` shape and
    ``Q4K_ROWS`` row count, layer 1 of a stack of two, each call twice and
    bit-identical; returns the max abs error."""
    import torch
    from whisper_apr_tpu_torch.ops import q4k
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tol = TOL_BF16 if cdt == torch.bfloat16 else TOL_F32
    worst = 0.0
    for K, N in Q4K_EDGES:
        wq = torch.randint(-128, 128, (2, K // 2, N), generator=gen,
                           device=dev, dtype=torch.int8)
        s = (0.5 + torch.rand((2, K // 32, N), generator=gen, device=dev)) \
            / (KQ_AMP["q4k"] * np.sqrt(K))
        z = s * KQ_AMP["q4k"] * (0.9 + 0.2 * torch.rand(
            s.shape, generator=gen, device=dev))
        for M in Q4K_ROWS:
            x = torch.randn((M, K), generator=gen, device=dev).to(cdt)
            got = q4k.q4k_matvec_stacked(x, wq, s, z, 1)
            again = q4k.q4k_matvec_stacked(x, wq, s, z, 1)
            ref = q4k.q4k_matvec_stacked_plain(x, wq, s, z, 1)
            what = (f"[kquant] {str(cdt)[6:]} q4k_matvec_stacked M={M} K={K} "
                    f"N={N}")
            assert got.dtype == cdt and got.shape == (M, N), what
            assert torch.equal(got, again), f"{what}: two runs differ"
            e = rel_err(got, ref)
            assert e <= tol, f"{what}: rel err {e:.3g} > {tol:.3g}"
            worst = max(worst, abs_err(got, ref))
    torch.cuda.synchronize()
    log(f"[kquant] {str(cdt)[6:]}: K10 at {len(Q4K_EDGES)} shapes x M in "
        f"{list(Q4K_ROWS)} agrees with the plain version, two runs "
        f"bit-identical; max abs err {worst:.3g}")
    return worst


# K11's shapes: the scan step's four at whisper-base and large-v3, and 1,
# 3 and 9 groups of K (32, 96, 288 for Q5_K; 16, 48, 144 for Q6_K: splits
# of an odd group count) against part strips (N = 32, 96, 160), at every
# ``Q4K_ROWS`` row count
KQ_EDGE_GROUPS = (1, 3, 9)


def kq_edges(fmt: str) -> tuple:
    """(K, N) of K11's smoke cases in ``fmt`` (see ``KQ_EDGE_GROUPS``)."""
    sub = 16 if fmt == "q6k" else 32
    return Q4K_EDGES[:8] + tuple((G * sub, N) for G in KQ_EDGE_GROUPS
                                 for N in (32, 96, 160))


def check_kq_edges(fmt: str, cdt, seed: int) -> float:
    """K11 in ``fmt`` (q5k or q6k) against its plain version at every
    ``kq_edges`` shape and ``Q4K_ROWS`` row count, layer 1 of a stack of
    two with values over the format's range, each call twice and
    bit-identical; returns the max abs error."""
    import torch
    from whisper_apr_tpu_torch.ops import kquants
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tol = TOL_BF16 if cdt == torch.bfloat16 else TOL_F32
    sub = 16 if fmt == "q6k" else 32
    lo = -32 if fmt == "q6k" else 0
    worst = 0.0
    for K, N in kq_edges(fmt):
        wq = torch.randint(lo, 32, (2, K, N), generator=gen, device=dev,
                           dtype=torch.int8)
        s = (0.5 + torch.rand((2, K // sub, N), generator=gen, device=dev)) \
            / (KQ_AMP[fmt] * np.sqrt(K))
        z = None if fmt == "q6k" else s * KQ_AMP[fmt] * (
            0.9 + 0.2 * torch.rand(s.shape, generator=gen, device=dev))
        for M in Q4K_ROWS:
            x = torch.randn((M, K), generator=gen, device=dev).to(cdt)
            got = kquants.kq_matvec_stacked(x, wq, s, z, 1)
            again = kquants.kq_matvec_stacked(x, wq, s, z, 1)
            ref = kquants.kq_matvec_stacked_plain(x, wq, s, z, 1)
            what = (f"[kquant] {str(cdt)[6:]} {fmt} kq_matvec_stacked M={M} "
                    f"K={K} N={N}")
            assert got.dtype == cdt and got.shape == (M, N), what
            assert torch.equal(got, again), f"{what}: two runs differ"
            e = rel_err(got, ref)
            assert e <= tol, f"{what}: rel err {e:.3g} > {tol:.3g}"
            worst = max(worst, abs_err(got, ref))
    torch.cuda.synchronize()
    log(f"[kquant] {str(cdt)[6:]} {fmt}: K11 at {len(kq_edges(fmt))} shapes "
        f"x M in {list(Q4K_ROWS)} agrees with the plain version, two runs "
        f"bit-identical; max abs err {worst:.3g}")
    return worst


# K13's cross lengths over a 1536-row cache: none (every padded row at
# NEG), one row, either side of a 32-row group, the encoder's 1500 frames
# and the whole cache
KQ_CROSS_EDGES = (0, 1, 31, 32, 33, 1500, 1536)


def check_cross_kq(fmt: str, D: int, H: int, cdt, label: str, seed: int,
                   L: int = 2, T: int = 1536) -> float:
    """K13 against its plain version over ``fmt`` weights at every cache
    dtype (``CROSS_CACHES``) and every ``KQ_CROSS_EDGES`` length, each
    call twice: the two runs must give the same bits. Returns the max abs
    error."""
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks_kq as dbk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    blk = make_kq_blk(fmt, D, L, gen, dev)
    tol = TOL_BF16 if cdt == torch.bfloat16 else TOL_F32
    worst = 0.0
    for name, mode, rows_dt in CROSS_CACHES:
        dt = cdt if rows_dt is None else getattr(torch, rows_dt)
        kq, ks, vq, vs = make_cache(mode, L, T, D, gen, dev, dt)
        for enc_len in KQ_CROSS_EDGES:
            layer = enc_len % L
            x = torch.randn((1, D), generator=gen, device=dev).to(cdt)
            args = (x, blk, kq, ks, vq, vs, enc_len, layer, H)
            got = dbk.cross_block_kq(*args)
            again = dbk.cross_block_kq(*args)
            ref = dbk.cross_block_kq_plain(*args)
            torch.cuda.synchronize()
            what = (f"[kquant] {label} {fmt} cross_block_kq {name} enc_len "
                    f"{enc_len}")
            assert torch.equal(got, again), f"{what}: two runs differ"
            e = rel_err(got, ref)
            assert e <= tol, f"{what}: rel err {e:.3g} > {tol:.3g}"
            worst = max(worst, abs_err(got, ref))
        del kq, ks, vq, vs
    log(f"[kquant] {label} {fmt}: K13 at enc_len {list(KQ_CROSS_EDGES)} over "
        f"{', '.join(n for n, *_ in CROSS_CACHES)} rows agrees with the "
        f"plain version, two runs bit-identical; max abs err {worst:.3g}")
    return worst


def time_kq(fmt: str, D: int, H: int, L: int, T_self: int, T_cross: int,
            enc_len: int, pos: int, label: str, seed: int) -> dict:
    """K12-K14 and K10/K11 (M=1, the scan step's four weights: fc1's under
    the kernel's name, the others as "<name> qkv", "dd", "fc2") against
    their plain versions, device ms per call by CUDA-graph replay (eager in
    "eager_*"), at the main path's B=1 shapes: bf16 activations, bf16
    self rows at ``pos``, int8 cross rows (cross8); with the bound and no
    library call (no single PyTorch call computes a k-quant matvec)."""
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks_kq as dbk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cdt = torch.bfloat16
    blk = make_kq_blk(fmt, D, L, gen, dev)
    sk, _, sv, _ = make_cache("rows", L, T_self, D, gen, dev, cdt)
    ck, cks, cv, cvs = make_cache("int8", L, T_cross, D, gen, dev, cdt)
    x = torch.randn((1, D), generator=gen, device=dev).to(cdt)
    layer = L - 1
    mv = KQ_MATVEC[fmt]
    kern, plain = _kq_matvec(fmt), _kq_matvec(fmt, plain=True)
    cases = {
        "self_block_kq": (
            lambda: dbk.self_block_kq(x, blk, sk, None, sv, None, pos,
                                      layer, H),
            lambda: dbk.self_block_kq_plain(x, blk, sk, None, sv, None, pos,
                                            layer, H)),
        "cross_block_kq": (
            lambda: dbk.cross_block_kq(x, blk, ck, cks, cv, cvs, enc_len,
                                       layer, H),
            lambda: dbk.cross_block_kq_plain(x, blk, ck, cks, cv, cvs,
                                             enc_len, layer, H)),
        "ffn_block_kq": (lambda: dbk.ffn_block_kq(x, blk, layer),
                         lambda: dbk.ffn_block_kq_plain(x, blk, layer))}
    shapes = {"self_block_kq": dict(rows=pos),
              "cross_block_kq": dict(rows=enc_len, cache_bytes=1,
                                     scales=True),
              "ffn_block_kq": {}}
    # K10 / K11 at the scan step's four shapes, M = 1 (fc1's row is the
    # kernels line's)
    for key, w in ((mv, "fc1"), (f"{mv} qkv", "qkv"), (f"{mv} dd", "self_o"),
                   (f"{mv} fc2", "fc2")):
        K = D * (4 if w == "fc2" else 1)
        xk = torch.randn((1, K), generator=gen, device=dev).to(cdt)
        cases[key] = (lambda xk=xk, w=w: kern(xk, *blk[w], layer),
                      lambda xk=xk, w=w: plain(xk, *blk[w], layer))
        shapes[key] = dict(K=K, N=blk[w][0].shape[2])
    out = {}
    for name, (k, p) in cases.items():
        p1, k1, k2, p2 = graph_ms(p), graph_ms(k), graph_ms(k), graph_ms(p)
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "eager_ms": cuda_ms(k), "eager_plain_ms": cuda_ms(p),
                     "library_ms": None}
        out[name]["bound_ms"], out[name]["bound_by"] = kq_bound(
            name, fmt, D, **shapes[name])
    log(f"[time] {label} {fmt} (pos {pos}, bf16 self rows, cross8), device "
        f"ms per call (eager) vs plain, bound: " + "; ".join(
            f"{k} {v['ms']:.4f} ({v['eager_ms']:.4f}) vs {v['plain_ms']:.4f}"
            f", bound {v['bound_ms']:.4f}" for k, v in out.items()))
    return out


def time_kq_steps(D: int, H: int, L: int, n_vocab: int, label: str,
                  seed: int, pos: int = 128, fmts=KQ_MODES) -> dict:
    """Device ms of one B=1 decode step over a k-quant qd (K12-K14 per
    layer, the K8 logits tail; cross8 cache, bf16) by CUDA-graph replay,
    eager in brackets, with random planar stacks of each format, and of
    the scan step ("<fmt>_scan": K10 or K11 six times a layer, torch
    attention over the dense cache, the K8 logits)."""
    import torch
    from whisper_apr_tpu_torch.config import ModelConfig
    from whisper_apr_tpu_torch.model import qdecode
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg = ModelConfig("timing", n_vocab, 1500, D, H, L, 448, D, H, L, 80)
    out = {}
    for fmt in fmts:
        blk = make_kq_blk(fmt, D, L, gen, dev)
        params, qd, kv = scan_case(blk, D, L, n_vocab, 1, gen, dev,
                                   torch.bfloat16)
        qd["mode"] = fmt
        qkv = qdecode.quantize_cache(kv, "cross8")
        tok = torch.randint(0, n_vocab, (1,), generator=gen, device=dev,
                            dtype=torch.int32)

        def step():
            return qdecode.decode_step_qf(params, qd, tok, pos, qkv, cfg,
                                          compute_dtype=torch.bfloat16)

        def scan():
            return qdecode.decode_step_q(params, qd, tok, pos, kv, cfg,
                                         compute_dtype=torch.bfloat16)
        for key, fn in ((fmt, step), (f"{fmt}_scan", scan)):
            out[key] = {"ms": min(graph_ms(fn, reps=3, replays=5),
                                  graph_ms(fn, reps=3, replays=5)),
                        "eager_ms": cuda_ms(fn, iters=10)}
        del blk, params, qd, kv, qkv
        torch.cuda.empty_cache()
    log(f"[time] {label} k-quant B=1 decode step (K12-K14 x {L} + K8; "
        f"_scan: K10/K11 x 6 x {L} + K8), "
        f"device ms (eager ms), pos {pos}, bf16, cross8: " + ", ".join(
            f"{k} {v['ms']:.4f} ({v['eager_ms']:.4f})" for k, v in out.items()))
    return out


def phase_kquant_kernels() -> tuple:
    """K10-K14 against their plain versions in every format at the
    whisper-base and large-v3 decoder shapes (bf16; f32 at base), K10 and
    K11 at their edges (``check_q4k_edges``, ``check_kq_edges``, bf16 and
    f32), then their times at both and the large-v3 B=1 k-quant steps.
    Returns (max abs errors, times)."""
    import torch
    base = dict(D=512, H=8, L=4, T_self=512, T_cross=1536, enc_len=1500)
    large = dict(D=1280, H=20, L=4, T_self=512, T_cross=1536, enc_len=1500)
    errs = {}
    for i, fmt in enumerate(KQ_MODES):
        for shape, cdt, label in ((base, torch.bfloat16, "base bf16"),
                                  (base, torch.float32, "base f32"),
                                  (large, torch.bfloat16, "large-v3 bf16")):
            w = check_kq(fmt, **shape, cdt=cdt, label=label, seed=30 + i)
            for k, v in w.items():
                errs[k] = max(errs.get(k, 0.0), v)
        for (D, H, label), cdt in itertools.product(
                ((512, 8, "base"), (1280, 20, "large-v3")),
                (torch.bfloat16, torch.float32)):
            e = check_cross_kq(fmt, D, H, cdt,
                               f"{label} {str(cdt).split('.')[-1]}",
                               seed=33 + i)
            errs["cross_block_kq"] = max(errs["cross_block_kq"], e)
    for seed, cdt in ((36, torch.bfloat16), (37, torch.float32)):
        errs["q4k_matvec_stacked"] = max(errs["q4k_matvec_stacked"],
                                         check_q4k_edges(cdt, seed))
        for i, fmt in enumerate(("q5k", "q6k")):
            errs["kq_matvec_stacked"] = max(
                errs["kq_matvec_stacked"],
                check_kq_edges(fmt, cdt, seed + 2 * (i + 1)))
    times = {}
    for i, fmt in enumerate(KQ_MODES):
        times[f"base_{fmt}"] = time_kq(fmt, **base, pos=128, label="base",
                                       seed=40 + i)
        times[f"large_v3_{fmt}"] = time_kq(fmt, **large, pos=128,
                                           label="large-v3", seed=50 + i)
    times["large_v3_kq_steps"] = time_kq_steps(1280, 20, 32, 51866,
                                               "large-v3", seed=60)
    torch.cuda.empty_cache()
    return errs, times


def write_kq_apr(path: Path, cfg, mode: str) -> None:
    """Random-weight (seed 0) .apr of ``cfg`` with header quantization
    q4k/q5k/q6k, via the port's writer."""
    from whisper_apr_tpu_torch.format import (QUANT_Q4K, QUANT_Q5K,
                                              QUANT_Q6K, AprWriter)
    from whisper_apr_tpu_torch.model.params import (init_params,
                                                    params_to_apr_tensors)
    code = {"q4k": QUANT_Q4K, "q5k": QUANT_Q5K, "q6k": QUANT_Q6K}[mode]
    w = AprWriter.from_config(cfg, quantization=code)
    for name, arr in params_to_apr_tensors(init_params(cfg, seed=0)).items():
        w.add_tensor(name, arr)
    w.write_file(str(path))


@contextlib.contextmanager
def transcode_as_qd(eng):
    """Decode a k-quant engine at every batch through its int8 transcode
    (K1-K4 at B=1): the per-clip reference of its batched paths."""
    saved = eng._qdecode
    eng._qdecode_cache = eng._qdecode_batched
    try:
        yield
    finally:
        eng._qdecode_cache = saved


def phase_kquant(workdir: Path, cfg=None, device="cuda", specials=None,
                 max_tokens: int = 48) -> dict:
    """k-quant models through the engine's entry points: for each of
    q4k, q5k, q6k an .apr of ``cfg`` (default whisper-base, the smallest
    preset whose decoder is 256-aligned) written by the port, loaded with
    WhisperApr.load_from_apr, 30 s of noise at B=1 (K12-K14 L times and K4
    once per step), the bench protocol's RTF in bf16, and in f32 the
    tokens through the kernels against the plain versions (identical);
    kv_mode "scan" on the q4k engine (K10 6L times and K8 once per step)
    and the q5k engine (K11); then over the q4k engine transcribe_batch of
    4 clips (K5-K7 L times and K4 once per step, on the int8 transcode)
    and BatchScheduler(n_slots=4) (K5-K7 L times and K8 once per tick),
    whose f32 tokens follow per-clip decoding through the transcode
    (near-tie rule). Each path's launches count from 0 just before it;
    ``launch_checks`` lists (path, counts, want) for the card."""
    from whisper_apr_tpu_torch import (ComputeConfig, ModelConfig,
                                       TranscribeOptions, WhisperApr)
    from whisper_apr_tpu_torch.parallel.serving import BatchScheduler
    cfg = cfg or ModelConfig.base()
    L = cfg.n_text_layer
    rng = np.random.default_rng(0)
    noise = rng.normal(0, 0.1, 30 * 16_000).astype(np.float32)
    clips = make_clips((4, 9, 17, 30), seed=4)
    out = {"paths": {}, "launch_checks": [], "rtf": {}, "f32_gaps": {}}

    def engine(apr, mode, dtype, kv_mode="auto"):
        return WhisperApr.load_from_apr(
            str(apr), ComputeConfig(quantization=mode, compute_dtype=dtype,
                                    kv_mode=kv_mode),
            specials=specials, device=device)

    def path(name, fn, want):
        reset_launches()
        sync(device)
        t0 = time.perf_counter()
        res = fn()
        sync(device)
        dt = time.perf_counter() - t0
        counts = launches()
        out["paths"][name] = {"seconds": dt, "launches": counts}
        out["launch_checks"].append((name, counts, want(res, counts)))
        log(f"[kquant] {name}: {dt * 1e3:.1f} ms, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        return res, dt

    aprs = {}
    for mode in KQ_MODES:
        apr = aprs[mode] = workdir / f"whisper-{cfg.model_type}-random-" \
            f"{mode}.apr"
        t0 = time.perf_counter()
        write_kq_apr(apr, cfg, mode)
        eng = engine(apr, mode, "bfloat16")
        assert eng._qdecode["mode"] == mode, eng._qdecode
        P = len(eng.get_initial_tokens("en"))
        opts = TranscribeOptions(language="en", max_tokens=P + max_tokens)
        log(f"[kquant] {apr.name}: {apr.stat().st_size / 1e6:.1f} MB, "
            f"written and loaded in {time.perf_counter() - t0:.1f} s")
        eng.transcribe(clips[0], opts)                   # warm-up

        def b1(r, _):
            n = len(r.tokens) - P - 1
            return want_counts(self_block_kq=L * n, cross_block_kq=L * n,
                               ffn_block_kq=L * n, qmatvec_greedy_head=n)
        res, dt = path(f"{mode} noise 30 s", lambda: eng.transcribe(
            noise, opts), b1)
        toks = np.asarray(res.tokens)
        assert toks.size > P and toks.min() >= 0 \
            and toks.max() < cfg.n_vocab and np.isfinite(res.avg_logprob)
        out["paths"][f"{mode} noise 30 s"]["ms_per_step"] = \
            1e3 * dt / max(len(res.tokens) - P - 1, 1)
        out["rtf"][mode] = bench_rtf(eng, noise, runs=2)
        log(f"[kquant] {mode} bench protocol (30 s, {TOKENS_FORCED} forced "
            f"tokens, B=1, bf16, cross8): RTF {out['rtf'][mode]['rtf']:.6f}"
            f" ({out['rtf'][mode]['seconds'] * 1e3:.1f} ms)")
        e32 = engine(apr, mode, "float32")
        kern = e32.transcribe(clips[1], opts).tokens
        with plain_kernels():
            plain = e32.transcribe(clips[1], opts).tokens
        assert kern == plain, (f"[kquant] {mode} f32 tokens differ: kernels "
                               f"{kern[:16]}..., plain {plain[:16]}...")
        log(f"[kquant] {mode} f32: {len(kern)} tokens through the kernels "
            f"== plain versions")
        if mode in ("q4k", "q5k"):
            scan = engine(apr, mode, "bfloat16", "scan")
            mv = KQ_MATVEC[mode]

            def scan_want(r, _, mv=mv):
                n = len(r.tokens) - P - 1
                return want_counts(**{mv: 6 * L * n}, qmatvec_stacked=n)
            path(f"{mode} scan greedy", lambda: scan.transcribe(
                clips[1], opts), scan_want)
        del eng, e32

    # B > 1 over the q4k engine: the int8 transcode on K5-K8
    eng = engine(aprs["q4k"], "q4k", "bfloat16")
    P = len(eng.get_initial_tokens("en"))
    opts = TranscribeOptions(language="en", max_tokens=P + max_tokens)
    eng.transcribe_batch(clips[:2], opts)                # warm-up

    def batch_want(r, _):
        n = max(len(x.tokens) for x in r.results) - P - 1
        return want_counts(self_block_batched=L * n,
                           cross_block_batched=L * n,
                           ffn_block_batched=L * n, qmatvec_greedy_head=n)
    res, dt = path("q4k transcribe_batch of 4", lambda: eng.transcribe_batch(
        clips, opts), batch_want)
    out["paths"]["q4k transcribe_batch of 4"]["ms_per_step"] = 1e3 * dt / max(
        max(len(x.tokens) for x in res.results) - P - 1, 1)

    def serve(e, kv):
        s = BatchScheduler(e, n_slots=4)
        assert s._qd is e._qdecode_batched and s._qf == kv
        rid = [s.submit(c, "en", max_tokens=max_tokens) for c in clips]
        s.run_until_drained()
        return s

    def serve_want(s, c):
        t = s.stats()["ticks"]
        return want_counts(self_block_batched=L * t,
                           cross_block_batched=L * t,
                           ffn_block_batched=L * t, qmatvec_stacked=t)
    sched, _ = path("q4k BatchScheduler(n_slots=4)", lambda: serve(
        eng, "int8"), serve_want)
    assert sched.stats()["completed_ok"] == len(clips)

    # f32: kernels == plain; follows per-clip decoding on the transcode
    e32 = engine(aprs["q4k"], "q4k", "float32", kv_mode="int8")
    kern = [r.tokens for r in e32.transcribe_batch(clips, opts).results]
    with plain_kernels():
        plain = [r.tokens for r in e32.transcribe_batch(clips, opts).results]
    assert kern == plain, "[kquant] q4k f32 batch tokens: kernels vs plain"

    def served(e):
        s = serve(e, "int8")
        return [s.result(i).tokens for i in range(len(clips))]
    skern = served(e32)
    with plain_kernels():
        splain = served(e32)
    assert skern == splain, "[kquant] q4k f32 scheduler: kernels vs plain"
    with transcode_as_qd(e32):
        per_clip = [e32.transcribe(c, opts).tokens for c in clips]
        gaps = [check_follows(e32, c, k, w, "kquant batch")
                for c, k, w in zip(clips, kern, per_clip)]
        gaps += [check_follows(e32, c, k, w, "kquant serve")
                 for c, k, w in zip(clips, skern, per_clip)]
    out["f32_gaps"]["q4k batch and serve"] = gaps
    log(f"[kquant] q4k f32 batch and scheduler: kernels == plain versions; "
        f"against per-clip decoding on the transcode "
        f"{sum(g is None for g in gaps)} of {len(gaps)} identical, near-tie "
        f"gaps {[g for g in gaps if g is not None]}")
    return out


def check_kq_launches(kq: dict) -> None:
    """Every path of the k-quant phase launched exactly what it should."""
    for name, counts, want in kq["launch_checks"]:
        assert counts == want, f"[kquant] {name}: launches {counts}, want " \
            f"{want}"


def device_busy(eng, audio: np.ndarray, wall_s: float) -> dict:
    """Kernel time on the card during one bench run (torch.profiler), as a
    share of the best unprofiled wall time, and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run = bench_runner(eng, audio)
    run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        sync(eng.device)
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    out = {"busy_ms": busy_ms, "wall_ms": wall_s * 1e3,
           "busy_share": busy_ms / (wall_s * 1e3),
           "top": [{"kernel": k[:90], "ms": ms, "count": n}
                   for k, ms, n in kernels[:10]]}
    log(f"[e2e] device busy {busy_ms:.1f} ms of a {wall_s * 1e3:.1f} ms run "
        f"({100 * out['busy_share']:.1f}%); top: " + "; ".join(
            f"{t['kernel'][:48]} {t['ms']:.1f} ms x{t['count']}"
            for t in out["top"][:5]))
    return out


def bench_runner(eng, audio: np.ndarray):
    """One run of bench.py's protocol through the port's pipeline: 224
    decode tokens with EOT suppressed, one 30 s clip, B=1."""
    import torch
    from whisper_apr_tpu_torch.pipeline import (fused_transcribe_step,
                                                pad_audio_batch)
    cfg = eng.config
    eot = eng.specials.eot
    prompt_list = eng.get_initial_tokens("en")    # [50258, 50259, 50359, 50363]
    prompt = torch.tensor([prompt_list], device=eng.device)
    bias = torch.zeros(cfg.n_vocab, device=eng.device)
    bias[eot] = torch.finfo(torch.float32).min
    batch = torch.from_numpy(pad_audio_batch(
        [audio], 2 * cfg.n_audio_ctx * 160)).to(eng.device)
    consts = eng.mel_filters.constants(eng.device)

    def run():
        res = fused_transcribe_step(
            eng.params, batch, *consts, prompt, bias, eot, cfg,
            max_len=min(len(prompt_list) + TOKENS_FORCED, cfg.n_text_ctx),
            prompt_len=len(prompt_list), compute_dtype=torch.bfloat16,
            qd=eng._qdecode, qf_mode="cross8")
        n = int(res.lengths[0])
        assert n == min(len(prompt_list) + TOKENS_FORCED, cfg.n_text_ctx), n
        return n
    return run


def bench_rtf(eng, audio: np.ndarray, runs: int = 3) -> dict:
    """bench.py's protocol: best of ``runs`` after a warm-up run."""
    run = bench_runner(eng, audio)
    run()
    times = []
    for _ in range(runs):
        sync(eng.device)
        t0 = time.perf_counter()
        run()
        sync(eng.device)
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {"seconds": best, "rtf": best / AUDIO_SECONDS,
            "runs_ms": [round(t * 1e3, 3) for t in times]}


# ---------------------------------------------------------------------------
# phase 3c: the paged and opt-in kernels K15-K18
# ---------------------------------------------------------------------------

# K15's check and timing: 8 slots of 28 pages (448 rows); the last slot
# rests past its table (an inactive slot at its last position while the
# width is bucketed to the active ones)
PAGED_LENGTHS = (1, 16, 17, 100, 255, 256, 448, 460)
P_MAX = 28
# K17 / K18 shapes (K, N): the tiny and large-v3 encoder and decoder
# linears (attention, fc1, fc2), at M = 1 (a decode row), 8 (a serving
# tick) and 1500 (the encoder's frames); K18 also at an odd width
MATMUL_SHAPES = {"tiny": ((384, 384), (384, 1536), (1536, 384)),
                 "large-v3": ((1280, 1280), (1280, 5120), (5120, 1280))}
MATMUL_ROWS = (1, 8, 1500)
# K18's edges (M, K, N), checked in bf16 and f32 beside MATMUL_SHAPES: the
# decode kernel's one and two 8-row tiles (1, 8; 15, 16), the tile
# kernel's first rows (17) and either side of its 128-row tile (127,
# 129); K = 200, not a multiple of a 16-row step or a 64-deep slice;
# N = 1000 and 999 (500 packed bytes a row: rows not 16-byte aligned, the
# kernels' byte-wise path); and K = 16, one step: the decode kernel unsplit
INT4_EDGES = tuple((M, 200, N) for M in (1, 8, 15, 16, 17, 127, 129)
                   for N in (1000, 999)) + ((4, 16, 64),)
# K17's edges (M, K, N), the same in bf16 and f32: one to four 8-row
# tiles of the decode kernel (1, 8; 9, 15, 16; 17; 32), the tile kernel's
# first rows (33) and either side of its 128-row tile (127, 129); K = 200
# (not a multiple of a 16-row step or a 64-deep slice: split in two) and
# 16 (one step: the decode kernel unsplit); N = 1000 and 999 (rows not
# 16-byte aligned, the kernels' byte-wise path, and an odd width's single
# last column)
INT8_MM_EDGES = tuple((M, K, N)
                      for M in (1, 8, 9, 15, 16, 17, 32, 33, 127, 129)
                      for K in (200, 16) for N in (1000, 999))
# K8's edges (M, K, N), at layer 1 of a stack of 2, bf16 and f32 out: the
# decode kernel's one to four 8-row tiles (1, 8; 9, 16; 17, 24; 25, 32)
# and two launches (40: 32 + 8 rows); N = 1024 and 96 (a part strip of
# 128 columns), K = 200 and 16
K8_EDGES = tuple((M, K, N) for M in (1, 8, 9, 16, 17, 24, 25, 32, 40)
                 for K in (200, 16) for N in (1024, 96))
# K16 checks (B, Tq, Tk, kwargs): the encoder's 1500 frames at B=1 and 4,
# causal, kv_valid; then the ragged edges of the key ring, the split and
# its combine: one key, a tile's edge either side, 7 tiles (an uneven
# split of 2-tile ranges), Tq != Tk (one row, a part tile), kv_valid at a
# tile edge and one past it, causal over 448, and 21 key tiles (a split
# whose last range holds fewer tiles)
FLASH_CASES = ((1, 1500, 1500, {}), (4, 1500, 1500, {}),
               (1, 1500, 1500, dict(causal=True)),
               (1, 1500, 1500, dict(kv_valid=1000)),
               (1, 64, 1, {}), (1, 64, 63, {}), (1, 64, 65, {}),
               (1, 448, 448, {}), (1, 1, 1500, {}), (1, 100, 1500, {}),
               (1, 1500, 1500, dict(kv_valid=1024)),
               (1, 1500, 1500, dict(kv_valid=1025)),
               (1, 448, 448, dict(causal=True)), (1, 64, 1300, {}))
# K16 over operands whose rows are not 16-byte aligned (a row stride of
# 65): one query tile split over many keys, the encoder's shape, causal
FLASH_UNALIGNED = ((1, 100, 1500, {}), (1, 1500, 1500, dict(kv_valid=1025)),
                   (1, 448, 448, dict(causal=True)))


def optin_bound(name: str, *, M: int = 0, K: int = 0, N: int = 0,
                B: int = 0, H: int = 0, Tq: int = 0, Tk: int = 0,
                pairs: int = 0, rows: int = 0, D: int = 0, P: int = 0,
                elem: int = 2, compute: str = "bfloat16", products: int = 1):
    """(bound_ms, "bytes" or "operations") of one K15-K18 call, from the
    work these inputs need: each input byte read once, each output byte
    written once, over HBM_BPS, against the operations over the peak for
    the compute type, ``products`` times over (an f32 product taken as
    that many bf16 products on the tensor cores).

    paged_attention_stacked: ``rows`` K and V rows read (each slot's
    valid rows, at most 16 * P), q and out [B, D], tables [B, P] and
    lengths; 4 * rows * D operations. flash_attention: q, k, v, out;
    4 * 64 * ``pairs`` operations (pairs: (query, key) pairs the mask
    keeps, default B * H * Tq * Tk). int8_matmul: the weight bytes K * N,
    x [M, K], y [M, N], the f32 scale [N]; 2 M N K operations.
    int4_matmul: the same with K * N / 2 weight bytes."""
    if name == "paged_attention_stacked":
        nbytes = 2 * rows * D * elem + 2 * B * D * elem + 4 * B * (P + 1)
        flops = 4 * rows * D
    elif name == "flash_attention":
        pairs = pairs or B * H * Tq * Tk
        nbytes = B * H * 64 * elem * (2 * Tq + 2 * Tk)
        flops = 4 * 64 * pairs
    elif name in ("int8_matmul", "int4_matmul"):
        w = K * N if name == "int8_matmul" else K * N // 2
        nbytes = w + elem * (M * K + M * N) + 4 * N
        flops = 2 * M * N * K
    else:
        raise ValueError(name)
    t_bytes = nbytes / HBM_BPS
    t_ops = products * flops / PEAK_FLOPS[compute]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def paged_case(D: int, L: int, cdt, gen, device, lengths=PAGED_LENGTHS):
    """Pools [L, n_pages, 16, D] of one serving pool (n_slots * P_MAX + 1
    pages), each slot's P_MAX pages scattered over it (a random
    permutation), a query per slot and the slots' lengths."""
    import torch
    B = len(lengths)
    n_pages = B * P_MAX + 1
    kp = torch.randn((L, n_pages, 16, D), generator=gen, device=device)
    vp = torch.randn((L, n_pages, 16, D), generator=gen, device=device)
    perm = torch.randperm(n_pages, generator=gen, device=device)
    tables = perm[: B * P_MAX].reshape(B, P_MAX).to(torch.int32)
    q = torch.randn((B, D), generator=gen, device=device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q.to(cdt), kp.to(cdt), vp.to(cdt), tables, lens


def paged_rows(lengths, P: int = P_MAX) -> int:
    """Rows K15 reads: each slot's valid rows, at most 16 * P (all of its
    pages' rows when none is valid)."""
    return sum(min(max(n, 0), 16 * P) or 16 * P for n in lengths)


def matmul_case(K: int, N: int, M: int, cdt, gen, device, bits: int = 8,
                per_channel: bool = True):
    """x [M, K], random int8 weights (or packed int4 bytes, N // 2 + N % 2
    columns) and a scale of N values (or one)."""
    import torch
    x = torch.randn((M, K), generator=gen, device=device).to(cdt)
    cols = N if bits == 8 else (N + 1) // 2
    wq = torch.randint(-128, 128, (K, cols), generator=gen, device=device,
                       dtype=torch.int8)
    n_s = N if per_channel else 1
    s = 0.001 + 0.01 * torch.rand((n_s,), generator=gen, device=device)
    return x, wq, s


def _kernel_and_plain(mod, name):
    return getattr(mod, name), getattr(mod, name + "_plain")


def check_optin(label: str, D: int, H: int, cdt, seed: int) -> dict:
    """K15-K18 against their plain versions on the card at one model's
    shapes in ``cdt`` (K17 also at INT8_MM_EDGES, K18 at INT4_EDGES, both
    bit-identical over two runs). Returns each kernel's largest abs
    error."""
    import torch
    from whisper_apr_tpu_torch.ops import flash_attention as fa
    from whisper_apr_tpu_torch.ops import int4_matmul as i4
    from whisper_apr_tpu_torch.ops import int8_matmul as i8
    from whisper_apr_tpu_torch.ops import paged_attention as pa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tol = TOL_BF16 if cdt == torch.bfloat16 else TOL_F32
    worst = {}

    def agree(name, got, ref, what):
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype and got.shape == ref.shape, what
        err = rel_err(got, ref)
        assert err <= tol, f"[kernels] {label} {name} {what}: rel err " \
            f"{err:.3g} > {tol:.3g}"
        names = [name] + ([name + "_f32"] if cdt == torch.float32
                          and name != "paged_attention_stacked" else [])
        for n in names:
            worst[n] = max(worst.get(n, 0.0), abs_err(got, ref))

    q, kp, vp, tables, lens = paged_case(D, 2, cdt, gen, dev)
    for layer in (0, 1):
        args = (q, kp, vp, tables, lens, layer, H)
        agree("paged_attention_stacked", pa.paged_attention_stacked(*args),
              pa.paged_attention_stacked_plain(*args), f"layer {layer}")
    narrow = tables[:, :2].contiguous()   # rows past 32 out of the table
    args = (q, kp, vp, narrow, lens, 1, H)
    agree("paged_attention_stacked", pa.paged_attention_stacked(*args),
          pa.paged_attention_stacked_plain(*args), "width 2")

    for B, Tq, Tk, kw in FLASH_CASES:
        qkv = [torch.randn((B, H, T, 64), generator=gen, device=dev).to(cdt)
               for T in (Tq, Tk, Tk)]
        agree("flash_attention", fa.flash_attention(*qkv, **kw),
              fa.flash_attention_plain(*qkv, **kw),
              f"B={B} Tq={Tq} Tk={Tk} {kw} {fa.flash_split(B, H, Tq, Tk)}")
    for T, causal in ((1500, False), (448, True)):
        # the encoder's combined heads [B, T, H * 64]: strided operands
        q, k_, v = (torch.randn((1, T, D), generator=gen, device=dev)
                    .to(cdt) for _ in range(3))
        ref = fa.flash_attention_plain(
            *(x.reshape(1, T, H, 64).transpose(1, 2) for x in (q, k_, v)),
            causal=causal).transpose(1, 2).reshape(1, T, D)
        agree("flash_attention", fa.mha_flash(q, k_, v, H, causal=causal),
              ref, f"mha_flash T={T} causal={causal}")
    for B, Tq, Tk, kw in FLASH_UNALIGNED:
        # rows of 65 values, not 16-byte aligned: bf16 takes the kernel
        # that does not split, f32 its tensor-core kernel's element loads
        qkv = [torch.randn((B, H, T, 65), generator=gen, device=dev)
               .to(cdt)[..., :64] for T in (Tq, Tk, Tk)]
        agree("flash_attention", fa.flash_attention(*qkv, **kw),
              fa.flash_attention_plain(*qkv, **kw),
              f"rows of 65: B={B} Tq={Tq} Tk={Tk} {kw}")

    int8_cases = [(M, K, N, pc) for K, N in MATMUL_SHAPES[label]
                  for M in MATMUL_ROWS for pc in (True, False)]
    for i, (M, K, N) in enumerate(INT8_MM_EDGES):
        int8_cases.append((M, K, N, i % 3 != 0))   # a third: one scale
    for M, K, N, pc in int8_cases:
        x, wq, s = matmul_case(K, N, M, cdt, gen, dev, 8, pc)
        got = i8.int8_matmul(x, wq, s)
        what = (f"M={M} K={K} N={N} scales {s.numel()} "
                f"{i8.int8_plan(M, K, N)}")
        agree("int8_matmul", got, i8.int8_matmul_plain(x, wq, s), what)
        assert torch.equal(got, i8.int8_matmul(x, wq, s)), \
            f"[kernels] {label} int8_matmul {what}: two runs differ"
    int4_cases = [(M, K, n) for K, N in MATMUL_SHAPES[label]
                  for M in MATMUL_ROWS
                  for n in (N, N - 1)]    # an odd width: orig_last N - 1
    for M, K, N in int4_cases + list(INT4_EDGES):
        x, wq, s = matmul_case(K, N, M, cdt, gen, dev, 4)
        got = i4.int4_matmul(x, wq, s)
        what = f"M={M} K={K} N={N} {i4.int4_plan(M, K, 2 * wq.shape[1])}"
        agree("int4_matmul", got, i4.int4_matmul_plain(x, wq, s), what)
        assert torch.equal(got, i4.int4_matmul(x, wq, s)), \
            f"[kernels] {label} int4_matmul {what}: two runs differ"
    torch.cuda.synchronize()
    log(f"[kernels] {label} {str(cdt).split('.')[-1]}: K15-K18 agree with "
        f"the plain versions; max abs err " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()))
    return worst


# K15's edge checks: 16 slots over tables of these widths in pages (one,
# two, the serving pool's 28, and 29: a last run shorter than the rest)
PAGED_EDGE_WIDTHS = (1, 2, 28, 29)
PAGED_EDGE_SLOTS = 16


def paged_edge_lengths(P: int, run: int, B: int, gen) -> list:
    """B slot lengths over P-page tables with ``run`` pages a block: an
    empty slot, one row, either side of a page's end, of the first two run
    boundaries and of the table's end, past it; the rest random."""
    import torch
    cap = 16 * P
    want = {0, 1, 15, 16, 17, cap - 1, cap, cap + 1, cap + 37}
    for k in (1, 2):
        want |= {16 * run * k - 1, 16 * run * k, 16 * run * k + 1}
    lens = sorted(n for n in want if 0 <= n <= cap + 37)[:B]
    extra = torch.randint(1, cap + 1, (B - len(lens),), generator=gen,
                          device=gen.device).tolist()
    return lens + extra


def check_paged_edges(label: str, D: int, H: int, cdt, seed: int) -> float:
    """K15 against its plain version at ``PAGED_EDGE_WIDTHS`` x
    ``paged_edge_lengths``, each call twice and bit-identical: every
    slot's pages scattered over one pool; each row past a non-empty
    slot's length (its last page's tail and its later pages) NaN in K and
    V, which must not reach any output; one slot's first page id past the
    pool (clamped to its last page, which no table holds). Returns the
    max abs error."""
    import torch
    from whisper_apr_tpu_torch.ops import paged_attention as pa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tol = TOL_BF16 if cdt == torch.bfloat16 else TOL_F32
    B, worst = PAGED_EDGE_SLOTS, 0.0
    for P in PAGED_EDGE_WIDTHS:
        plan = pa.paged_plan(B, P, H, D, torch.empty((), dtype=cdt)
                             .element_size())
        lens = paged_edge_lengths(P, plan.run, B, gen)
        n_pages = B * P + 1                   # the last page: in no table
        kp = torch.randn((2, n_pages, 16, D), generator=gen, device=dev)
        vp = torch.randn((2, n_pages, 16, D), generator=gen, device=dev)
        tables = torch.randperm(n_pages - 1, generator=gen, device=dev)[
            : B * P].reshape(B, P).to(torch.int32)
        rows = torch.arange(16 * P, device=dev)
        for b, n in enumerate(lens):
            if n <= 0:
                continue                      # reads all of its pages
            past = rows[n:]
            for pool in (kp, vp):
                pool[:, tables[b, past // 16].long(), past % 16] = \
                    float("nan")
        b = next(b for b, n in enumerate(lens) if n >= 17)
        tables[b, 0] = n_pages + 7
        q = torch.randn((B, D), generator=gen, device=dev).to(cdt)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for layer in (0, 1):
            args = (q, kp.to(cdt), vp.to(cdt), tables, lengths, layer, H)
            got = pa.paged_attention_stacked(*args)
            again = pa.paged_attention_stacked(*args)
            ref = pa.paged_attention_stacked_plain(*args)
            torch.cuda.synchronize()
            what = f"[kernels] {label} paged_attention_stacked P={P} {plan}"
            assert torch.equal(got, again), f"{what}: two runs differ"
            assert bool(torch.isfinite(got).all()), f"{what}: not finite"
            e = rel_err(got, ref)
            assert e <= tol, f"{what}: rel err {e:.3g} > {tol:.3g}"
            worst = max(worst, abs_err(got, ref))
    log(f"[kernels] {label} {str(cdt).split('.')[-1]}: K15 at table widths "
        f"{list(PAGED_EDGE_WIDTHS)}, {B} slots (empty, run edges, past the "
        f"table, NaN past each length, a clamped page id) agrees with the "
        f"plain version, two runs bit-identical; max abs err {worst:.3g}")
    return worst


def library_sdpa(q, k, v) -> "float | None":
    """Time of torch's scaled_dot_product_attention on K16's tensors: a
    yardstick only, the port never calls it."""
    import torch
    import torch.nn.functional as F
    try:
        return graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    except RuntimeError as e:
        log(f"[time] scaled_dot_product_attention: "
            f"{str(e).splitlines()[0][:120]}")
        torch.cuda.synchronize()
        return None


def library_int4_mm(x, wq, s) -> "float | None":
    """Time of torch._weight_int4pack_mm on K18's operands: a yardstick
    only, the port never calls it. The weight is packed once, outside the
    timed call, as the call's own format asks: unsigned nibbles q + 8 of
    the transposed [N, K] weight (even k in the high nibble) through
    torch._convert_weight_to_int4pack, and the per-channel scale repeated
    over groups of 128 rows of K with zeros 0, so (q + 8 - 8) * scale is
    K18's dequantized weight."""
    import torch
    from whisper_apr_tpu_torch.ops import int4_matmul as i4
    K, N = x.shape[1], 2 * wq.shape[1]
    try:
        u = (i4.unpack_plain(wq).t().to(torch.int32) + 8).to(torch.uint8)
        packed = torch._convert_weight_to_int4pack(
            (u[:, ::2] << 4 | u[:, 1::2]).contiguous(), 8)
        sz = torch.stack([s.to(x.dtype).expand(K // 128, N),
                          torch.zeros((K // 128, N), dtype=x.dtype,
                                      device=x.device)], -1).contiguous()
        err = rel_err(torch._weight_int4pack_mm(x, packed, 128, sz),
                      i4.int4_matmul_plain(x, wq, s))
        ms = graph_ms(lambda: torch._weight_int4pack_mm(x, packed, 128, sz))
        log(f"[time] torch._weight_int4pack_mm at M={x.shape[0]} K={K} "
            f"N={N}: {ms:.4f} ms, rel err {err:.3g} against K18's plain "
            f"version")
        return ms
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        log(f"[time] torch._weight_int4pack_mm refused: "
            f"{str(e).splitlines()[0][:120]}")
        torch.cuda.synchronize()
        return None


def time_int4(K: int, N: int, gen) -> dict:
    """Device times (CUDA-graph replay) of K18 and its plain version in
    bf16 at [M, K] x [K, N] for M = 1 (a decode step), 8 (a serving tick)
    and 1500 (the encoder), each with its bound and
    torch._weight_int4pack_mm; at 1500 rows also a bf16 torch.matmul over
    the weight dequantized ahead of time (``dense_ms``: the dense figure
    an int4 kernel nears there; the port never calls it)."""
    import torch
    from whisper_apr_tpu_torch.ops import int4_matmul as i4
    out = {}
    for M in (1, 8, 1500):
        x, wq, s = matmul_case(K, N, M, torch.bfloat16, gen, gen.device, 4)
        bnd, by = optin_bound("int4_matmul", M=M, K=K, N=N)
        t = {"ms": graph_ms(lambda: i4.int4_matmul(x, wq, s)),
             "plain_ms": graph_ms(lambda: i4.int4_matmul_plain(x, wq, s)),
             "bound_ms": bnd, "bound_by": by,
             "library_ms": library_int4_mm(x, wq, s), "M": M, "K": K,
             "N": N, "plan": list(i4.int4_plan(M, K, N))}
        if M == 1500:
            w = (i4.unpack_plain(wq) * s).to(torch.bfloat16)
            t["dense_ms"] = graph_ms(lambda: x @ w)
        out["int4_matmul" + {1: "_m1", 8: "", 1500: "_m1500"}[M]] = t
    return out


def time_optin(label: str, D: int, H: int, seed: int) -> dict:
    """Device times (CUDA-graph replay) of K15-K18 and their plain
    versions in bf16 at one model's main-path shapes: K15 at 8 slots of
    PAGED_LENGTHS, K16 over the encoder's 1500 frames at B = 1 (and 4),
    K17 at fc1's shape for a serving tick (M = 8) and for the encoder
    (M = 1500), K18 there and at a decode step (M = 1; ``time_int4``).
    Each with its bound and its library yardstick
    (SDPA for K16, torch._weight_int8pack_mm for K17,
    torch._weight_int4pack_mm for K18); then K16-K18 on f32 inputs
    (``time_optin_f32``, the entries ``<name>_f32...``); K16's time over
    SDPA's is printed beside them."""
    import torch
    from whisper_apr_tpu_torch.ops import flash_attention as fa
    from whisper_apr_tpu_torch.ops import int4_matmul as i4
    from whisper_apr_tpu_torch.ops import int8_matmul as i8
    from whisper_apr_tpu_torch.ops import paged_attention as pa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    cdt = torch.bfloat16
    out = {}

    def entry(key, kern, plain, bnd, library=None, **shape):
        ms, by = bnd
        out[key] = {"ms": graph_ms(kern), "plain_ms": graph_ms(plain),
                    "bound_ms": ms, "bound_by": by, "library_ms": library,
                    **shape}

    q, kp, vp, tables, lens = paged_case(D, 1, cdt, gen, dev)
    args = (q, kp, vp, tables, lens, 0, H)
    entry("paged_attention_stacked",
          lambda: pa.paged_attention_stacked(*args),
          lambda: pa.paged_attention_stacked_plain(*args),
          optin_bound("paged_attention_stacked", B=len(PAGED_LENGTHS), D=D,
                      P=P_MAX, rows=paged_rows(PAGED_LENGTHS)),
          B=len(PAGED_LENGTHS), lengths=list(PAGED_LENGTHS))
    for B in (1, 4):
        qkv = [torch.randn((B, H, 1500, 64), generator=gen,
                           device=dev).to(cdt) for _ in range(3)]
        entry("flash_attention" + ("" if B == 1 else f"_b{B}"),
              lambda: fa.flash_attention(*qkv),
              lambda: fa.flash_attention_plain(*qkv),
              optin_bound("flash_attention", B=B, H=H, Tq=1500, Tk=1500),
              library_sdpa(*qkv), B=B, H=H, T=1500)
    K, N = MATMUL_SHAPES[label][1]
    for M in (8, 1500):
        sfx = "" if M == 8 else f"_m{M}"
        x, wq, s = matmul_case(K, N, M, cdt, gen, dev, 8)
        w_nk = wq.t().contiguous()
        ones = torch.ones(N, dtype=cdt, device=dev)
        try:
            lib = graph_ms(lambda: torch._weight_int8pack_mm(x, w_nk, ones))
        except (RuntimeError, NotImplementedError, AttributeError) as e:
            log(f"[time] torch._weight_int8pack_mm: "
                f"{str(e).splitlines()[0][:120]}")
            torch.cuda.synchronize()
            lib = None
        entry("int8_matmul" + sfx, lambda: i8.int8_matmul(x, wq, s),
              lambda: i8.int8_matmul_plain(x, wq, s),
              optin_bound("int8_matmul", M=M, K=K, N=N), lib, M=M, K=K, N=N)
    out.update(time_int4(K, N, gen))
    log(f"[time] {label} K15-K18 bf16, device ms (plain; bound; library): "
        + "; ".join(f"{k} {v['ms']:.4f} ({v['plain_ms']:.4f}; "
                    f"{v['bound_ms']:.4f} {v['bound_by']}; "
                    f"{v['library_ms'] if v['library_ms'] is None else round(v['library_ms'], 4)})"
                    for k, v in out.items()))
    log(f"[time] {label} K18 / _weight_int4pack_mm: " + ", ".join(
        f"{k} {v['ms'] / v['library_ms']:.2f}x" for k, v in out.items()
        if k.startswith("int4_matmul") and v["library_ms"])
        + "; at 1500 rows over the dense bf16 matmul: "
        f"{out['int4_matmul_m1500']['ms'] / out['int4_matmul_m1500']['dense_ms']:.2f}x")
    out.update(time_optin_f32(label, D, H, seed + 100))
    log(f"[time] {label} K16 / SDPA: " + ", ".join(
        f"{k} {v['ms'] / v['library_ms']:.2f}x" for k, v in out.items()
        if k.startswith("flash_attention") and v["library_ms"]))
    return out


# K17 f32's prompt-sized row count (above the decode kernel's 32 rows:
# the tile kernel): a prefill of bench.py's 224 forced tokens
F32_MID_ROWS = {"int8_matmul": TOKENS_FORCED, "int4_matmul": 64}


def tc_floor_ms(products: int, flops: float) -> float:
    """The tensor-core floor of a kernel that takes each f32 product as
    ``products`` bf16 products: their operations over the bf16 peak."""
    return 1e3 * products * flops / PEAK_FLOPS["bfloat16"]


def sdpa_backend(q, k, v) -> str:
    """The kernel that took most of the device time of one
    scaled_dot_product_attention call on these tensors (torch.profiler):
    which SDPA backend ran."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            F.scaled_dot_product_attention(q, k, v)
            torch.cuda.synchronize()
    except RuntimeError as e:
        return f"refused: {str(e).splitlines()[0][:80]}"
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA]
    if not ev:
        return "not traced"
    return max(ev, key=lambda e: e.self_device_time_total).key[:120]


def library_mm(name: str, x, wq, s) -> "float | None":
    """Time of torch._weight_int8pack_mm (K17) on f32 x where it takes
    it, with the weight [N, K] and the scale as that call wants them; a
    yardstick only, the port never calls it. K18's _weight_int4pack_mm is
    ``library_int4_mm``."""
    import torch
    if name == "int4_matmul":
        return library_int4_mm(x, wq, s)
    w_nk = wq.t().contiguous()
    try:
        return graph_ms(lambda: torch._weight_int8pack_mm(x, w_nk, s))
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        log(f"[time] torch._weight_int8pack_mm on {x.dtype}: "
            f"{str(e).splitlines()[0][:120]}")
        torch.cuda.synchronize()
        return None


def time_optin_f32(label: str, D: int, H: int, seed: int) -> dict:
    """Device times (CUDA-graph replay) of K16-K18 on f32 inputs and
    their plain versions at one model's encoder shapes: K16 over 1500
    frames at B = 1 and 4; K17 at fc1's shape for the encoder (M = 1500)
    and a prompt (``F32_MID_ROWS``), K18 at M = 1500 and 64. Each with
    its bound on the tensor cores the kernels run on (``bound_ms``: the
    larger of its bytes over HBM_BPS and its tensor-core floor,
    ``floor_ms`` = ``tc_floor_ms``: six bf16 products an f32 product in
    K16, three in K17 / K18), its bound on the CUDA cores'
    67 f32 TFLOP/s (``f32_simt_bound_ms``) and its library yardstick,
    measured only: SDPA on the f32 inputs (``sdpa`` names the
    backend that ran), ``_weight_int8pack_mm`` / ``_weight_int4pack_mm``
    where they take f32 x (else None), and for K17 / K18 a dense f32
    torch.matmul over the weight dequantized ahead of time
    (``dense_ms``; TF32 off, as PyTorch's default)."""
    import torch
    from whisper_apr_tpu_torch.ops import flash_attention as fa
    from whisper_apr_tpu_torch.ops import int4_matmul as i4
    from whisper_apr_tpu_torch.ops import int8_matmul as i8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls"
    f32 = torch.float32
    out = {}
    for B in (1, 4):
        qkv = [torch.randn((B, H, 1500, 64), generator=gen, device=dev)
               for _ in range(3)]
        shape = dict(B=B, H=H, Tq=1500, Tk=1500, elem=4)
        bnd, by = optin_bound("flash_attention", **shape, products=6)
        out["flash_attention_f32" + ("" if B == 1 else f"_b{B}")] = {
            "ms": graph_ms(lambda: fa.flash_attention(*qkv)),
            "plain_ms": graph_ms(lambda: fa.flash_attention_plain(*qkv)),
            "bound_ms": bnd, "bound_by": by,
            "f32_simt_bound_ms": optin_bound("flash_attention", **shape,
                                             compute="float32")[0],
            "floor_ms": tc_floor_ms(6, 4 * 64 * B * H * 1500 * 1500),
            "library_ms": library_sdpa(*qkv), "sdpa": sdpa_backend(*qkv),
            "B": B, "H": H, "T": 1500}
    K, N = MATMUL_SHAPES[label][1]
    for name, mod, bits in (("int8_matmul", i8, 8), ("int4_matmul", i4, 4)):
        kern, plain = _kernel_and_plain(mod, name)
        for M in (1500, F32_MID_ROWS[name]):
            x, wq, sc = matmul_case(K, N, M, f32, gen, dev, bits)
            w = (mod.unpack_plain(wq) if bits == 4 else wq.float()) * sc
            shape = dict(M=M, K=K, N=N, elem=4)
            bnd, by = optin_bound(name, **shape, products=3)
            out[f"{name}_f32" + ("" if M == 1500 else f"_m{M}")] = {
                "ms": graph_ms(lambda: kern(x, wq, sc)),
                "plain_ms": graph_ms(lambda: plain(x, wq, sc)),
                "bound_ms": bnd, "bound_by": by,
                "f32_simt_bound_ms": optin_bound(name, **shape,
                                                 compute="float32")[0],
                "floor_ms": tc_floor_ms(3, 2 * M * N * K),
                "library_ms": library_mm(name, x, wq, sc),
                "dense_ms": graph_ms(lambda: x @ w), "M": M, "K": K, "N": N}
    log(f"[time] {label} K16-K18 f32, device ms (plain; bound on the "
        f"tensor cores; CUDA-core f32 bound; library; dense f32): "
        + "; ".join(
            f"{k} {v['ms']:.4f} ({v['plain_ms']:.4f}; {v['bound_ms']:.4f}; "
            f"{v['f32_simt_bound_ms']:.4f}; {v['library_ms']}; "
            f"{v.get('dense_ms', '-')})" for k, v in out.items()))
    log(f"[time] {label} SDPA on f32: " + ", ".join(
        f"{k} {v['sdpa']}" for k, v in out.items() if "sdpa" in v))
    return out


# K16-K18's f32 kernels against f64 (TOL_F32_TERMS): K16 (Tq, Tk,
# causal) over one key tile and over two, K17 / K18 at fc1's shape on the
# decode rows and on the tile kernel
F32_TERM_FLASH = ((128, 64, False), (128, 64, True), (64, 128, False))
F32_TERM_ROWS = (8, 64)


def attention_f64(q, k, v, causal: bool = False):
    """softmax(q . k^T / 8) . v in f64, keys j > i masked when causal."""
    import torch
    q, k, v = (t.double() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) * 64 ** -0.5
    if causal:
        Tq, Tk = s.shape[-2:]
        above = torch.ones((Tq, Tk), dtype=torch.bool,
                           device=s.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    return torch.softmax(s, -1) @ v


def check_f32_terms(label: str, D: int, H: int, seed: int) -> dict:
    """K16-K18 on f32 inputs against f64 at the smoke's unit-normal
    draws, within TOL_F32_TERMS: the check that sees the three-term
    splits' products (a split short of one of them misses it, where
    TOL_F32 against the plain f32 version would not). Returns each
    kernel's largest relative error."""
    import torch
    from whisper_apr_tpu_torch.ops import flash_attention as fa
    from whisper_apr_tpu_torch.ops import int4_matmul as i4
    from whisper_apr_tpu_torch.ops import int8_matmul as i8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {}

    def agree(name, got, ref, what):
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        assert got.shape == ref.shape and err <= TOL_F32_TERMS, (
            f"[kernels] {label} {name} f32 {what} against f64: rel err "
            f"{err:.3g} > {TOL_F32_TERMS:.3g}")
        worst[name] = max(worst.get(name, 0.0), err)

    for Tq, Tk, causal in F32_TERM_FLASH:
        qkv = [torch.randn((1, H, T, 64), generator=gen, device=dev)
               for T in (Tq, Tk, Tk)]
        agree("flash_attention", fa.flash_attention(*qkv, causal=causal),
              attention_f64(*qkv, causal=causal),
              f"Tq={Tq} Tk={Tk} causal={causal}")
    K, N = MATMUL_SHAPES[label][1]
    for name, mod, bits in (("int8_matmul", i8, 8), ("int4_matmul", i4, 4)):
        for M in F32_TERM_ROWS:
            x, wq, sc = matmul_case(K, N, M, torch.float32, gen, dev, bits)
            w = wq.double() if bits == 8 else mod.unpack_plain(wq).double()
            agree(name, getattr(mod, name)(x, wq, sc),
                  (x.double() @ w) * sc.double(), f"M={M} K={K} N={N}")
    log(f"[kernels] {label} f32 against f64 (tolerance {TOL_F32_TERMS}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return worst


def phase_optin_kernels() -> tuple:
    """K15-K18 against their plain versions at the whisper-tiny and
    large-v3 shapes in bf16 and f32, K16-K18 in f32 against f64, then
    their times. Returns (max abs errors, {shape label: times})."""
    import torch
    errs = {}
    for label, D, H, seed in (("tiny", 384, 6, 41), ("large-v3", 1280, 20,
                                                      43)):
        for cdt in (torch.bfloat16, torch.float32):
            for k, v in check_optin(label, D, H, cdt, seed).items():
                errs[k] = max(errs.get(k, 0.0), v)
            errs["paged_attention_stacked"] = max(
                errs["paged_attention_stacked"],
                check_paged_edges(label, D, H, cdt, seed + 100))
            seed += 1
        check_f32_terms(label, D, H, seed + 200)
    times = {"tiny_optin": time_optin("tiny", 384, 6, seed=45),
             "large_v3_optin": time_optin("large-v3", 1280, 20, seed=46)}
    torch.cuda.empty_cache()
    return errs, times


# ---------------------------------------------------------------------------
# phase 5b: paged serving (K15; K16 and K17 with the opt-in switches)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def optin_switches(int8: bool = False, int4: bool = False):
    """Turn the opt-in linear switches on for the block, then restore."""
    from whisper_apr_tpu_torch.ops import int4_matmul as i4
    from whisper_apr_tpu_torch.ops import int8_matmul as i8
    old = i8.USE_PALLAS_INT8, i4.USE_PALLAS_INT4
    i8.USE_PALLAS_INT8, i4.USE_PALLAS_INT4 = int8, int4
    try:
        yield
    finally:
        i8.USE_PALLAS_INT8, i4.USE_PALLAS_INT4 = old


def paged_want(cfg, ticks: int, encodes: int, optin: bool) -> dict:
    """The launches of a paged scheduler run: K15 once per decoder layer
    per tick; with flash and the int8 switch also K16 once per encoder
    layer per admission encode and K17 for every int8 linear: 8 per
    decoder layer per tick, and per encode 6 per encoder layer for the
    encoder and 2 + 8 per decoder layer for the cross K/V and the prompt
    prefill."""
    L, La = cfg.n_text_layer, cfg.n_audio_layer
    if not optin:
        return want_counts(paged_attention_stacked=L * ticks)
    return want_counts(paged_attention_stacked=L * ticks,
                       flash_attention=La * encodes,
                       int8_matmul=8 * L * ticks
                       + encodes * (6 * La + 10 * L))


def phase_paged(apr: Path, device="cuda", specials=None,
                n_slots: int = 8) -> dict:
    """BatchScheduler(paged=True) over the e2e phase's int8 .apr: the
    serve phase's 12 clips in two bursts with batched admission, then
    with staged admission, each in bf16 (launch counts held exactly; wall
    and device ms per tick) and in f32 (tokens through the kernels ==
    plain versions; following per-clip decoding on an f32-KV engine,
    near-tie rule). A second pass turns use_flash_attention and
    USE_PALLAS_INT8 on (admission runs K16 and K17, the tick K15 and
    K17) and holds its f32 tokens to the plain versions' again."""
    import torch
    from whisper_apr_tpu_torch import (ComputeConfig, TranscribeOptions,
                                       WhisperApr)
    from whisper_apr_tpu_torch.parallel.serving import BatchScheduler
    on_card = torch.device(device).type == "cuda"

    def engine(dtype, flash=False, kv_mode="auto"):
        return WhisperApr.load_from_apr(
            str(apr), ComputeConfig(quantization="int8", compute_dtype=dtype,
                                    kv_mode=kv_mode,
                                    use_flash_attention=flash),
            specials=specials, device=device)
    clips = make_clips(SERVE_SECONDS, seed=1)
    short, max_tokens = clips[:4], 48
    out = {"runs": {}, "launch_checks": []}
    per_clip = None
    for optin in (False, True):
        eng = engine("bfloat16", flash=optin)
        eng32 = engine("float32", flash=optin)
        cfg = eng.config
        for staged in (False, True):
            name = ("staged" if staged else "batched") + (
                " + flash + int8" if optin else "")
            with optin_switches(int8=optin):
                sched = BatchScheduler(eng, n_slots=n_slots, paged=True,
                                       batched_admission=not staged)
                encodes = count_calls(sched, "_admit_one" if staged
                                      else "_admit_batch")
                ticks = []

                def tick() -> int:
                    sync(device)
                    t0 = time.perf_counter()
                    n = sched.step()
                    sync(device)
                    ticks.append(time.perf_counter() - t0)
                    return n
                reset_launches()
                ids = [sched.submit(c, "en") for c in clips[:8]]
                for _ in range(16):
                    tick()
                ids += [sched.submit(c, "en") for c in clips[8:]]
                while tick() or sched.pending():
                    pass
                counts = launches()
                st = sched.stats()
                assert st["completed_ok"] == len(clips), st
                assert sched._paged_kv.free_pages == \
                    sched._paged_kv.n_pages - 1
                for i in ids:
                    t = np.asarray(sched.result(i).tokens)
                    assert t.min() >= 0 and t.max() < cfg.n_vocab
                want = paged_want(cfg, st["ticks"], encodes[0], optin)
                out["launch_checks"].append((name, counts, want))
                device_ms = (paged_device_ms(eng, clips[:n_slots], n_slots)
                             if on_card else float("nan"))
                wall = sum(ticks)
                run = {"ticks": st["ticks"], "launches": counts,
                       "wall_s": wall, "ms_per_tick_mean":
                       1e3 * wall / st["ticks"],
                       "ms_per_tick_median": 1e3 * float(np.median(ticks)),
                       "device_ms_per_tick": device_ms,
                       "pool_pages": sched._paged_kv.n_pages}
                out["runs"][name] = run
                log(f"[paged] {name}: {len(clips)} clips, {st['ticks']} "
                    f"ticks in {wall:.3f} s; wall ms per tick "
                    f"{run['ms_per_tick_mean']:.4f} (median "
                    f"{run['ms_per_tick_median']:.4f}); device ms per tick "
                    f"{device_ms:.4f}; launches "
                    f"{ {k: v for k, v in counts.items() if v} }")

                def served():
                    s = BatchScheduler(eng32, n_slots=n_slots, paged=True,
                                       batched_admission=not staged)
                    rid = [s.submit(c, "en", max_tokens=max_tokens)
                           for c in short]
                    s.run_until_drained()
                    return [s.result(i).tokens for i in rid]
                kern = served()
                with plain_kernels():
                    plain = served()
            assert kern == plain, (f"[paged] {name} f32 tokens differ: "
                                   f"kernels {[k[:12] for k in kern]}, plain "
                                   f"{[p[:12] for p in plain]}")
            if per_clip is None:
                ref = engine("float32", kv_mode="scan")
                P = len(ref.get_initial_tokens("en"))
                opts = TranscribeOptions(language="en",
                                         max_tokens=P + max_tokens)
                per_clip = [ref.transcribe(c, opts).tokens for c in short]
            gaps = [check_follows(eng32, c, k, w, "paged")
                    for c, k, w in zip(short, kern, per_clip)]
            run["f32_gaps"] = gaps
            log(f"[paged] {name} f32: tokens through the kernels == plain "
                f"versions ({sum(map(len, kern))} tokens); against per-clip "
                f"decoding {sum(g is None for g in gaps)} of {len(gaps)} "
                f"identical, near-tie gaps "
                f"{[g for g in gaps if g is not None]}")
        del eng, eng32
    return out


def count_calls(obj, name: str) -> list:
    """Count the calls of ``obj``'s method ``name`` from now on, in the
    returned one-item list."""
    n = [0]
    real = getattr(obj, name)

    def counted(*a, **kw):
        n[0] += 1
        return real(*a, **kw)
    setattr(obj, name, counted)
    return n


def paged_device_ms(eng, clips: list, n_slots: int, n: int = 20) -> float:
    """Kernel time on the card per pure decode tick of a paged scheduler
    (torch.profiler over ``n`` ticks after its admission)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from whisper_apr_tpu_torch.parallel.serving import BatchScheduler
    sched = BatchScheduler(eng, n_slots=n_slots, paged=True)
    for c in clips:
        sched.submit(c, "en")
    for _ in range(2):
        sched.step()
    sync(eng.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            sched.step()
        sync(eng.device)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy / n


def check_paged_launches(paged: dict) -> None:
    for name, counts, want in paged["launch_checks"]:
        assert counts == want, f"[paged] {name}: launches {counts}, want " \
            f"{want}"


# ---------------------------------------------------------------------------
# phase 8b: the opt-in kernels at full width (K18 on tiny int4, K16 and
# K17 on large-v3)
# ---------------------------------------------------------------------------

def phase_int4(apr: Path, device="cuda", specials=None,
               max_tokens: int = 48) -> dict:
    """A whisper-tiny int4 engine (the e2e .apr quantized to per-channel
    int4 at load) with USE_PALLAS_INT4 on: 30 s of noise at B=1, every
    int4 linear of the encoder, the prefill, the cross K/V and each plain
    decode step through K18 (bf16; launch count held: 6 per encoder
    layer, 10 per decoder layer at admission, 8 per decoder layer and
    step); then f32 tokens through K18 == the plain versions' (the same
    counts, the encoder's and the cross K/V's 1500 rows, 6 per encoder
    layer and 2 per decoder layer, through the f32 tile kernel)."""
    from whisper_apr_tpu_torch import (ComputeConfig, TranscribeOptions,
                                       WhisperApr)

    def engine(dtype):
        return WhisperApr.load_from_apr(
            str(apr), ComputeConfig(quantization="int4", compute_dtype=dtype),
            specials=specials, device=device)
    audio = np.random.default_rng(0).normal(0, 0.1, 30 * 16_000).astype(
        np.float32)
    eng = engine("bfloat16")
    cfg = eng.config
    L, La = cfg.n_text_layer, cfg.n_audio_layer
    P = len(eng.get_initial_tokens("en"))
    opts = TranscribeOptions(language="en", max_tokens=P + max_tokens)
    with optin_switches(int4=True):
        eng.transcribe(audio, opts)                       # warm-up
        reset_launches()
        sync(device)
        t0 = time.perf_counter()
        res = eng.transcribe(audio, opts)
        sync(device)
        dt = time.perf_counter() - t0
        counts = launches()
        steps = len(res.tokens) - P - 1
        want = want_counts(int4_matmul=6 * La + 10 * L + 8 * L * steps)
        e32 = engine("float32")
        reset_launches()
        kern = e32.transcribe(audio, opts).tokens
        counts32 = launches()
        with plain_kernels():
            plain = e32.transcribe(audio, opts).tokens
    assert kern == plain, "[int4] f32 tokens: K18 vs plain"
    steps32 = len(kern) - P - 1
    want32 = want_counts(int4_matmul=6 * La + 10 * L + 8 * L * steps32,
                         int4_matmul_f32=6 * La + 2 * L)
    log(f"[int4] tiny int4, USE_PALLAS_INT4: 30 s noise, {len(res.tokens)} "
        f"tokens ({steps} decode steps) in {dt * 1e3:.1f} ms "
        f"({1e3 * dt / max(steps, 1):.4f} ms per step); launches "
        f"{ {k: v for k, v in counts.items() if v} }; f32 tokens through "
        f"K18 == plain ({len(kern)} tokens; launches "
        f"{ {k: v for k, v in counts32.items() if v} })")
    return {"seconds": dt, "decode_steps": steps, "launches": counts,
            "want_launches": want, "launches_f32": counts32,
            "want_launches_f32": want32}


def encoder_ms(eng, mel, n: int = 3) -> float:
    """Wall ms of one encode on the card (best of ``n`` after a warm-up,
    synchronised)."""
    eng.encode(mel)
    best = float("inf")
    for _ in range(n):
        sync(eng.device)
        t0 = time.perf_counter()
        eng.encode(mel)
        sync(eng.device)
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def encoder_event_ms(eng, mel, n: int = 3) -> float:
    """Device ms of one encode (CUDA events around it; best of ``n``
    after a warm-up); NaN off the card."""
    import torch
    if torch.device(eng.device).type != "cuda":
        return float("nan")
    eng.encode(mel)
    best = float("inf")
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        eng.encode(mel)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def phase_large_v3_optin(device="cuda", max_tokens: int = 24,
                         cfg=None, specials=None) -> dict:
    """The large-v3 model of phase 8 once more with use_flash_attention
    and USE_PALLAS_INT8 on: 30 s of noise in f32, K16 once per encoder
    layer and K17 for every int8 linear of the encoder, the cross K/V and
    the prefill (the decode steps stay on K1-K4; f32, so K16 and K17's
    1500-row linears take the three-term tensor-core kernels, counted
    apart); tokens through the kernels == the plain versions' (near-tie
    rule). Then encoder ms, host wall and device by CUDA events, with and
    without K16, in f32 and bf16, with K17 off and on. ``cfg`` and
    ``specials`` (default large-v3's)
    let a CPU rehearsal run it at a small width, where nothing launches
    and the counts are not held."""
    import torch
    from whisper_apr_tpu_torch import (ComputeConfig, ModelConfig,
                                       TranscribeOptions, WhisperApr)
    from whisper_apr_tpu_torch.model.params import (init_params,
                                                    quantize_params,
                                                    to_device)
    cfg = cfg or ModelConfig.large_v3()
    params = to_device(quantize_params(init_params(cfg, seed=0), "int8"),
                       device)

    def engine(dtype, flash):
        return WhisperApr(cfg, params, compute=ComputeConfig(
            quantization="int8", compute_dtype=dtype,
            use_flash_attention=flash), specials=specials, device=device)
    audio = np.random.default_rng(7).normal(0, 0.1, 30 * 16_000).astype(
        np.float32)
    opts = TranscribeOptions(language="en", max_tokens=max_tokens)
    eng = engine("float32", True)
    P = len(eng.get_initial_tokens("en"))
    L, La = cfg.n_text_layer, cfg.n_audio_layer
    with optin_switches(int8=True):
        eng.transcribe(audio, opts)                          # warm-up
        reset_launches()
        sync(device)
        t0 = time.perf_counter()
        kern = eng.transcribe(audio, opts)
        sync(device)
        dt = time.perf_counter() - t0
        counts = launches()
        n = len(kern.tokens) - P - 1
        want = want_counts(self_block=L * n, cross_block=L * n,
                           ffn_block=L * n, qmatvec_greedy_head=n,
                           flash_attention=La, flash_attention_f32=La,
                           int8_matmul=6 * La + 10 * L,
                           int8_matmul_f32=6 * La + 2 * L)
        assert counts == want or torch.device(device).type == "cpu", \
            f"[large-v3 opt-in] launches {counts}, want {want}"
        with plain_kernels():
            plain = eng.transcribe(audio, opts)
    gap = check_same(eng, audio, kern.tokens, plain.tokens,
                     "large-v3 opt-in")
    mel = eng.compute_mel(audio)
    enc, enc_dev = {}, {}
    for int8 in (False, True):      # every linear through K17
        for dtype in ("float32", "bfloat16"):
            for flash in (False, True):
                key = (f"{dtype} {'K16' if flash else 'plain attention'}"
                       + (" + K17" if int8 else ""))
                e = engine(dtype, flash)
                with optin_switches(int8=int8):
                    enc[key] = encoder_ms(e, mel)
                    enc_dev[key] = encoder_event_ms(e, mel)
    log(f"[large-v3 opt-in] flash + int8 switch, f32: {len(kern.tokens)} "
        f"tokens in {dt * 1e3:.1f} ms; tokens "
        f"{'identical' if gap is None else f'near tie {gap:.3g}'} to the "
        f"plain versions; launches "
        f"{ {k: v for k, v in counts.items() if v} }; encoder ms (one "
        f"30 s clip, B=1; host wall / device by CUDA events): " + ", ".join(
            f"{k} {v:.3f} / {enc_dev[k]:.3f}" for k, v in enc.items()))
    del eng, params
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"seconds": dt, "launches": counts, "want_launches": want,
            "near_tie_gap": gap, "encoder_ms": enc,
            "encoder_device_ms": enc_dev}


# ---------------------------------------------------------------------------
# phase 3d: the probes P1-P3; 3e: the probe tool
# ---------------------------------------------------------------------------

# the kernels line's entry of each probe ("tricks" sums P3's cases)
PROBE_KERNEL = {"P1": "int8_dot", "P2": "mixed_dot"}
PROBE_COMPUTE = {"P1": "int8", "P2": "bfloat16", "P3 (b)": "bfloat16",
                 "P3 (i)": "bfloat16"}


def probe_bound(case, out) -> tuple:
    """(ms of bytes, ms of operations) of one probe call: its inputs and
    output, each once, over HBM_BPS; 2 M N K operations of a contraction
    (none for a transpose) over the peak of its compute type (int8 P1,
    bf16 tensor cores P2, P3 (b), (i); f32 CUDA cores the rest)."""
    nbytes = sum(t.numel() * t.element_size() for t in case.inputs) \
        + out.numel() * out.element_size()
    flops = 0
    if len(case.inputs) == 2:
        a = case.inputs[0]
        k = a.shape[-2] * a.shape[-1] // out.shape[-2]
        flops = 2 * out.numel() * k
    peak = PEAK_FLOPS[PROBE_COMPUTE.get(case.probe, "float32")]
    return 1e3 * nbytes / HBM_BPS, 1e3 * flops / peak


def probe_yardstick(case) -> "float | None":
    """Device ms of one PyTorch call computing the same function, where
    there is one (the port never calls it): torch._int_mm for P1, an f32
    torch.matmul (TF32 off) for P3 (a), .t().contiguous() for P3 (d)."""
    import torch
    if case.probe == "P1":
        a, b = case.inputs
        try:
            return graph_ms(lambda: torch._int_mm(a, b))
        except (RuntimeError, NotImplementedError, AttributeError) as e:
            log(f"[probes] torch._int_mm: {str(e).splitlines()[0][:120]}")
            torch.cuda.synchronize()
            return None
    if case.probe == "P3 (a)":
        a, b = case.inputs
        assert not torch.backends.cuda.matmul.allow_tf32
        return graph_ms(lambda: torch.matmul(a.t(), b))
    if case.probe == "P3 (d)":
        (a,) = case.inputs
        return graph_ms(lambda: a.t().contiguous())
    return None


def probe_edge_cases(device) -> list:
    """P3's f32 contraction at shapes the probe tool does not reach (this
    smoke's own list; the tool keeps the JAX tool's cases): K = 1281 (no
    chunk divides it; rows not 16-byte aligned, staged an element a
    thread; split over 21 blocks), ragged M and N of 33 and 65, a batch
    of 3 whose K splits, a transposed int8 A, aligned (split) and not,
    and two grids of over 132 tiles whose K panels stream through the
    2-stage ring, with aligned and unaligned rows. Inputs from
    np.random.default_rng(7). Returns (case, the kernel's launch plan)
    pairs."""
    import torch
    from whisper_apr_tpu_torch.ops import probe_mma as pm
    from whisper_apr_tpu_torch.tools import probe_layer_kernel as tool
    rng = np.random.default_rng(7)

    def f32(*shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).to(device)

    def i8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(
            np.int8)).to(device)

    def dot(name, a, b, trans_a=False):
        K, M = a.shape[-2:] if trans_a else a.shape[-2:][::-1]
        plan = pm.dot_plan(a.shape[0] if a.dim() == 3 else 1, M, K,
                           b.shape[-1], trans_a, a.element_size(),
                           b.element_size())
        return tool.ProbeCase(
            name, "P3 edge", lambda: pm.tricks_dot(a, b, trans_a),
            lambda: pm.tricks_dot_plain(a, b, trans_a), False,
            (a, b)), plan

    return [dot("dot f32xf32 K=1281", f32(40, 1281), f32(1281, 48)),
            dot("dot int8xf32 K=1281 M=33 N=65", i8(33, 1281),
                f32(1281, 65)),
            dot("dot f32xint8 M=33 N=65", f32(33, 200), i8(200, 65)),
            dot("bdot int8xf32 batch 3 split-K", i8(3, 96, 1280),
                f32(3, 1280, 32)),
            dot("bdotT int8xf32 batch 3 split-K", i8(3, 640, 64),
                f32(3, 640, 32), trans_a=True),
            dot("dotT int8xf32 M=65 N=33", i8(300, 65), f32(300, 33),
                trans_a=True),
            dot("dot f32xint8 2-stage ring", f32(264, 640), i8(640, 1056)),
            dot("dot f32xf32 2-stage ring K=601", f32(256, 601),
                f32(601, 1088))]


# P1 off the probe's 256^3: one row, ragged M, K and N, rows that are not
# 16-byte aligned (A: K % 16, B: N % 16), K past one staged panel (the
# 2-stage ring) and output rows not 16-byte aligned
INT8_EDGES = ((1, 32, 8), (1, 1, 1), (100, 200, 300), (33, 1281, 65),
              (129, 257, 130), (64, 4096, 48), (256, 512, 256))


def int8_edge_cases(device) -> list:
    """P1 at ``INT8_EDGES``, inputs from np.random.default_rng(8); each
    case exact. Returns (case, the K the kernel stages at a time) pairs."""
    from whisper_apr_tpu_torch.ops import probe_mma as pm
    from whisper_apr_tpu_torch.tools import probe_layer_kernel as tool
    import torch
    rng = np.random.default_rng(8)
    out = []
    for M, K, N in INT8_EDGES:
        a, b = (torch.from_numpy(rng.integers(-127, 128, s).astype(
            np.int8)).to(device) for s in ((M, K), (K, N)))
        out.append((tool.ProbeCase(
            f"int8xint8 {M}x{K}x{N}", "P1 edge",
            lambda a=a, b=b: pm.int8_dot(a, b),
            lambda a=a, b=b: pm.int8_dot_plain(a, b), True, (a, b)),
            pm.int8_plan(K)))
    return out


# P2's kernel off the probes' shapes: P2 (int8 . bf16) at one element, K
# not a multiple of 16, K past one staged panel (the 2-stage ring), M and N
# of 33 and 65, and 64 x 64 tiles staged whole and through the ring; then
# the kernel's other operand forms through tricks_dot (P3 (b), (i) and
# kin): transposed and cast A, a batch, int8 . int8, bf16 . bf16, rows
# that are not 16-byte aligned
MIXED_EDGES = ((1, 1, 1), (33, 1281, 65), (65, 23, 33), (100, 257, 130),
               (7, 4096, 9), (40, 48, 1000), (512, 300, 512),
               (1024, 256, 1024))


def mixed_edge_cases(device) -> list:
    """P2's kernel at ``MIXED_EDGES`` (``mixed_dot``) and in its other
    operand forms (``tricks_dot``), inputs from np.random.default_rng(9).
    Returns (case, the kernel's launch plan) pairs."""
    import torch
    from whisper_apr_tpu_torch.ops import probe_mma as pm
    from whisper_apr_tpu_torch.tools import probe_layer_kernel as tool
    rng = np.random.default_rng(9)

    def draw(shape, dt):
        if dt == "int8":
            return torch.from_numpy(rng.integers(-127, 128, shape).astype(
                np.int8)).to(device)
        t = torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).to(device)
        return t if dt == "f32" else t.to(torch.bfloat16)

    out = []
    for M, K, N in MIXED_EDGES:
        a, b = draw((M, K), "int8"), draw((K, N), "bf16")
        out.append((tool.ProbeCase(
            f"int8xbf16 {M}x{K}x{N}", "P2 edge",
            lambda a=a, b=b: pm.mixed_dot(a, b),
            lambda a=a, b=b: pm.mixed_dot_plain(a, b), False, (a, b)),
            pm.mixed_plan(1, M, K, N)))
    for name, a, b, trans_a, cast in (
            ("dotT bf16xint8 M=65 N=33 K=300", draw((300, 65), "bf16"),
             draw((300, 33), "int8"), True, False),
            ("dot bf16(cast)xint8 M=33 K=129 N=65", draw((33, 129), "f32"),
             draw((129, 65), "int8"), False, True),
            ("dotT bf16(cast)xbf16 K=45 M=33 N=77", draw((45, 33), "f32"),
             draw((45, 77), "bf16"), True, True),
            ("bdot int8xbf16 batch 3", draw((3, 40, 200), "int8"),
             draw((3, 200, 70), "bf16"), False, False),
            ("dotT int8xint8 K=257", draw((257, 33), "int8"),
             draw((257, 100), "int8"), True, False),
            ("dot bf16xbf16 64 x 64 tiles", draw((520, 96), "bf16"),
             draw((96, 530), "bf16"), False, False)):
        batch = a.shape[0] if a.dim() == 3 else 1
        K, M = a.shape[-2:] if trans_a else a.shape[-2:][::-1]
        plan = pm.mixed_plan(batch, M, K, b.shape[-1], trans_a,
                             a.element_size(), b.element_size())
        out.append((tool.ProbeCase(
            name, "P3 mma edge",
            lambda a=a, b=b, t=trans_a, c=cast: pm.tricks_dot(a, b, t, c),
            lambda a=a, b=b, t=trans_a, c=cast: pm.tricks_dot_plain(
                a, b, t, c), False, (a, b)), plan))
    return out


def phase_probes() -> tuple:
    """P1-P3 against their plain versions on the card at the probes'
    shapes (P1 and the transposes exact, the rest within TOL_F32 of the
    plain version's largest magnitude), then each case's device time,
    plain time, bound and yardstick (and time / yardstick); then P1's
    edge cases (``int8_edge_cases``) exact and the same over two runs,
    P2's kernel's (``mixed_edge_cases``) within TOL_F32 and the same over
    two runs, and P3's (``probe_edge_cases``) within TOL_F32. Returns (max
    abs errors, {"cases": [...], and one entry per kernel of the summary
    line: P1, P2, and P3's eleven calls summed})."""
    import torch
    from whisper_apr_tpu_torch.tools import probe_layer_kernel as tool
    cases = tool.int8dot_cases("cuda") + tool.tricks_cases("cuda")
    rows, errs, per_kernel = [], {}, {}
    for case in cases:
        got, ref = case.kernel(), case.plain()
        torch.cuda.synchronize()
        assert got.dtype == ref.dtype and got.shape == ref.shape, case.name
        exact = torch.equal(got, ref)
        err = tool.rel_err(got, ref)
        assert exact if case.exact else err <= TOL_F32, (
            f"[probes] {case.probe} {case.name}: exact {exact}, rel err "
            f"{err:.3g} (tolerance {'exact' if case.exact else TOL_F32})")
        t_bytes, t_ops = probe_bound(case, ref)
        row = {"probe": case.probe, "name": case.name, "exact": exact,
               "rel_err": err, "max_abs_err": abs_err(got, ref),
               "ms": graph_ms(case.kernel), "plain_ms": graph_ms(case.plain),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes_ms": t_bytes, "ops_ms": t_ops,
               "library_ms": probe_yardstick(case)}
        rows.append(row)
        key = PROBE_KERNEL.get(case.probe, "tricks")
        errs[key] = max(errs.get(key, 0.0), row["max_abs_err"])
        agg = per_kernel.setdefault(key, {
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0,
            "ops_ms": 0.0, "library_ms": None, "cases": 0})
        for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
            agg[k] += row[k]
        agg["cases"] += 1
        if key != "tricks":
            agg["library_ms"] = row["library_ms"]
        lib = row["library_ms"]
        log(f"[probes] {case.probe:<7} {case.name}: exact {exact}, rel err "
            f"{err:.3g}; {row['ms'] * 1e3:.2f} us (plain "
            f"{row['plain_ms'] * 1e3:.2f}; bound {row['bound_ms'] * 1e3:.3f}"
            f" {row['bound_by']}; library "
            f"{'none' if lib is None else '%.2f' % (lib * 1e3)}"
            f"{'' if lib is None else '; %.2fx the library' % (row['ms'] / lib)})")
    for agg in per_kernel.values():
        agg["bound_by"] = ("bytes" if agg.pop("bytes_ms") >= agg.pop("ops_ms")
                           else "operations")
    for case, k_chunk in int8_edge_cases("cuda"):
        got, ref = case.kernel(), case.plain()
        again = case.kernel()
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(got, again), (
            f"[probes] {case.name}: not exact (K staged {k_chunk} at a "
            f"time)")
        rows.append({"probe": case.probe, "name": case.name, "exact": True,
                     "k_chunk": k_chunk, "ms": graph_ms(case.kernel),
                     "plain_ms": graph_ms(case.plain)})
        log(f"[probes] {case.probe} {case.name}: exact; "
            f"{rows[-1]['ms'] * 1e3:.2f} us (plain "
            f"{rows[-1]['plain_ms'] * 1e3:.2f}); K staged {k_chunk} at a "
            f"time")
    for case, plan in mixed_edge_cases("cuda"):
        got, ref = case.kernel(), case.plain()
        again = case.kernel()
        torch.cuda.synchronize()
        err = tool.rel_err(got, ref)
        assert got.shape == ref.shape and err <= TOL_F32, (
            f"[probes] {case.name}: rel err {err:.3g} > {TOL_F32} ({plan})")
        assert torch.equal(got, again), (
            f"[probes] {case.name}: two runs differ")
        key = "mixed_dot" if case.probe == "P2 edge" else "tricks"
        errs[key] = max(errs[key], abs_err(got, ref))
        rows.append({"probe": case.probe, "name": case.name, "rel_err": err,
                     "plan": plan._asdict(), "ms": graph_ms(case.kernel),
                     "plain_ms": graph_ms(case.plain)})
        log(f"[probes] {case.probe} {case.name}: rel err {err:.3g}, two runs "
            f"bit-identical; {rows[-1]['ms'] * 1e3:.2f} us (plain "
            f"{rows[-1]['plain_ms'] * 1e3:.2f}); {plan}")
    for case, plan in probe_edge_cases("cuda"):
        got, ref = case.kernel(), case.plain()
        torch.cuda.synchronize()
        err = tool.rel_err(got, ref)
        assert got.shape == ref.shape and err <= TOL_F32, (
            f"[probes] {case.name}: rel err {err:.3g} > {TOL_F32}")
        errs["tricks"] = max(errs["tricks"], abs_err(got, ref))
        rows.append({"probe": case.probe, "name": case.name, "rel_err": err,
                     "plan": plan._asdict(), "ms": graph_ms(case.kernel),
                     "plain_ms": graph_ms(case.plain)})
        log(f"[probes] {case.probe} {case.name}: rel err {err:.3g}; "
            f"{rows[-1]['ms'] * 1e3:.2f} us (plain "
            f"{rows[-1]['plain_ms'] * 1e3:.2f}); {plan}")
    torch.cuda.empty_cache()
    return errs, {"probes": per_kernel, "probe_cases": rows}


PROBE_TOOL = ["-m", "whisper_apr_tpu_torch.tools.probe_layer_kernel",
              "--int8dot", "--tricks", "--large", "--lo", "16", "--hi", "48"]


def phase_probe_tool(out_dir: Path, times: dict) -> dict:
    """The slice's entry point as a user runs it, in a process of its own:
    it must exit 0 and print every probe case. Returns its results: its
    launch counts (counted from 0 in that process) and its large-v3
    slope."""
    from whisper_apr_tpu_torch.tools import probe_layer_kernel as tool
    res_path = out_dir / "probe_tool.json"
    cmd = [sys.executable, *PROBE_TOOL, "--json", str(res_path)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    dt = time.perf_counter() - t0
    for line in proc.stdout.strip().splitlines()[:-1]:
        log(f"[probe_tool] {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"[probe_tool] {' '.join(PROBE_TOOL)} exited "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    names = [c.name for c in tool.int8dot_cases("cpu")
             + tool.tricks_cases("cpu")]
    missing = [n for n in names if n not in proc.stdout]
    assert not missing, f"[probe_tool] cases not printed: {missing}"
    res = json.loads(res_path.read_text())
    assert len(res["probes"]) == len(names) \
        and all(p["passed"] for p in res["probes"]), res["probes"]
    slope = res["steps_ms"]["qf"]
    graph = times["large_v3_steps"]["fused_b1"]["ms"]
    log(f"[probe_tool] exit 0 in {dt:.1f} s; large-v3 B=1 fused step: "
        f"{slope:.4f} ms/step host-loop slope (bf16 rows, pos 0-47), "
        f"{graph:.4f} ms CUDA-graph device time (phase 3: cross8, pos 128)"
        f"; launches {({k: v for k, v in res['launches'].items() if v})}")
    return {"seconds": dt, **res}


# ---------------------------------------------------------------------------
# phase 7c: v1 and v2 .apr files, load progress, validation
# ---------------------------------------------------------------------------

def write_apr_files(workdir: Path, cfg) -> dict:
    """{(version, quant): path} of the seed-0 weights written by the
    port's v1 and v2 writers in f32 and int8."""
    from whisper_apr_tpu_torch.format import (QUANT_F32, QUANT_INT8,
                                              AprWriter, AprWriterV2)
    from whisper_apr_tpu_torch.model.params import (init_params,
                                                    params_to_apr_tensors)
    tensors = params_to_apr_tensors(init_params(cfg, seed=0))
    out = {}
    for version, cls in (("v1", AprWriter), ("v2", AprWriterV2)):
        for quant, code in (("f32", QUANT_F32), ("int8", QUANT_INT8)):
            w = cls.from_config(cfg, quantization=code)
            for name, arr in tensors.items():
                w.add_tensor(name, arr)
            path = workdir / f"tiny-{version}-{quant}.apr"
            w.write_file(str(path))
            out[(version, quant)] = path
    return out


def phase_formats(workdir: Path, cfg=None, device="cuda",
                  specials=None, lz4_apr=None) -> dict:
    """Each file loaded through load_from_apr with a progress callback
    (int8 weights, f32 compute: the kernels' path), its updates monotone
    and ending at 1.0; AprValidator passes on each; greedy tokens over 30
    s of noise from each v2 file, and from the compressed v1 int8 file
    (``lz4_apr``, phase 2b's, the same seed-0 weights; written here if
    None), equal its v1 twin's, K1-K4 launched; the compressed file's
    blocks decoded by the host runtime, the others' not at all.
    ``cfg``/``specials`` let a CPU rehearsal run it at a small width."""
    import torch
    from whisper_apr_tpu_torch import (ComputeConfig, ModelConfig,
                                       TranscribeOptions, WhisperApr, native)
    from whisper_apr_tpu_torch.format import (AprReader, AprReaderV2,
                                              AprValidator)
    cfg = cfg or ModelConfig.tiny()
    t0 = time.perf_counter()
    files = write_apr_files(workdir, cfg)
    if lz4_apr is None:
        lz4_apr = workdir / "tiny-v1-int8-lz4.apr"
        write_random_apr(lz4_apr, cfg, compressed=True)
    files[("v1", "int8_lz4")] = lz4_apr
    audio = np.random.default_rng(11).normal(0, 0.1, 30 * 16_000).astype(
        np.float32)
    opts = TranscribeOptions(language="en", max_tokens=48)
    out = {}
    for (version, quant), path in files.items():
        data = path.read_bytes()
        reader = (AprReaderV2 if version == "v2" else AprReader)(data)
        report = AprValidator(reader).validate_all()
        assert report.passed, f"[formats] {path.name}: {report}"
        updates = []
        native.reset_calls()
        t1 = time.perf_counter()
        eng = WhisperApr.load_from_apr(
            str(path), ComputeConfig(quantization="int8",
                                     compute_dtype="float32"),
            specials=specials, progress=updates.append, device=device)
        load_s = time.perf_counter() - t1
        lz4_calls = native.CALLS["lz4_decompress_block"]
        assert (lz4_calls > 0) == (quant == "int8_lz4"), \
            f"[formats] {path.name}: {lz4_calls} LZ4 blocks decoded"
        frac = [u.overall for u in updates]
        assert frac == sorted(frac) and frac[-1] == 1.0 \
            and updates[-1].phase == "finalize", \
            f"[formats] {path.name}: progress {frac}"
        reset_launches()
        tokens = eng.transcribe(audio, opts).tokens
        sync(device)
        counts = launches()
        assert torch.device(device).type == "cpu" or all(
            counts[k] > 0 for k in ("self_block", "cross_block",
                                    "ffn_block", "qmatvec_greedy_head")), \
            f"[formats] {path.name}: launches {counts}"
        out[f"{version}_{quant}"] = {
            "bytes": len(data), "load_s": load_s, "updates": len(updates),
            "checks_passed": sum(c.passed for c in report.checks),
            "tokens": tokens, "launches": counts, "lz4_blocks": lz4_calls}
        log(f"[formats] {path.name}: {len(data) / 1e6:.1f} MB, "
            f"{len(report.checks)} checks passed, loaded in {load_s:.2f} s "
            f"({len(updates)} progress updates, monotone, last 1.0; "
            f"{lz4_calls} LZ4 blocks through the host runtime), "
            f"{len(tokens)} tokens, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        del eng
    for v, twin in (("v2_f32", "v1_f32"), ("v2_int8", "v1_int8"),
                    ("v1_int8_lz4", "v1_int8")):
        a, b = out[twin]["tokens"], out[v]["tokens"]
        assert a == b, f"[formats] {v} tokens {b[:16]}... != {twin} " \
            f"{a[:16]}..."
    log(f"[formats] v2 tokens == v1 twin's (f32 compute, K1-K4) in f32 and "
        f"int8, the compressed v1 int8 file's too (loaded in "
        f"{out['v1_int8_lz4']['load_s']:.2f} s, its twin in "
        f"{out['v1_int8']['load_s']:.2f} s); "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 9: the measuring utils on the card
# ---------------------------------------------------------------------------

def phase_utils(times: dict, tool_res: dict) -> dict:
    """device_memory_stats, the large-v3 roofline floors on H100 beside
    the measured steps, and run_pipeline_benchmark's split."""
    from whisper_apr_tpu_torch import ModelConfig
    from whisper_apr_tpu_torch.utils import roofline
    from whisper_apr_tpu_torch.utils.benchmark import run_pipeline_benchmark
    from whisper_apr_tpu_torch.utils.memory import device_memory_stats
    mem = device_memory_stats()
    assert mem is not None and mem.bytes_limit > 0, mem
    log(f"[utils] device_memory_stats: {mem.bytes_in_use / 2**20:.1f} MiB "
        f"in use, peak {mem.peak_bytes / 2**30:.2f} GiB, limit "
        f"{mem.bytes_limit / 2**30:.2f} GiB")
    cfg = ModelConfig.large_v3()
    floors = {kv: roofline.decode_step_floor_ms(cfg, "int8", pos=128, kv=kv)
              for kv in ("bf16", "int8")}
    steps = times["large_v3_steps"]
    log(f"[utils] large-v3 int8 B=1 decode-step floor on H100, pos 128: "
        f"bf16 rows {floors['bf16']:.4f} ms, int8 rows {floors['int8']:.4f}"
        f" ms; measured: fused step {steps['fused_b1']['ms']:.4f} ms "
        f"(CUDA graph, cross8), scan {steps['scan_b1']['ms']:.4f} ms, tool "
        f"slope {tool_res['steps_ms']['qf']:.4f} ms/step; encoder floor "
        f"{roofline.encoder_floor_ms(cfg):.4f} ms; RTF floor "
        f"{roofline.rtf_floor(cfg):.6f}")
    bench = json.loads(run_pipeline_benchmark(emit="json"))
    log(f"[utils] run_pipeline_benchmark (tiny, bf16, 224 tokens): RTF "
        f"{bench['rtf']} on {bench['device']}; " + ", ".join(
            f"{c['name']} {c['seconds'] * 1e3:.2f} ms"
            for c in bench["components"]))
    return {"memory": dataclasses.asdict(mem), "floors_ms": floors,
            "pipeline_benchmark": bench}


# ---------------------------------------------------------------------------

# (name, source, TPU kernel it replaces, the times it is reported at)
KERNELS = [
    ("self_block", "whisper_apr_tpu_torch/csrc/decode_blocks.cu",
     "whisper_apr_tpu/ops/decode_blocks.py:373", "tiny_b1"),
    ("cross_block", "whisper_apr_tpu_torch/csrc/decode_blocks.cu",
     "whisper_apr_tpu/ops/decode_blocks.py:545", "tiny_b1"),
    ("ffn_block", "whisper_apr_tpu_torch/csrc/decode_blocks.cu",
     "whisper_apr_tpu/ops/decode_blocks.py:625", "tiny_b1"),
    ("qmatvec_greedy_head", "whisper_apr_tpu_torch/csrc/int8_matmul.cu",
     "whisper_apr_tpu/ops/qmatvec.py:193", "tiny_b1"),
    ("self_block_batched",
     "whisper_apr_tpu_torch/csrc/decode_blocks_batched.cu",
     "whisper_apr_tpu/ops/decode_blocks.py:890", "tiny_b8"),
    ("cross_block_batched",
     "whisper_apr_tpu_torch/csrc/decode_blocks_batched.cu",
     "whisper_apr_tpu/ops/decode_blocks.py:1025", "tiny_b8"),
    ("ffn_block_batched", "whisper_apr_tpu_torch/csrc/ffn_batched.cu",
     "whisper_apr_tpu/ops/decode_blocks.py:1099", "tiny_b8"),
    ("qmatvec_stacked", "whisper_apr_tpu_torch/csrc/int8_matmul.cu",
     "whisper_apr_tpu/ops/qmatvec.py:86", "tiny_b8"),
    ("ffn_fused", "whisper_apr_tpu_torch/csrc/ffn_batched.cu",
     "whisper_apr_tpu/ops/qmatvec.py:279", "tiny_b1"),
    ("q4k_matvec_stacked", "whisper_apr_tpu_torch/csrc/kquant_matvec.cu",
     "whisper_apr_tpu/ops/q4k.py:329", "base_q4k"),
    ("kq_matvec_stacked", "whisper_apr_tpu_torch/csrc/kquant_matvec.cu",
     "whisper_apr_tpu/ops/kquants.py:458", "base_q5k"),
    ("self_block_kq", "whisper_apr_tpu_torch/csrc/decode_blocks.cu",
     "whisper_apr_tpu/ops/decode_blocks_kq.py:395", "base_q4k"),
    ("cross_block_kq", "whisper_apr_tpu_torch/csrc/decode_blocks.cu",
     "whisper_apr_tpu/ops/decode_blocks_kq.py:549", "base_q4k"),
    ("ffn_block_kq", "whisper_apr_tpu_torch/csrc/decode_blocks.cu",
     "whisper_apr_tpu/ops/decode_blocks_kq.py:672", "base_q4k"),
    ("paged_attention_stacked",
     "whisper_apr_tpu_torch/csrc/paged_attention.cu",
     "whisper_apr_tpu/ops/paged_attention.py:115", "tiny_optin"),
    ("flash_attention", "whisper_apr_tpu_torch/csrc/flash_attention.cu",
     "whisper_apr_tpu/ops/flash_attention.py:135", "tiny_optin"),
    ("int8_matmul", "whisper_apr_tpu_torch/csrc/int8_matmul.cu",
     "whisper_apr_tpu/ops/int8_matmul.py:72", "tiny_optin"),
    ("int4_matmul", "whisper_apr_tpu_torch/csrc/dequant_matmul.cu",
     "whisper_apr_tpu/ops/int4_matmul.py:115", "tiny_optin"),
    # the f32 paths (three bf16 terms on the tensor cores): K16 at B=1,
    # K17 / K18's tile kernels at 1500 rows, at large-v3's shapes
    ("flash_attention_f32", "whisper_apr_tpu_torch/csrc/flash_attention.cu",
     "whisper_apr_tpu/ops/flash_attention.py:135", "large_v3_optin"),
    ("int8_matmul_f32", "whisper_apr_tpu_torch/csrc/int8_matmul.cu",
     "whisper_apr_tpu/ops/int8_matmul.py:72", "large_v3_optin"),
    ("int4_matmul_f32", "whisper_apr_tpu_torch/csrc/dequant_matmul.cu",
     "whisper_apr_tpu/ops/int4_matmul.py:115", "large_v3_optin"),
    ("int8_dot", "whisper_apr_tpu_torch/csrc/probe_mma.cu",
     "tools/probe_layer_kernel.py:427", "probes"),
    ("mixed_dot", "whisper_apr_tpu_torch/csrc/probe_mma.cu",
     "tools/probe_layer_kernel.py:447", "probes"),
    ("tricks", "whisper_apr_tpu_torch/csrc/probe_mma.cu",
     "tools/probe_layer_kernel.py:479", "probes"),
]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--detail", type=Path, default=None,
                        help="also write every measurement to this JSON file")
    detail_path = parser.parse_args().detail
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    smi = phase_device()
    import torch
    from whisper_apr_tpu_torch import native
    phase_build()
    out_dir = ROOT / "build" / "smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    native_dir = Path(tempfile.mkdtemp(dir=out_dir))
    host = phase_native(native_dir)
    errs, times = phase_kernels()
    kq_errs, kq_times = phase_kquant_kernels()
    errs.update(kq_errs)
    times.update(kq_times)
    op_errs, op_times = phase_optin_kernels()
    errs.update(op_errs)
    times.update(op_times)
    from whisper_apr_tpu_torch.utils import trace
    trace.enable_tracing(True)
    trace.drain_events()
    with trace.trace_span("probes"):
        pr_errs, pr_times = phase_probes()
    errs.update(pr_errs)
    times.update(pr_times)
    with trace.trace_span("probe_tool"):
        tool_res = phase_probe_tool(out_dir, times)
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        e2e = phase_e2e(Path(work))
        check_launches(e2e["total"], e2e["requests"])
        rtf = e2e["rtf"]
        rtf["device"] = device_busy(e2e["engine"],
                                    e2e["clips"]["noise_30s"],
                                    rtf["seconds"])
        serve = phase_serve(e2e["apr"], e2e["engine"])
        assert serve["launches"] == serve["want_launches"], (
            f"[serve] launches over {serve['ticks']} ticks "
            f"{serve['launches']}, want {serve['want_launches']}")
        paged = phase_paged(e2e["apr"])
        check_paged_launches(paged)
        batch = phase_batch(e2e["engine"], e2e["engine_f32"])
        longform = phase_longform(e2e["engine"], e2e["engine_f32"],
                                  Path(work))
        cli = phase_cli(e2e["apr"], Path(work), smi)
        decoders = phase_decoders(e2e["apr"])
        with trace.trace_span("mesh"):
            mesh = phase_mesh(smi)
        with trace.trace_span("speculative"):
            spec = phase_speculative(e2e["apr"], e2e["engine"], smi)
        kq = phase_kquant(Path(work))
        check_kq_launches(kq)
        int4 = phase_int4(e2e["apr"])
        for sfx in ("", "_f32"):
            assert int4["launches" + sfx] == int4["want_launches" + sfx], (
                f"[int4] launches{sfx} {int4['launches' + sfx]}, want "
                f"{int4['want_launches' + sfx]}")
    large = phase_large_v3()
    large_optin = phase_large_v3_optin()
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        with trace.trace_span("formats"):
            formats = phase_formats(Path(work), lz4_apr=host["lz4_apr"])
    shutil.rmtree(native_dir)
    with trace.trace_span("utils"):
        utils = phase_utils(times, tool_res)
    # the phases' own spans (the program's spans sit inside them or on
    # the serving threads)
    phases = ("probes", "probe_tool", "mesh", "speculative", "formats",
              "utils")
    events = [e for e in trace.drain_events() if e[0] in phases]
    trace.enable_tracing(False)
    log("[utils] trace_span events: " + ", ".join(
        f"{name} {dur:.2f} s" for name, _, dur in events))
    # each path's counts, taken from 0 just before it ran (the probe
    # tool's in its own process)
    runs = [e2e["total"], serve["launches"], serve["scan"]["launches"],
            batch["launches"], large["launches"], large["long"]["launches"],
            *(p["launches"] for p in longform["paths"].values()),
            *cli["launches"],
            *(p["launches"] for p in decoders["paths"].values()),
            *(p["launches"] for p in kq["paths"].values()),
            *(r["launches"] for r in paged["runs"].values()),
            int4["launches"], int4["launches_f32"], large_optin["launches"],
            tool_res["launches"],
            *(f["launches"] for f in formats.values())]
    total = {k: sum(r.get(k, 0) for r in runs) for k in e2e["total"]}
    for name in ("int8_dot", "mixed_dot", "tricks"):
        assert tool_res["launches"][name] > 0, tool_res["launches"]
    assert all(total[name] > 0 for name, *_ in KERNELS), total
    # the host runtime's calls on the main path, each run's from 0
    lib_runs = [*(p["native"] for p in longform["paths"].values()),
                cli["native"], {"lz4_decompress_block":
                                formats["v1_int8_lz4"]["lz4_blocks"]}]
    lib_total = {k: sum(r.get(k, 0) for r in lib_runs) for k in native.CALLS}
    assert all(lib_total[k] > 0 for k in (
        "resample_sinc", "lz4_decompress_block", "dtw_path")), lib_total
    # the f32 entries' bound is on the tensor cores they run on; beside it
    # their bound on the CUDA cores' f32 rate
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    simt = "f32_simt_bound_ms"
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": total[name], "max_abs_err": errs[name],
         **{k: times[at][name][k] for k in keys},
         **({simt: times[at][name][simt]} if simt in times[at][name]
            else {})}
        for name, src, rep, at in KERNELS]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    if detail_path is not None:
        detail = {"card": smi, "kernels_ms": times,
                  "native": {**{k: v for k, v in host.items()
                                if k != "lz4_apr"}, "calls": lib_total},
                  "requests": e2e["requests"], "bench_rtf": rtf,
                  "bench_rtf_plain": e2e["rtf_plain"],
                  "serve": {k: v for k, v in serve.items()
                            if k != "want_launches"},
                  "batch": {k: v for k, v in batch.items()
                            if k != "want_launches"},
                  "longform": longform,
                  "cli": {k: v for k, v in cli.items() if k != "launches"},
                  "decoders": decoders, "mesh": mesh,
                  "speculative": spec, "large_v3": large,
                  "kquant": {k: v for k, v in kq.items()
                             if k != "launch_checks"},
                  "paged": paged["runs"],
                  "int4": {k: v for k, v in int4.items()
                           if not k.startswith("want_launches")},
                  "large_v3_optin": {k: v for k, v in large_optin.items()
                                     if k != "want_launches"},
                  "probe_tool": tool_res, "formats": formats,
                  "utils": utils, "trace_events": events}
        detail_path.parent.mkdir(parents=True, exist_ok=True)
        detail_path.write_text(json.dumps(detail, indent=1))
    log(f"[native] host runtime calls on the main path: "
        f"{json.dumps(lib_total)}")
    log(json.dumps(summary))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
