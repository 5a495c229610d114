"""chip_smoke.py, the port's GPU check, exercised without a GPU: it must
refuse to run (non-zero exit, no result line) where there is no CUDA
device or no repository beside it; its end-to-end, serve, batch and
decoders phases must run on the CPU at a small width through the plain
versions; and the kernel check's and the step timing's inputs must be
what the kernels and steps take, with the planted head tie a tie."""

import importlib.util
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_refuses_without_cuda_or_repo(tmp_path, where):
    """Run with no visible CUDA device, so the refusal is tested on a GPU
    machine too."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _small():
    from whisper_apr_tpu_torch import ModelConfig
    from whisper_apr_tpu_torch.tokenizer import SpecialTokens
    cfg = ModelConfig(model_type="tiny", n_vocab=700, n_audio_ctx=32,
                      n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                      n_text_ctx=40, n_text_state=128, n_text_head=2,
                      n_text_layer=2, n_mels=80)
    V = cfg.n_vocab
    sp = SpecialTokens(eot=V - 1, sot=V - 2, lang_base=V - 110,
                       transcribe=V - 3, no_timestamps=V - 4,
                       timestamp_base=V + 1000, is_multilingual=False,
                       translate=V - 5, no_speech=V - 6, speaker_turn=V - 7,
                       prev=V - 8)
    return cfg, sp


def test_end_to_end_phase_on_cpu(smoke, e2e_small):
    """The e2e phase through the engine entry points: three requests, the
    f32 kernels-vs-plain token check, the bench protocol. On the CPU the
    plain versions run, so no kernel launches and ``check_launches``
    (which the GPU run applies) refuses the counts."""
    cfg, _ = _small()
    out, _ = e2e_small
    requests = out["requests"]
    assert [r["clip"] for r in requests] == ["noise_30s", "tone_5s",
                                             "silence_10s"]
    assert all(r["decode_steps"] > 0 for r in requests)
    assert out["rtf"]["rtf"] > 0 and out["rtf_plain"]["rtf"] > 0
    assert set(out["total"]) == {
        "self_block", "cross_block", "ffn_block", "qmatvec_greedy_head",
        "self_block_batched", "cross_block_batched", "ffn_block_batched",
        "qmatvec_stacked", "ffn_fused", "q4k_matvec_stacked",
        "kq_matvec_stacked", "self_block_kq", "cross_block_kq",
        "ffn_block_kq", "paged_attention_stacked", "flash_attention",
        "int8_matmul", "int4_matmul", "int8_dot", "mixed_dot", "tricks",
        "flash_attention_f32", "int8_matmul_f32", "int4_matmul_f32"}
    assert not any(out["total"].values())
    steps = requests[0]["decode_steps"]
    assert requests[0]["want_launches"]["self_block"] == \
        cfg.n_text_layer * steps
    with pytest.raises(AssertionError, match="launches"):
        smoke.check_launches(out["total"], requests)


@pytest.fixture(scope="module")
def e2e_small(smoke, tmp_path_factory):
    cfg, sp = _small()
    return smoke.phase_e2e(tmp_path_factory.mktemp("e2e"), cfg=cfg,
                           device="cpu", specials=sp), sp


def test_serve_phase_on_cpu(smoke, e2e_small):
    """The serve phase through BatchScheduler at a small width: a dozen
    clips drain with status "ok", the f32 kernels-vs-plain and
    per-clip-transcribe checks run, and the launch counts it holds the
    card to are L per tick for K5-K7, one for K8 (none on the CPU); then
    the same clips over a kv_mode "scan" engine."""
    out, sp = e2e_small
    serve = smoke.phase_serve(out["apr"], out["engine"], device="cpu",
                              specials=sp)
    st = serve["stats"]
    assert st["completed_ok"] == len(smoke.SERVE_SECONDS) == 12
    assert serve["ticks"] > 0 and serve["ms_per_slot_token"] > 0
    L = out["engine"].config.n_text_layer
    want = serve["want_launches"]
    assert want["self_block_batched"] == L * serve["ticks"]
    assert want["qmatvec_stacked"] == serve["ticks"]
    assert want["self_block"] == want["qmatvec_greedy_head"] == 0
    assert not any(serve["launches"].values())
    # the kv_mode "scan" scheduler: dense slots, f32 checks without a
    # difference
    scan = serve["scan"]
    assert scan["ticks"] > 0 and all(g is None for g in scan["f32_gaps"])
    assert not any(scan["launches"].values())


def test_batch_phase_on_cpu(smoke, e2e_small):
    """The batched-transcribe phase runs its f32 checks, then its launch
    check (K5-K7 L x steps, K4 steps) refuses the CPU's zero counts."""
    out, _ = e2e_small
    with pytest.raises(AssertionError, match="launches"):
        smoke.phase_batch(out["engine"], out["engine_f32"], device="cpu")


def test_longform_phase_on_cpu(smoke, e2e_small, tmp_path):
    """The longform phase at a small width through the plain versions:
    a 2 s 44.1 kHz WAV over four 10 240-sample windows in one batch, the
    VAD's batch of three, both streaming sessions, the prefixed
    continuation, hotwords against the fused path and word timestamps
    run, every decode is logged with its rows, and nothing launches."""
    out, _ = e2e_small
    lf = smoke.phase_longform(out["engine"], out["engine_f32"], tmp_path,
                              device="cpu", max_tokens=12, stream_tokens=20,
                              long_seconds=2.0)
    paths = lf["paths"]
    assert set(paths) == {
        "transcribe_file", "transcribe_with_vad", "session reuse=on",
        "session reuse=off", "transcribe_prefixed",
        "hotwords reference (fused greedy)", "word timestamps"}
    assert [b for b, _, _ in paths["transcribe_file"]["decodes"]] == [4]
    assert all(b == 1 for p in ("session reuse=on", "session reuse=off")
               for b, _, _ in paths[p]["decodes"])
    assert max(P for _, P, _ in paths["session reuse=on"]["decodes"]) > \
        max(P for _, P, _ in paths["session reuse=off"]["decodes"])
    assert not any(any(p["launches"].values()) for p in paths.values())
    assert lf["words"]["n"] > 1 and lf["hotword_ms_per_step"] > 0
    assert lf["stream"]["session reuse=on"]["partials"] > 10
    L = out["engine"].config.n_text_layer
    want = smoke.want_decodes([(1, 4, 5), (3, 4, 7)], L)
    assert (want["self_block"], want["self_block_batched"],
            want["qmatvec_greedy_head"]) == (5 * L, 7 * L, 12)


def test_near_tie_rule(smoke, e2e_small):
    """Identical token lists pass with no gap; a difference where the
    logits are not tied fails."""
    out, _ = e2e_small
    eng = out["engine_f32"]
    audio = smoke.make_clips((1,), seed=3)[0]
    toks = eng.transcribe(audio).tokens
    assert smoke.check_follows(eng, audio, toks, toks, "t") is None
    bad = toks[:-1] + [(toks[-1] + 1) % eng.config.n_vocab]
    with pytest.raises(AssertionError, match="gap"):
        smoke.check_follows(eng, audio, bad, toks, "t")


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
def test_kernel_check_phase_on_cpu(smoke, cdt):
    """The kernel check's inputs at a small width: the stacks and every
    cache mode pass the layout checks the main path applies, and the
    planted head tie resolves to its first column in the plain version
    (suppressed and padding columns do not win)."""
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    D, L, n_vocab = 128, 3, 700
    gen = torch.Generator().manual_seed(1)
    smoke.make_blk(D, L, gen, "cpu")
    for mode in ("rows", "int8", "fp8"):
        kq, ks, vq, vs = smoke.make_cache(mode, L, 512, D, gen, "cpu", cdt)
        assert (ks is not None) == (mode == "int8")
    x = torch.randn((1, D), generator=gen).to(cdt)
    wq, bias, (first, second) = smoke.head_case(n_vocab, x, gen)
    assert int(qm.qmatvec_greedy_head_plain(x, wq, bias, n_vocab)[0]) == first
    bias[0, [first, second]] = 0.0
    tok = int(qm.qmatvec_greedy_head_plain(x, wq, bias, n_vocab)[0])
    assert tok < n_vocab - 100 or n_vocab - 50 <= tok < n_vocab


def _ts_specials():
    """Special ids of the small vocabulary with timestamps from 510 up
    (above EOT, as in Whisper)."""
    from whisper_apr_tpu_torch.tokenizer import SpecialTokens
    return SpecialTokens(eot=500, sot=501, lang_base=390, transcribe=502,
                         no_timestamps=503, timestamp_base=510,
                         is_multilingual=False, translate=504,
                         no_speech=505, speaker_turn=506, prev=507)


def test_decoders_phase_on_cpu(smoke, e2e_small):
    """The decoders phase at a small width through the plain versions:
    every path runs (scan greedy, beam on 1 and 8 clips, n-best,
    sampling twice with one seed, timestamps, the fallback), nothing
    launches, and its f32 kernels-vs-plain checks find no difference."""
    out, _ = e2e_small
    dec = smoke.phase_decoders(out["apr"], device="cpu",
                               specials=_ts_specials(), max_tokens=10)
    assert set(dec["paths"]) == {
        "scan greedy", "beam 5, 1 clip", "beam 5, 8 clips (40 rows)",
        "nbest 5", "sampling T=0.8 top_k 40",
        "sampling best_of 3, top_p 0.95", "timestamps", "fallback"}
    assert not any(any(p["launches"].values())
                   for p in dec["paths"].values())
    assert all(g in ([], [None]) for g in dec["f32_gaps"].values())


def test_scan_step_timing_operands_on_cpu(smoke):
    """The operands the scan-step timing builds drive both decode steps
    (scan and fused) at B = 1 and B = 8."""
    from whisper_apr_tpu_torch import ModelConfig
    from whisper_apr_tpu_torch.model import qdecode
    gen = torch.Generator().manual_seed(0)
    blk = smoke.make_blk(128, 2, gen, "cpu")
    cfg = ModelConfig("timing", 700, 1500, 128, 2, 2, 448, 128, 2, 2, 80)
    for B, mode in ((1, "cross8"), (8, "int8")):
        params, qd, kv = smoke.scan_case(blk, 128, 2, 700, B, gen, "cpu",
                                         torch.float32, T=40, S=32)
        tok = torch.randint(0, 700, (B,), generator=gen, dtype=torch.int32)
        pos = 5 if B == 1 else torch.full((B,), 5, dtype=torch.int32)
        a, _ = qdecode.decode_step_q(params, qd, tok, pos, kv, cfg,
                                     compute_dtype=torch.float32)
        b, _ = qdecode.decode_step_qf(params, qd, tok, pos,
                                      qdecode.quantize_cache(kv, mode), cfg,
                                      compute_dtype=torch.float32)
        assert a.shape == b.shape == (B, 700)
        assert bool(torch.isfinite(a).all() and torch.isfinite(b).all())


def test_ffn_fused_bound(smoke):
    """K9's bound: its int8 weights (2·D·4D bytes) and s1/b1 over the
    memory rate, about 0.36 us at tiny and 3.9 us at large-v3."""
    tiny, _ = smoke.bound("ffn_fused", 384, 1)
    large, by = smoke.bound("ffn_fused", 1280, 1)
    assert by == "bytes"
    assert 0.35e-3 < tiny < 0.37e-3 and 3.9e-3 < large < 4.0e-3


def test_kquant_phase_on_cpu(smoke, tmp_path):
    """The k-quant phase at a small 256-wide model through the plain
    versions: each format's .apr loads with its k-quant qd, every path
    runs, the f32 checks find no difference, nothing launches, and the
    launch check (which the GPU run applies) refuses the zero counts."""
    from whisper_apr_tpu_torch import ModelConfig
    cfg = ModelConfig(model_type="tiny", n_vocab=700, n_audio_ctx=32,
                      n_audio_state=256, n_audio_head=4, n_audio_layer=1,
                      n_text_ctx=40, n_text_state=256, n_text_head=4,
                      n_text_layer=2, n_mels=80)
    _, sp = _small()
    out = smoke.phase_kquant(tmp_path, cfg=cfg, device="cpu", specials=sp,
                             max_tokens=8)
    assert set(out["paths"]) == {
        "q4k noise 30 s", "q5k noise 30 s", "q6k noise 30 s",
        "q4k scan greedy", "q5k scan greedy", "q4k transcribe_batch of 4",
        "q4k BatchScheduler(n_slots=4)"}
    assert not any(any(p["launches"].values())
                   for p in out["paths"].values())
    assert all(g is None for g in out["f32_gaps"]["q4k batch and serve"])
    want = {name: w for name, _, w in out["launch_checks"]}
    L = cfg.n_text_layer
    n = want["q4k noise 30 s"]["qmatvec_greedy_head"]
    assert n > 0 and want["q4k noise 30 s"]["self_block_kq"] == L * n
    scan = want["q5k scan greedy"]
    assert scan["kq_matvec_stacked"] == 6 * L * scan["qmatvec_stacked"] > 0
    with pytest.raises(AssertionError, match="launches"):
        smoke.check_kq_launches(out)


@pytest.mark.parametrize("fmt", ["q4k", "q5k", "q6k"])
def test_kquant_kernel_operands_on_cpu(smoke, fmt):
    """The random planar stacks of the kernel check pass the layout check
    of the main path and drive the plain K12-K14 and K10/K11 to finite
    O(1) outputs."""
    from whisper_apr_tpu_torch.ops import decode_blocks_kq as dbk
    gen = torch.Generator().manual_seed(0)
    D, L = 256, 2
    blk = smoke.make_kq_blk(fmt, D, L, gen, "cpu")
    kq, ks, vq, vs = smoke.make_cache("int8", L, 256, D, gen, "cpu",
                                      torch.float32)
    x = torch.randn((1, D), generator=gen)
    outs = [dbk.self_block_kq_plain(x, blk, kq, ks, vq, vs, 5, 1, 4)[0],
            dbk.cross_block_kq_plain(x, blk, kq, ks, vq, vs, 200, 1, 4),
            dbk.ffn_block_kq_plain(x, blk, 1),
            smoke._kq_matvec(fmt, plain=True)(
                torch.randn((3, 4 * D), generator=gen), *blk["fc2"], 1)]
    for y in outs:
        assert bool(torch.isfinite(y).all()) and float(y.abs().max()) < 50


def test_kquant_bounds(smoke):
    """The k-quant bounds from the planar bytes (0.75 a weight for Q4_K,
    1.25 for Q5_K and Q6_K) at large-v3, pos 128, cross8: about 1.7 /
    2.6 us for K12, 1.9 / 2.4 for K13 and 2.9 / 4.9 for K14."""
    want = {("self_block_kq", "q4k"): 1.7, ("self_block_kq", "q5k"): 2.6,
            ("cross_block_kq", "q4k"): 1.9, ("cross_block_kq", "q6k"): 2.4,
            ("ffn_block_kq", "q4k"): 2.9, ("ffn_block_kq", "q6k"): 4.9}
    for (name, fmt), us in want.items():
        shape = {"self_block_kq": dict(rows=128),
                 "cross_block_kq": dict(rows=1500, cache_bytes=1,
                                        scales=True)}.get(name, {})
        ms, by = smoke.kq_bound(name, fmt, 1280, **shape)
        assert by == "bytes" and abs(1e3 * ms - us) < 0.1, (name, fmt, ms)


def test_paged_phase_on_cpu(smoke, e2e_small):
    """The paged phase at a small width through the plain versions: the
    dozen clips drain over the page pool with batched and staged
    admission, without and with flash + the int8 switch; the f32
    kernels-vs-plain and per-clip checks find no difference; the launch
    counts it holds the card to are L per tick for K15 and, with the
    switches, La per admission encode for K16 and 8 L per tick plus
    6 La + 10 L per encode for K17 (none launch on the CPU, so the check
    refuses the counts)."""
    out, sp = e2e_small
    cfg = out["engine"].config
    L, La = cfg.n_text_layer, cfg.n_audio_layer
    paged = smoke.phase_paged(out["apr"], device="cpu", specials=sp)
    assert set(paged["runs"]) == {"batched", "staged",
                                  "batched + flash + int8",
                                  "staged + flash + int8"}
    for name, run in paged["runs"].items():
        assert run["ticks"] > 0 and not any(run["launches"].values())
        assert all(g is None for g in run["f32_gaps"]), name
        assert run["pool_pages"] == 8 * -(-cfg.n_text_ctx // 16) + 1
    want = {name: w for name, _, w in paged["launch_checks"]}
    ticks = paged["runs"]["staged + flash + int8"]["ticks"]
    w = want["staged + flash + int8"]
    assert w["paged_attention_stacked"] == L * ticks
    assert w["flash_attention"] == La * 12       # one encode per request
    assert w["int8_matmul"] == 8 * L * ticks + 12 * (6 * La + 10 * L)
    assert want["batched"] == smoke.want_counts(
        paged_attention_stacked=L * paged["runs"]["batched"]["ticks"])
    with pytest.raises(AssertionError, match="launches"):
        smoke.check_paged_launches(paged)


def test_optin_full_width_phases_on_cpu(smoke, e2e_small):
    """The int4 phase (an int4 engine with USE_PALLAS_INT4: K18 held to
    6 La + 10 L + 8 L per step) and the large-v3 opt-in phase at a small
    width through the plain versions: both run, their f32 token checks
    pass, nothing launches, and the switches are off again after."""
    from whisper_apr_tpu_torch.ops import int4_matmul, int8_matmul
    out, sp = e2e_small
    cfg = out["engine"].config
    L, La = cfg.n_text_layer, cfg.n_audio_layer
    int4 = smoke.phase_int4(out["apr"], device="cpu", specials=sp,
                            max_tokens=8)
    n = int4["decode_steps"]
    assert n > 0 and int4["want_launches"]["int4_matmul"] == \
        6 * La + 10 * L + 8 * L * n
    assert not any(int4["launches"].values())
    large = smoke.phase_large_v3_optin(device="cpu", max_tokens=8, cfg=cfg,
                                       specials=sp)
    assert large["near_tie_gap"] is None
    assert large["want_launches"]["int8_matmul"] == 6 * La + 10 * L
    assert large["want_launches"]["flash_attention"] == La
    # f32: K16 and K17's 1500-row linears through the three-term kernels
    assert large["want_launches"]["flash_attention_f32"] == La
    assert large["want_launches"]["int8_matmul_f32"] == 6 * La + 2 * L
    assert int4["want_launches_f32"]["int4_matmul_f32"] == 6 * La + 2 * L
    assert not any(int4["launches_f32"].values())
    # f32 and bf16, plain attention and K16, K17 off and on
    assert len(large["encoder_ms"]) == 8
    assert set(large["encoder_device_ms"]) == set(large["encoder_ms"])
    assert not int8_matmul.USE_PALLAS_INT8 and not int4_matmul.USE_PALLAS_INT4


@pytest.mark.parametrize("cdt", [torch.bfloat16, torch.float32])
def test_optin_kernel_operands_on_cpu(smoke, cdt):
    """The K15-K18 check operands: 8 slots of 28 scattered, distinct pages
    over an n_slots * 28 + 1 page pool, the slot past its table; they
    drive the plain K15 (the full and a 2-page table), K16 (causal and
    kv_valid) and K17 / K18 (an odd int4 width) to finite outputs of
    the kernels' shapes."""
    from whisper_apr_tpu_torch.ops import flash_attention as fa
    from whisper_apr_tpu_torch.ops import int4_matmul as i4
    from whisper_apr_tpu_torch.ops import int8_matmul as i8
    from whisper_apr_tpu_torch.ops import paged_attention as pa
    gen = torch.Generator().manual_seed(0)
    q, kp, vp, tables, lens = smoke.paged_case(128, 2, cdt, gen, "cpu")
    assert tables.shape == (8, smoke.P_MAX) and kp.shape[1] == 8 * 28 + 1
    assert len(set(tables.flatten().tolist())) == 8 * 28
    assert int(lens.max()) > 16 * smoke.P_MAX
    for t in (tables, tables[:, :2].contiguous()):
        y = pa.paged_attention_stacked(q, kp, vp, t, lens, 1, 2)
        assert y.dtype == cdt and bool(torch.isfinite(y).all())
    qkv = [torch.randn((1, 2, 70, 64), generator=gen).to(cdt)
           for _ in range(3)]
    for kw in ({}, dict(causal=True), dict(kv_valid=40)):
        y = fa.flash_attention(*qkv, **kw)
        assert y.shape == (1, 2, 70, 64) and bool(torch.isfinite(y).all())
    x, wq, s = smoke.matmul_case(96, 101, 3, cdt, gen, "cpu", bits=4)
    assert wq.shape == (96, 51) and s.shape == (101,)
    y = i4.int4_matmul(x, wq, s)
    assert y.shape == (3, 102) and float(y[:, 101].abs().max()) == 0.0
    x, wq, s = smoke.matmul_case(96, 40, 3, cdt, gen, "cpu",
                                 per_channel=False)
    assert s.shape == (1,) and i8.int8_matmul(x, wq, s).shape == (3, 40)


def test_optin_bounds(smoke):
    """K15: the bytes of the K and V rows read (1541 rows of 8 slots at
    tiny, about 0.71 us); K16: 4 B H T^2 64 operations at 989 TFLOP/s
    (about 3.49 us at tiny, 11.65 at large-v3), compute-bound; K17: the
    int8 weights at a tick's 8 rows (0.19 us at tiny fc1), 2 M N K
    operations at the encoder's 1500 rows (19.9 us at large-v3 fc1); K18
    half K17's weight bytes."""
    assert smoke.paged_rows(smoke.PAGED_LENGTHS) == 1541
    ms, by = smoke.optin_bound("paged_attention_stacked", B=8, D=384,
                               P=28, rows=1541)
    assert by == "bytes" and abs(1e3 * ms - 0.7105) < 1e-3
    for H, us in ((6, 3.494), (20, 11.648)):
        ms, by = smoke.optin_bound("flash_attention", B=1, H=H, Tq=1500,
                                   Tk=1500)
        assert by == "operations" and abs(1e3 * ms - us) < 1e-2
    ms, by = smoke.optin_bound("int8_matmul", M=8, K=384, N=1536)
    assert by == "bytes" and abs(1e3 * ms - 0.1871) < 1e-3
    ms, by = smoke.optin_bound("int8_matmul", M=1500, K=1280, N=5120)
    assert by == "operations" and abs(1e3 * ms - 19.88) < 0.01
    ms4, _ = smoke.optin_bound("int4_matmul", M=8, K=384, N=1536)
    assert abs(1e3 * ms4 - (0.1871 - 384 * 768 / 3.35e12 * 1e6)) < 1e-3


def test_f32_bounds_and_floors(smoke):
    """The f32 rows' bound on the CUDA cores (67 TFLOP/s: K16 at large-v3
    B=1 0.172 ms, K17 / K18 fc1 at 1500 rows 0.293 ms, operations-bound)
    and their tensor-core floors at six and three bf16 products an f32
    one (69.9 and 59.6 us at 989 TFLOP/s), which are their bounds on the
    tensor cores they run on (the bytes take 9.2 and 13.4 us); the prompt
    row counts above the decode kernels' rows."""
    ms, by = smoke.optin_bound("flash_attention", B=1, H=20, Tq=1500,
                               Tk=1500, elem=4, compute="float32")
    assert by == "operations" and abs(1e3 * ms - 171.9) < 0.1
    ms, by = smoke.optin_bound("flash_attention", B=1, H=20, Tq=1500,
                               Tk=1500, elem=4, products=6)
    assert by == "operations" and abs(1e3 * ms - 69.9) < 0.1
    for name in ("int8_matmul", "int4_matmul"):
        ms, by = smoke.optin_bound(name, M=1500, K=1280, N=5120, elem=4,
                                   compute="float32")
        assert by == "operations" and abs(1e3 * ms - 293.4) < 0.1
        ms, by = smoke.optin_bound(name, M=1500, K=1280, N=5120, elem=4,
                                   products=3)
        assert by == "operations" and abs(1e3 * ms - 59.6) < 0.1
    assert abs(1e3 * smoke.tc_floor_ms(6, 4 * 64 * 20 * 1500 ** 2)
               - 69.9) < 0.1
    assert abs(1e3 * smoke.tc_floor_ms(3, 2 * 1500 * 5120 * 1280)
               - 59.6) < 0.1
    assert smoke.F32_MID_ROWS == {"int8_matmul": 224, "int4_matmul": 64}


def test_formats_phase_on_cpu(smoke, tmp_path):
    """The formats phase at a small width: the port's v1 and v2 files in
    f32 and int8 and a compressed v1 int8 file, each validated and loaded
    with monotone progress; the v2 tokens equal the v1 twins', the
    compressed file's its uncompressed twin's, its blocks decoded by the
    host runtime."""
    cfg, sp = _small()
    out = smoke.phase_formats(tmp_path, cfg=cfg, device="cpu", specials=sp)
    assert set(out) == {"v1_f32", "v1_int8", "v2_f32", "v2_int8",
                        "v1_int8_lz4"}
    for q in ("f32", "int8"):
        assert out[f"v1_{q}"]["tokens"] == out[f"v2_{q}"]["tokens"]
    assert out["v1_int8_lz4"]["tokens"] == out["v1_int8"]["tokens"]
    assert out["v1_int8_lz4"]["lz4_blocks"] > 0
    assert all(r["checks_passed"] > 0 and r["updates"] > 5
               for r in out.values())


def test_probe_bounds(smoke):
    """P1: 393 216 bytes at 3.35 TB/s (0.117 us) over 2 * 256^3 int8
    operations at 1979 TOP/s; P2: 458 752 bytes (0.137 us), bf16; P3 (g):
    f32 on the CUDA cores, 2 * 8 * 128 * 32 * 1280 operations at 67
    TFLOP/s (1.25 us) above its 2.75 MB (0.82 us); a transpose has no
    operations."""
    from whisper_apr_tpu_torch.tools import probe_layer_kernel as tool
    cases = {c.probe: c for c in tool.int8dot_cases("cpu")}
    p1 = cases["P1"]
    b, o = smoke.probe_bound(p1, p1.plain())
    assert abs(1e3 * b - 0.1174) < 1e-3 and abs(1e3 * o - 0.01696) < 1e-4
    p2 = cases["P2"]
    b, o = smoke.probe_bound(p2, p2.plain())
    assert abs(1e3 * b - 0.1369) < 1e-3 and abs(1e3 * o - 0.0339) < 1e-3
    tricks = {c.probe: c for c in tool.tricks_cases("cpu")}
    g = tricks["P3 (g)"]
    b, o = smoke.probe_bound(g, g.plain())
    want_bytes = 8 * 128 * 1280 + 4 * 8 * 1280 * 32 + 4 * 8 * 128 * 32
    assert abs(b - 1e3 * want_bytes / 3.35e12) < 1e-9
    assert abs(o - 1e3 * 2 * 8 * 128 * 32 * 1280 / 67e12) < 1e-9
    d = tricks["P3 (d)"]
    assert smoke.probe_bound(d, d.plain())[1] == 0.0


def test_probe_tool_command(smoke):
    """The smoke runs the tool as a user would, with the flags the slice
    names."""
    assert smoke.PROBE_TOOL[:2] == [
        "-m", "whisper_apr_tpu_torch.tools.probe_layer_kernel"]
    assert {"--int8dot", "--tricks", "--large"} <= set(smoke.PROBE_TOOL)
    names = [n for n, *_ in smoke.KERNELS]
    # the 21 sites, and K16-K18's f32 paths apart (three bf16 terms)
    assert len(names) == 24 and names[-3:] == ["int8_dot", "mixed_dot",
                                               "tricks"]
    assert {"flash_attention_f32", "int8_matmul_f32",
            "int4_matmul_f32"} <= set(names)


@pytest.mark.parametrize("H", [6, 20], ids=["tiny", "large-v3"])
def test_flash_cases_reach_the_split_edges(smoke, H):
    """The K16 checks run at each width through the unsplit kernel and
    through splits, among them one whose last key range is short of the
    others and a query count that is not the key count."""
    from whisper_apr_tpu_torch.ops import flash_attention as fa
    plans = [(fa.flash_split(B, H, Tq, Tk), Tq, Tk)
             for B, Tq, Tk, _ in smoke.FLASH_CASES]
    assert any(p.n_split == 1 for p, _, _ in plans)
    split = [(p, Tq, Tk) for p, Tq, Tk in plans if p.n_split > 1]
    assert any(Tq != Tk for _, Tq, Tk in split)
    assert any(Tk - p.key_ranges(Tk)[-1][0] < p.split_tiles * fa.BLOCK_K
               for p, _, Tk in split)
    assert {1, 63, 65} <= {Tk for _, _, Tk in plans}


def test_probe_edge_cases_cover_each_path(smoke):
    """P3's smoke-only cases run on the CPU (plain versions) to the
    kernel's output shapes, and their plans take every path of the f32
    contraction: split K, the 2-stage ring, a batch, rows not 16-byte
    aligned, a transposed int8 A."""
    import torch
    cases = smoke.probe_edge_cases("cpu")
    for case, plan in cases:
        got, ref = case.kernel(), case.plain()
        assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    plans = [plan for _, plan in cases]
    assert any(p.n_split > 1 for p in plans)
    assert any(p.k_chunk < p.k_split for p in plans)      # the ring
    assert any(c.inputs[0].dim() == 3 for c, _ in cases)
    assert any(c.inputs[0].shape[-1] * c.inputs[0].element_size() % 16
               for c, _ in cases)
    assert any(c.inputs[0].dtype == torch.int8 and "dotT" in c.name
               for c, _ in cases)


def test_int4_cases_reach_each_path(smoke):
    """K18's smoke cases take every path of the kernels: one and two
    8-row tiles of the decode kernel, split and unsplit K, the tile kernel
    either side of a 128-row tile, K not a multiple of a 16-row
    step, packed rows that are not 16-byte aligned (even and odd widths),
    and the plain version takes them all on the CPU."""
    from whisper_apr_tpu_torch.ops import int4_matmul as i4
    cases = [(M, K, N) for shapes in smoke.MATMUL_SHAPES.values()
             for K, N in shapes for M in smoke.MATMUL_ROWS] + list(
                 smoke.INT4_EDGES)
    rows = {M for M, _, _ in cases}
    assert {1, 8} <= rows and {15, 16} <= rows and 17 in rows
    assert {127, 129, 1500} <= rows
    plans = [i4.int4_plan(M, K, N + N % 2) for M, K, N in cases]
    decode = [p for p, (M, _, _) in zip(plans, cases)
              if M <= i4.DECODE_ROWS]
    assert {p.n_split > 1 for p in decode} == {True, False}
    assert any(K % i4.STEP for _, K, _ in cases)
    assert any((N + N % 2) // 2 % 16 and N % 2 for _, _, N in cases)
    assert any((N + N % 2) // 2 % 16 and not N % 2 for _, _, N in cases)
    gen = torch.Generator().manual_seed(0)
    for M, K, N in smoke.INT4_EDGES:
        x, wq, s = smoke.matmul_case(K, N, M, torch.float32, gen, "cpu", 4)
        y = i4.int4_matmul(x, wq, s)
        assert y.shape == (M, N + N % 2) and bool(torch.isfinite(y).all())


def test_int8_mm_cases_reach_each_path(smoke):
    """K17's smoke cases take every path of the kernels: one and two
    8-row tiles of the decode kernel, split and unsplit K, the tile
    kernel either side of a 128-row tile, K not a multiple of a 16-row
    step, rows that are not 16-byte aligned (an odd width among them),
    one scale and one per column; the plain version takes them all on the
    CPU."""
    from whisper_apr_tpu_torch.ops import int8_matmul as i8
    cases = smoke.INT8_MM_EDGES
    rows = {M for M, _, _ in cases}
    assert {1, 8} <= rows and {9, 15, 16} <= rows and {17, 32} <= rows
    assert {33, 127, 129} <= rows
    decode = [i8.int8_plan(M, K, N) for M, K, N in cases
              if M <= i8.DECODE_ROWS]
    assert {p.n_split > 1 for p in decode} == {True, False}
    assert any(K % i8.STEP for _, K, _ in cases)
    assert any(N % 16 and N % 2 for _, _, N in cases)
    assert any(N % 16 and not N % 2 for _, _, N in cases)
    gen = torch.Generator().manual_seed(0)
    for i, (M, K, N) in enumerate(cases[:8]):
        x, wq, s = smoke.matmul_case(K, N, M, torch.float32, gen, "cpu", 8,
                                     i % 3 != 0)
        y = i8.int8_matmul(x, wq, s)
        assert y.shape == (M, N) and bool(torch.isfinite(y).all())


def test_k8_edges_reach_each_path(smoke):
    """K8's smoke cases take one to four 8-row tiles of the decode kernel
    and two launches (rows past 32), split and unsplit K, a part strip;
    every width a multiple of 32 (K8's contract)."""
    from whisper_apr_tpu_torch.ops import int8_matmul as i8
    tiles = {-(-min(M, 32) // 8) for M, _, _ in smoke.K8_EDGES}
    assert tiles == {1, 2, 3, 4}
    assert any(M > 32 for M, _, _ in smoke.K8_EDGES)
    assert all(N % 32 == 0 for _, _, N in smoke.K8_EDGES)
    assert any(N % i8.STRIP for _, _, N in smoke.K8_EDGES)
    plans = {i8.int8_plan(min(M, 32), K, N).n_split > 1
             for M, K, N in smoke.K8_EDGES}
    assert plans == {True, False}


def test_q4k_edges_reach_each_path(smoke):
    """K10's smoke cases take one to four 8-row tiles and two launches
    (rows past 32), split and unsplit K, splits of an odd group count
    (the last split shorter), part strips and the four scan shapes at
    whisper-base and large-v3; every width a multiple of 32 (its
    contract), every plan within its shared memory."""
    from whisper_apr_tpu_torch.ops import q4k
    tiles = {-(-min(M, 32) // 8) for M in smoke.Q4K_ROWS}
    assert tiles == {1, 2, 3, 4} and max(smoke.Q4K_ROWS) > 32
    assert all(K % 32 == 0 and N % 32 == 0 for K, N in smoke.Q4K_EDGES)
    assert any(N % q4k.STRIP for _, N in smoke.Q4K_EDGES)
    for D in (512, 1280):
        for K, N in ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D)):
            assert (K, N) in smoke.Q4K_EDGES
    plans = [q4k.kq_plan(K, N) for K, N in smoke.Q4K_EDGES]
    assert {p.n_split > 1 for p in plans} == {True, False}
    assert any(K % p.split_rows for (K, _), p in zip(smoke.Q4K_EDGES, plans))
    assert all(q4k.kq_smem(min(M, 32), p) <= 227 * 1024
               for p in plans for M in smoke.Q4K_ROWS)


@pytest.mark.parametrize("fmt", ["q5k", "q6k"])
def test_kq_edges_reach_each_path(smoke, fmt):
    """K11's smoke cases (``check_kq_edges``) take the four scan shapes
    at whisper-base and large-v3, 1, 3 and 9 groups of the format's size
    (Q6_K: 16) against part strips, split and unsplit K, splits of an odd
    group count, every width a multiple of 32, every plan within its
    shared memory at each of ``Q4K_ROWS``."""
    from whisper_apr_tpu_torch.ops import q4k
    sub = 16 if fmt == "q6k" else 32
    edges = smoke.kq_edges(fmt)
    for D in (512, 1280):
        for K, N in ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D)):
            assert (K, N) in edges
    assert {K // sub for K, N in edges if K < 512} == {1, 3, 9}
    assert all(K % sub == 0 and N % 32 == 0 for K, N in edges)
    assert any(N % q4k.STRIP for _, N in edges)
    plans = [q4k.kq_plan(K, N, sub) for K, N in edges]
    assert {p.n_split > 1 for p in plans} == {True, False}
    assert any(K % p.split_rows for (K, _), p in zip(edges, plans))
    assert all(q4k.kq_smem(min(M, 32), p) <= 227 * 1024
               for p in plans for M in smoke.Q4K_ROWS)


def test_mixed_edge_cases_cover_each_path(smoke):
    """P2's kernel's smoke cases run on the CPU (plain versions) to the
    kernel's output shapes, and their plans take both tiles, K staged
    whole and through the ring at each tile, K not a multiple of 16, rows
    not 16-byte aligned, and every operand form P2, P3 (b) and (i) give
    the kernel: int8 . bf16, a transposed bf16 A with an int8 B, an f32 A
    cast in the kernel, a batch."""
    import torch
    cases = smoke.mixed_edge_cases("cpu")
    for case, plan in cases:
        got, ref = case.kernel(), case.plain()
        assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    shapes = smoke.MIXED_EDGES
    assert (256, 256, 256) not in shapes      # the probe's own case
    assert any(K % 16 for _, K, _ in shapes)
    assert any(N % 8 for _, _, N in shapes)
    plans = [(plan, case.inputs[1].shape[-2]) for case, plan in cases]
    for tile in (32, 64):
        ks = {p.k_chunk >= K for p, K in plans if p.tile == tile}
        assert ks == {True, False}, tile
    forms = {(c.inputs[0].dtype, c.inputs[1].dtype, "dotT" in c.name)
             for c, _ in cases}
    assert {(torch.int8, torch.bfloat16, False),
            (torch.bfloat16, torch.int8, True),
            (torch.float32, torch.int8, False)} <= forms
    assert any(c.inputs[0].dim() == 3 for c, _ in cases)


def test_k8_scan_bounds(smoke):
    """K8 at the scan step's projections: the int8 weights (3 D^2 and
    D^2 bytes), the per-column f32 scales and bf16 x in and out over the
    memory rate, bytes-bound at 8 rows."""
    for D in (384, 1280):
        q, by = smoke.bound("qmatvec_stacked_qkv", D, 8)
        d, by2 = smoke.bound("qmatvec_stacked_dd", D, 8)
        assert by == by2 == "bytes"
        want_q = (3 * D * D + 4 * 3 * D + 2 * 8 * D * 2 + 2 * 8 * D * 2)
        want_d = (D * D + 4 * D + 2 * 8 * D * 2)
        assert abs(q - 1e3 * want_q / smoke.HBM_BPS) < 1e-9
        assert abs(d - 1e3 * want_d / smoke.HBM_BPS) < 1e-9


def test_int8_edge_cases_reach_each_path(smoke):
    """P1's smoke-only cases take K staged whole and through the ring,
    rows of A and of B that are not 16-byte aligned and output rows that
    are not; the plain version runs them all here, exact against an int64
    product."""
    from whisper_apr_tpu_torch.ops import probe_mma as pm
    cases = smoke.int8_edge_cases("cpu")
    shapes = smoke.INT8_EDGES
    assert [k_chunk for _, k_chunk in cases] \
        == [pm.int8_plan(K) for _, K, _ in shapes]
    assert any(K > pm.I8_PANEL_K for _, K, _ in shapes)
    assert any(K % 16 for _, K, _ in shapes)
    assert any(N % 16 for _, _, N in shapes)
    assert any(N % 4 for _, _, N in shapes)
    assert (256, 256, 256) not in shapes      # the probe's own case
    for case, _ in cases:
        a, b = case.inputs
        got = case.kernel()
        assert case.exact and got.dtype == torch.int32
        assert torch.equal(got.long(), a.long() @ b.long())


def test_cross_edges_cover_the_split(smoke):
    """K2's smoke checks take no valid row, one row, both sides of a
    64-row group and the last rows of 1500 frames, over every cache dtype
    the kernel takes, in 1536 padded rows: at the tiny and large-v3
    widths some lengths leave all blocks but the first empty and others
    end inside a block's rows."""
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    assert {0, 1, 63, 64, 65, 1499, 1500} <= set(smoke.CROSS_EDGES)
    assert {name for name, *_ in smoke.CROSS_CACHES} == {"int8", "bf16",
                                                         "f32", "fp8"}
    for H in (6, 20):
        for e in smoke.CROSS_EDGES:
            plan = db.cross_plan(H, 64 * H, e or 1536, 1)
            assert plan.rows * plan.cluster >= (e or 1536)
        rows = db.cross_plan(H, 64 * H, 1500, 1).rows
        assert any(0 < e < rows for e in smoke.CROSS_EDGES)
        assert any(e > rows and e % rows for e in smoke.CROSS_EDGES)


def test_self_edges_cover_the_split(smoke):
    """K1's smoke checks take no history, one row, both sides of one and
    two rows a block at the tiny (16 blocks a head) and large-v3 (8)
    clusters, both sides of 128 and the last row of a 448-token window;
    one chunk a block holds every block's rows."""
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    edges = set(smoke.SELF_EDGES)
    assert {0, 1, 127, 128, 129, 447} <= edges
    for H in (6, 20):
        C = db.cross_plan(H, 64 * H, 1, 2).cluster
        assert {C - 1, C, C + 1, 2 * C - 1, 2 * C, 2 * C + 1} <= edges
        for pos in edges:
            plan = db.cross_plan(H, 64 * H, pos, 2)
            assert plan.cluster == C and plan.chunk >= plan.rows


def _k1_case(smoke, D=128, H=2, L=2, pos=5, seed=3):
    """K1's plain version on the CPU over int8 rows: (call, x, blk)."""
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    gen = torch.Generator().manual_seed(seed)
    blk = smoke.make_blk(D, L, gen, "cpu")
    kq, ks, vq, vs = smoke.make_cache("int8", L, 64, D, gen, "cpu",
                                      torch.float32)
    x = torch.randn((1, D), generator=gen)
    return (lambda: db.self_block_plain(x, blk, kq, ks, vq, vs, pos, 1, H),
            x, blk)


def test_quantized_rows_records_and_sets_the_rows(smoke):
    """``quantized_rows`` records the f32 k and v K1's plain version
    rounds, and with given rows makes it attend to them at its own
    scales: its own rows give its own output bit for bit, a row one step
    off another output; the quantizer is restored after."""
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    call, _, _ = _k1_case(smoke)
    quantize_row = db.quantize_row
    with smoke.quantized_rows(db) as pre:
        ref = call()
    assert len(pre) == 2 and pre[0].dtype == torch.float32
    assert torch.equal(quantize_row(pre[0])[0], ref[1])
    assert torch.equal(quantize_row(pre[1])[0], ref[3])
    with smoke.quantized_rows(db, (ref[1], ref[3])):
        same = call()
    assert all(torch.equal(a, b) for a, b in zip(same, ref))
    v_row = ref[3].clone()
    v_row[0, 7] += 1 if v_row[0, 7] < 127 else -1
    with smoke.quantized_rows(db, (ref[1], v_row)):
        off = call()
    assert torch.equal(off[3], v_row) and torch.equal(off[4], ref[4])
    assert not torch.equal(off[0], ref[0])
    assert db.quantize_row is quantize_row


def _k_rows(smoke):
    """K1's plain k row at D = 128: (pre, exact k, steps, int8 row)."""
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    call, x, blk = _k1_case(smoke)
    with smoke.quantized_rows(db) as pre:
        ref = call()
    exact = smoke.exact_qkv(db, x, blk, 1)[:, 128:256]
    q = pre[0] / (pre[0].abs().amax(-1, keepdim=True) / 127)
    return pre[0], exact, q, ref[1]


def test_rounding_ties_takes_a_tie_only(smoke):
    """A step off where the value before rounding sits on a half step is
    a tie; a step off elsewhere is not, and stays the plain's."""
    pre, exact, q, row = _k_rows(smoke)
    half = (q.abs() - q.abs().floor() - 0.5).abs()
    far = int(half.argmax())                   # farthest from a half step
    j = int((half + (torch.arange(128) == far)).argmin())
    # move element j onto its half step: what either order may round away
    step = pre.abs().amax() / 127
    pre = pre.clone()
    pre[0, j] = (q[0, j].floor() + 0.5) * step
    exact = exact.clone()
    exact[0, j] = pre[0, j].double()
    got = row.clone()
    for i in (j, far):
        got[0, i] += 1 if got[0, i] < 127 else -1
    tie = smoke.rounding_ties(got, row, pre, exact, "k")
    assert tie[0, j] and not tie[0, far] and int(tie.sum()) == 1


def test_rounding_ties_refuses_a_truncated_row(smoke):
    """A row truncated where it should round (half its elements a step
    off) has no element at a tie: the output stays held to the plain
    version's own rows."""
    pre, exact, q, row = _k_rows(smoke)
    got = torch.trunc(q).clamp(-127, 127).to(torch.int8)
    assert int((got != row).sum()) > 20
    assert not smoke.rounding_ties(got, row, pre, exact, "k").any()


def test_rounding_ties_at_most_tie_max(smoke):
    """More than TIE_MAX elements a step off at ties is refused."""
    pre, exact, q, row = _k_rows(smoke)
    step = pre.abs().amax() / 127
    pre, got = pre.clone(), row.clone()
    idx = (q.abs()[0] < 100).nonzero()[:smoke.TIE_MAX + 1, 0]
    for j in idx.tolist():
        pre[0, j] = (q[0, j].floor() + 0.5) * step
        got[0, j] += 1
    with pytest.raises(AssertionError, match="rounding ties"):
        smoke.rounding_ties(got, row, pre, pre.double(), "k")


def test_batch_edges_reach_each_plan_path(smoke):
    """K5's and K6's smoke checks take a pair of slots, an odd count, the
    serving tick's 8, a full 32-slot launch and two launches (40), K5 at
    positions from SLOT_POS mixed within the batch: over the tiny and
    large-v3 widths the plans there put the slots in one tile and in
    several, with slots holding no history row beside full ones."""
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    from whisper_apr_tpu_torch.ops._build import MAX_ROWS
    assert {2, 8, MAX_ROWS} <= set(smoke.BATCH_EDGES)
    assert any(b % 2 for b in smoke.BATCH_EDGES)
    assert any(b > MAX_ROWS for b in smoke.BATCH_EDGES)
    assert 0 in smoke.SLOT_POS and max(smoke.SLOT_POS) >= 447
    tiles = set()
    for H in (6, 20):
        for width, n_loop in ((64, 1500), (192, 512)):
            for b in smoke.BATCH_EDGES:
                m = min(b, MAX_ROWS)
                plan = db.batched_plan(H, 64 * H, m, n_loop, 1, width)
                tiles.add(math.ceil(m / plan.slots))
    assert 1 in tiles and max(tiles) > 2
    for b in smoke.BATCH_EDGES:
        pos = [smoke.SLOT_POS[(3 * i + b) % len(smoke.SLOT_POS)]
               for i in range(b)]
        assert len(set(pos)) > 1


def _k5_bf16_case(smoke, D=128, H=2, L=2, seed=4):
    """K5's plain version on the CPU over bf16 rows at f32 activations:
    (call, x, blk), three slots at positions 0, 5 and 40."""
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    gen = torch.Generator().manual_seed(seed)
    blk = smoke.make_blk(D, L, gen, "cpu")
    kq, ks, vq, vs = smoke.make_cache("rows", L, 64, D, gen, "cpu",
                                      torch.bfloat16, 3)
    x = torch.randn((3, D), generator=gen)
    pos = torch.tensor([0, 5, 40], dtype=torch.int32)
    return (lambda: db.self_block_plain(x, blk, kq, ks, vq, vs, pos, 1, H),
            x, blk)


def test_quantized_rows_sets_float_rows(smoke):
    """For a float cache ``quantized_rows`` records the f32 k and v K5's
    plain version casts and, with given rows, makes it attend to them:
    its own rows give its own output bit for bit, an element one bf16
    step off another output; the cast is restored after."""
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    call, _, _ = _k5_bf16_case(smoke)
    cast_row = db.cast_row
    with smoke.quantized_rows(db) as pre:
        ref = call()
    assert len(pre) == 2 and pre[0].dtype == torch.float32
    assert torch.equal(pre[0].to(torch.bfloat16), ref[1])
    with smoke.quantized_rows(db, (ref[1], ref[3])):
        same = call()
    assert all(torch.equal(a, b) for a, b in zip(same, ref))
    k_row = ref[1].clone()
    k_row[2, 7] = torch.nextafter(k_row[2, 7].float(),
                                  torch.tensor(1e9)).to(torch.bfloat16)
    if torch.equal(k_row, ref[1]):              # rounded back: step in bf16
        k_row[2, 7] = (k_row[2, 7].float() * (1 + 2 ** -7)).to(
            torch.bfloat16)
    with smoke.quantized_rows(db, (k_row, ref[3])):
        off = call()
    assert torch.equal(off[1], k_row) and not torch.equal(off[0], ref[0])
    assert db.cast_row is cast_row


def test_float_ties_take_a_tie_only(smoke):
    """A bf16 element a step off where the f32 value before the cast sits
    on the boundary between the two neighbours is a tie; one a step off
    elsewhere is not; more than TIE_MAX ties in a row are refused."""
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    call, x, blk = _k5_bf16_case(smoke)
    with smoke.quantized_rows(db) as pre:
        ref = call()
    k, row = pre[0].clone(), ref[1]
    exact = smoke.exact_qkv(db, x, blk, 1)[:, 128:256].clone()
    up = (row.float() * (1 + 2 ** -7)).to(torch.bfloat16)   # next bf16 up
    got = row.clone()
    # element 3 of slot 1 on the boundary between row and up; element 9
    # one step up though its f32 value sits on the row's own value
    k[1, 3] = (row[1, 3].double() + up[1, 3].double()).float() / 2
    exact[1, 3] = k[1, 3].double()
    got[1, 3], got[1, 9] = up[1, 3], up[1, 9]
    tie = smoke.float_ties(got, row, k, exact, "k")
    assert tie[1, 3] and not tie[1, 9] and int(tie.sum()) == 1
    idx = range(10, 11 + smoke.TIE_MAX)
    for j in idx:
        k[0, j] = (row[0, j].double() + up[0, j].double()).float() / 2
        got[0, j] = up[0, j]
    with pytest.raises(AssertionError, match="rounding ties"):
        smoke.float_ties(got, row, k, k.double(), "k")


def test_head_edges_cover_the_strips(smoke):
    """K4's smoke checks take ties within one 128-column strip of the
    kernel and across the boundary of two, one row, both sides of an
    8-row tile and of a launch's 32 rows; the planted tie of each pair
    resolves to its first column in the plain version, at every row."""
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    strips = {tuple(c // 128 for c in tie) for tie in smoke.HEAD_TIES}
    assert any(a == b for a, b in strips)
    assert any(b == a + 1 for a, b in strips)
    assert {1, 8, 9, 32, 33} <= set(smoke.HEAD_ROWS)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((3, 64), generator=gen)
    for tie in smoke.HEAD_TIES:
        wq, bias, (first, second) = smoke.head_case(700, x, gen, tie)
        assert (first, second) == tie
        tok = qm.qmatvec_greedy_head_plain(x, wq, bias, 700)[0]
        assert tok.tolist() == [first] * 3


@pytest.mark.parametrize("fmt", ["q4k", "q5k", "q6k"])
def test_exact_qkv_kq_is_the_plain_projection(smoke, fmt):
    """K12's f64 projection over the dequantized planes is the plain
    version's ``kq_mv`` of the LayerNorm output (plus the bias) within
    f32 summation error, in bf16 and f32."""
    from whisper_apr_tpu_torch.ops import decode_blocks_kq as dbk
    from whisper_apr_tpu_torch.ops.basic import layer_norm
    gen = torch.Generator().manual_seed(5)
    blk = smoke.make_kq_blk(fmt, 256, 2, gen, "cpu")
    for cdt in (torch.bfloat16, torch.float32):
        x = torch.randn((1, 256), generator=gen).to(cdt)
        exact = smoke.exact_qkv_kq(x, blk, 1, fmt)
        h = layer_norm(x.float(), blk["ln1_w"][1, 0], blk["ln1_b"][1, 0])
        got = dbk.kq_mv(h, blk["qkv"], 1, cdt) + blk["bqkv"][1]
        assert exact.shape == (1, 768) and exact.dtype == torch.float64
        err = float((got.double() - exact).abs().max())
        assert err <= 1e-5 * float(exact.abs().max())


def test_kq_self_edges_cover_the_split(smoke):
    """K12's smoke checks take no history, one row, both sides of a
    64-row group, a row past the cluster's first cut and the last row of
    a 448-token window, all inside the checks' 512-row self cache."""
    from whisper_apr_tpu_torch.ops import decode_blocks_kq as dbk
    edges = set(smoke.KQ_SELF_EDGES)
    assert {0, 1, 63, 64, 65, 447} <= edges and max(edges) < 512
    for H, D in ((8, 512), (20, 1280)):
        plan = dbk.cross_kq_plan(H, D, 447, 2, "q4k")
        assert any(plan.rows < e < 447 for e in edges)
