#!/usr/bin/env python3
"""Decode-kernel times of several checkouts, in turn, on one GPU.

    python3 chip_ab.py [--optin | --split | --int8 | --batched | --bits |
                        --f32] DIR [DIR ...]

Each DIR is the root of a checkout of this repository, for example the
parent commit unpacked with ``git archive`` into a gitignored directory.
The checkouts run in the order given, one process each, so that a
sequence such as ``parent change change parent`` compares two versions
on the same card. Each process imports that checkout's ``chip_smoke.py``,
builds its kernels, and times them with ``chip_smoke.time_kernels`` (B=1,
pos 128) and, where the checkout has it, ``chip_smoke.time_batched`` (B=8,
pos 128), at the whisper-tiny and large-v3 decoder shapes; then the host
clock of the whisper-tiny end-to-end path: bench.py's protocol through
``chip_smoke.bench_rtf`` (30 s of noise, 224 forced tokens, B=1; best of
5) and a ``BatchScheduler`` of 8 slots draining 8 clips (ms per tick).
It prints the card's line and one line per run, ``AB <dir> <json>``,
with the device
microseconds of each kernel and stack and the host milliseconds of the
end-to-end runs, and a table of them all at the end. With ``--optin``
each process times the opt-in kernels and the probes instead:
``chip_smoke.time_optin`` (K15-K18 and their library yardsticks at the
whisper-tiny and large-v3 shapes, bf16), K18 at one decode row
(``time_int4_m1``, timed alike in every checkout), the whisper-tiny int4
engine's host ms per decode step (``time_int4_engine``),
``chip_smoke.phase_probes`` (P1-P3 per case, device microseconds) and
the whisper-tiny paged serving tick's device ms (``paged_tick_device_ms``:
8 slots, ``chip_smoke.paged_device_ms``; plain, then with
use_flash_attention and the int8 switch on, as ``--int8`` times the dense
tick). With
``--split`` each process splits the device time of each B=1 decode block
(K1 ``self_block``, K2 ``cross_block``, K3 ``ffn_block``, at
``time_kernels``' operands and both shapes) by kernel instead
(``kernel_split``), and times each over all the layers in turn in one
graph (``<block>_cold``: at large-v3 the weights then come from device
memory, not the L2 cache). With ``--int8`` each process times the int8
weight products instead (``time_int8_tree``): K8 over the vocab and at
the scan step's projection shapes, K17 at ``MATMUL_SHAPES`` x
``MATMUL_ROWS`` and more decode rows, the large-v3 B=8 scan tick, the
whisper-tiny dense serving tick's device time and the large-v3 bf16
encoder with the int8 switch on. With ``--batched`` each process times
the B > 1 decode path instead (``time_batched_tree``): K5 and K6 split by
kernel, K4, K7 and K9 at one row, K4-K9 at B = 8 and 32, K10-K14 at B =
1 (K12 and K14 in q4k, q5k and q6k, K12 over compute-dtype and int8 self
rows; K10 and K11, in q5k and q6k, at the scan step's four shapes, M = 1
and 8), the large-v3 scan and fused steps at B = 8 and 32, the
whisper-tiny dense serving tick and the large-v3 q4k, q5k and q6k B = 1
fused and scan decode steps (``kq_steps_ms``: K12-K14, or K10 / K11, in
every layer, device ms). With ``--bits`` each process prints, instead of
times, a SHA-256 digest of K1's, K2's, K3's, K13's and K10's outputs over
fixed inputs (``bits_tree``): equal digests in two checkouts mean
bit-identical kernels. With ``--f32`` each process times the f32 paths of
K16-K18 instead (``time_f32_tree``), through the ``time_optin_f32`` of
the chip_smoke beside this script, so every checkout is timed alike,
and the f32 large-v3 encoder with and without K16 and K17 (host and
CUDA-event ms), the f32 paths' relative error against f64
(``f32_errors``), and K16-K18 in bf16 at B = 1 / M = 1500 with a digest
of each output (``bf16_optin``). Needs one CUDA GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SHAPES = {
    "tiny": dict(D=384, H=6, L=4, n_vocab=51865, T_self=512, T_cross=1536,
                 enc_len=1500),
    "large": dict(D=1280, H=20, L=32, n_vocab=51866, T_self=512,
                  T_cross=1536, enc_len=1500),
}


def time_tree(root: Path, mode: str = "") -> dict:
    """Times of one checkout, in this process (run from its root)."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as c
    c.phase_device()
    c.phase_build()
    if mode == "--optin":
        return time_optin_tree(c, root)
    if mode == "--f32":
        return time_f32_tree(root)
    if mode == "--split":
        return time_split_tree(c)
    if mode == "--int8":
        return time_int8_tree(c, root)
    if mode == "--batched":
        return time_batched_tree(c, root)
    if mode == "--bits":
        return bits_tree(c)
    dev = torch.device("cuda")
    out = {}
    for i, (name, shape) in enumerate(SHAPES.items()):
        gen = torch.Generator(device=dev).manual_seed(104 + i)
        blk = c.make_blk(shape["D"], shape["L"], gen, dev)
        t = c.time_kernels(blk, **shape, pos=128, label=name, seed=4 + i)
        out[name] = {k: round(v["ms"] * 1e3, 2) for k, v in t.items()}
        if hasattr(c, "time_batched"):
            t = c.time_batched(blk, **shape, B=8, pos=128, label=name,
                               seed=4 + i)
            out[name + "_b8"] = {k: round(v["ms"] * 1e3, 2)
                                 for k, v in t.items()}
        del blk
        torch.cuda.empty_cache()
    out["e2e_tiny"] = time_e2e(c, root)
    return out


def bits_tree(c) -> dict:
    """SHA-256 digests (first 16 hex digits) of K1's, K2's, K3's, K13's
    and K10's outputs, at the whisper-tiny and large-v3 shapes in bf16 and
    f32: K1 over bf16 / f32, int8 and fp8 self rows at
    ``chip_smoke.SELF_EDGES`` positions (its new rows and scales too), K2
    over ``chip_smoke.CROSS_CACHES`` at ``CROSS_EDGES`` lengths, K3 over
    16 inputs at both layers, K13 in q4k, q5k and q6k (whisper-base's
    width in the whisper-tiny run) over the same caches at
    ``KQ_CROSS_EDGES`` lengths, K10 at the scan step's four shapes of that
    width and two odd group counts over ``Q4K_ROWS`` rows, inputs from
    fixed seeds."""
    import hashlib
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    from whisper_apr_tpu_torch.ops import decode_blocks_kq as dbk
    from whisper_apr_tpu_torch.ops import q4k
    dev = torch.device("cuda")
    out = {}
    for i, (name, shape) in enumerate(SHAPES.items()):
        D, H = shape["D"], shape["H"]
        for cdt in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(90 + i)
            blk = c.make_blk(D, 2, gen, dev)
            digest = {k: hashlib.sha256()
                      for k in ("K1", "K2", "K3", "K13", "K10")}

            def feed(k, *ts):
                for t in ts:
                    digest[k].update(t.contiguous().view(torch.uint8)
                                     .cpu().numpy().tobytes())
            for mode in ("rows", "int8", "fp8"):
                kq, ks, vq, vs = c.make_cache(mode, 2, 512, D, gen, dev, cdt)
                for pos in c.SELF_EDGES:
                    x = torch.randn((1, D), generator=gen, device=dev).to(cdt)
                    feed("K1", *(t for t in db.self_block(
                        x, blk, kq, ks, vq, vs, pos, pos % 2, H)))
            for _, mode, rows_dt in c.CROSS_CACHES:
                dt = cdt if rows_dt is None else getattr(torch, rows_dt)
                kq, ks, vq, vs = c.make_cache(mode, 2, 1536, D, gen, dev, dt)
                for enc_len in c.CROSS_EDGES:
                    x = torch.randn((1, D), generator=gen, device=dev).to(cdt)
                    feed("K2", db.cross_block(x, blk, kq, ks, vq, vs,
                                              enc_len, enc_len % 2, H))
            for j in range(16):
                x = (4.0 * torch.randn((1, D), generator=gen,
                                       device=dev)).to(cdt)
                feed("K3", db.ffn_block(x, blk, j % 2))
            del blk
            Dk, Hk = (512, 8) if name == "tiny" else (D, H)
            for fmt in c.KQ_MODES:
                kblk = c.make_kq_blk(fmt, Dk, 2, gen, dev)
                for _, mode, rows_dt in c.CROSS_CACHES:
                    dt = cdt if rows_dt is None else getattr(torch, rows_dt)
                    kq, ks, vq, vs = c.make_cache(mode, 2, 1536, Dk, gen,
                                                  dev, dt)
                    for enc_len in c.KQ_CROSS_EDGES:
                        x = torch.randn((1, Dk), generator=gen,
                                        device=dev).to(cdt)
                        feed("K13", dbk.cross_block_kq(
                            x, kblk, kq, ks, vq, vs, enc_len, enc_len % 2,
                            Hk))
                del kblk
            # K10 at the scan step's four shapes of the run's width
            # (whisper-base's in the whisper-tiny run) and odd group
            # counts, every row count of chip_smoke.Q4K_ROWS
            for K, N in ((Dk, 3 * Dk), (Dk, Dk), (Dk, 4 * Dk), (4 * Dk, Dk),
                         (96, 160), (288, 32)):
                wq = torch.randint(-128, 128, (2, K // 2, N), generator=gen,
                                   device=dev, dtype=torch.int8)
                s = (0.5 + torch.rand((2, K // 32, N), generator=gen,
                                      device=dev)) / (7.5 * K ** 0.5)
                z = 7.5 * s * (0.9 + 0.2 * torch.rand(
                    s.shape, generator=gen, device=dev))
                for M in c.Q4K_ROWS:
                    x = torch.randn((M, K), generator=gen, device=dev).to(
                        cdt)
                    feed("K10", q4k.q4k_matvec_stacked(x, wq, s, z, 1))
            out[f"{name}_{str(cdt)[6:]}"] = {
                k: v.hexdigest()[:16] for k, v in digest.items()}
            torch.cuda.empty_cache()
    return out


def time_split_tree(c) -> dict:
    """Device microseconds per call of each B=1 decode block, split by
    kernel (``kernel_split``), at ``time_kernels``' operands: bf16 x,
    compute-dtype self rows at pos 128, int8 cross rows, the last
    layer. ``<block>_cold`` is the same call over every layer in turn,
    in one graph, per call: at large-v3 its weights (and cache rows) come
    from device memory, as in the decode step, where the one-layer split
    reads them from the L2 cache."""
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    dev = torch.device("cuda")
    out = {}
    for i, (name, shape) in enumerate(SHAPES.items()):
        gen = torch.Generator(device=dev).manual_seed(104 + i)
        D, H, L = shape["D"], shape["H"], shape["L"]
        blk = c.make_blk(D, L, gen, dev)
        gen = torch.Generator(device=dev).manual_seed(4 + i)
        cdt = torch.bfloat16
        sk, _, sv, _ = c.make_cache("rows", L, shape["T_self"], D, gen, dev,
                                    cdt)
        ck, cks, cv, cvs = c.make_cache("int8", L, shape["T_cross"], D, gen,
                                        dev, cdt)
        x = torch.randn((1, D), generator=gen, device=dev).to(cdt)
        calls = {
            "self_block": lambda l: db.self_block(x, blk, sk, None, sv, None,
                                                  128, l, H),
            "cross_block": lambda l: db.cross_block(
                x, blk, ck, cks, cv, cvs, shape["enc_len"], l, H),
            "ffn_block": lambda l: db.ffn_block(x, blk, l)}
        for k, call in calls.items():
            out[f"{name}_{k}"] = kernel_split(c, lambda: call(L - 1))
            out[f"{name}_{k}_cold"] = {"per_call": round(c.graph_ms(
                lambda: [call(l) for l in range(L)], reps=2) * 1e3 / L, 2)}
        del blk
        torch.cuda.empty_cache()
    return out


def kernel_split(c, call) -> dict:
    """``call``'s device microseconds per call, split by kernel:
    ``torch.profiler`` over CUDA-graph replays. Keys are the kernels'
    names with their template arguments, ``kernels`` their sum, ``total``
    ``graph_ms`` of the call and ``gaps`` the difference: the launch gaps
    between the call's kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    reps, replays = 20, 10
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            call()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us or "Memcpy" in ev.key or "Memset" in ev.key:
            continue
        name = ev.key.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").replace("wa::", "").split("(")[0]
        out[name.strip()] = round(us / (reps * replays), 2)
    out["kernels"] = round(sum(out.values()), 2)
    out["total"] = round(c.graph_ms(call) * 1e3, 2)
    out["gaps"] = round(out["total"] - out["kernels"], 2)
    return out


BATCHES = (8, 32)      # slots of the --batched mode's kernels and ticks


def time_batched_tree(c, root: Path) -> dict:
    """Device microseconds (CUDA-graph replay, bf16 x) of one checkout's
    B > 1 decode kernels, timed here alike for every checkout, at the
    whisper-tiny and large-v3 shapes: K4, K7 and K9 at one row (K9's B=1
    scan step); then at B in ``BATCHES``, pos 128 for every slot, int8
    self and cross rows (the serving cache), the last layer: K5 and K6
    split by kernel (``kernel_split``), then K4 (the greedy head at M =
    B), K5-K7, K8 (the vocab logits, f32 out) and K9 at M = B; at B = 1
    and whisper-base and large-v3, K12 in q4k, q5k and q6k over
    compute-dtype self rows and (``K12_int8``) int8 rows, K14 in each
    format, K13 in q4k, K10 in q4k and K11 in q5k (the control) at the
    scan step's four shapes (fc1, qkv, self_o, fc2) and M = 1 and 8 (fc1
    at M = 1 under the bare name). Then the large-v3 scan and fused decode
    steps at B slots (device ms), the whisper-tiny dense serving tick's
    device time and the large-v3 q4k B = 1 fused and scan steps
    (``kq_steps_ms``)."""
    import torch
    from whisper_apr_tpu_torch.ops import decode_blocks as db
    from whisper_apr_tpu_torch.ops import decode_blocks_kq as dbk
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    dev = torch.device("cuda")
    bf = torch.bfloat16
    out = {}

    def us(fn):
        return round(c.graph_ms(fn) * 1e3, 2)

    for i, (name, shape) in enumerate(SHAPES.items()):
        D, H, L, n_vocab = shape["D"], shape["H"], shape["L"], \
            shape["n_vocab"]
        gen = torch.Generator(device=dev).manual_seed(60 + i)
        blk = c.make_blk(D, L, gen, dev)
        v_pad = n_vocab + (-n_vocab) % 128
        wq = torch.randint(-127, 128, (1, D, v_pad), generator=gen,
                           device=dev, dtype=torch.int8)
        ones = torch.ones((1, 1, v_pad), device=dev)
        bias = torch.zeros((1, v_pad), device=dev)
        layer = L - 1
        x = torch.randn((1, D), generator=gen, device=dev).to(bf)
        out[f"{name}_b1"] = {
            "K4": us(lambda: qm.qmatvec_greedy_head(x, wq, bias, n_vocab)),
            "K7": us(lambda: db.ffn_block_batched(x, blk, layer)),
            "K9": us(lambda: qm.ffn_fused(x, blk["w1"], blk["s1"], blk["b1"],
                                          blk["w2"], layer))}
        for B in BATCHES:
            sk, sks, sv, svs = c.make_cache("int8", L, shape["T_self"], D,
                                            gen, dev, bf, B)
            ck, cks, cv, cvs = c.make_cache("int8", L, shape["T_cross"], D,
                                            gen, dev, bf, B)
            x = torch.randn((B, D), generator=gen, device=dev).to(bf)
            pos = torch.full((B,), 128, dtype=torch.int32, device=dev)
            calls = {
                "K5": lambda: db.self_block_batched(
                    x, blk, sk, sks, sv, svs, pos, layer, H),
                "K6": lambda: db.cross_block_batched(
                    x, blk, ck, cks, cv, cvs, shape["enc_len"], layer, H),
                "K7": lambda: db.ffn_block_batched(x, blk, layer),
                "K4": lambda: qm.qmatvec_greedy_head(x, wq, bias, n_vocab),
                "K8": lambda: qm.qmatvec_stacked(x, wq, ones, 0,
                                                 out_dtype=torch.float32),
                "K9": lambda: qm.ffn_fused(x, blk["w1"], blk["s1"],
                                           blk["b1"], blk["w2"], layer)}
            for k in ("K5", "K6"):
                out[f"{name}_b{B}_{k}_split"] = kernel_split(c, calls[k])
            out[f"{name}_b{B}"] = {k: us(f) for k, f in calls.items()}
            del sk, sks, sv, svs, ck, cks, cv, cvs
            torch.cuda.empty_cache()
        del blk, wq
        label, Dk, Hk = (("base", 512, 8) if name == "tiny"
                         else ("large-v3", D, H))
        gen = torch.Generator(device=dev).manual_seed(70 + i)
        kblk = c.make_kq_blk("q4k", Dk, L, gen, dev)
        sk, _, sv, _ = c.make_cache("rows", L, shape["T_self"], Dk, gen, dev,
                                    bf)
        ck, cks, cv, cvs = c.make_cache("int8", L, shape["T_cross"], Dk, gen,
                                        dev, bf)
        x = torch.randn((1, Dk), generator=gen, device=dev).to(bf)
        for fmt in ("q4k", "q5k", "q6k"):
            if fmt != "q4k":
                kblk = c.make_kq_blk(fmt, Dk, L, gen, dev)
            t = out[f"{label}_{fmt}_b1"] = {
                "K12": us(lambda: dbk.self_block_kq(
                    x, kblk, sk, None, sv, None, 128, layer, Hk)),
                "K12_int8": us(lambda: dbk.self_block_kq(
                    x, kblk, ck, cks, cv, cvs, 128, layer, Hk))}
            if fmt == "q4k":
                t["K13"] = us(lambda: dbk.cross_block_kq(
                    x, kblk, ck, cks, cv, cvs, shape["enc_len"], layer, Hk))
            t["K14"] = us(lambda: dbk.ffn_block_kq(x, kblk, layer))
            k = "K10" if fmt == "q4k" else "K11"
            for w in ("fc1", "qkv", "self_o", "fc2"):
                K = Dk * (4 if w == "fc2" else 1)
                for M in (1, 8):
                    xm = torch.randn((M, K), generator=gen, device=dev).to(bf)
                    name = k if (w, M) == ("fc1", 1) else f"{k}_{w}_m{M}"
                    t[name] = us(lambda: c._kq_matvec(fmt)(
                        xm, *kblk[w], layer))
            del kblk
        del sk, sv, ck, cks, cv, cvs
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(105)
    shape = SHAPES["large"]
    blk = c.make_blk(shape["D"], shape["L"], gen, dev)
    out["large_v3_ticks_ms"] = batched_ticks(c, blk, **shape)
    del blk
    torch.cuda.empty_cache()
    out["tiny_serve"] = {"device_ms": round(serve_tick_device_ms(c, root),
                                            4)}
    out["large_v3_kq_step_ms"] = kq_steps_ms(c)
    return out


def kq_steps_ms(c, D: int = 1280, H: int = 20, L: int = 32,
                n_vocab: int = 51866, pos: int = 128) -> dict:
    """Device ms (CUDA-graph replay, best of two) of the large-v3 B=1
    decode steps over a random q4k, q5k and q6k qd, timed here alike for
    every checkout: the fused step ("<fmt>": K12-K14 a layer, the K8
    logits; cross8 cache) and the scan step ("<fmt>_scan": K10 or K11 six
    times a layer, torch attention over the dense cache, the K8 logits),
    bf16."""
    import torch
    from whisper_apr_tpu_torch.config import ModelConfig
    from whisper_apr_tpu_torch.model import qdecode
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(60)
    cfg = ModelConfig("timing", n_vocab, 1500, D, H, L, 448, D, H, L, 80)
    out = {}
    for fmt in ("q4k", "q5k", "q6k"):
        blk = c.make_kq_blk(fmt, D, L, gen, dev)
        params, qd, kv = c.scan_case(blk, D, L, n_vocab, 1, gen, dev,
                                     torch.bfloat16)
        qd["mode"] = fmt
        qkv = qdecode.quantize_cache(kv, "cross8")
        tok = torch.randint(0, n_vocab, (1,), generator=gen, device=dev,
                            dtype=torch.int32)
        steps = {
            fmt: lambda: qdecode.decode_step_qf(
                params, qd, tok, pos, qkv, cfg, compute_dtype=torch.bfloat16),
            f"{fmt}_scan": lambda: qdecode.decode_step_q(
                params, qd, tok, pos, kv, cfg, compute_dtype=torch.bfloat16)}
        out.update({k: round(min(c.graph_ms(f, reps=3, replays=5),
                                 c.graph_ms(f, reps=3, replays=5)), 4)
                    for k, f in steps.items()})
        del blk, params, qd, kv, qkv
        torch.cuda.empty_cache()
    return out


def batched_ticks(c, blk, D: int, H: int, L: int, n_vocab: int,
                  pos: int = 128, **_) -> dict:
    """Device ms of one decode step at B slots (``BATCHES``), pos for
    every slot, bf16: the scan step (``decode_step_q``: K8 and K9, torch
    attention over the dense cache) and the fused step
    (``decode_step_qf``: K5-K7 per layer and K8's logits over the int8
    cache), as ``chip_smoke.time_scan_steps`` times them."""
    import torch
    from whisper_apr_tpu_torch.config import ModelConfig
    from whisper_apr_tpu_torch.model import qdecode
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    cfg = ModelConfig("timing", n_vocab, 1500, D, H, L, 448, D, H, L, 80)
    out = {}
    for B in BATCHES:
        params, qd, kv = c.scan_case(blk, D, L, n_vocab, B, gen, dev,
                                     torch.bfloat16)
        qkv = qdecode.quantize_cache(kv, "int8")
        tok = torch.randint(0, n_vocab, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        p = torch.full((B,), pos, dtype=torch.int32, device=dev)
        steps = {
            "scan": lambda: qdecode.decode_step_q(
                params, qd, tok, p, kv, cfg, compute_dtype=torch.bfloat16),
            "fused": lambda: qdecode.decode_step_qf(
                params, qd, tok, p, qkv, cfg, compute_dtype=torch.bfloat16)}
        for k, fn in steps.items():
            out[f"{k}_b{B}"] = round(min(
                c.graph_ms(fn, reps=3, replays=5),
                c.graph_ms(fn, reps=3, replays=5)), 4)
        del params, qd, kv, qkv
        torch.cuda.empty_cache()
    return out


def time_int8_tree(c, root: Path) -> dict:
    """Device microseconds (CUDA-graph replay, bf16 x) of one checkout's
    int8 weight products, timed here alike for every checkout: K8 over
    the vocab (f32 logits, as the serving tick and the logits tail run
    it) at 1, 8, 16 and 32 rows; K8 at the scan step's projections
    (``qkv`` D x 3D and ``dd`` D x D, a layer > 0 of a stack of two, bf16
    out) at 1 and 8 rows; K17 at ``MATMUL_SHAPES`` x (``MATMUL_ROWS``, 16,
    32), per-column scale. Then the large-v3 B=8 scan tick and the
    whisper-tiny dense serving tick (device ms), and the large-v3 bf16
    encoder (host ms) with the int8 switch on."""
    import torch
    from whisper_apr_tpu_torch.ops import int8_matmul as i8
    from whisper_apr_tpu_torch.ops import qmatvec as qm
    dev = torch.device("cuda")
    bf = torch.bfloat16
    out = {}
    for i, (name, shape) in enumerate(SHAPES.items()):
        D, n_vocab = shape["D"], shape["n_vocab"]
        v_pad = n_vocab + (-n_vocab) % 128
        gen = torch.Generator(device=dev).manual_seed(48 + i)
        t = {}

        def us(fn):
            return round(c.graph_ms(fn) * 1e3, 2)

        def rows(M, K):
            return torch.randn((M, K), generator=gen, device=dev).to(bf)
        wq = torch.randint(-127, 128, (1, D, v_pad), generator=gen,
                           device=dev, dtype=torch.int8)
        ones = torch.ones((1, 1, v_pad), device=dev)
        for M in (1, 8, 16, 32):
            x = rows(M, D)
            t[f"k8_vocab_m{M}"] = us(lambda: qm.qmatvec_stacked(
                x, wq, ones, 0, out_dtype=torch.float32))
        del wq
        for proj, N in (("qkv", 3 * D), ("dd", D)):
            w = torch.randint(-127, 128, (2, D, N), generator=gen,
                              device=dev, dtype=torch.int8)
            s = 0.001 + 0.01 * torch.rand((2, 1, N), generator=gen,
                                          device=dev)
            for M in (1, 8):
                x = rows(M, D)
                t[f"k8_{proj}_m{M}"] = us(
                    lambda: qm.qmatvec_stacked(x, w, s, 1))
        label = "tiny" if name == "tiny" else "large-v3"
        for K, N in c.MATMUL_SHAPES[label]:
            for M in tuple(c.MATMUL_ROWS) + (16, 32):
                x, w, s = c.matmul_case(K, N, M, bf, gen, dev, 8)
                t[f"k17_{K}x{N}_m{M}"] = us(lambda: i8.int8_matmul(x, w, s))
        out[name] = t
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(105)
    blk = c.make_blk(1280, 32, gen, dev)
    steps = c.time_scan_steps(blk, 1280, 20, 32, 51866, label="large-v3",
                              seed=8)
    out["large_v3_steps_ms"] = {k: round(v["ms"], 4)
                                for k, v in steps.items()}
    del blk
    torch.cuda.empty_cache()
    out["tiny_serve"] = {"device_ms": round(serve_tick_device_ms(c, root),
                                            4)}
    out["large_v3_encoder_ms"] = encoder_int8_ms(c)
    return out


def serve_tick_device_ms(c, root: Path) -> float:
    """Device ms per pure decode tick of a whisper-tiny int8 bf16
    ``BatchScheduler`` of 8 slots (``chip_smoke.serve_device_ms``)."""
    import tempfile
    from whisper_apr_tpu_torch import ComputeConfig, ModelConfig, WhisperApr
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as work:
        apr = Path(work) / "tiny.apr"
        c.write_random_apr(apr, ModelConfig.tiny())
        eng = WhisperApr.load_from_apr(str(apr), ComputeConfig(
            quantization="int8", compute_dtype="bfloat16"))
    return c.serve_device_ms(eng, c.make_clips(c.SERVE_SECONDS[:8], seed=1),
                             8)


def encoder_int8_ms(c) -> dict:
    """Host ms of one bf16 encode of 30 s of noise (best of 3,
    ``chip_smoke.encoder_ms``) by the large-v3 encoder (large-v3-turbo's
    config: the same encoder, 4 decoder layers), int8 weights, with the
    int8 switch on (every linear through K17), attention plain and
    through K16, and with the switch off beside them."""
    import numpy as np
    from whisper_apr_tpu_torch import ComputeConfig, ModelConfig, WhisperApr
    from whisper_apr_tpu_torch.model.params import (init_params,
                                                    quantize_params,
                                                    to_device)
    cfg = ModelConfig.large_v3_turbo()
    params = to_device(quantize_params(init_params(cfg, seed=0), "int8"),
                       "cuda")
    audio = np.random.default_rng(7).normal(0, 0.1, 30 * 16_000).astype(
        np.float32)
    out = {}
    for flash in (False, True):
        eng = WhisperApr(cfg, params, compute=ComputeConfig(
            quantization="int8", compute_dtype="bfloat16",
            use_flash_attention=flash), device="cuda")
        mel = eng.compute_mel(audio)
        attn = "K16" if flash else "plain attention"
        out[f"bf16 {attn}"] = round(c.encoder_ms(eng, mel), 3)
        with c.optin_switches(int8=True):
            out[f"bf16 {attn} + K17"] = round(c.encoder_ms(eng, mel), 3)
    return out


def time_optin_tree(c, root: Path) -> dict:
    """Device microseconds of one checkout's K15-K18 (and their library
    yardsticks) at the whisper-tiny and large-v3 shapes, and of each
    probe case."""
    out = {}
    for label, D, H, seed in (("tiny", 384, 6, 45),
                              ("large-v3", 1280, 20, 46)):
        t = c.time_optin(label, D, H, seed)
        out[label] = {k: round(v["ms"] * 1e3, 2) for k, v in t.items()}
        out[label + "_library"] = {
            k: round(v["library_ms"] * 1e3, 2) for k, v in t.items()
            if v["library_ms"] is not None}
    out["int4_m1"] = time_int4_m1(c)
    out["int4_engine"] = time_int4_engine(c, root)
    _, pr = c.phase_probes()
    out["probes"] = {f"{r['probe']} {r['name']}": round(r["ms"] * 1e3, 2)
                     for r in pr["probe_cases"]}
    out["tiny_paged"] = paged_tick_device_ms(c, root)
    return out


def this_smoke():
    """This checkout's ``chip_smoke`` (the one beside this script), loaded
    under another name: its functions time whichever checkout's package
    the process imported, the same way in every checkout."""
    import importlib.util
    path = Path(__file__).resolve().with_name("chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_f32_tree(root: Path) -> dict:
    """Device microseconds of one checkout's K16-K18 on f32 inputs
    (``time_optin_f32`` of the chip_smoke beside this script: K16 over
    1500 frames at B = 1 and 4, K17 at M = 1500 and 224, K18 at 1500 and
    64, at the whisper-tiny and large-v3 shapes; their plain versions and
    yardsticks too), and the f32 large-v3 encoder (large-v3-turbo's
    config: the same encoder) of 30 s of noise, int8 weights, attention
    plain and through K16, the int8 switch off and on: host ms and device
    ms by CUDA events (best of 3)."""
    import numpy as np
    from whisper_apr_tpu_torch import ComputeConfig, ModelConfig, WhisperApr
    from whisper_apr_tpu_torch.model.params import (init_params,
                                                    quantize_params,
                                                    to_device)
    s = this_smoke()
    out = {}
    for label, D, H, seed in (("tiny", 384, 6, 145),
                              ("large-v3", 1280, 20, 146)):
        t = s.time_optin_f32(label, D, H, seed)
        for key, field in (("", "ms"), ("_plain", "plain_ms"),
                           ("_library", "library_ms"),
                           ("_dense", "dense_ms")):
            out[label + key] = {k: round(v[field] * 1e3, 2)
                                for k, v in t.items()
                                if v.get(field) is not None}
    out["bf16"], out["bf16_digest"] = bf16_optin(s)
    out["f32_err"] = f32_errors(s)
    cfg = ModelConfig.large_v3_turbo()
    params = to_device(quantize_params(init_params(cfg, seed=0), "int8"),
                       "cuda")
    audio = np.random.default_rng(7).normal(0, 0.1, 30 * 16_000).astype(
        np.float32)
    enc = {}
    for flash in (False, True):
        eng = WhisperApr(cfg, params, compute=ComputeConfig(
            quantization="int8", compute_dtype="float32",
            use_flash_attention=flash), device="cuda")
        mel = eng.compute_mel(audio)
        for int8 in (False, True):
            key = ("K16" if flash else "plain") + (" + K17" if int8 else "")
            with s.optin_switches(int8=int8):
                enc[key + " host"] = round(s.encoder_ms(eng, mel), 3)
                enc[key + " device"] = round(s.encoder_event_ms(eng, mel), 3)
    out["encoder_f32_ms"] = enc
    return out


def f32_errors(s) -> dict:
    """Relative error against f64 (max |out - f64| over max |f64|) of K16
    on f32 inputs over 1500 frames at B = 1 and over one key tile (Tq
    128, Tk 64), and of K17 / K18 on f32 x at fc1's shape over 1500 rows,
    at the whisper-tiny and large-v3 shapes, each beside its plain
    version's (chip_smoke's ``attention_f64``; unit-normal draws, as the
    smoke's)."""
    import torch
    from whisper_apr_tpu_torch.ops import flash_attention as fa
    from whisper_apr_tpu_torch.ops import int4_matmul as i4
    from whisper_apr_tpu_torch.ops import int8_matmul as i8
    dev = torch.device("cuda")
    out = {}
    for label, D, H in (("tiny", 384, 6), ("large-v3", 1280, 20)):
        gen = torch.Generator(device=dev).manual_seed(49)
        for Tq, Tk in ((1500, 1500), (128, 64)):
            qkv = [torch.randn((1, H, T, 64), generator=gen, device=dev)
                   for T in (Tq, Tk, Tk)]
            ref = s.attention_f64(*qkv)
            out[f"{label} flash_attention {Tq}x{Tk}"] = s.rel_err(
                fa.flash_attention(*qkv), ref)
            out[f"{label} flash_attention {Tq}x{Tk} plain"] = s.rel_err(
                fa.flash_attention_plain(*qkv), ref)
        K, N = s.MATMUL_SHAPES[label][1]
        for name, mod, bits in (("int8_matmul", i8, 8),
                                ("int4_matmul", i4, 4)):
            x, wq, sc = s.matmul_case(K, N, 1500, torch.float32, gen, dev,
                                      bits)
            w = wq.double() if bits == 8 else mod.unpack_plain(wq).double()
            ref = (x.double() @ w) * sc.double()
            out[f"{label} {name} m1500"] = s.rel_err(
                getattr(mod, name)(x, wq, sc), ref)
            out[f"{label} {name} m1500 plain"] = s.rel_err(
                getattr(mod, name + "_plain")(x, wq, sc), ref)
    return {k: float(f"{v:.3g}") for k, v in out.items()}


def bf16_optin(s) -> tuple:
    """Device microseconds of K16 (B = 1), K17 and K18 (M = 1500, fc1) in
    bf16 at the whisper-tiny and large-v3 shapes, and a SHA-256 digest of
    each one's output over fixed inputs (K16 also over rows of 65 values,
    not 16-byte aligned): equal digests in two checkouts mean the bf16
    paths compute the same bits."""
    import hashlib
    import torch
    from whisper_apr_tpu_torch.ops import flash_attention as fa
    from whisper_apr_tpu_torch.ops import int4_matmul as i4
    from whisper_apr_tpu_torch.ops import int8_matmul as i8
    dev, bf = torch.device("cuda"), torch.bfloat16
    times, digests = {}, {}
    for label, D, H in (("tiny", 384, 6), ("large-v3", 1280, 20)):
        gen = torch.Generator(device=dev).manual_seed(48)
        qkv = [torch.randn((1, H, 1500, 64), generator=gen, device=dev)
               .to(bf) for _ in range(3)]
        odd = [torch.randn((1, H, 448, 65), generator=gen, device=dev)
               .to(bf)[..., :64] for _ in range(3)]
        K, N = s.MATMUL_SHAPES[label][1]
        x8, w8, s8 = s.matmul_case(K, N, 1500, bf, gen, dev, 8)
        x4, w4, s4 = s.matmul_case(K, N, 1500, bf, gen, dev, 4)
        calls = {"flash_attention": lambda: fa.flash_attention(*qkv),
                 "flash_attention_rows65": lambda: fa.flash_attention(
                     *odd, causal=True),
                 "int8_matmul_m1500": lambda: i8.int8_matmul(x8, w8, s8),
                 "int4_matmul_m1500": lambda: i4.int4_matmul(x4, w4, s4)}
        for name, fn in calls.items():
            key = f"{label} {name}"
            times[key] = round(s.graph_ms(fn) * 1e3, 2)
            digests[key] = hashlib.sha256(
                fn().float().cpu().numpy().tobytes()).hexdigest()[:16]
    return times, digests


def paged_tick_device_ms(c, root: Path) -> dict:
    """Device ms per pure decode tick of a whisper-tiny int8 bf16
    ``BatchScheduler(paged=True)`` of 8 slots (``chip_smoke.
    paged_device_ms``: K15 in every layer), plain and with
    use_flash_attention and the int8 switch on (K17 in the tick's
    linears)."""
    import tempfile
    from whisper_apr_tpu_torch import ComputeConfig, ModelConfig, WhisperApr
    (root / "build").mkdir(exist_ok=True)
    clips = c.make_clips(c.SERVE_SECONDS[:8], seed=1)
    out = {}
    with tempfile.TemporaryDirectory(dir=root / "build") as work:
        apr = Path(work) / "tiny.apr"
        c.write_random_apr(apr, ModelConfig.tiny())
        for name, optin in (("device_ms", False),
                            ("flash_int8_device_ms", True)):
            eng = WhisperApr.load_from_apr(str(apr), ComputeConfig(
                quantization="int8", compute_dtype="bfloat16",
                use_flash_attention=optin))
            with c.optin_switches(int8=optin):
                out[name] = round(c.paged_device_ms(eng, clips, 8), 4)
    return out


def time_int4_m1(c) -> dict:
    """Device microseconds of one checkout's K18 at a decode row (M = 1,
    bf16) at the whisper-tiny and large-v3 fc1 shapes, timed here the
    same way for every checkout (a ``time_optin`` before K18's M = 1 row
    does not time it)."""
    import torch
    from whisper_apr_tpu_torch.ops import int4_matmul as i4
    dev = torch.device("cuda")
    out = {}
    for label, (K, N) in (("tiny", (384, 1536)), ("large-v3", (1280, 5120))):
        gen = torch.Generator(device=dev).manual_seed(47)
        x, wq, s = c.matmul_case(K, N, 1, torch.bfloat16, gen, dev, 4)
        out[label] = round(
            c.graph_ms(lambda: i4.int4_matmul(x, wq, s)) * 1e3, 2)
    return out


def time_int4_engine(c, root: Path) -> dict:
    """Host milliseconds per decode step of one checkout's whisper-tiny
    int4 engine through K18 (``chip_smoke.phase_int4``: 30 s of noise,
    bf16, B=1; its f32 token check included)."""
    import tempfile
    from whisper_apr_tpu_torch import ModelConfig
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as work:
        apr = Path(work) / "tiny.apr"
        c.write_random_apr(apr, ModelConfig.tiny())
        r = c.phase_int4(apr)
    return {"ms_per_step": round(1e3 * r["seconds"] / r["decode_steps"], 3)}


def time_e2e(c, root: Path) -> dict:
    """Host milliseconds of one checkout's whisper-tiny path: the bench
    protocol (best of 5) and the mean tick of 8 slots draining 8 clips
    (admission included)."""
    import tempfile
    import time
    import numpy as np
    from whisper_apr_tpu_torch import ComputeConfig, ModelConfig, WhisperApr
    from whisper_apr_tpu_torch.parallel.serving import BatchScheduler
    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build") as work:
        apr = Path(work) / "tiny.apr"
        c.write_random_apr(apr, ModelConfig.tiny())
        eng = WhisperApr.load_from_apr(str(apr), ComputeConfig(
            quantization="int8", compute_dtype="bfloat16"))
    audio = np.random.default_rng(0).normal(0, 0.1, 480_000).astype(
        np.float32)
    rtf = c.bench_rtf(eng, audio, runs=5)
    sched = BatchScheduler(eng, n_slots=8)
    for clip in c.make_clips(c.SERVE_SECONDS[:8], seed=1):
        sched.submit(clip, "en")
    c.sync("cuda")
    t0 = time.perf_counter()
    sched.run_until_drained()
    c.sync("cuda")
    wall = time.perf_counter() - t0
    return {"bench_ms": round(rtf["seconds"] * 1e3, 1),
            "serve_tick_ms": round(1e3 * wall / sched.stats()["ticks"], 3)}


def main() -> int:
    args = sys.argv[1:]
    modes = [a for a in args
             if a in ("--optin", "--split", "--int8", "--batched", "--bits",
                      "--f32")]
    args = [a for a in args if a not in modes]
    if len(args) == 2 and args[0] == "--one":
        root = Path(args[1])
        print("AB", root.name, json.dumps(time_tree(root, *modes)),
              flush=True)
        return 0
    if not args or len(modes) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for d in args:
        root = Path(d).resolve()
        if not (root / "chip_smoke.py").is_file():
            print(f"chip_ab: {d} holds no chip_smoke.py", file=sys.stderr)
            return 2
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one",
             str(root)] + modes,
            cwd=root, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"chip_ab: {d} failed ({proc.returncode})", file=sys.stderr)
            return 1
        for ln in proc.stdout.splitlines():
            if ln.startswith("[device]"):
                print(ln, flush=True)
        print(lines[-1], flush=True)
        runs.append((d, json.loads(lines[-1].split(" ", 2)[2])))
    rows = sorted({(s, k) for _, t in runs for s in t for k in t[s]})
    print(f"{'us (e2e_tiny: ms)':40s}" + "".join(f" {d:>13s}"
                                                 for d, _ in runs))
    for s, k in rows:
        print(f"{s + '.' + k:40s}" + "".join(
            f" {t.get(s, {}).get(k, '-'):>13}" for _, t in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
