"""Probe the card's contractions and slope-time the port's decode steps
(port of the JAX package's ``tools/probe_layer_kernel.py``).

    python -m whisper_apr_tpu_torch.tools.probe_layer_kernel \\
        [--int8dot] [--tricks] [--large] [--anatomy]
        [--q4k | --q5k | --q6k [--fused]] [--batched --b N --quant Q]
        [--lo N] [--hi N] [--model NAME] [--device cuda|cpu] [--json OUT]

--int8dot (P1, P2) and --tricks (P3, sub-probes (a)-(j)) run the probe
kernels of ``ops/probe_mma.py`` on the JAX tool's inputs
(``np.random.default_rng(0)``, drawn in its order) and hold each against
its plain PyTorch version: P1 and the transposes exact, the rest within
2e-5 of the plain version's largest magnitude. Each case reports whether
it ran, exact or its relative error, and its device us by CUDA-graph
replay. A kernel that does not build or launch raises (the JAX tool
caught that and printed FAILED); a case out of tolerance makes the tool
exit 1.

--large, --anatomy, --q4k/--q5k/--q6k [--fused] and --batched slope-time
(``profile_decode.P``, a Python loop of steps) the port's decode steps on
random weights made on the device from a seed (the step's time does not
depend on the values): ``decode_step_qf`` at B=1 over int8 weights (K1-K4
per block: K1-K3 each layer and the fused greedy head K4; bf16 self and
cross rows), over k-quant weights with --fused (K12-K14), the scan step
``decode_step_q`` (K8 + K9, or K10/K11 over k-quants, and the standalone
qkv matvec), and the B-slot tick (K5-K8; k-quants through their int8
transcode). ``--which`` takes "qf" only: the JAX variants select TPU
switches the port does not have (deferred KV writes, transposed score
tiles). Timings on the CPU are host times and are labelled so.

The last line printed is the launch count of every kernel in this run,
as JSON; ``--json`` also writes every result to a file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..model import qdecode
from ..model.decoder import KVCache
from ..ops import kquants, probe_mma, q4k
from ..ops.dispatch import resolve_device
from ..ops.quant import QTensor
from .profile_decode import P, graph_ms

# f32 results: the kernel and the plain version sum the same exact
# products in another order (and the tensor cores accumulate in their
# own order): 2e-5 of the plain version's largest magnitude
TOL = 2e-5


# ---------------------------------------------------------------------------
# P1-P3
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProbeCase:
    """One probe: the kernel call and its plain version on the same
    inputs. ``exact`` cases are held with ``torch.equal``."""

    name: str
    probe: str
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    exact: bool
    inputs: tuple


@dataclasses.dataclass
class ProbeResult:
    name: str
    probe: str
    runs: bool
    exact: bool
    relerr: float
    passed: bool
    us: Optional[float]          # device us per call; None off the card


def _dev(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t if dtype is None else t.to(dtype)


def int8dot_cases(device) -> List[ProbeCase]:
    """P1: int8 [256, 256] . int8 [256, 256] -> int32; P2: the same int8
    . bf16 [256, 256] -> f32 (the JAX tool's :414-447)."""
    M = K = N = 256
    rng = np.random.default_rng(0)
    a = _dev(rng.integers(-127, 128, (M, K), dtype=np.int8), device)
    b = _dev(rng.integers(-127, 128, (K, N), dtype=np.int8), device)
    bb = _dev(rng.normal(0, 1, (K, N)).astype(np.float32), device,
              torch.bfloat16)
    pm = probe_mma
    return [
        ProbeCase("int8xint8 dot", "P1", lambda: pm.int8_dot(a, b),
                  lambda: pm.int8_dot_plain(a, b), True, (a, b)),
        ProbeCase("int8xbf16 dot", "P2", lambda: pm.mixed_dot(a, bb),
                  lambda: pm.mixed_dot_plain(a, bb), False, (a, bb)),
    ]


def tricks_cases(device) -> List[ProbeCase]:
    """P3's sub-probes (a)-(j) at bt=128, D=1280, H=32, B=8 (the JAX
    tool's :470-631, inputs drawn in its order)."""
    rng = np.random.default_rng(0)
    bt, D, H, B = 128, 1280, 32, 8
    p_f = _dev(rng.normal(0, 1, (bt, H)).astype(np.float32), device)
    v8 = _dev(rng.integers(-127, 128, (bt, D), dtype=np.int8), device)
    v_f = v8.float()
    p_b = p_f.to(torch.bfloat16)
    qe = _dev(rng.normal(0, 1, (D, H)).astype(np.float32), device)
    q_row = _dev(rng.normal(0, 1, (8, D)).astype(np.float32), device)
    pT = p_f.t().contiguous()
    k8b = _dev(rng.integers(-127, 128, (B, bt, D), dtype=np.int8), device)
    qeb = _dev(rng.normal(0, 1, (B, D, H)).astype(np.float32), device)
    pb = _dev(rng.normal(0, 1, (B, bt, H)).astype(np.float32), device)
    v8b = _dev(rng.integers(-127, 128, (B, bt, D), dtype=np.int8), device)
    pm = probe_mma

    def dot(name, probe, a, b, trans_a=False, cast=False):
        return ProbeCase(
            name, probe, lambda: pm.tricks_dot(a, b, trans_a, cast),
            lambda: pm.tricks_dot_plain(a, b, trans_a, cast), False, (a, b))

    def tr(name, probe, a):
        return ProbeCase(name, probe, lambda: pm.tricks_transpose(a),
                         lambda: pm.tricks_transpose_plain(a), True, (a,))

    return [
        dot("dotT f32xf32", "P3 (a)", p_f, v_f, trans_a=True),
        dot("dotT bf16xint8", "P3 (b)", p_b, v8, trans_a=True),
        dot("dot int8xf32", "P3 (c)", v8, qe),
        tr("transpose [8,D]->[D,8] f32", "P3 (d)", q_row),
        tr("transpose [bt,H]->[H,bt] f32", "P3 (d)", p_f),
        dot("dotT f32xint8", "P3 (e)", p_f, v8, trans_a=True),
        dot("dot f32xint8", "P3 (f)", pT, v8),
        dot("bdot int8xf32 [B,bt,D]x[B,D,H]", "P3 (g)", k8b, qeb),
        dot("bdotT f32xint8 [B,bt,H]x[B,bt,D]", "P3 (h)", pb, v8b,
            trans_a=True),
        dot("dot bf16(cast)xint8", "P3 (i)", pT, v8, cast=True),
        dot("dotT int8xf32", "P3 (j)", v8, p_f, trans_a=True),
    ]


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|, in float64."""
    g, r = got.double(), ref.double()
    return float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))


def run_case(case: ProbeCase, time_it: bool) -> ProbeResult:
    """The kernel against its plain version; its device us by CUDA-graph
    replay when ``time_it`` (on the card)."""
    got = case.kernel()
    ref = case.plain()
    if got.device.type == "cuda":
        torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{case.name}: kernel gives {got.dtype} "
                             f"{tuple(got.shape)}, plain {ref.dtype} "
                             f"{tuple(ref.shape)}")
    exact = torch.equal(got, ref)
    err = rel_err(got, ref)
    passed = exact if case.exact else err <= TOL
    us = 1e3 * graph_ms(case.kernel) if time_it else None
    return ProbeResult(case.name, case.probe, True, exact, err, passed, us)


def run_probes(cases: List[ProbeCase], device) -> List[ProbeResult]:
    time_it = torch.device(device).type == "cuda"
    out = []
    for case in cases:
        r = run_case(case, time_it)
        us = "not measured (cpu)" if r.us is None else f"{r.us:.2f} us"
        print(f"{r.probe:<7} {r.name}: OK exact={r.exact} relerr "
              f"{r.relerr:.2e} {'PASS' if r.passed else 'FAIL'} {us}",
              flush=True)
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# decode steps on random weights
# ---------------------------------------------------------------------------

KQ_RANGE = {"q4k": (-128, 128), "q5k": (0, 32), "q6k": (-32, 32)}
# mean magnitude of a planar value (zeros centre the values on 0)
KQ_AMP = {"q4k": 7.5, "q5k": 15.5, "q6k": 32.0}


def _weight(quant: str, L: int, K: int, N: int, gen, device) -> QTensor:
    """A random stacked [L, K, N] linear: int8 with per-channel scales, or
    a planar k-quant (values over the format's range, scales keeping the
    outputs O(1), zeros at the values' mean)."""
    if quant == "int8":
        q = torch.randint(-127, 128, (L, K, N), generator=gen,
                          device=device, dtype=torch.int8)
        return QTensor(q, torch.full((L, 1, N), 1 / (127 * math.sqrt(K)),
                                     device=device))
    sub = 16 if quant == "q6k" else 32
    rows = K // 2 if quant == "q4k" else K
    lo, hi = KQ_RANGE[quant]
    q = torch.randint(lo, hi, (L, rows, N), generator=gen, device=device,
                      dtype=torch.int8)
    s = torch.full((L, K // sub, N), 1 / (KQ_AMP[quant] * math.sqrt(K)),
                   device=device)
    return QTensor(q, s, zero=None if quant == "q6k" else s * KQ_AMP[quant],
                   int4=quant == "q4k", group=sub, kpack=quant == "q4k")


def decoder_params(cfg: ModelConfig, quant: str, seed: int, device,
                   dtype=torch.bfloat16) -> dict:
    """The decoder half of a param tree (what the decode steps read) with
    random ``quant`` block linears, an int8 token embedding and
    LayerNorms at identity, made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D, V = cfg.n_text_layer, cfg.n_text_state, cfg.n_vocab

    def vec(*shape, one=False):
        return (torch.ones if one else torch.zeros)(shape, dtype=dtype,
                                                    device=device)

    def attn():
        out = {}
        for k in ("q", "k", "v", "o"):
            out[f"{k}_w"] = _weight(quant, L, D, D, gen, device)
            out[f"{k}_b"] = vec(L, D)
        return out

    def ln():
        return {"w": vec(L, D, one=True), "b": vec(L, D)}

    emb = torch.randint(-127, 128, (V, D), generator=gen, device=device,
                        dtype=torch.int8)
    return {"decoder": {
        "token_emb": QTensor(emb, torch.full((1, D), 0.02 / 127,
                                             device=device)),
        "pos_emb": 0.02 * torch.randn((cfg.n_text_ctx, D), generator=gen,
                                      device=device).to(dtype),
        "blocks": {"ln1": ln(), "self_attn": attn(), "ln2": ln(),
                   "cross_attn": attn(), "ln3": ln(),
                   "fc1": {"w": _weight(quant, L, D, 4 * D, gen, device),
                           "b": vec(L, 4 * D)},
                   "fc2": {"w": _weight(quant, L, 4 * D, D, gen, device),
                           "b": vec(L, D)}},
        "ln_post": {"w": vec(D, one=True), "b": vec(D)}}}


def random_cache(cfg: ModelConfig, B: int, seed: int, device,
                 dtype=torch.bfloat16, max_len: int = 448) -> KVCache:
    """A dense cache of B rows (self ``max_len``, cross n_audio_ctx)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, D = cfg.n_text_layer, cfg.n_text_state
    return KVCache(*(0.5 * torch.randn((L, B, t, D), generator=gen,
                                       device=device).to(dtype)
                     for t in (max_len, max_len, cfg.n_audio_ctx,
                               cfg.n_audio_ctx)))


def _tok(B: int, device) -> torch.Tensor:
    return torch.zeros((B,), dtype=torch.int32, device=device)


def _qf_body(cfg, max_len: int, batched: bool):
    """Greedy steps of decode_step_qf: carry (token, cache) at B=1 (pos
    = the step), (token, pos, cache) with per-slot device positions."""
    if not batched:
        def body(i, env, carry):
            prm, qd = env
            tok, c = carry
            logits, c = qdecode.decode_step_qf(prm, qd, tok, i % max_len, c,
                                               cfg)
            return (torch.argmax(logits, -1).to(torch.int32), c)
        return body

    def body(i, env, carry):
        prm, qd = env
        tok, pos, c = carry
        logits, c = qdecode.decode_step_qf(prm, qd, tok, pos, c, cfg)
        return (torch.argmax(logits, -1).to(torch.int32),
                (pos + 1) % max_len, c)
    return body


def large_measure(lo: int, hi: int, device, cfg: ModelConfig,
                  which=("qf",)) -> Dict[str, float]:
    """ms/step of the fused B=1 step over int8 weights and bf16 rows."""
    for name in which:
        if name != "qf":
            raise ValueError(f"--which {name}: only qf is ported (the other "
                             "variants select TPU switches)")
    params = decoder_params(cfg, "int8", 0, device)
    qd = qdecode.prepare_qdecode(params, cfg)
    qc = qdecode.quantize_cache(random_cache(cfg, 1, 1, device), "bf16")
    s = P(lo, hi, device).per_step(_qf_body(cfg, 448, False), (params, qd),
                                   (_tok(1, device), qc))
    print(f"qf          : {s * 1e3:8.4f} ms/step ({cfg.model_type}, "
          f"{torch.device(device).type})", flush=True)
    return {"qf": s * 1e3}


def anatomy_measure(lo: int, hi: int, device, cfg_full: ModelConfig,
                    layers=(8, 32), b: int = 1) -> Dict[str, float]:
    """The fused step at several layer counts: the slope over layers is
    the per-layer cost, the rest the step's fixed part (embedding, vocab
    head, loop)."""
    results = {}
    for nl in layers:
        cfg = dataclasses.replace(cfg_full, n_text_layer=nl)
        params = decoder_params(cfg, "int8", 0, device)
        qd = qdecode.prepare_qdecode(params, cfg)
        qc = qdecode.quantize_cache(random_cache(cfg, b, 1, device), "bf16")
        carry = (_tok(b, device), qc) if b == 1 else (
            _tok(b, device), torch.arange(b, dtype=torch.int32,
                                          device=device) * 16, qc)
        s = P(lo, hi, device).per_step(_qf_body(cfg, 448, b > 1),
                                       (params, qd), carry)
        print(f"qf B={b} L={nl:<3}: {s * 1e3:8.4f} ms/step", flush=True)
        results[nl] = s
        del params, qd, qc
    out = {f"L{n}": results[n] * 1e3 for n in results}
    ls = sorted(results)
    if len(ls) >= 2:
        xs = np.asarray(ls, np.float64)
        ys = np.asarray([results[n] for n in ls], np.float64)
        slope, intercept = np.polyfit(xs, ys, 1)
        print(f"per-layer: {slope * 1e3:.4f} ms   fixed: "
              f"{intercept * 1e3:.4f} ms (embedding + vocab + loop)",
              flush=True)
        out.update(per_layer=slope * 1e3, fixed=intercept * 1e3)
    return out


def kq_measure(lo: int, hi: int, device, cfg: ModelConfig, qmode: str,
               fused: bool = False) -> Dict[str, float]:
    """A k-quant B=1 step: with ``fused`` decode_step_qf (K12-K14), else
    the scan step decode_step_q (K10/K11) and its qkv matvec alone."""
    params = decoder_params(cfg, qmode, 0, device)
    qd = (qdecode.prepare_q4k_decode if qmode == "q4k"
          else qdecode.prepare_kq_decode)(params, cfg)
    if qd is None or qd["mode"] != qmode:
        raise ValueError(f"{cfg.model_type}: no {qmode} decode (the decoder "
                         "width must be a multiple of 256)")
    p = P(lo, hi, device)
    kv = random_cache(cfg, 1, 1, device)
    if fused:
        s = p.per_step(_qf_body(cfg, 448, False), (params, qd),
                       (_tok(1, device), qdecode.quantize_cache(kv, "bf16")))
        print(f"{qmode} FUSED step: {s * 1e3:8.4f} ms/step", flush=True)
        return {f"{qmode}_fused": s * 1e3}

    def body(i, env, carry):
        prm, q_d = env
        tok, c = carry
        logits, c = qdecode.decode_step_q(prm, q_d, tok, i % 448, c, cfg)
        return (torch.argmax(logits, -1).to(torch.int32), c)

    s = p.per_step(body, (params, qd), (_tok(1, device), kv))
    print(f"{qmode} scan step: {s * 1e3:8.4f} ms/step", flush=True)
    tri = qd["blk"]["qkv"]
    D, L = cfg.n_text_state, cfg.n_text_layer
    mv = q4k.q4k_matvec_stacked if qmode == "q4k" else kquants.kq_matvec_stacked

    def mv_body(i, env, x):
        return mv(x, *env, i % L)[:, :D].to(x.dtype)

    s_mv = p.per_step(mv_body, tri, torch.zeros((1, D), dtype=torch.bfloat16,
                                                device=device))
    nbytes = sum(t.numel() * t.element_size() for t in tri
                 if t is not None) // L
    print(f"{qmode} qkv matvec: {s_mv * 1e3:8.4f} ms/step "
          f"({nbytes / s_mv / 2 ** 30:5.0f} GiB/s eff)", flush=True)
    return {f"{qmode}_scan": s * 1e3, f"{qmode}_qkv_matvec": s_mv * 1e3}


def batched_measure(lo: int, hi: int, device, cfg: ModelConfig, b: int = 8,
                    quant: str = "int8", which=("qf",)) -> Dict[str, float]:
    """The B-slot tick (K5-K8) over bf16 rows, slots at positions 0, 16,
    32, ...; k-quant weights through their int8 transcode."""
    for name in which:
        if name != "qf":
            raise ValueError(f"--which {name}: only qf is ported")
    params = decoder_params(cfg, quant, 0, device)
    qd = (qdecode.prepare_qdecode(params, cfg) if quant == "int8"
          else qdecode.transcode_kq_to_int8(params, cfg))
    qc = qdecode.quantize_cache(random_cache(cfg, b, 1, device), "bf16")
    pos0 = (torch.arange(b, dtype=torch.int32, device=device) * 16) % 448
    s = P(lo, hi, device).per_step(_qf_body(cfg, 448, True), (params, qd),
                                   (_tok(b, device), pos0, qc))
    print(f"B={b} qf [{quant}]: {s * 1e3:8.4f} ms/step  "
          f"{s * 1e3 / b:6.4f} ms/slot-token", flush=True)
    return {f"b{b}_{quant}": s * 1e3}


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _launches() -> Dict[str, int]:
    from ..ops import decode_blocks, decode_blocks_kq, qmatvec
    out = {}
    for mod in (decode_blocks, qmatvec, q4k, kquants, decode_blocks_kq,
                probe_mma):
        out.update(mod.LAUNCHES)
    return out


def _reset_launches() -> None:
    from ..ops import decode_blocks, decode_blocks_kq, qmatvec
    for mod in (decode_blocks, qmatvec, q4k, kquants, decode_blocks_kq,
                probe_mma):
        mod.reset_launches()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m whisper_apr_tpu_torch.tools.probe_layer_kernel",
        description=__doc__.split("\n")[0])
    for flag in ("large", "q4k", "q5k", "q6k", "int8dot", "tricks",
                 "batched"):
        ap.add_argument(f"--{flag}", action="store_true")
    ap.add_argument("--anatomy", action="store_true",
                    help="fixed-vs-per-layer split of the fused B=1 step")
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--anatomy-b", type=int, default=1)
    ap.add_argument("--anatomy-layers", default="8,32")
    ap.add_argument("--quant", default="int8",
                    help="--batched weights: int8 | q4k | q5k | q6k")
    ap.add_argument("--fused", action="store_true",
                    help="time decode_step_qf (K12-K14) instead of the "
                         "scan step for --q4k/--q5k/--q6k")
    ap.add_argument("--which", default="qf", help="only qf is ported")
    ap.add_argument("--lo", type=int, default=16)
    ap.add_argument("--hi", type=int, default=144)
    ap.add_argument("--model", default="large-v3",
                    help="model preset of the step timings")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="also write every result to this JSON file")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the chosen stages; returns {"probes": [...], "steps": {...},
    "launches": {...}} (launches of this run, counted from 0)."""
    ap = parser()
    args = ap.parse_args(argv)
    stages = ("large", "q4k", "q5k", "q6k", "anatomy", "int8dot", "tricks",
              "batched")
    if not any(getattr(args, s) for s in stages):
        ap.error("pick a stage: --large / --q4k / --q5k / --q6k / "
                 "--anatomy / --int8dot / --tricks / --batched")
    device = resolve_device(args.device, "probe_layer_kernel")
    # the plain versions' f32 matmuls stay in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu (plain versions, host times)")
    print(f"device: {name}", flush=True)
    _reset_launches()
    cfg = ModelConfig.from_name(args.model)
    which = args.which.split(",")
    probes: List[ProbeResult] = []
    steps: Dict[str, float] = {}
    if args.int8dot:
        probes += run_probes(int8dot_cases(device), device)
    if args.tricks:
        probes += run_probes(tricks_cases(device), device)
    if args.batched:
        steps.update(batched_measure(args.lo, args.hi, device, cfg, args.b,
                                     args.quant, which))
    if args.large:
        steps.update(large_measure(args.lo, args.hi, device, cfg, which))
    if args.anatomy:
        steps.update(anatomy_measure(
            args.lo, args.hi, device, cfg,
            tuple(int(x) for x in args.anatomy_layers.split(",")),
            args.anatomy_b))
    for q in ("q4k", "q5k", "q6k"):
        if getattr(args, q):
            steps.update(kq_measure(args.lo, args.hi, device, cfg, q,
                                    args.fused))
    result = {"device": device.type, "model": args.model,
              "probes": [dataclasses.asdict(r) for r in probes],
              "steps_ms": steps, "launches": _launches()}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"launches": result["launches"]}), flush=True)
    return result


if __name__ == "__main__":
    out = main()
    sys.exit(0 if all(p["passed"] for p in out["probes"]) else 1)
