"""Multi-rank dry runs of the mesh path: the port's ``dryrun_multichip``
(``__graft_entry__.py``) and of the multi-host worker
(``tests/distributed_worker.py``).

    python -m whisper_apr_tpu_torch.parallel.dryrun --n 1 --config tiny
    python -m whisper_apr_tpu_torch.parallel.dryrun --n 2 --backend gloo \\
        --config tiny --clips 4 --slots 4 --requests 5
    python -m whisper_apr_tpu_torch.parallel.dryrun --n 4 --tp 2 --device cpu

Without ``--rank`` the module is the launcher: it picks a free port,
starts ``--n`` ranks of itself as subprocesses (``--rank r``), waits for
each within ``--timeout`` seconds and fails unless every rank exits 0
and reports its checks passed. ``--case CONFIG:TP`` (repeated) runs
several configurations one after another in the same ranks. Each rank
writes ``rank<r>.json`` (each case's checks, errors and times) and
``rank<r>.npz`` (its outputs) under ``--out``; :func:`launch` returns
them. :func:`run_here` runs a single rank in the calling process.

Jobs:

- ``mesh``: a (dp, tp) mesh over the ranks (``--tp``). Every rank builds
  the same random weights (``init_params`` at ``SEED``, its convolutions,
  projections and embedding redrawn with ``GAIN`` so that a decode
  depends on its clip)
  and inputs, runs the single-device reference on its own device, then
  the mesh path: sharded ``encode`` and teacher-forced
  ``decoder_forward`` (logits within ``--tol`` of the largest
  single-device magnitude), sharded ``greedy_generate_body`` (tokens and
  lengths equal, except where the reference's top two logits are within
  ``NEAR_TIE``; the clips' tokens not all the same), a dp-only mesh
  (``shard_params(shard_tp=False)``), and a ``BatchScheduler(mesh=...)``
  that serves ``--requests`` clips on ``--slots`` slots with none
  dropped, the single-device scheduler's tokens, and completions not all
  the same. With
  ``--refusals`` it also records the refusals (an odd vocabulary under
  tp, quantized weights, paged slots on a mesh, slots that do not
  divide over dp, a kernel path over a sharded tree) and, on 4 ranks,
  the mesh shapes and the mesh of a subset of the ranks.
- ``multihost``: ``--n`` ranks as hosts of ``--per-host`` ranks
  (``init_distributed(local_device_count=...)``), a
  ``make_multihost_mesh(tp=--tp)``, each host feeding its own rows
  (``host_local_batch_to_global``) through the sharded encoder, decoder
  and argmax, and ``process_slice`` giving each host's next tokens back.

Ranks put their tensors on ``--device`` (the card by default; ``cpu``
asks for the CPU) and use ``--backend``: by default NCCL for a CUDA
device (one GPU a rank) and gloo for the CPU. gloo carries CUDA tensors
too, so two ranks can share one GPU. Every process group gives up after
``--timeout``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

# ModelConfig fields of the named configurations
SMALL = dict(model_type="tiny", n_vocab=512, n_audio_ctx=32,
             n_audio_state=64, n_audio_head=4, n_audio_layer=2,
             n_text_ctx=16, n_text_state=64, n_text_head=4, n_text_layer=2,
             n_mels=80)


def named_config(name: str):
    """"small" (the JAX dry run's shapes), "tiny", "large-v3-4x4"
    (large-v3's widths, 4 encoder and 4 decoder layers), or a JSON
    object of ModelConfig fields."""
    from ..config import ModelConfig
    if name == "small":
        return ModelConfig(**SMALL)
    if name == "tiny":
        return ModelConfig.tiny()
    if name == "large-v3-4x4":
        return dataclasses.replace(ModelConfig.large_v3(), n_audio_layer=4,
                                   n_text_layer=4)
    return ModelConfig(**json.loads(name))


def fitted_specials(cfg):
    """Special tokens inside a small test vocabulary (the JAX dry run's);
    None (the vocabulary's own) for a released vocabulary size."""
    from ..tokenizer import SpecialTokens
    if cfg.n_vocab >= 51864:
        return None
    V = cfg.n_vocab
    return SpecialTokens(
        eot=V - 1, sot=V - 2, lang_base=V - 110, transcribe=V - 3,
        no_timestamps=V - 4, timestamp_base=V + 1000,
        is_multilingual=False, translate=V - 5)


# the mesh job's weights: init_params at SEED, the convolutions,
# projections and embedding redrawn with GAIN (redraw); greedy tokens
# that leave the reference must do so where its top two logits are
# within NEAR_TIE
SEED, GAIN, NEAR_TIE = 0, 1.6, 1e-4
REDRAWN = ("q_w", "k_w", "v_w", "o_w", "token_emb", "fc1.w", "fc2.w",
           "conv1.w", "conv2.w")


def redraw(params: dict, gain: float, seed: int) -> dict:
    """``params`` with the convolutions, every projection matrix and the
    token embedding drawn again from N(0, (gain / sqrt(fan_in))^2)
    (numpy, ``seed``, in the tree's order): each product then scales its
    input by about ``gain`` at any width. Under ``init_params``' small
    draws the positional embedding outweighs the convolutions, so every
    clip encodes nearly alike and decodes the same tokens; these make a
    decode depend on its clip."""
    import torch
    rng = np.random.default_rng(seed)

    def fan_in(name, shape):
        if name.startswith("conv"):        # [d_out, d_in, k]
            return shape[1] * shape[2]
        return shape[-1] if name == "token_emb" else shape[-2]

    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(v, k if k != "w" else f"{name}.w")
                    for k, v in t.items()}
        if name in REDRAWN:
            std = gain / math.sqrt(fan_in(name, tuple(t.shape)))
            return torch.from_numpy(rng.normal(0.0, std, tuple(t.shape))
                                    .astype(np.float32)).to(t.device)
        return t
    return walk(params, "")


def mesh_inputs(cfg, clips: int, tf_tokens: int):
    """The mesh job's inputs, numpy, from ``SEED``: mels ``[clips, 2 *
    n_audio_ctx, n_mels]`` (noise over a spectral profile of each clip's
    own: noise alone averages out over a long context, and the clips
    decode alike) and teacher-forced tokens ``[clips, tf_tokens]``."""
    rng = np.random.default_rng(SEED)
    mel = rng.normal(size=(clips, 2 * cfg.n_audio_ctx, cfg.n_mels))
    tf = rng.integers(0, cfg.n_vocab, size=(clips, tf_tokens))
    mel = mel + rng.normal(size=(clips, 1, cfg.n_mels))
    return mel.astype(np.float32), tf


def serve_clip(i: int, samples: int) -> np.ndarray:
    """The scheduler's clip ``i`` at 16 kHz: a tone at 300 + 450 i Hz
    (amplitude 0.3) over noise (seed ``SEED + 1 + i``). Clips of noise
    alone have nearly the same log-mel spectrum and decode alike."""
    t = np.arange(samples) / 16000.0
    noise = np.random.default_rng(SEED + 1 + i).normal(0, 0.05, samples)
    return (0.3 * np.sin(2 * np.pi * (300 + 450 * i) * t)
            + noise).astype(np.float32)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(argv: List[str], timeout: Optional[float] = None
           ) -> List[List[dict]]:
    """Start the ranks of this module that ``argv`` (its options, without
    ``--rank``) asks for, wait for them (all within ``timeout`` seconds,
    ``--timeout`` by default; all are killed if they overrun) and return
    the reports, ``[case][rank]``: each rank's JSON for the case, the
    case's arrays of its npz under "arrays" and its output under "log".
    Raises RuntimeError if a rank fails or a check does not pass."""
    a = parse_args(argv)
    timeout = timeout or a.timeout
    n = a.n
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    root = Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(root), env.get("PYTHONPATH", "")) if p)
    args = [*argv, "--port", str(free_port())]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "whisper_apr_tpu_torch.parallel.dryrun",
         *args, "--rank", str(r)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=str(root))
        for r in range(n)]
    logs = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError(f"dry run ranks overran {timeout} s")
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError("dry run ranks %s failed:\n%s" % (bad, "\n".join(
            f"--- rank {r}:\n{logs[r][-4000:]}" for r in bad)))
    return _collect(out, logs)


def run_here(argv: List[str]) -> List[List[dict]]:
    """One rank (``--n 1``) in this process, as :func:`launch` runs it
    (its process group made and destroyed here): no process start."""
    a = parse_args([*argv, "--port", str(free_port()), "--rank", "0"])
    if a.n != 1:
        raise ValueError("run_here runs one rank; launch runs several")
    Path(a.out).mkdir(parents=True, exist_ok=True)
    rank_main(a)
    return _collect(Path(a.out), [""])


def _collect(out: Path, logs: List[str]) -> List[List[dict]]:
    """The ranks' reports, ``[case][rank]``; RuntimeError on a failed
    check."""
    by_rank = []
    for r, log in enumerate(logs):
        rep = json.loads((out / f"rank{r}.json").read_text())
        with np.load(out / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        for i, case in enumerate(rep["cases"]):
            case["arrays"] = {k.split("/", 1)[1]: v
                              for k, v in arrays.items()
                              if k.split("/", 1)[0] == str(i)}
            case["log"] = log
        by_rank.append(rep["cases"])
    cases = [list(c) for c in zip(*by_rank)]
    failed = [(i, r, k) for i, case in enumerate(cases)
              for r, rep in enumerate(case)
              for k, ok in rep["ok"].items() if not ok]
    if failed:
        raise RuntimeError(f"dry run checks failed: {failed}")
    return cases


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _error(fn) -> str:
    """The message of the ValueError ``fn`` raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e) or "ValueError"
    return ""


def _mesh_checks(world: int, rep: dict) -> None:
    """make_mesh shapes, a subset mesh and the ValueErrors (4 ranks)."""
    from .mesh import make_mesh, mesh_shape
    rep["mesh_shapes"] = {
        "n_tp2": mesh_shape(make_mesh(world, tp=2)),
        "n_tp1": mesh_shape(make_mesh(world, tp=1)),
        "default_tp2": mesh_shape(make_mesh(tp=2))}
    sub = make_mesh(2, tp=2)
    rep["subset"] = {"shape": mesh_shape(sub),
                     "size": sub.size(),
                     "coordinate": (None if sub.get_coordinate() is None
                                    else list(sub.get_coordinate()))}
    rep["errors"]["mesh_3x2"] = _error(lambda: make_mesh(world, dp=3, tp=2))
    rep["errors"]["mesh_too_big"] = _error(lambda: make_mesh(world + 1))


def _first_gap(ref_logits_fn, ref_tok, got_tok, prompt_len: int,
               bias) -> Optional[float]:
    """Where ``got_tok`` first leaves ``ref_tok`` (rows of one clip), the
    reference's top-two gap there (None where they agree)."""
    import torch
    diff = np.flatnonzero(ref_tok != got_tok)
    if diff.size == 0:
        return None
    i = int(diff[0])
    logits = ref_logits_fn(torch.as_tensor(ref_tok[None, :i]).long())[0, -1]
    top = torch.topk(logits.float() + bias, 2).values
    return float(top[0] - top[1])


def _serve_gap(eng, audio, want: list, got: list) -> Optional[float]:
    """Where a completion ``got`` first leaves the single-device one
    ``want``, the top-two gap of the suppressed logits after that prefix
    (a plain prefill on the engine; None where they agree)."""
    import torch
    from ..inference.processors import WhisperTokenSuppressor
    from ..model.decoder import init_cache, prefill
    d = next((i for i in range(min(len(got), len(want)))
              if got[i] != want[i]), None)
    if d is None and len(got) == len(want):
        return None
    d = min(len(got), len(want)) if d is None else d
    enc = eng.encode(eng.compute_mel(audio))
    cache = init_cache(eng.params, enc, eng.config, max_len=d,
                       compute_dtype=torch.float32)
    logits, _ = prefill(eng.params, torch.tensor([want[:d]],
                                                 device=eng.device),
                        enc, cache, eng.config, compute_dtype=torch.float32)
    bias = torch.from_numpy(WhisperTokenSuppressor(
        n_vocab=eng.config.n_vocab, tokens=eng.specials).bias()).to(
        eng.device)
    top = torch.topk(logits[0].float() + bias, 2).values
    return float(top[0] - top[1])


def run_mesh(a, rep: dict, arrays: dict) -> None:
    import torch
    import torch.distributed as dist
    from ..config import ComputeConfig
    from ..engine import WhisperApr
    from ..model import qdecode
    from ..model.decoder import decoder_forward, greedy_generate_body
    from ..model.encoder import encode
    from ..model.params import init_params, quantize_params, to_device
    from .mesh import (gather_dp, make_mesh, mesh_shape, replicate,
                       shard_batch, shard_params)
    from .serving import BatchScheduler

    dev = torch.device(a.device)
    cfg = named_config(a.config)
    if a.refusals and a.n == 4:
        _mesh_checks(a.n, rep)
    params = to_device(redraw(init_params(cfg, seed=SEED), GAIN, SEED), dev)
    B = a.clips
    mel, tf = (torch.from_numpy(x).to(dev)
               for x in mesh_inputs(cfg, B, a.tf_tokens))
    eot = cfg.n_vocab - 1
    P = 3
    prompt = torch.full((B, P), 5, dtype=torch.long, device=dev)
    bias = torch.zeros(cfg.n_vocab, device=dev)

    def greedy(p, enc, pr, bias=bias):
        return greedy_generate_body(p, enc, pr, bias, eot, cfg,
                                    max_len=a.max_len, prompt_len=P)

    # the single-device reference, on this rank's device
    enc_ref = encode(params, mel, cfg)
    logits_ref = decoder_forward(params, tf, enc_ref, cfg)
    greedy(params, enc_ref[:1], prompt[:1])            # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    ref = greedy(params, enc_ref, prompt)
    _sync(dev)
    t_single = time.perf_counter() - t0

    mesh = make_mesh(tp=a.tp)
    shape = mesh_shape(mesh)
    rep["mesh"] = shape
    sp = shard_params(params, mesh)
    enc_s = encode(sp, shard_batch(mel, mesh), cfg)
    logits_s = decoder_forward(sp, shard_batch(tf, mesh), enc_s, cfg)
    _sync(dev)
    t0 = time.perf_counter()
    out = greedy(sp, enc_s, shard_batch(prompt, mesh),
                 replicate(bias, mesh))
    _sync(dev)
    t_mesh = time.perf_counter() - t0
    enc_s, logits_s = gather_dp(enc_s, mesh), gather_dp(logits_s, mesh)
    toks, lens = gather_dp(out.tokens, mesh), gather_dp(out.lengths, mesh)
    scale = float(logits_ref.abs().max())
    rep["logits_max_err"] = float((logits_s - logits_ref).abs().max())
    rep["logits_scale"] = scale
    rep["enc_max_err"] = float((enc_s - enc_ref).abs().max())
    rep["ok"]["logits"] = rep["logits_max_err"] <= a.tol * scale
    ref_t, got_t = ref.tokens.cpu().numpy(), toks.cpu().numpy()
    gaps = [_first_gap(lambda t: decoder_forward(
        params, t.to(dev), enc_ref[b: b + 1], cfg), ref_t[b], got_t[b], P,
        bias) for b in range(B)]
    rep["greedy_exact"] = bool(np.array_equal(ref_t, got_t) and torch.equal(
        ref.lengths.cpu(), lens.cpu()))
    rep["greedy_gaps"] = gaps
    rep["ok"]["greedy"] = all(g is None or g < NEAR_TIE for g in gaps)
    # a check that a wrong row or slot mapping could pass needs clips
    # that decode differently
    rep["ok"]["greedy_clips_differ"] = B < 2 or len(
        {tuple(t) for t in ref_t}) > 1
    steps = int((ref.lengths - P).sum())
    rep["ms_per_token"] = {"single": 1e3 * t_single / max(steps, 1),
                           "mesh": 1e3 * t_mesh / max(steps, 1),
                           "tokens": steps}
    arrays.update(enc=enc_s.cpu().numpy(), logits=logits_s.cpu().numpy(),
                  tokens=got_t, lengths=lens.cpu().numpy(),
                  ref_tokens=ref_t)

    # a dp-only mesh keeps every weight whole (the clips repeated until
    # they split over its dp)
    dpm = make_mesh(tp=1)
    reps = mesh_shape(dpm)["dp"] // math.gcd(B, mesh_shape(dpm)["dp"])
    enc_dp = gather_dp(encode(shard_params(params, dpm, shard_tp=False),
                              shard_batch(mel.repeat(reps, 1, 1), dpm), cfg),
                       dpm)[:B]
    rep["dp_only_enc_max_err"] = float((enc_dp - enc_ref).abs().max())
    rep["ok"]["dp_only"] = rep["dp_only_enc_max_err"] <= a.tol * float(
        enc_ref.abs().max())
    arrays["dp_only_enc"] = enc_dp.cpu().numpy()

    # serving on the mesh: slots over dp, every rank the same calls
    eng = WhisperApr(cfg, params, specials=fitted_specials(cfg),
                     compute=ComputeConfig(), device=dev)
    clips = [serve_clip(i, a.clip_samples)
             for i in range(a.requests or (a.slots or shape["dp"]) + 1)]
    n_slots = a.slots or shape["dp"]

    def serve(m):
        sched = BatchScheduler(eng, n_slots=n_slots, mesh=m,
                               max_len=a.sched_len)
        ids = [sched.submit(c, "en", max_tokens=a.sched_tokens)
               for c in clips]
        sched.run_until_drained()
        return [sched.result(i) for i in ids], sched
    _sync(dev)
    t0 = time.perf_counter()
    done, sched = serve(mesh)
    _sync(dev)
    rep["serve_seconds"] = time.perf_counter() - t0
    single, _ = serve(None)
    rep["completions"] = [None if c is None else c.tokens for c in done]
    rep["single_completions"] = [c.tokens for c in single]
    rep["ok"]["served"] = all(c is not None and c.status == "ok"
                              for c in done)
    rep["serve_exact"] = rep["completions"] == rep["single_completions"]
    rep["serve_gaps"] = [None if c is None else _serve_gap(eng, x, w, c)
                         for x, w, c in zip(clips, rep["single_completions"],
                                            rep["completions"])]
    rep["ok"]["serve_equal"] = all(g is None or g < NEAR_TIE
                                   for g in rep["serve_gaps"])
    rep["ok"]["serve_clips_differ"] = len(clips) < 2 or len(
        {tuple(c) for c in rep["single_completions"]}) > 1
    rep["serve_stats"] = {k: v for k, v in sched.stats().items()
                          if isinstance(v, (int, float))}

    if a.refusals:
        # a cancel that only rank 0 saw (one queued, one in flight) acts
        # on every rank at once: the same statuses and tokens everywhere
        sched = BatchScheduler(eng, n_slots=n_slots, mesh=mesh,
                               max_len=a.sched_len)
        ids = [sched.submit(c, "en", max_tokens=a.sched_tokens)
               for c in clips]
        rank0 = dist.get_rank() == 0
        if rank0:
            sched.cancel(ids[0])
        sched.step()
        if rank0:
            sched.cancel(ids[1])
        sched.run_until_drained()
        rep["cancel_one_rank"] = [(sched.result(i).status,
                                   sched.result(i).tokens) for i in ids]
        err = rep["errors"]
        err["start"] = _error(sched.start)
        odd = dataclasses.replace(cfg, n_vocab=cfg.n_vocab + 1)
        if shape["tp"] > 1:
            err["odd_vocab"] = _error(lambda: shard_params(
                init_params(odd, seed=SEED), mesh))
        err["quantized"] = _error(lambda: shard_params(
            quantize_params(params, "int8"), mesh))
        err["paged"] = _error(lambda: BatchScheduler(
            eng, n_slots=n_slots, mesh=mesh, paged=True))
        if shape["dp"] > 1:
            err["slots_dp"] = _error(lambda: BatchScheduler(
                eng, n_slots=shape["dp"] + 1, mesh=mesh))
        if shape["tp"] > 1:
            err["kernel_path"] = _error(
                lambda: qdecode.prepare_qdecode(sp, cfg))
            err["flash"] = _error(lambda: encode(
                sp, shard_batch(mel, mesh), cfg, use_flash=True))


def run_multihost(a, rep: dict, arrays: dict) -> None:
    import torch
    from ..model.decoder import decoder_forward
    from ..model.encoder import encode
    from ..model.params import init_params, to_device
    from .distributed import (host_local_batch_to_global, make_multihost_mesh,
                              process_slice, ranks_per_host, shard_params)
    from .mesh import mesh_shape

    import torch.distributed as dist
    dev = torch.device(a.device)
    cfg = named_config(a.config)
    rep["ranks_per_host"] = ranks_per_host()
    rep["errors"]["tp_not_dividing"] = _error(
        lambda: make_multihost_mesh(tp=ranks_per_host() + 1))
    whole = to_device(init_params(cfg, seed=0), dev)
    host = dist.get_rank() // ranks_per_host()
    rng = np.random.default_rng(100 + host)
    mel_local = rng.normal(size=(a.clips, 2 * cfg.n_audio_ctx,
                                 cfg.n_mels)).astype(np.float32)
    tok_local = rng.integers(0, cfg.n_vocab, size=(a.clips, 8))
    rep["host"] = host
    # the tp mesh asked for, then a dp-only one (each host's rows split
    # over its ranks)
    for tp in dict.fromkeys((a.tp, 1)):
        mesh = make_multihost_mesh(tp=tp)
        params = shard_params(whole, mesh)
        mel = host_local_batch_to_global(mel_local, mesh, device=dev)
        tokens = host_local_batch_to_global(tok_local, mesh, device=dev)
        logits = decoder_forward(params, tokens, encode(params, mel, cfg),
                                 cfg)
        local = process_slice(torch.argmax(logits[:, -1], dim=-1))
        rep[f"mesh_tp{tp}"] = mesh_shape(mesh)
        rep[f"shard_rows_tp{tp}"] = int(mel.shape[0])
        rep["ok"][f"rows_tp{tp}"] = len(local) == a.clips
        arrays[f"local_tp{tp}"] = local


def rank_main(a) -> int:
    import torch
    from .distributed import init_distributed
    if a.device == "cpu":
        torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{a.port}", a.n, a.rank,
                     local_device_count=a.per_host, backend=_backend(a),
                     timeout_s=a.timeout)
    cases, arrays = [], {}
    for i, (config, tp) in enumerate(a.case or [(a.config, a.tp)]):
        rep = {"rank": a.rank, "job": a.job, "config": config, "tp": tp,
               "ok": {}, "errors": {}}
        out: dict = {}
        t0 = time.perf_counter()
        with torch.inference_mode():
            (run_mesh if a.job == "mesh" else run_multihost)(
                argparse.Namespace(**{**vars(a), "config": config,
                                      "tp": tp}), rep, out)
        rep["seconds"] = time.perf_counter() - t0
        cases.append(rep)
        arrays.update({f"{i}/{k}": v for k, v in out.items()})
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    out_dir = Path(a.out)
    np.savez(out_dir / f"rank{a.rank}.npz", **arrays)
    (out_dir / f"rank{a.rank}.json").write_text(json.dumps(
        {"rank": a.rank, "cases": cases}))
    return 0


def _backend(a) -> str:
    """``--backend``, else the one that follows ``--device``."""
    import torch
    if a.backend:
        return a.backend
    return "nccl" if torch.device(a.device).type == "cuda" else "gloo"


def _case(text: str):
    config, tp = text.rsplit(":", 1)
    return config, int(tp)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--job", choices=("mesh", "multihost"), default="mesh")
    p.add_argument("--n", type=int, default=4, help="ranks")
    p.add_argument("--tp", type=int, default=2)
    p.add_argument("--per-host", type=int, default=None,
                   help="ranks per host (init_distributed's "
                        "local_device_count)")
    p.add_argument("--backend", default=None,
                   help="nccl or gloo (default: nccl on cuda, gloo on cpu)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default="small")
    p.add_argument("--case", action="append", type=_case, default=None,
                   metavar="CONFIG:TP",
                   help="run these (config, tp) cases one after another "
                        "in the same ranks (default: --config, --tp)")
    p.add_argument("--clips", type=int, default=None,
                   help="greedy batch (default: one clip a rank)")
    p.add_argument("--max-len", type=int, default=12)
    p.add_argument("--tf-tokens", type=int, default=5,
                   help="teacher-forced tokens a clip")
    p.add_argument("--tol", type=float, default=1e-5,
                   help="logit error over the largest magnitude")
    p.add_argument("--slots", type=int, default=0,
                   help="scheduler slots (default dp)")
    p.add_argument("--requests", type=int, default=0,
                   help="scheduler requests (default slots + 1)")
    p.add_argument("--clip-samples", type=int, default=2000)
    p.add_argument("--sched-len", type=int, default=16)
    p.add_argument("--sched-tokens", type=int, default=4)
    p.add_argument("--refusals", action="store_true")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--out", default="build/dryrun")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--rank", type=int, default=None)
    a = p.parse_args(argv)
    from ..ops.dispatch import resolve_device
    resolve_device(a.device, "parallel.dryrun")
    if a.clips is None:
        a.clips = a.n
    return a


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    a = parse_args(argv)
    if a.rank is not None:
        return rank_main(a)
    for case in launch(argv):
        for rep in case:
            rep.pop("arrays")
            rep.pop("log")
            print(json.dumps(rep))
    print(f"dryrun OK: {a.n} ranks, job {a.job}, tp={a.tp}, "
          f"backend {_backend(a)}, device {a.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
