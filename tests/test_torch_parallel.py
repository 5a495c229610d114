"""The port's mesh path (``parallel/mesh.py``, ``ops/tp.py``, serving on a
mesh) against the JAX package: the counterpart of ``tests/test_parallel.py``
and of ``__graft_entry__.dryrun_multichip``.

One launch of four gloo ranks on the CPU (``parallel/dryrun.py``, dp=2 x
tp=2, ``small_config()`` widths, the weights redrawn by
``dryrun.redraw``) runs every check at once; each rank reports its
outputs, and the tests below
hold them against the JAX package's unsharded functions, run here in the
test process on the same numpy weights and inputs. The ranks import no
JAX.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import small_config
from whisper_apr_tpu.audio.mel import MelFilterbank
from whisper_apr_tpu.config import ComputeConfig
from whisper_apr_tpu.engine import WhisperApr as JWhisperApr
from whisper_apr_tpu.model.decoder import decoder_forward, greedy_generate
from whisper_apr_tpu.model.encoder import encode
from whisper_apr_tpu.parallel.mesh import param_specs as j_param_specs
from whisper_apr_tpu.parallel.serving import BatchScheduler as JScheduler
from whisper_apr_tpu.tokenizer import SpecialTokens
from whisper_apr_tpu_torch.config import ModelConfig as TModelConfig
from whisper_apr_tpu_torch.model.params import init_params as t_init_params
from whisper_apr_tpu_torch.ops.tp import (TPGroup, TPShard, local_config,
                                          require_unsharded)
from whisper_apr_tpu_torch.parallel import dryrun
from whisper_apr_tpu_torch.parallel.mesh import param_specs, split_axis

N_RANKS, TP, GAIN, SEED = 4, 2, dryrun.GAIN, dryrun.SEED
CLIPS, MAX_LEN, TF = 4, 12, 5


@pytest.fixture(scope="module")
def cfg():
    return small_config()


def _tree_np(t):
    if isinstance(t, dict):
        return {k: _tree_np(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def weights(cfg):
    """The ranks' weights: the port's seeded init_params (the JAX
    package's draws) with the weights redrawn, as numpy."""
    tcfg = TModelConfig(**dataclasses.asdict(cfg))
    return _tree_np(dryrun.redraw(t_init_params(tcfg, seed=SEED), GAIN, SEED))


@pytest.fixture(scope="module")
def jparams(weights):
    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        return jnp.asarray(t)
    return to_jax(weights)


@pytest.fixture(scope="module")
def ranks(cfg, tmp_path_factory):
    """One launch of four ranks: every check of the module."""
    torch.set_num_threads(1)
    return dryrun.launch([
        "--job", "mesh", "--n", str(N_RANKS), "--tp", str(TP),
        "--device", "cpu", "--config", json.dumps(dataclasses.asdict(cfg)),
        "--clips", str(CLIPS), "--max-len", str(MAX_LEN),
        "--tf-tokens", str(TF), "--refusals",
        "--out", str(tmp_path_factory.mktemp("mesh"))], timeout=240)[0]


@pytest.fixture(scope="module")
def inputs(cfg):
    """The ranks' inputs (``dryrun.mesh_inputs``)."""
    return dryrun.mesh_inputs(cfg, CLIPS, TF)


@pytest.fixture(scope="module")
def jax_ref(cfg, jparams, inputs):
    mel, tf = inputs
    enc = encode(jparams, jnp.asarray(mel), cfg)
    logits = decoder_forward(jparams, jnp.asarray(tf, jnp.int32), enc, cfg)
    toks, lens, _, _ = greedy_generate(
        jparams, enc, jnp.asarray(np.full((CLIPS, 3), 5, np.int32)),
        jnp.zeros(cfg.n_vocab, jnp.float32), eot=cfg.n_vocab - 1,
        config=cfg, max_len=MAX_LEN, prompt_len=3)
    return {"enc": np.asarray(enc), "logits": np.asarray(logits),
            "tokens": np.asarray(toks), "lengths": np.asarray(lens)}


# -- the mesh ------------------------------------------------------------------

def test_every_rank_passed_its_checks(ranks):
    """dryrun_multichip's contract: every rank exits 0 with its checks."""
    assert len(ranks) == N_RANKS
    for r in ranks:
        assert r["ok"] and all(r["ok"].values()), r["ok"]


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_make_mesh_shapes(ranks, rank):
    """test_parallel.TestMesh.test_make_mesh_shapes on 4 ranks."""
    r = ranks[rank]
    assert r["mesh_shapes"] == {"n_tp2": {"dp": 2, "tp": 2},
                                "n_tp1": {"dp": 4, "tp": 1},
                                "default_tp2": {"dp": 2, "tp": 2}}
    assert r["errors"]["mesh_3x2"] == "mesh 3x2 != 4 devices"
    assert "5 devices over 4 ranks" in r["errors"]["mesh_too_big"]


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_make_mesh_subset_of_ranks(ranks, rank):
    """test_make_mesh_subset_of_visible_devices: a mesh of 2 of the 4
    ranks holds those 2; the others are outside it."""
    sub = ranks[rank]["subset"]
    assert sub["shape"] == {"dp": 1, "tp": 2} and sub["size"] == 2
    assert sub["coordinate"] == ([0, rank] if rank < 2 else None)


def test_param_specs_match_jax_tree(weights):
    """test_param_specs_match_tree: the placement tree has the JAX tree's
    structure and the same tp axis at every leaf, with and without tp."""
    for shard_tp in (True, False):
        ours = param_specs(weights, shard_tp=shard_tp)
        theirs = j_param_specs(weights, shard_tp=shard_tp)

        def walk(a, b, path):
            if isinstance(b, dict):
                assert isinstance(a, dict) and set(a) == set(b), path
                for k in b:
                    walk(a[k], b[k], f"{path}.{k}")
                return
            jaxis = next((i for i, s in enumerate(b) if s == "tp"), None)
            assert split_axis(a) == jaxis, (path, a, b)
            assert not a[0].is_shard(), path          # whole over dp
        walk(ours, theirs, "params")
    specs = param_specs(weights)
    assert split_axis(specs["decoder"]["blocks"]["fc1"]["w"]) == 2
    assert split_axis(specs["decoder"]["blocks"]["fc2"]["w"]) == 1
    assert split_axis(specs["decoder"]["token_emb"]) == 0


# -- the sharded forward against JAX's unsharded one ---------------------------

@pytest.mark.parametrize("rank", range(N_RANKS))
def test_sharded_forward_matches_jax(ranks, jax_ref, rank):
    """test_sharded_forward_matches_single: dp=2 x tp=2 encode and
    teacher-forced decoder logits within 1e-5 of the JAX package's
    unsharded ones (every rank holds the whole batch after the dp
    gather)."""
    a = ranks[rank]["arrays"]
    assert a["enc"].shape == jax_ref["enc"].shape
    assert a["logits"].shape == jax_ref["logits"].shape
    np.testing.assert_allclose(a["enc"], jax_ref["enc"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(a["logits"], jax_ref["logits"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_sharded_greedy_matches_jax(ranks, jax_ref, rank):
    """test_sharded_greedy_matches_single: the greedy loop over the
    sharded tree gives JAX's unsharded tokens and lengths, exactly."""
    a = ranks[rank]["arrays"]
    assert np.array_equal(a["tokens"], jax_ref["tokens"])
    assert np.array_equal(a["lengths"], jax_ref["lengths"])
    assert np.array_equal(a["ref_tokens"], jax_ref["tokens"])
    assert ranks[rank]["greedy_exact"]


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_dp_only_mesh(ranks, jax_ref, rank):
    """test_dp_only_mesh: tp=1 keeps every weight whole; the encoder on
    dp shards equals JAX's."""
    r = ranks[rank]
    assert r["dp_only_enc_max_err"] == 0.0
    np.testing.assert_allclose(r["arrays"]["dp_only_enc"], jax_ref["enc"],
                               rtol=0, atol=1e-5)


# -- serving on the mesh ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_completions(cfg, jparams):
    """JAX's single-device BatchScheduler over the same engine and clips
    (dryrun_multichip's: n_slots = dp, dp + 1 requests, max_len 16; the
    dry run's clips)."""
    V = cfg.n_vocab
    specials = SpecialTokens(
        eot=V - 1, sot=V - 2, lang_base=V - 110, transcribe=V - 3,
        no_timestamps=V - 4, timestamp_base=V + 1000,
        is_multilingual=False, translate=V - 5)
    eng = JWhisperApr(cfg, jparams, None, MelFilterbank.create(cfg.n_mels),
                      ComputeConfig(), specials)
    dp = N_RANKS // TP
    sched = JScheduler(eng, n_slots=dp, max_len=16)
    ids = [sched.submit(dryrun.serve_clip(i, 2000), "en", max_tokens=4)
           for i in range(dp + 1)]
    sched.run_until_drained()
    return [sched.result(i).tokens for i in ids]


def test_mesh_scheduler_same_on_every_rank(ranks):
    """The host mirrors cannot drift: every rank completes every request
    with the same tokens."""
    first = ranks[0]["completions"]
    assert len(first) == N_RANKS // TP + 1 and None not in first
    for r in ranks[1:]:
        assert r["completions"] == first


def test_mesh_scheduler_matches_jax(ranks, jax_completions):
    """The mesh scheduler's completions equal JAX's single-device
    BatchScheduler's (and the port's own single-device scheduler's)."""
    assert ranks[0]["completions"] == [list(map(int, c))
                                       for c in jax_completions]
    assert ranks[0]["single_completions"] == ranks[0]["completions"]
    assert ranks[0]["serve_exact"]


def test_mesh_scheduler_agrees_on_a_cancel_one_rank_saw(ranks):
    """Rank 0 alone cancels a queued request and, after a tick, one in
    flight: every rank completes both as cancelled with the same tokens,
    and the third request still decodes its clip's tokens."""
    first = ranks[0]["cancel_one_rank"]
    assert [s for s, _ in first] == ["cancelled", "cancelled", "ok"]
    assert first[0][1] == []
    assert first[2][1] == ranks[0]["completions"][2]
    for r in ranks[1:]:
        assert r["cancel_one_rank"] == first


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_mesh_scheduler_counters(ranks, rank):
    s = ranks[rank]["serve_stats"]
    dp = N_RANKS // TP
    assert s["n_slots"] == dp and s["completed_ok"] == dp + 1
    assert s["admitted"] == dp + 1 and s["active_slots"] == 0


# -- the refusals ------------------------------------------------------------------

@pytest.mark.parametrize("what,text", [
    ("odd_vocab", "token_emb: dim 0 of (1001, 64) does not split over tp=2"),
    ("quantized", "quantized weights do not shard"),
    ("paged", "paged serving is per-device"),
    ("slots_dp", "n_slots=3 not divisible by dp=2"),
    ("kernel_path", "fused decode kernels (K1-K9): whole weights only"),
    ("flash", "flash encoder (K16): whole weights only"),
    ("start", "a mesh is served synchronously"),
])
def test_refusals(ranks, what, text):
    """What JAX refuses, the port refuses with a ValueError: a vocabulary
    tp does not divide (NamedSharding's error), quantized trees, paged
    slots or slots that dp does not divide on a mesh; and the kernel
    paths refuse a sharded tree."""
    for r in ranks:
        assert text in r["errors"][what], r["errors"]


def test_entry_points_default_to_the_card(monkeypatch):
    """The dry run and the value study run on the card unless the caller
    asks for the CPU: without one they raise, as every entry point of the
    port does."""
    from whisper_apr_tpu_torch.tools import spec_study
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: dryrun.parse_args([]),
                lambda: spec_study.main(["--c-full", "1", "--c-vocab", "1"])):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            run()
    assert dryrun._backend(dryrun.parse_args(["--device", "cpu"])) == "gloo"


def test_heads_must_split_over_tp(cfg):
    """A tp that splits the width but not the heads would cut heads in
    two: the local config refuses it."""
    tcfg = TModelConfig(**dataclasses.asdict(cfg))
    q = torch.zeros(2, 64, 64 // 8)
    params = {"decoder": {"blocks": {"self_attn": {
        "q_w": TPShard(q, "col", TPGroup(None, 0, 8), 64)}}}}
    with pytest.raises(ValueError, match="heads do not split over tp=8"):
        local_config(params, tcfg)
    with pytest.raises(ValueError, match="paged step"):
        require_unsharded(params, "the paged step (K15)")
    two = {"decoder": {"blocks": {"self_attn": {
        "q_w": TPShard(torch.zeros(2, 64, 32), "col",
                       TPGroup(None, 1, 2), 64)}}}}
    local = local_config(two, tcfg)
    assert (local.n_text_head, local.n_text_state) == (2, 32)
    assert local_config(two, local) is local          # idempotent
