"""The port's multi-host layer (``parallel/distributed.py``) against the
JAX package: the counterpart of ``tests/test_distributed.py``.

One launch of four gloo ranks on the CPU (``parallel/dryrun.py``, job
``multihost``) stands for two hosts of two ranks each
(``init_distributed(local_device_count=2)``). Each host feeds its own
rows (``host_local_batch_to_global``) through the sharded encoder,
decoder and argmax on ``make_multihost_mesh(tp=2)``, then on a dp-only
mesh, and gets its rows back (``process_slice``). Every rank's slice must
equal JAX's next tokens for the same global batch. The ranks import no
JAX.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.model.decoder import decoder_forward
from whisper_apr_tpu.model.encoder import encode
from whisper_apr_tpu.model.params import init_params
from whisper_apr_tpu_torch.parallel import dryrun

N_RANKS, PER_HOST, TP, ROWS = 4, 2, 2, 4
CFG = ModelConfig(
    model_type="tiny", n_vocab=512, n_audio_ctx=32, n_audio_state=64,
    n_audio_head=4, n_audio_layer=2, n_text_ctx=16, n_text_state=64,
    n_text_head=4, n_text_layer=2, n_mels=80)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    torch.set_num_threads(1)
    return dryrun.launch([
        "--job", "multihost", "--device", "cpu", "--n", str(N_RANKS),
        "--per-host",
        str(PER_HOST), "--tp", str(TP), "--clips", str(ROWS),
        "--config", json.dumps(dataclasses.asdict(CFG)),
        "--out", str(tmp_path_factory.mktemp("multihost"))], timeout=240)[0]


@pytest.fixture(scope="module")
def want():
    """JAX's single-process next tokens over the global batch: host h's
    rows from default_rng(100 + h), hosts in order (distributed_worker)."""
    params = init_params(CFG, seed=0)
    mels, toks = [], []
    for host in range(N_RANKS // PER_HOST):
        rng = np.random.default_rng(100 + host)
        mels.append(rng.normal(size=(ROWS, 2 * CFG.n_audio_ctx,
                                     CFG.n_mels)).astype(np.float32))
        toks.append(rng.integers(0, CFG.n_vocab, size=(ROWS, 8)).astype(
            np.int32))
    enc = encode(params, jnp.asarray(np.concatenate(mels)), CFG)
    logits = decoder_forward(params, jnp.asarray(np.concatenate(toks)), enc,
                             CFG)
    return np.asarray(jnp.argmax(logits[:, -1], axis=-1))


def test_every_rank_passed(ranks):
    """The two-process DCN test's contract: every rank completes."""
    assert len(ranks) == N_RANKS
    for r in ranks:
        assert r["ok"] == {"rows_tp2": True, "rows_tp1": True}


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_multihost_mesh(ranks, rank):
    """make_multihost_mesh keeps tp inside a host: (dp 2, tp 2) over two
    hosts of two; a dp-only mesh has four dp shards; a tp that does not
    divide the ranks of a host is refused."""
    r = ranks[rank]
    assert r["ranks_per_host"] == PER_HOST and r["host"] == rank // PER_HOST
    assert r["mesh_tp2"] == {"dp": 2, "tp": 2}
    assert r["mesh_tp1"] == {"dp": 4, "tp": 1}
    assert r["errors"]["tp_not_dividing"] == \
        "tp=3 does not divide local devices 2"


@pytest.mark.parametrize("rank", range(N_RANKS))
def test_host_local_batch_to_global(ranks, rank):
    """A host's rows form one dp shard under tp=2 and split over its two
    ranks under tp=1."""
    r = ranks[rank]
    assert r["shard_rows_tp2"] == ROWS
    assert r["shard_rows_tp1"] == ROWS // PER_HOST


@pytest.mark.parametrize("tp", [2, 1])
@pytest.mark.parametrize("rank", range(N_RANKS))
def test_process_slice_equals_jax(ranks, want, rank, tp):
    """test_two_process_dcn_pipeline_step: each rank's process_slice is
    its host's rows of JAX's next tokens for the same global batch, once
    per dp shard even where tp replicates them."""
    host = rank // PER_HOST
    got = ranks[rank]["arrays"][f"local_tp{tp}"]
    assert got.shape == (ROWS,)
    assert np.array_equal(got, want[host * ROWS: (host + 1) * ROWS]), \
        (got, want)
