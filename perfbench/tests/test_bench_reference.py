"""The reference agrees with the port's plain f32 path at tiny widths:
log-mel, encoder and teacher-forced logits over the same int8 weights."""

import numpy as np
import pytest
import torch

from perfbench import port, traffic, weights
from perfbench.reference.whisper import Whisper, fp8_rows, full_f32
from perfbench.tests import tiny


@pytest.fixture(scope="module")
def both():
    from whisper_apr_tpu_torch.audio.mel import MelFilterbank
    from whisper_apr_tpu_torch.model.decoder import decoder_forward
    from whisper_apr_tpu_torch.model.encoder import encode
    from whisper_apr_tpu_torch.pipeline import _batch_mel
    d = tiny.dims()
    w = weights.draw(d, 2 ** 33 + 1, "cpu")
    params, cfg = port.port_params(w, d), port.model_config(d)
    audio = traffic.recording(9, 25.0, "cpu")[16000:]
    padded = np.zeros((1, 480000), np.float32)
    padded[0, : len(audio)] = audio
    mel = _batch_mel(torch.from_numpy(padded),
                     *MelFilterbank.create(80).constants("cpu"), cfg)
    enc = encode(params, mel, cfg, torch.float32)
    toks = torch.tensor([[50258, 50259, 50359, 50363, 11, 4000, 220, 9]])
    logits = decoder_forward(params, toks, enc, cfg, torch.float32)
    ref = Whisper(w, d.d_model, d.heads, d.n_mels)
    with torch.no_grad(), full_f32():
        r_mel = ref.log_mel(audio)
        r_enc = ref.encode(r_mel[None])
        r_logits = ref.logits(r_enc, toks)
    return dict(mel=(mel[0], r_mel), enc=(enc, r_enc),
                logits=(logits, r_logits), d=d)


def test_mel(both):
    p, r = both["mel"]
    assert p.shape == r.shape == (3000, 80)
    assert float((p - r).abs().max()) < 1e-4
    assert float(r[-2:].max()) == -1.0          # frames past the audio


def test_encoder(both):
    p, r = both["enc"]
    assert float((p - r).abs().max() / r.abs().max()) < 1e-5


def test_logits(both):
    p, r = both["logits"]
    assert float((p - r).abs().max()) < 1e-4
    assert float(r[0, :, both["d"].eot].abs().max()) == 0.0   # eot's row
    assert float(r[0, :, : both["d"].sot].max(dim=-1).values.min()) > 0.0


def test_fp8_rows_rounds_coarser_than_bf16():
    x = torch.randn(64, 256)
    e8 = float(((fp8_rows(x) - x) / x.abs().amax(-1, keepdim=True)).abs()
               .max())
    e16 = float(((x.bfloat16().float() - x) / x.abs().amax(-1, keepdim=True))
                .abs().max())
    assert e8 > 4 * e16
