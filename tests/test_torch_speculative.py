"""The port's speculative decode (``inference/speculative.py``, the
engine's branch, ``tools/spec_study.py``) against the JAX package: the
counterpart of ``tests/test_speculative.py``.

Weights: the JAX test's HF twin, and the streaming tests' engines (the
same twin with every matrix redrawn at std 0.2, so the decode follows the
audio). Both sides run f32 (JAX at ``fidelity=True``, HIGHEST matmuls);
the port's tokens, lengths and round counts must equal JAX's exactly.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_hf_twin, random_mel, small_config
from test_torch_streaming import make_engines
from whisper_apr_tpu.inference.speculative import \
    speculative_greedy_generate as j_spec
from whisper_apr_tpu.model.encoder import encode_jit
from whisper_apr_tpu.model.params import params_from_hf_model
from whisper_apr_tpu_torch import ModelConfig as TModelConfig
from whisper_apr_tpu_torch import TranscribeOptions
from whisper_apr_tpu_torch.inference import speculative as tspec
from whisper_apr_tpu_torch.model.decoder import greedy_generate_body
from whisper_apr_tpu_torch.model.params import from_jax_params
from whisper_apr_tpu_torch.tools import spec_study as t_study

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_LP, ATOL_NS = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return small_config()


@pytest.fixture(scope="module")
def engines(cfg):
    return make_engines(cfg)


@pytest.fixture(scope="module", params=["hf", "std0.2"])
def setup(request, cfg, engines):
    """(JAX params, port params, encoder output [1, S, D] as numpy)."""
    if request.param == "hf":
        jp = params_from_hf_model(make_hf_twin(cfg), cfg)
    else:
        jp = engines[0].params
    enc = encode_jit(jp, jnp.asarray(random_mel(cfg))[:1], cfg,
                     fidelity=True)
    return jp, from_jax_params(jp), np.array(enc)


def _run_both(cfg, setup, bias, k, ld, max_len, no_speech):
    jp, tp, enc = setup
    eot = cfg.n_vocab - 1
    prompt = np.full((1, 3), 5, np.int32)
    j = j_spec(jp, jnp.asarray(enc), jnp.asarray(prompt), jnp.asarray(bias),
               eot=eot, config=cfg, max_len=max_len, prompt_len=3,
               draft_tokens=k, draft_layers=ld, fidelity=True,
               no_speech=no_speech)
    t = tspec.speculative_greedy_generate(
        tp, torch.from_numpy(enc), torch.from_numpy(prompt).long(),
        torch.from_numpy(bias), eot, cfg, max_len=max_len, prompt_len=3,
        draft_tokens=k, draft_layers=ld, no_speech=no_speech)
    plain = greedy_generate_body(
        tp, torch.from_numpy(enc), torch.from_numpy(prompt).long(),
        torch.from_numpy(bias), eot, cfg, max_len=max_len, prompt_len=3)
    return j, t, plain


def _same_as_jax(j, t):
    assert np.array_equal(t.tokens.numpy(), np.asarray(j.tokens)), \
        (t.tokens, np.asarray(j.tokens))
    assert np.array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    assert t.n_verify_passes == int(np.asarray(j.n_verify_passes))
    assert t.n_accepted == int(np.asarray(j.n_accepted))
    np.testing.assert_allclose(t.sum_logprob.numpy(),
                               np.asarray(j.sum_logprob), rtol=0,
                               atol=ATOL_LP)
    np.testing.assert_allclose(t.no_speech_prob.numpy(),
                               np.asarray(j.no_speech_prob), rtol=0,
                               atol=ATOL_NS)


@pytest.mark.parametrize("k,ld", [(2, 1), (4, 1), (3, 2)])
def test_token_exact_vs_jax_and_greedy(cfg, setup, k, ld):
    """test_token_exact_vs_greedy: tokens, lengths, verify passes and
    accepted drafts equal JAX's speculative decode, its log-prob within
    1e-5 and no-speech probability within 1e-6; and the tokens are the
    port's plain greedy's, however poor the draft."""
    bias = np.zeros(cfg.n_vocab, np.float32)
    j, t, plain = _run_both(cfg, setup, bias, k, ld, 24, cfg.n_vocab - 10)
    _same_as_jax(j, t)
    assert torch.equal(t.tokens, plain.tokens)
    assert torch.equal(t.lengths, plain.lengths)
    assert t.n_verify_passes > 0
    np.testing.assert_allclose(t.sum_logprob.numpy(),
                               plain.sum_logprob.numpy(), rtol=0, atol=1e-4)


def test_full_depth_draft_accepts_everything(cfg, setup):
    """test_full_depth_draft_accepts_everything: a draft of every layer
    is the full model, so every round accepts all k drafts."""
    bias = np.zeros(cfg.n_vocab, np.float32)
    bias[cfg.n_vocab - 1] = np.finfo(np.float32).min
    k = 3
    j, t, plain = _run_both(cfg, setup, bias, k, cfg.n_text_layer, 30, -1)
    _same_as_jax(j, t)
    assert t.n_verify_passes > 0
    assert t.n_accepted == t.n_verify_passes * k
    assert torch.equal(t.tokens, plain.tokens)


def test_batch_of_two_is_refused(cfg, setup):
    _, tp, enc = setup
    two = torch.from_numpy(np.concatenate([enc, enc]))
    with pytest.raises(ValueError, match="single-stream"):
        tspec.speculative_greedy_generate(
            tp, two, torch.full((2, 3), 5), torch.zeros(cfg.n_vocab),
            cfg.n_vocab - 1, cfg, max_len=12, prompt_len=3)


# -- the engine -------------------------------------------------------------------

def _audio(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 0.1, 4000).astype(
        np.float32)


@pytest.mark.parametrize("draft_tokens,draft_layers",
                         [(3, 0), (4, 1), (2, 2)])
def test_engine_speculative_matches_plain_and_jax(engines, draft_tokens,
                                                  draft_layers):
    """test_engine_speculative_matches_plain and _gate_metrics: the
    engine's speculative transcription gives plain greedy's tokens and
    text, the JAX engine's speculative tokens, and the quality-gate
    signals (average log-prob, no-speech probability) of both."""
    from whisper_apr_tpu.engine import TranscribeOptions as JOptions
    jeng, teng = engines
    audio = _audio(9)
    kw = dict(language="en", max_tokens=12)
    spec_kw = dict(speculative=True, draft_tokens=draft_tokens,
                   draft_layers=draft_layers)
    plain = teng.transcribe(audio, TranscribeOptions(**kw))
    spec = teng.transcribe(audio, TranscribeOptions(**kw, **spec_kw))
    jspec = jeng.transcribe(audio, JOptions(**kw, **spec_kw))
    assert spec.tokens == plain.tokens
    assert spec.text == plain.text
    assert spec.tokens == list(jspec.tokens)
    assert spec.text == jspec.text
    assert len(spec.segments) == len(jspec.segments)
    assert spec.avg_logprob != 0.0
    assert abs(spec.avg_logprob - jspec.avg_logprob) < ATOL_LP
    assert abs(spec.avg_logprob - plain.avg_logprob) < 1e-4
    assert abs(spec.no_speech_prob - jspec.no_speech_prob) < ATOL_NS
    assert abs(spec.no_speech_prob - plain.no_speech_prob) < ATOL_NS


@pytest.fixture
def spy(monkeypatch):
    """Counts calls of the speculative decode."""
    calls = []
    real = tspec.speculative_greedy_generate

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tspec, "speculative_greedy_generate", counted)
    return calls


def test_engine_speculative_runs_the_speculative_path(engines, spy):
    _, teng = engines
    teng.transcribe(_audio(11), TranscribeOptions(
        language="en", max_tokens=12, speculative=True))
    assert spy == [1]


@pytest.mark.parametrize("case", ["two_clips", "timestamps", "temperature",
                                  "beam"])
def test_engine_falls_through_to_plain(engines, spy, case):
    """What JAX's gate sends to the plain strategies goes there here
    too: two clips, timestamps, a temperature above 0, another strategy.
    Results equal the same options without ``speculative``."""
    _, teng = engines
    kw = dict(language="en", max_tokens=12)
    clips = [_audio(9)]
    if case == "two_clips":
        clips = [_audio(9), _audio(10)]
    elif case == "timestamps":
        kw["timestamps"] = True
    elif case == "temperature":
        kw.update(temperature=0.7, seed=3)
    else:
        kw.update(strategy="beam", beam_size=2)
    plain = teng.transcribe_batch(clips, TranscribeOptions(**kw))
    spec = teng.transcribe_batch(clips, TranscribeOptions(
        **kw, speculative=True))
    assert spy == []
    assert [r.tokens for r in spec.results] == \
        [r.tokens for r in plain.results]
    assert [r.avg_logprob for r in spec.results] == \
        [r.avg_logprob for r in plain.results]


# -- the value study ----------------------------------------------------------------

@pytest.fixture(scope="module")
def j_study():
    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    try:
        import spec_study
    finally:
        sys.path.pop(0)
    return spec_study


@pytest.fixture(scope="module")
def study_cfg():
    from whisper_apr_tpu.config import ModelConfig
    return ModelConfig(
        model_type="tiny", n_vocab=256, n_audio_ctx=16, n_audio_state=64,
        n_audio_head=4, n_audio_layer=1, n_text_ctx=32, n_text_state=64,
        n_text_head=4, n_text_layer=4, n_mels=80)


@pytest.mark.parametrize("gamma", [1.0, 0.05])
def test_spec_study_acceptance_equals_jax(j_study, study_cfg, gamma):
    """The port's tool measures the JAX tool's acceptance at its test
    configuration (same seeded weights, same damping, same clips)."""
    import dataclasses
    tcfg = TModelConfig(**dataclasses.asdict(study_cfg))
    want = j_study.measure_acceptance(
        study_cfg, j_study.structured_params(study_cfg, gamma, 1), 3, 1,
        n_clips=2, max_len=24)
    got = t_study.measure_acceptance(
        tcfg, t_study.structured_params(tcfg, gamma, 1), 3, 1, n_clips=2,
        max_len=24, device="cpu")
    assert got[0] == pytest.approx(want[0], abs=1e-12)
    assert got[1] == pytest.approx(want[1], abs=1e-12)


def test_spec_study_acceptance_rises_with_structure(study_cfg):
    """test_spec_study_acceptance_rises_with_structure, on the port's
    tool: acceptance grows as the late layers matter less."""
    import dataclasses
    tcfg = TModelConfig(**dataclasses.asdict(study_cfg))
    e_flat, _ = t_study.measure_acceptance(
        tcfg, t_study.structured_params(tcfg, 1.0, 1), 3, 1, n_clips=2,
        max_len=24, device="cpu")
    e_struct, _ = t_study.measure_acceptance(
        tcfg, t_study.structured_params(tcfg, 0.05, 1), 3, 1, n_clips=2,
        max_len=24, device="cpu")
    assert e_struct >= e_flat - 0.2, (e_flat, e_struct)
    assert e_struct > 1.0


def test_spec_study_cost_model_takes_measured_costs(j_study):
    """The cost model is the JAX tool's, with the step costs as required
    arguments (no device's figures built in)."""
    import inspect
    for args in ((2.5, 4, 8, 2, 1.2, 0.1), (1.0, 3, 32, 8, 0.4, 0.02)):
        assert t_study.net_ms_per_token(*args) == pytest.approx(
            j_study.net_ms_per_token(*args))
    params = inspect.signature(t_study.net_ms_per_token).parameters
    assert params["c_full"].default is inspect.Parameter.empty
    assert params["c_vocab"].default is inspect.Parameter.empty


def test_spec_study_main_prints_its_table(capsys):
    assert t_study.main(["--c-full", "1.0", "--c-vocab", "0.05",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("L=8 draft_layers=2 draft_tokens=4 c_full=1.0")
    assert len(out) == 2 + 5 and "ms/tok" in out[1]
