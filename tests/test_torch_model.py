"""The port's model path against the JAX package, at a small width, B=1:
log-mel, encoder, prefill, cache quantization, the fused decode step, and
greedy transcription as a whole.

Weights come from the JAX package's seeded ``init_params`` and cross
through ``from_jax_params``; inputs are numpy draws handed to both. The
JAX Pallas kernels run in interpret mode (``qdecode.INTERPRET``), as the
JAX package's own tests run them on the CPU. Compute is f32 on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_apr_tpu.audio.mel import MelFilterbank as JMel
from whisper_apr_tpu.audio.mel import log_mel_body as j_log_mel
from whisper_apr_tpu.config import HOP_LENGTH, N_FFT, ModelConfig
from whisper_apr_tpu.inference.processors import WhisperTokenSuppressor
from whisper_apr_tpu.model import decoder as jdec
from whisper_apr_tpu.model import qdecode as jqd
from whisper_apr_tpu.model.encoder import encode as j_encode
from whisper_apr_tpu.model.params import init_params, quantize_params
from whisper_apr_tpu.pipeline import fused_transcribe_step
from whisper_apr_tpu.tokenizer import SpecialTokens
from whisper_apr_tpu_torch import ComputeConfig as TCompute
from whisper_apr_tpu_torch import TranscribeOptions, WhisperApr
from whisper_apr_tpu_torch.audio.mel import MelFilterbank as TMel
from whisper_apr_tpu_torch.audio.mel import log_mel_body as t_log_mel
from whisper_apr_tpu_torch.model import decoder as tdec
from whisper_apr_tpu_torch.model import qdecode as tqd
from whisper_apr_tpu_torch.model.encoder import encode as t_encode
from whisper_apr_tpu_torch.model.params import from_jax_params
from whisper_apr_tpu_torch.model.params import init_params as t_init_params
from whisper_apr_tpu_torch.model.params import \
    quantize_params as t_quantize_params
from whisper_apr_tpu_torch.tokenizer import SpecialTokens as TSpecials


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return ModelConfig(
        model_type="tiny", n_vocab=700, n_audio_ctx=32, n_audio_state=128,
        n_audio_head=4, n_audio_layer=2, n_text_ctx=24, n_text_state=128,
        n_text_head=4, n_text_layer=3, n_mels=80)


@pytest.fixture(scope="module")
def params(cfg):
    jp = quantize_params(init_params(cfg, seed=3), "int8")
    return jp, from_jax_params(jp)


@pytest.fixture(scope="module")
def enc(cfg):
    rng = np.random.default_rng(0)
    return rng.normal(0, 0.5, (1, cfg.n_audio_ctx,
                                cfg.n_text_state)).astype(np.float32)


def _audio(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + rng.normal(0, 0.05, n)).astype(np.float32)


class TestParams:
    def test_init_params_same_draws(self, cfg):
        """The port's init_params draws the same numbers in the same order."""
        j = init_params(cfg, seed=5)
        t = t_init_params(cfg, seed=5)
        fj = from_jax_params(j)

        def walk(a, b):
            if isinstance(a, dict):
                assert a.keys() == b.keys()
                for k in a:
                    walk(a[k], b[k])
            else:
                assert torch.equal(a, b)
        walk(fj, t)

    def test_quantize_params_same_bytes(self, cfg, params):
        jp, tp = params
        tq = t_quantize_params(t_init_params(cfg, seed=3), "int8")
        for a, b in ((tp["decoder"]["token_emb"], tq["decoder"]["token_emb"]),
                     (tp["decoder"]["blocks"]["fc1"]["w"],
                      tq["decoder"]["blocks"]["fc1"]["w"]),
                     (tp["encoder"]["blocks"]["attn"]["q_w"],
                      tq["encoder"]["blocks"]["attn"]["q_w"])):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)

    def test_prepare_qdecode_operands_match(self, cfg, params):
        jp, tp = params
        j = jqd.prepare_qdecode(jp, cfg)
        t = tqd.prepare_qdecode(tp, cfg)
        for k, v in j["blk"].items():
            np.testing.assert_array_equal(t["blk"][k].numpy(), np.asarray(v))
        np.testing.assert_array_equal(t["vocab_qT"].numpy(),
                                      np.asarray(j["vocab_qT"]))
        np.testing.assert_array_equal(t["vocab_k_scale"].numpy(),
                                      np.asarray(j["vocab_k_scale"]))

    def test_per_tensor_embedding_scale_broadcasts(self, cfg, params):
        """An int8 .apr carries one scale per tensor; the vocab K-side
        scale broadcasts it over D."""
        _, tp = params
        emb = tp["decoder"]["token_emb"]
        tp2 = dict(tp, decoder=dict(tp["decoder"]))
        tp2["decoder"]["token_emb"] = type(emb)(emb.q, torch.tensor(0.25))
        ks = tqd.prepare_qdecode(tp2, cfg)["vocab_k_scale"]
        assert ks.shape == (1, cfg.n_text_state)
        assert torch.all(ks == 0.25)


class TestFrontEnd:
    def test_log_mel_body(self):
        """f32 on both sides; noise-like audio, as bench.py feeds (a
        strong pure tone leaves bins eight decades down, where the GEMMs'
        summation order shows at the 2e-5 level)."""
        audio = np.random.default_rng(1).normal(0, 0.1, 16_000).astype(
            np.float32)
        fb = JMel.create(80)
        a = j_log_mel(jnp.asarray(audio), fb._window, fb._basis,
                      fb._filters_t, N_FFT, HOP_LENGTH)
        b = t_log_mel(torch.from_numpy(audio), *TMel.create(80).constants("cpu"),
                      N_FFT, HOP_LENGTH)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5,
                                   rtol=0)

    def test_encode(self, cfg, params):
        jp, tp = params
        mel = np.random.default_rng(2).normal(
            size=(1, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32)
        a = j_encode(jp, jnp.asarray(mel), cfg)
        b = t_encode(tp, torch.from_numpy(mel), cfg)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4,
                                   rtol=0)


@pytest.fixture(scope="module")
def prefilled(cfg, params, enc):
    jp, tp = params
    prompt = np.array([[697, 696, 7]], np.int32)
    jc = jdec.init_cache(jp, jnp.asarray(enc), cfg, max_len=cfg.n_text_ctx)
    jl, jc = jdec.prefill(jp, jnp.asarray(prompt), jnp.asarray(enc), jc, cfg,
                          all_logits=True)
    tc = tdec.init_cache(tp, torch.from_numpy(enc), cfg,
                         max_len=cfg.n_text_ctx)
    tl, tc = tdec.prefill(tp, torch.from_numpy(prompt).long(),
                          torch.from_numpy(enc), tc, cfg, all_logits=True)
    return (jl, jc), (tl, tc)


class TestPrefill:
    def test_logits_and_cache(self, prefilled):
        (jl, jc), (tl, tc) = prefilled
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        for a, b in zip(jc, tc):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4,
                                       rtol=0)

    def test_out_of_range_token_raises(self, cfg, params, enc):
        from whisper_apr_tpu_torch.errors import InferenceError
        _, tp = params
        tc = tdec.init_cache(tp, torch.from_numpy(enc), cfg, max_len=8)
        with pytest.raises(InferenceError, match="out of range"):
            tdec.prefill(tp, torch.tensor([[1, cfg.n_vocab]]),
                         torch.from_numpy(enc), tc, cfg)


class TestQuantizeCache:
    @pytest.mark.parametrize("mode", tqd.QF_MODES)
    def test_rows_and_scales(self, prefilled, mode):
        """Same input cache to both: padding to 256 / 512 rows; int8,
        fp8 and float rows exact; row scales within 1e-7."""
        (_, jc), _ = prefilled
        a = jqd.quantize_cache(jc, mode=mode)
        b = tqd.quantize_cache(tdec.KVCache(
            *(torch.from_numpy(np.array(t)) for t in jc)), mode=mode)
        assert b.self_kq.shape[2] == 256 and b.cross_kq.shape[2] == 512
        for x, y in zip(a, b):
            if x is None:
                assert y is None
                continue
            xa = np.asarray(x)
            assert tuple(y.shape) == xa.shape
            if xa.dtype == np.int8:
                np.testing.assert_array_equal(y.numpy(), xa)
            elif y.dtype == torch.float8_e4m3fn:
                np.testing.assert_array_equal(
                    y.view(torch.uint8).numpy(), xa.view(np.uint8))
            elif y.dtype == torch.float32 and y.shape[-1] == 1:   # scales
                np.testing.assert_allclose(y.numpy(), xa, rtol=1e-7,
                                           atol=0)
            else:
                np.testing.assert_array_equal(y.numpy(), xa)


class TestDecodeStep:
    def test_three_steps_match_jax(self, cfg, params, prefilled):
        """decode_step_qf with the fused head, cross8 cache, 3 steps:
        tokens exact, max / logsumexp within 1e-5, written rows alike."""
        jp, tp = params
        (_, jc), (_, tc) = prefilled
        jq, tq = jqd.prepare_qdecode(jp, cfg), tqd.prepare_qdecode(tp, cfg)
        a = jqd.quantize_cache(jc, mode="cross8")
        b = tqd.quantize_cache(tc, mode="cross8")
        gb = np.zeros((1, 768), np.float32)
        gb[0, [3, 17, 123]] = -np.inf
        tok = np.array([9], np.int32)
        for step in range(3):
            pos = 3 + step
            (ja, jm, jl), a = jqd.decode_step_qf(
                jp, jq, jnp.asarray(tok), jnp.int32(pos), a, cfg,
                compute_dtype=jnp.float32, interpret=True,
                greedy_bias=jnp.asarray(gb))
            (tb, tm, tl), b = tqd.decode_step_qf(
                tp, tq, torch.from_numpy(tok), pos, b, cfg,
                compute_dtype=torch.float32, greedy_bias=torch.from_numpy(gb))
            assert int(tb[0]) == int(np.asarray(ja)[0])
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=1e-5, atol=1e-5)
            tok = np.asarray(ja).astype(np.int32)
        np.testing.assert_allclose(b.self_kq.numpy(), np.asarray(a.self_kq),
                                   rtol=1e-5, atol=1e-5)

    def test_rows_written_after_the_layer_loop(self, cfg, params, prefilled,
                                               monkeypatch):
        """Deferred writes: every layer's self_block sees the cache as it
        was before the step, and the rows land at ``pos`` afterwards."""
        from whisper_apr_tpu_torch.ops import decode_blocks as tdb
        _, tp = params
        (_, _), (_, tc) = prefilled
        tq = tqd.prepare_qdecode(tp, cfg)
        b = tqd.quantize_cache(tc, mode="int8")
        before = b.self_kq.clone()
        seen, rows = [], []
        real = tdb.self_block

        def spy(x, blk, kq, *rest):
            seen.append(torch.equal(kq, before))
            out = real(x, blk, kq, *rest)
            rows.append(out[1])
            return out
        monkeypatch.setattr(tdb, "self_block", spy)
        gb = torch.zeros((1, 768))
        tqd.decode_step_qf(tp, tq, torch.tensor([9], dtype=torch.int32), 5,
                           b, cfg, compute_dtype=torch.float32,
                           greedy_bias=gb)
        assert seen == [True] * cfg.n_text_layer
        assert torch.equal(b.self_kq[:, 0, 5], torch.cat(rows))
        assert torch.equal(b.self_kq[:, :, :5], before[:, :, :5])

    def test_vocab_scale_folds_into_x_in_f32(self, cfg, params, prefilled,
                                             monkeypatch):
        """bf16 step: the head gets (LN(x).float() * k_scale) cast to bf16."""
        from whisper_apr_tpu_torch.ops import basic, qmatvec
        _, tp = params
        (_, _), (_, tc) = prefilled
        tq = tqd.prepare_qdecode(tp, cfg)
        tcb = tdec.KVCache(*(t.to(torch.bfloat16) for t in tc))
        b = tqd.quantize_cache(tcb, mode="cross8")
        got = {}
        real_ln, real_head = basic.layer_norm, qmatvec.qmatvec_greedy_head

        def ln_spy(x, w, bias, eps=basic.LN_EPS):
            got["ln"] = real_ln(x, w, bias, eps)
            return got["ln"]

        def head_spy(xs, wq, bias, n_vocab):
            got["xs"] = xs
            return real_head(xs, wq, bias, n_vocab)
        monkeypatch.setattr(tqd, "layer_norm", ln_spy)
        monkeypatch.setattr(qmatvec, "qmatvec_greedy_head", head_spy)
        tqd.decode_step_qf(tp, tq, torch.tensor([9], dtype=torch.int32), 3,
                           b, cfg, compute_dtype=torch.bfloat16,
                           greedy_bias=torch.zeros((1, 768)))
        want = (got["ln"].float() * tq["vocab_k_scale"]).to(torch.bfloat16)
        assert got["xs"].dtype == torch.bfloat16
        assert torch.equal(got["xs"], want)

    def test_batch_rows_match_single_row_steps(self, cfg, params,
                                               prefilled):
        """decode_step_qf at B = 2 (the batched sub-blocks) gives each row
        what a B = 1 step (K1-K3) gives it: same token, max and
        logsumexp, and the same rows written."""
        _, tp = params
        (_, _), (_, tc) = prefilled
        tq = tqd.prepare_qdecode(tp, cfg)
        gb = torch.zeros((1, 768))
        one = tqd.quantize_cache(tc, mode="int8")
        two = tqd.quantize_cache(tdec.KVCache(*(t.repeat(1, 2, 1, 1)
                                                for t in tc)), mode="int8")
        tok = torch.tensor([9, 9], dtype=torch.int32)
        (t2, m2, z2), two = tqd.decode_step_qf(
            tp, tq, tok, 3, two, cfg, compute_dtype=torch.float32,
            greedy_bias=gb)
        (t1, m1, z1), one = tqd.decode_step_qf(
            tp, tq, tok[:1], 3, one, cfg, compute_dtype=torch.float32,
            greedy_bias=gb)
        assert t2.tolist() == [int(t1[0])] * 2
        for a, b in ((m2, m1), (z2, z1)):
            torch.testing.assert_close(a, b.expand(2), rtol=1e-6, atol=1e-6)
        for r in range(2):
            assert torch.equal(two.self_kq[:, r, 3], one.self_kq[:, 0, 3])


def _specials(cfg, cls):
    V = cfg.n_vocab
    return cls(eot=V - 1, sot=V - 2, lang_base=V - 110, transcribe=V - 3,
               no_timestamps=V - 4, timestamp_base=V + 1000,
               is_multilingual=False, translate=V - 5, no_speech=V - 6,
               speaker_turn=V - 7, prev=V - 8)


class TestWholeSlice:
    def test_transcribe_matches_fused_transcribe_step(self, cfg, params):
        """WhisperApr(device="cpu").transcribe against the JAX
        fused_transcribe_step on prepare_qdecode params, kv mode cross8,
        f32, same seeded audio: identical tokens and lengths,
        sum_logprob within 1e-4, no_speech_prob within 1e-5."""
        jp, tp = params
        audio = _audio(8_000, seed=4)
        eng = WhisperApr(cfg, tp, specials=_specials(cfg, TSpecials),
                         compute=TCompute(quantization="int8",
                                          compute_dtype="float32"),
                         device="cpu")
        res = eng.transcribe(audio, TranscribeOptions(language="en"))

        sp = _specials(cfg, SpecialTokens)
        prompt = [sp.sot, sp.transcribe, sp.no_timestamps]
        bias = WhisperTokenSuppressor(True, cfg.n_vocab, tokens=sp).bias()
        fb = JMel.create(cfg.n_mels)
        batch = np.zeros((1, 2 * cfg.n_audio_ctx * 160), np.float32)
        batch[0, : audio.size] = audio
        jqd.INTERPRET = True
        try:
            ref = fused_transcribe_step(
                jp, jnp.asarray(batch), fb._window, fb._basis,
                fb._filters_t, jnp.asarray(np.array([prompt], np.int32)),
                jnp.asarray(bias), sp.eot, cfg, max_len=cfg.n_text_ctx,
                prompt_len=len(prompt), compute_dtype=jnp.float32,
                fidelity=True, no_speech=sp.no_speech,
                qd=jqd.prepare_qdecode(jp, cfg), qf_mode="cross8")
        finally:
            jqd.INTERPRET = False
        n = int(np.asarray(ref.lengths)[0])
        assert res.tokens == np.asarray(ref.tokens)[0, :n].tolist()
        gen = max(n - len(prompt), 1)
        np.testing.assert_allclose(res.avg_logprob * gen,
                                   float(np.asarray(ref.sum_logprob)[0]),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(res.no_speech_prob,
                                   float(np.asarray(ref.no_speech_prob)[0]),
                                   rtol=0, atol=1e-5)
        assert res.no_speech_prob > 0

    def test_decode_result_semantics(self, cfg, params, enc):
        """EOT-padded tokens with the EOT appended and lengths counting it:
        a suppression bias that leaves only EOT ends the decode at once."""
        _, tp = params
        tq = tqd.prepare_qdecode(tp, cfg)
        eot = cfg.n_vocab - 1
        bias = torch.full((cfg.n_vocab,), float("-inf"))
        bias[eot] = 0.0
        res = tdec.greedy_generate_body(
            tp, torch.from_numpy(enc), torch.tensor([[5, 6]]), bias, eot,
            cfg, max_len=12, prompt_len=2, qd=tq, qf_mode="cross8")
        assert res.tokens[0].tolist() == [5, 6] + [eot] * 10
        assert int(res.lengths[0]) == 3
        assert float(res.sum_logprob[0]) == pytest.approx(0.0, abs=1e-6)

    @pytest.mark.parametrize("opts,slice_", [
        pytest.param(dict(hotwords=["a"]), None, id="opts0-slice 3b"),
        pytest.param(dict(speculative=True), None, id="opts1-slice 3b"),
        pytest.param(dict(word_timestamps=True), None,
                     id="opts2-queue 1, item 5"),
    ])
    def test_later_slices_raise(self, cfg, params, opts, slice_):
        """Hotwords, speculative decoding and word timestamps, once
        refused here, now decode (their parity with JAX:
        tests/test_torch_hotwords.py, test_torch_speculative.py,
        test_torch_alignment.py)."""
        _, tp = params
        eng = WhisperApr(cfg, tp, specials=_specials(cfg, TSpecials),
                         device="cpu")
        opts = TranscribeOptions(language="en", max_tokens=8, **opts)
        if slice_ is not None:
            with pytest.raises(NotImplementedError, match=slice_):
                eng.transcribe(np.zeros(1600, np.float32), opts)
            return
        res = eng.transcribe(np.zeros(1600, np.float32), opts)
        assert len(res.tokens) > len(eng.get_initial_tokens("en"))
        if opts.word_timestamps:
            assert res.words and all(0 <= w.start <= w.end <= 0.1 + 1e-9
                                     for w in res.words)

    def test_batch_of_two_matches_single_clips(self, cfg, params):
        """transcribe_batch of two clips (one aligned decode at B = 2)
        gives each clip the tokens ``transcribe`` gives it alone."""
        _, tp = params
        eng = WhisperApr(cfg, tp, specials=_specials(cfg, TSpecials),
                         compute=TCompute(quantization="int8",
                                          compute_dtype="float32"),
                         device="cpu")
        opts = TranscribeOptions(language="en")
        audios = [_audio(8_000, seed=4), _audio(12_000, seed=9)]
        res = eng.transcribe_batch(audios, opts)
        assert len(res) == 2
        for r, a in zip(res.results, audios):
            alone = eng.transcribe(a, opts)
            assert r.tokens == alone.tokens
            assert r.avg_logprob == pytest.approx(alone.avg_logprob,
                                                  abs=1e-5)

    def test_cuda_device_required_by_default(self, cfg, params, monkeypatch):
        _, tp = params
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            WhisperApr(cfg, tp, specials=_specials(cfg, TSpecials))
