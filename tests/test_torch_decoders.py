"""The port's logits-tail decoders against the JAX package, at a small
width on the CPU: K9's plain version, the scan step ``decode_step_q``,
greedy decoding in its plain, scan and timestamp-rules branches, the
timestamp rules, beam search, sampling and the fallback gates; and the
row-chunk helper that lets the kernels take more than 32 rows.

Weights come from the JAX package's seeded ``init_params`` and cross
through ``from_jax_params``; inputs are numpy draws handed to both. The
JAX Pallas kernels run in interpret mode (``qdecode.INTERPRET``), as the
JAX package's own tests run them on the CPU. Compute is f32 unless a test
says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.inference import beam as jbeam
from whisper_apr_tpu.inference import sampling as jsamp
from whisper_apr_tpu.inference import timestamp_rules as jtsr
from whisper_apr_tpu.model import decoder as jdec
from whisper_apr_tpu.model import qdecode as jqd
from whisper_apr_tpu.model.params import init_params, quantize_params
from whisper_apr_tpu.ops.qmatvec import ffn_fused as j_ffn_fused
from whisper_apr_tpu_torch.inference import beam as tbeam
from whisper_apr_tpu_torch.inference import sampling as tsamp
from whisper_apr_tpu_torch.inference import timestamp_rules as ttsr
from whisper_apr_tpu_torch.model import decoder as tdec
from whisper_apr_tpu_torch.model import qdecode as tqd
from whisper_apr_tpu_torch.model.params import from_jax_params
from whisper_apr_tpu_torch.ops import _build
from whisper_apr_tpu_torch.ops import decode_blocks as tdb
from whisper_apr_tpu_torch.ops import qmatvec as tqm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

EOT = 550              # below the timestamps, as in Whisper's vocabularies
TS_BASE = 560


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
def qds(cfg, params):
    jp, tp = params
    return jqd.prepare_qdecode(jp, cfg), tqd.prepare_qdecode(tp, cfg)


@pytest.fixture(scope="module")
def enc(cfg):
    rng = np.random.default_rng(0)
    return rng.normal(0, 0.5, (2, cfg.n_audio_ctx,
                                cfg.n_text_state)).astype(np.float32)


@pytest.fixture
def interpret():
    jqd.INTERPRET = True
    yield
    jqd.INTERPRET = False


class TestFfnFused:
    @pytest.mark.parametrize("M", [1, 3, 9])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_matches_jax(self, params, qds, M, dtype):
        """K9's plain version against the JAX kernel in interpret mode,
        both errors relative to the largest magnitude of the (unscaled,
        O(100)) fc2 sums: f32 within 1e-5 (summation order); bf16 within
        2^-5 (the GELU output and the fc2 sum are rounded to bf16 on both
        sides, their f32 sums taken in another order)."""
        jq, tq = qds
        blk = tq["blk"]
        x = np.random.default_rng(M).normal(0, 1, (M, 128)).astype(np.float32)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        for layer in (0, 2):
            want = j_ffn_fused(jnp.asarray(x, jdt), jq["ffn"]["w1"],
                               jq["ffn"]["s1"], jq["ffn"]["b1"],
                               jq["ffn"]["w2"], layer, interpret=True)
            got = tqm.ffn_fused(torch.from_numpy(x).to(tdt), blk["w1"],
                                blk["s1"], blk["b1"], blk["w2"], layer)
            assert got.dtype == tdt and got.shape == (M, 128)
            w = np.asarray(want.astype(jnp.float32))
            g = got.float().numpy()
            tol = 1e-5 if dtype == "float32" else 2 ** -5
            assert np.abs(g - w).max() <= tol * np.abs(w).max()

    def test_fc2_scale_is_the_callers(self, qds):
        """The kernel's output is the UNSCALED fc2 sum: with unit fc2
        scales and zero bias the K3 block minus its residual equals K9
        of the LayerNorm output."""
        _, tq = qds
        blk = dict(tq["blk"])
        blk["fc2_s"] = torch.ones_like(blk["fc2_s"])
        blk["fc2_b"] = torch.zeros_like(blk["fc2_b"])
        x = torch.from_numpy(np.random.default_rng(5).normal(
            0, 1, (2, 128)).astype(np.float32))
        from whisper_apr_tpu_torch.ops.basic import layer_norm
        h = layer_norm(x, blk["ln3_w"][1], blk["ln3_b"][1])
        y = tqm.ffn_fused(h, blk["w1"], blk["s1"], blk["b1"], blk["w2"], 1)
        torch.testing.assert_close(tdb.ffn_block_plain(x, blk, 1) - x, y,
                                   rtol=1e-5, atol=1e-5)


def _prefilled(cfg, params, enc, prompt):
    jp, tp = params
    jc = jdec.init_cache(jp, jnp.asarray(enc), cfg, max_len=16)
    _, jc = jdec.prefill(jp, jnp.asarray(prompt), jnp.asarray(enc), jc, cfg)
    tc = tdec.init_cache(tp, torch.from_numpy(enc), cfg, max_len=16)
    _, tc = tdec.prefill(tp, torch.from_numpy(prompt).long(),
                         torch.from_numpy(enc), tc, cfg)
    return jc, tc


class TestDecodeStepQ:
    @pytest.mark.parametrize("per_row", [False, True])
    def test_matches_jax(self, cfg, params, qds, enc, interpret, per_row):
        """Two steps at B = 2, one position for both rows or one per row:
        logits within 1e-4 (f32, summation order), the written cache rows
        within 1e-5."""
        jp, tp = params
        jq, tq = qds
        prompt = np.array([[697, 696, 7], [697, 696, 9]], np.int32)
        jc, tc = _prefilled(cfg, params, enc, prompt)
        tok = np.array([11, 12], np.int32)
        for step in range(2):
            pos = np.array([3 + step, 5 + step], np.int32) if per_row \
                else 3 + step
            jl, jc = jqd.decode_step_q(jp, jq, jnp.asarray(tok),
                                       jnp.asarray(pos), jc, cfg,
                                       compute_dtype=jnp.float32)
            tl, tc = tqd.decode_step_q(tp, tq, torch.from_numpy(tok),
                                       torch.as_tensor(pos), tc, cfg,
                                       compute_dtype=torch.float32)
            assert tl.shape == (2, cfg.n_vocab) and tl.dtype == torch.float32
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                       atol=1e-4)
            tok = np.asarray(jl).argmax(-1).astype(np.int32)
        np.testing.assert_allclose(tc.self_k.numpy(), np.asarray(jc.self_k),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc.self_v.numpy(), np.asarray(jc.self_v),
                                   rtol=1e-5, atol=1e-5)

    def test_kquant_qd_raises(self, cfg, params, qds, enc):
        """A k-quant qd serves the fused step at B = 1 only: at B = 2 it
        raises, as the JAX step does (B > 1 decodes over the int8
        transcode)."""
        _, tp = params
        _, tq = qds
        _, tc = _prefilled(cfg, params, enc, np.array([[1, 2]] * 2, np.int32))
        assert not tqd.qf_supported(dict(tq, mode="q4k"), 2)
        with pytest.raises(NotImplementedError, match="B=1 only"):
            tqd.decode_step_qf(tp, dict(tq, mode="q4k"),
                               torch.tensor([1, 2], dtype=torch.int32), 2,
                               tqd.quantize_cache(tc, "bf16"), cfg)


class TestPlainSteps:
    def test_decode_step_matches_jax(self, cfg, params, enc):
        """The plain f32 step on f32 weights: logits within 1e-4."""
        jp = init_params(cfg, seed=3)
        tp = from_jax_params(jp)
        prompt = np.array([[697, 696, 7], [697, 696, 9]], np.int32)
        jc, tc = _prefilled(cfg, (jp, tp), enc, prompt)
        tok = np.array([11, 12], np.int32)
        jl, jc = jdec.decode_step(jp, jnp.asarray(tok), jnp.int32(3), jc, cfg)
        tl, tc = tdec.decode_step(tp, torch.from_numpy(tok), 3, tc, cfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(tc.self_k.numpy(), np.asarray(jc.self_k),
                                   rtol=1e-5, atol=1e-5)

    def test_decoder_forward_matches_jax_and_the_cache(self, cfg, params,
                                                       enc):
        """Teacher-forced logits within 1e-4 of JAX's, and the cached
        steps give the forward's last row (the KV-cache oracle)."""
        jp, tp = params
        toks = np.array([[697, 696, 7, 40, 41]] * 2, np.int32)
        want = jdec.decoder_forward(jp, jnp.asarray(toks), jnp.asarray(enc),
                                    cfg)
        got = tdec.decoder_forward(tp, torch.from_numpy(toks).long(),
                                   torch.from_numpy(enc), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
        _, tc = _prefilled(cfg, params, enc, toks[:, :4])
        last, _ = tdec.decode_step(tp, torch.from_numpy(toks[:, 4]), 4, tc,
                                   cfg)
        torch.testing.assert_close(last, got[:, 4], rtol=1e-5, atol=1e-4)


def _greedy_both(cfg, jp, tp, jq, tq, enc, qf_mode, ts_base=-1, B=2):
    prompt = np.array([[697, 696, 7]] * B, np.int32)
    bias = np.zeros(cfg.n_vocab, np.float32)
    bias[[3, 17]] = -np.inf
    want = jdec.greedy_generate_body(
        jp, jnp.asarray(enc[:B]), jnp.asarray(prompt), jnp.asarray(bias), EOT,
        cfg, max_len=12, prompt_len=3, timestamp_base=ts_base, no_speech=5,
        qd=jq, qf_mode=qf_mode, fidelity=True)
    got = tdec.greedy_generate_body(
        tp, torch.from_numpy(enc[:B]), torch.from_numpy(prompt).long(),
        torch.from_numpy(bias), EOT, cfg, max_len=12, prompt_len=3,
        timestamp_base=ts_base, no_speech=5, qd=tq, qf_mode=qf_mode)
    return want, got


def _same_decode(want, got, lp_tol=1e-4):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    np.testing.assert_allclose(got.sum_logprob.numpy(),
                               np.asarray(want.sum_logprob), rtol=0,
                               atol=lp_tol)
    np.testing.assert_allclose(got.no_speech_prob.numpy(),
                               np.asarray(want.no_speech_prob), rtol=0,
                               atol=1e-5)


class TestGreedyBranches:
    """greedy_generate_body token-exact against JAX (B = 2, 9 steps):
    sum_logprob within 1e-4, no_speech_prob within 1e-5."""

    def test_without_qd(self, cfg, enc):
        jp = init_params(cfg, seed=3)
        want, got = _greedy_both(cfg, jp, from_jax_params(jp), None, None,
                                 enc, None)
        _same_decode(want, got)

    def test_scan_step(self, cfg, params, qds, enc, interpret):
        want, got = _greedy_both(cfg, *params, *qds, enc, None)
        _same_decode(want, got)

    def test_logits_tail_with_timestamp_rules(self, cfg, params, qds, enc,
                                              interpret):
        want, got = _greedy_both(cfg, *params, *qds, enc, "cross8",
                                 ts_base=TS_BASE)
        _same_decode(want, got)
        first = got.tokens[:, 3]
        assert bool((first >= TS_BASE).all())          # rule 1

    def test_timestamps_skip_the_fused_head(self, cfg, params, qds, enc,
                                            monkeypatch):
        """With timestamp rules the fused step ends in the logits tail K8,
        never the greedy head K4."""
        calls = {"head": 0}
        real = tqm.qmatvec_greedy_head

        def spy(*a):
            calls["head"] += 1
            return real(*a)
        monkeypatch.setattr(tqm, "qmatvec_greedy_head", spy)
        _, tp = params
        tdec.greedy_generate_body(
            tp, torch.from_numpy(enc[:1]), torch.tensor([[697, 696, 7]]),
            torch.zeros(cfg.n_vocab), EOT, cfg, max_len=8, prompt_len=3,
            timestamp_base=TS_BASE, qd=qds[1], qf_mode="cross8")
        assert calls["head"] == 0


def _ts_case(seed: int, B: int = 6, V: int = 700):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (B, V)).astype(np.float32)
    logits[:, TS_BASE:] += rng.normal(0, 3, (B, 1)).astype(np.float32)
    logits[0, 40] = -np.inf                        # a suppressed id
    state = dict(
        last_was_ts=rng.random(B) < 0.5, penult_was_ts=rng.random(B) < 0.5,
        max_ts=np.where(rng.random(B) < 0.7,
                        rng.integers(TS_BASE, V, B), 0).astype(np.int32),
        n_sampled=rng.integers(0, 4, B).astype(np.int32))
    is_first = rng.random(B) < 0.3
    return logits, state, is_first


class TestTimestampRules:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_apply_rules_exact(self, seed):
        """Masked logits equal JAX's exactly, the -inf of two summed
        masks included (no clamp)."""
        logits, st, first = _ts_case(seed)
        want = jtsr.apply_rules(jnp.asarray(logits), jtsr.TimestampState(
            **{k: jnp.asarray(v) for k, v in st.items()}), TS_BASE, EOT,
            is_first=jnp.asarray(first))
        got = ttsr.apply_rules(torch.from_numpy(logits), ttsr.TimestampState(
            **{k: torch.from_numpy(v) for k, v in st.items()}), TS_BASE, EOT,
            is_first=torch.from_numpy(first))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_two_masks_sum_to_minus_inf(self):
        logits = np.zeros((1, 700), np.float32)
        st = ttsr.init_state(1)
        st = st._replace(last_was_ts=torch.tensor([True]),
                         n_sampled=torch.tensor([5], dtype=torch.int32))
        got = ttsr.apply_rules(torch.from_numpy(logits), st, TS_BASE, EOT,
                               is_first=torch.tensor([True]))
        assert got[0, 10] == float("-inf")          # rule 1 + rule 2a

    def test_update_state_exact(self):
        _, st, _ = _ts_case(7)
        tok = np.array([5, TS_BASE, TS_BASE + 9, EOT, 699, TS_BASE + 1],
                       np.int32)
        want = jtsr.update_state(jtsr.TimestampState(
            **{k: jnp.asarray(v) for k, v in st.items()}), jnp.asarray(tok),
            TS_BASE)
        got = ttsr.update_state(ttsr.TimestampState(
            **{k: torch.from_numpy(v) for k, v in st.items()}),
            torch.from_numpy(tok), TS_BASE)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _beam_both(cfg, jp, tp, jq, tq, enc, qf_mode, K=3, nbest=True):
    prompt = np.array([[697, 696, 7]] * 2, np.int32)
    bias = np.zeros(cfg.n_vocab, np.float32)
    bias[[3, 17]] = -np.inf
    want = jbeam.beam_generate(
        jp, jnp.asarray(enc), jnp.asarray(prompt), jnp.asarray(bias), EOT,
        cfg, beam_size=K, max_len=12, prompt_len=3, fidelity=True,
        return_nbest=nbest, no_speech=5, qd=jq, qf_mode=qf_mode)
    got = tbeam.beam_generate(
        tp, torch.from_numpy(enc), torch.from_numpy(prompt).long(),
        torch.from_numpy(bias), EOT, cfg, beam_size=K, max_len=12,
        prompt_len=3, return_nbest=nbest, no_speech=5, qd=tq,
        qf_mode=qf_mode)
    return want, got


class TestBeam:
    """beam_generate at B = 2, K = 3 token-exact against JAX: every beam
    of the n-best list in order, its length; scores within 1e-4."""

    @pytest.mark.parametrize("qf_mode", [None, "cross8"])
    def test_nbest_matches_jax(self, cfg, params, qds, enc, interpret,
                               qf_mode):
        want, got = _beam_both(cfg, *params, *qds, enc, qf_mode)
        assert got.tokens.shape == (2, 3, 12)
        _same_decode(want, got)

    def test_best_matches_jax(self, cfg, params, qds, enc, interpret):
        want, got = _beam_both(cfg, *params, *qds, enc, "cross8",
                               nbest=False)
        assert got.tokens.shape == (2, 12)
        _same_decode(want, got)

    @pytest.mark.parametrize("qf_mode", [None, "cross8"])
    def test_beam_one_is_greedy(self, cfg, params, qds, enc, qf_mode):
        _, tp = params
        prompt = torch.tensor([[697, 696, 7]] * 2)
        bias = torch.zeros(cfg.n_vocab)
        g = tdec.greedy_generate_body(
            tp, torch.from_numpy(enc), prompt, bias, EOT, cfg, max_len=12,
            prompt_len=3, qd=qds[1], qf_mode=qf_mode)
        b = tbeam.beam_generate(
            tp, torch.from_numpy(enc), prompt, bias, EOT, cfg, beam_size=1,
            max_len=12, prompt_len=3, qd=qds[1], qf_mode=qf_mode)
        assert torch.equal(b.tokens, g.tokens)
        assert torch.equal(b.lengths, g.lengths)


class TestSampling:
    def _run(self, cfg, params, qds, enc, **kw):
        _, tp = params
        seed = kw.pop("seed", 0)
        gen = torch.Generator().manual_seed(seed)
        return tsamp.sample_generate(
            tp, torch.from_numpy(enc), torch.tensor([[697, 696, 7]] * 2),
            torch.zeros(cfg.n_vocab), EOT, gen, cfg, max_len=12,
            prompt_len=3, qd=qds[1], qf_mode="cross8", **kw)

    @pytest.mark.parametrize("kw", [dict(temperature=0.0),
                                    dict(temperature=0.8, top_k=1)])
    def test_greedy_limits(self, cfg, params, qds, enc, kw):
        """Temperature 0, or top_k = 1 at any temperature, is greedy."""
        _, tp = params
        g = tdec.greedy_generate_body(
            tp, torch.from_numpy(enc), torch.tensor([[697, 696, 7]] * 2),
            torch.zeros(cfg.n_vocab), EOT, cfg, max_len=12, prompt_len=3,
            qd=qds[1], qf_mode="cross8")
        s = self._run(cfg, params, qds, enc, **kw)
        assert torch.equal(s.tokens, g.tokens)

    def test_same_seed_same_tokens(self, cfg, params, qds, enc):
        kw = dict(temperature=1.5, top_k=40, top_p=0.9)
        a = self._run(cfg, params, qds, enc, seed=7, **kw)
        b = self._run(cfg, params, qds, enc, seed=7, **kw)
        assert torch.equal(a.tokens, b.tokens)
        assert torch.equal(a.sum_logprob, b.sum_logprob)

    @pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.9),
                                             (40, 0.5), (None, None)])
    def test_candidate_mask_matches_jax(self, monkeypatch, top_k, top_p):
        """The candidate set after top-k / top-p equals JAX's on the same
        logits, exactly; the log-prob is of the unscaled logits."""
        logits = np.random.default_rng(3).normal(0, 2, (4, 700)).astype(
            np.float32)
        logits[:, 10] = -np.inf
        seen = {}

        def spy(key, scaled, axis=-1):
            seen["scaled"] = np.asarray(scaled)
            return jnp.zeros(scaled.shape[0], jnp.int32)
        monkeypatch.setattr(jax.random, "categorical", spy)
        _, j_lp = jsamp._pick(jnp.asarray(logits), jax.random.PRNGKey(0),
                              0.7, top_k, top_p)
        got = tsamp.candidates(torch.from_numpy(logits), 0.7, top_k, top_p)
        np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                      np.isfinite(seen["scaled"]))
        _, t_lp = tsamp._pick(torch.from_numpy(logits), None, 0.0, None,
                              None)
        lp0 = torch.log_softmax(torch.from_numpy(logits), -1)[:, 0]
        np.testing.assert_allclose(np.asarray(j_lp), lp0.numpy(), rtol=0,
                                   atol=1e-6)
        assert t_lp.shape == (4,)


class TestGates:
    CASES = [("", -0.5, 0, None, 0.0), ("abc " * 40, -0.2, 30, None, 0.1),
             ("a quick test", -1.7, 5, None, 0.2),
             ("hello there", -0.3, 4, list(range(3)) * 12, 0.1),
             ("hello there", -2.0, 4, None, 0.9)]

    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_host_gates_match_jax(self, case):
        text, lp, n, toks, ns = self.CASES[case]
        assert tsamp.compression_ratio(text) == jsamp.compression_ratio(text)
        assert tsamp.avg_logprob(lp * 3, n) == jsamp.avg_logprob(lp * 3, n)
        if toks is not None:
            assert tsamp.token_entropy(toks) == jsamp.token_entropy(toks)
        kw = dict(entropy_thold=2.4, tokens=toks, no_speech_prob=ns,
                  no_speech_thold=0.6)
        assert tsamp.needs_fallback(text, lp, n, **kw) == \
            jsamp.needs_fallback(text, lp, n, **kw)
        assert tsamp.is_silence(ns, lp) == jsamp.is_silence(ns, lp)


class TestRowChunks:
    """The wrappers' row chunking, with the plain versions standing in for
    the kernels: each chunk of at most 32 rows reads and writes views of
    the whole batch's tensors, and the result equals one call over every
    row."""

    @pytest.mark.parametrize("B", [33, 40])
    def test_chunks_cover_the_rows(self, B):
        seen = []
        _build.in_row_chunks(B, seen.append)
        assert [(s.start, s.stop) for s in seen] == \
            [(0, 32), (32, B)]

    @pytest.mark.parametrize("B", [33, 40])
    def test_slot_blocks(self, qds, B):
        blk = qds[1]["blk"]
        g = torch.Generator().manual_seed(B)
        L, T, D = 3, 20, 128
        x = torch.randn((B, D), generator=g)
        kq, vq = (torch.randn((L, B, T, D), generator=g) for _ in range(2))
        from whisper_apr_tpu_torch.ops.decode_attention import quantize_rows
        (kq, ks), (vq, vs) = quantize_rows(kq), quantize_rows(vq)
        pos = torch.randint(0, T, (B,), generator=g, dtype=torch.int32)
        whole = tdb.self_block_plain(x, blk, kq, ks, vq, vs, pos, 1, 4)
        outs = [torch.empty_like(t) for t in whole]
        cross = torch.empty_like(x)
        ffn = torch.empty_like(x)

        def launch(rows):
            part = tdb.self_block_plain(x[rows], blk, kq[:, rows],
                                        ks[:, rows], vq[:, rows],
                                        vs[:, rows], pos[rows], 1, 4)
            for o, p in zip(outs, part):
                o[rows] = p
            cross[rows] = tdb.cross_block_plain(
                x[rows], blk, kq[:, rows], ks[:, rows], vq[:, rows],
                vs[:, rows], 17, 2, 4)
            ffn[rows] = tdb.ffn_block_plain(x[rows], blk, 0)
        _build.in_row_chunks(B, launch)
        # f32 within 1e-5 (the int8 rows and scales exactly): a matmul
        # over 32 rows blocks its sums unlike one over B rows
        for o, w in zip(outs, whole):
            torch.testing.assert_close(o, w, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(
            cross, tdb.cross_block_plain(x, blk, kq, ks, vq, vs, 17, 2, 4),
            rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ffn, tdb.ffn_block_plain(x, blk, 0),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("B", [33, 40])
    def test_row_matvecs(self, qds, B):
        tq = qds[1]
        blk = tq["blk"]
        x = torch.randn((B, 128), generator=torch.Generator().manual_seed(B))
        bias = torch.zeros((1, tq["vocab_qT"].shape[2]))
        stacked, ffn = torch.empty((B, 384)), torch.empty((B, 128))
        head = [torch.empty(B, dtype=torch.int32), torch.empty(B),
                torch.empty(B)]

        def launch(rows):
            stacked[rows] = tqm.qmatvec_stacked_plain(x[rows], blk["wqkv"],
                                                      blk["sqkv"], 2)
            ffn[rows] = tqm.ffn_fused_plain(x[rows], blk["w1"], blk["s1"],
                                            blk["b1"], blk["w2"], 1)
            for o, p in zip(head, tqm.qmatvec_greedy_head_plain(
                    x[rows], tq["vocab_qT"], bias, 700)):
                o[rows] = p
        _build.in_row_chunks(B, launch)

        def close(got, want):
            # f32 within 1e-5 of the largest magnitude: a matmul over 32
            # rows blocks its sums unlike one over B rows
            assert (got - want).abs().max() <= 1e-5 * want.abs().max()
        close(stacked, tqm.qmatvec_stacked(x, blk["wqkv"], blk["sqkv"], 2))
        close(ffn, tqm.ffn_fused(x, blk["w1"], blk["s1"], blk["b1"],
                                 blk["w2"], 1))
        tok, mx, lse = tqm.qmatvec_greedy_head(x, tq["vocab_qT"], bias, 700)
        assert torch.equal(head[0], tok)
        close(head[1], mx)
        close(head[2], lse)
