"""The port's opt-in kernels against the JAX package's, at a small width on
the CPU: the plain versions of K16 (flash attention), K17 (int8 matmul)
and K18 (int4 matmul) against the JAX Pallas kernels in interpret mode,
the flash encoder and engine, the kernel selector, and the routing of
``basic.linear`` with the opt-in switches.

Inputs are made with numpy from fixed seeds and handed to both packages.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from whisper_apr_tpu.config import ComputeConfig as JCompute
from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.engine import WhisperApr as JWhisperApr
from whisper_apr_tpu.model.encoder import encode as jencode
from whisper_apr_tpu.model.params import init_params
from whisper_apr_tpu.ops import dispatch as jdispatch
from whisper_apr_tpu.ops import flash_attention as jfa
from whisper_apr_tpu.ops import int4_matmul as ji4
from whisper_apr_tpu.ops import int8_matmul as ji8
from whisper_apr_tpu.ops import kquants as jkq
from whisper_apr_tpu.ops import q4k as jq4k
from whisper_apr_tpu.ops import quant as jquant
from whisper_apr_tpu.tokenizer import SpecialTokens
from whisper_apr_tpu_torch import ComputeConfig as TCompute
from whisper_apr_tpu_torch import TranscribeOptions, WhisperApr
from whisper_apr_tpu_torch.model.encoder import encode as tencode
from whisper_apr_tpu_torch.model.params import from_jax_params
from whisper_apr_tpu_torch.ops import basic as tbasic
from whisper_apr_tpu_torch.ops import dispatch as tdispatch
from whisper_apr_tpu_torch.ops import flash_attention as tfa
from whisper_apr_tpu_torch.ops import int4_matmul as ti4
from whisper_apr_tpu_torch.ops import int8_matmul as ti8
from whisper_apr_tpu_torch.ops.quant import dequant, quantize_int8
from whisper_apr_tpu_torch.tokenizer import SpecialTokens as TSpecials

SHAPES = [(4, 64, 96), (130, 256, 250), (1, 384, 512)]
TOL_BF16 = 2.0 ** -6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _qkv(seed, B, H, T, d=64, Tk=None):
    rng = np.random.default_rng(seed)
    Tk = Tk or T
    return (rng.normal(size=(B, H, T, d)).astype(np.float32),
            rng.normal(size=(B, H, Tk, d)).astype(np.float32),
            rng.normal(size=(B, H, Tk, d)).astype(np.float32))


class TestFlashPlain:
    """K16's plain version against the JAX flash kernel (interpret)."""

    @pytest.mark.parametrize("case", ["plain", "causal_128_edge",
                                      "kv_valid"])
    def test_f32_matches_jax(self, case):
        kw = {"plain": {}, "causal_128_edge": dict(causal=True),
              "kv_valid": dict(kv_valid=150)}[case]
        T = 130 if case == "causal_128_edge" else 200
        q, k, v = _qkv(0, 2, 2, T)
        want = np.asarray(jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
            **kw))
        got = tfa.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
        assert np.abs(got - want).max() < 1e-4

    def test_bf16_matches_jax(self):
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _qkv(1, 1, 2, 160))
        j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
             for t in (q, k, v)]
        want = np.asarray(jfa.flash_attention(*j, causal=True,
                                              interpret=True)
                          .astype(jnp.float32))
        got = tfa.flash_attention(q, k, v, causal=True)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err <= TOL_BF16 * np.abs(want).max(), err

    def test_mha_flash_matches_jax(self):
        """Combined heads [B, T, H * 64], the encoder's layout, with a
        scale other than 1."""
        rng = np.random.default_rng(2)
        q, k, v = (rng.normal(size=(2, 70, 128)).astype(np.float32)
                   for _ in range(3))
        want = np.asarray(jfa.mha_flash(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), 2, interpret=True))
        got = tfa.mha_flash(_t(q), _t(k), _t(v), 2).numpy()
        assert np.abs(got - want).max() < 1e-4
        q4, k4, v4 = (_t(a.reshape(2, 70, 2, 64).transpose(0, 2, 1, 3))
                      for a in (q, k, v))
        out = tfa.flash_attention(q4, k4, v4, sm_scale=0.3)
        want = np.asarray(jfa.flash_attention(
            jnp.asarray(q4.numpy()), jnp.asarray(k4.numpy()),
            jnp.asarray(v4.numpy()), sm_scale=0.3, interpret=True))
        assert np.abs(out.numpy() - want).max() < 1e-4

    def test_kv_valid_bounds(self):
        q, k, v = (_t(a) for a in _qkv(3, 1, 1, 8))
        for bad in (0, 9):
            with pytest.raises(ValueError, match="kv_valid"):
                tfa.flash_attention(q, k, v, kv_valid=bad)

    @pytest.mark.parametrize("Tq,Tk,kw", [
        (64, 1, {}), (64, 63, {}), (64, 65, {}), (1, 130, {}),
        (100, 200, {}), (130, 200, dict(kv_valid=128)),
        (130, 200, dict(kv_valid=129)), (70, 200, dict(causal=True))],
        ids=["Tk=1", "Tk=63", "Tk=65", "Tq=1", "Tq=100 Tk=200",
             "kv_valid=128", "kv_valid=129", "causal Tq<Tk"])
    def test_ragged_edges_match_jax(self, Tq, Tk, kw):
        """The edges the CUDA kernel's key ring, split and combine mask:
        one key, a 64-key tile's edge either side, Tq != Tk, kv_valid at a
        tile edge and one past it, causal over fewer rows than keys."""
        q, k, v = _qkv(4, 1, 2, Tq, Tk=Tk)
        want = np.asarray(jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
            **kw))
        got = tfa.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
        assert got.shape == (1, 2, Tq, 64)
        assert np.abs(got - want).max() < 1e-4


class TestFlashSplit:
    """``flash_split``: how the bf16 kernel spreads a (query tile, head)'s
    key tiles over blocks."""

    @pytest.mark.parametrize("B,H,Tq,Tk", [
        (1, 6, 1500, 1500), (4, 6, 1500, 1500), (1, 20, 1500, 1500),
        (4, 20, 1500, 1500), (1, 6, 1, 1500), (1, 6, 100, 1500),
        (1, 6, 448, 448), (1, 20, 448, 448), (1, 6, 64, 1300),
        (1, 1, 64, 1), (1, 1, 64, 63), (1, 1, 64, 65), (2, 2, 70, 200)])
    def test_keys_covered_once_in_whole_tiles(self, B, H, Tq, Tk):
        plan = tfa.flash_split(B, H, Tq, Tk)
        assert 1 <= plan.n_split <= tfa.MAX_SPLITS
        ranges = plan.key_ranges(Tk)
        assert len(ranges) == plan.n_split
        assert ranges[0][0] == 0 and ranges[-1][1] == Tk
        for (_, end), (start, _) in zip(ranges, ranges[1:]):
            assert end == start and start % tfa.BLOCK_K == 0
        assert all(s < e for s, e in ranges)           # none empty
        blocks = B * H * -(-Tq // tfa.BLOCK_Q)
        if 2 * blocks > tfa.WAVE:
            assert plan.n_split == 1
        else:                                 # the split grid, one wave
            assert blocks * plan.n_split <= tfa.WAVE

    @pytest.mark.parametrize("B,H,n", [(1, 6, 3), (4, 6, 1), (1, 20, 1),
                                       (4, 20, 1)],
                             ids=["tiny B=1", "tiny B=4", "large-v3 B=1",
                                  "large-v3 B=4"])
    def test_encoder_shapes(self, B, H, n):
        """At 1500 frames only whisper-tiny at B=1 (72 blocks of 128 rows,
        where an H100 holds 264) splits, in three; large-v3 at B=4 (960
        blocks) does not."""
        assert tfa.flash_split(B, H, 1500, 1500).n_split == n

    def test_uneven_split(self):
        """21 key tiles in ranges of 6: the last holds 3."""
        plan = tfa.flash_split(1, 6, 64, 1300)
        assert plan == tfa.FlashSplit(4, 6)
        assert plan.key_ranges(1300)[-1] == (1152, 1300)

    @pytest.mark.parametrize("dtype,width,split", [
        (torch.float32, 64, True), (torch.float32, 65, True),
        (torch.bfloat16, 64, True), (torch.bfloat16, 65, False)],
        ids=["f32", "f32 rows of 65", "bf16", "bf16 rows of 65"])
    @pytest.mark.parametrize("B,H,Tq,Tk", [(1, 6, 1500, 1500),
                                           (1, 20, 1500, 1500),
                                           (1, 6, 100, 1500)],
                             ids=["tiny B=1", "large-v3 B=1", "Tq=100"])
    def test_launch_takes_the_split(self, monkeypatch, dtype, width, split,
                                    B, H, Tq, Tk):
        """``_flash_cuda`` hands the C entry point ``flash_split``'s plan,
        with scratch for the split's partials, for f32 at any strides (its
        tensor-core kernel loads unaligned rows element by element) and for
        bf16 rows that are 16-byte aligned; bf16 rows that are not (a row
        of 65 values) run unsplit. f32 launches are counted apart."""
        calls = []

        class Lib:
            def wa_flash_attention(self, *args):
                calls.append(args)
                return 0

        monkeypatch.setattr(tfa._build, "library", Lib)
        monkeypatch.setattr(tfa._build, "stream", lambda: 7)
        q, k, v = (torch.zeros((B, H, T, width), dtype=dtype)[..., :64]
                   for T in (Tq, Tk, Tk))
        before = dict(tfa.LAUNCHES)
        out = tfa._flash_cuda(q, k, v, 0.125, False, Tk, None)
        assert out.shape == (B, H, Tq, 64) and len(calls) == 1
        args = calls[0]
        assert args[16] == (0 if dtype == torch.float32 else 1)
        plan = tfa.flash_split(B, H, Tq, Tk) if split else \
            tfa.FlashSplit(1, -(-Tk // tfa.BLOCK_K))
        assert tuple(args[24:26]) == tuple(plan)
        assert (args[26] is None) == (plan.n_split == 1)
        assert args[28] == 7 and len(args) == 29
        f32 = int(dtype == torch.float32)
        assert tfa.LAUNCHES == {
            "flash_attention": before["flash_attention"] + 1,
            "flash_attention_f32": before["flash_attention_f32"] + f32}


# csrc/flash_attention.cu mma_terms: the (q or p term, k or v term) pairs
# of the f32 kernel's six bf16 products, in its order (hi 0, mid 1, lo 2)
F32_PAIRS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
TOL_F32 = 2e-5       # chip_smoke's: f32 outputs, summation order only
TOL_F32_TERMS = 1e-6  # chip_smoke's: K16-K18 f32 against f64
# the product sets of a split short of one product: hi.lo, lo.hi, mid.mid
F32_SHORT = {f"no {n}": tuple(p for p in F32_PAIRS if p != d)
             for n, d in (("hi.lo", (0, 2)), ("lo.hi", (2, 0)),
                          ("mid.mid", (1, 1)))}


def _terms_product(a, b, pairs=F32_PAIRS):
    """a [.., M, K] @ b [.., K, N] as K16's f32 kernel takes it: the f32
    sum of the bf16 products of the operands' three-term splits in
    ``pairs``, 16 deep a step (the mma's k), each step's products summed
    exactly and rounded once into the f32 sum."""
    ta, tb = _bf16_terms(a), _bf16_terms(b)
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for c in range(0, a.shape[-1], 16):
        for i, j in pairs:
            step = np.matmul(ta[i][..., c:c + 16].astype(np.float64),
                             tb[j][..., c:c + 16, :].astype(np.float64))
            acc = (acc + step).astype(np.float32)
    return acc


def _emulate_f32_flash(q, k, v, causal=False, kv_valid=None,
                       pairs=F32_PAIRS):
    """K16's f32 kernel in numpy, [B, H, T, 64] f32 -> f32: q . k^T and
    p . v by ``_terms_product``; the scores scaled into the log2 domain
    and masked at -0.7 f32max; p = 2^(s - m) in f32, not rounded; out =
    acc / l."""
    f32, Tq, Tk = np.float32, q.shape[2], k.shape[2]
    kv_valid = Tk if kv_valid is None else kv_valid
    s = _terms_product(q, np.swapaxes(k, -1, -2), pairs)
    s = (s * f32(64 ** -0.5 * np.log2(np.e))).astype(f32)
    col, row = np.arange(Tk)[None, :], np.arange(Tq)[:, None]
    ok = (col < kv_valid) & ((col <= row) if causal else True)
    s = np.where(ok, s, f32(-0.7 * np.finfo(np.float32).max))
    p = np.exp2((s - s.max(-1, keepdims=True)).astype(np.float64)).astype(f32)
    l = p.sum(-1, keepdims=True, dtype=f32)
    return _terms_product(p, v, pairs) / l


def _softmax_f64(q, k, causal=False, kv_valid=None):
    q, k = q.astype(np.float64), k.astype(np.float64)
    Tq, Tk = q.shape[2], k.shape[2]
    kv_valid = Tk if kv_valid is None else kv_valid
    s = np.matmul(q, np.swapaxes(k, -1, -2)) * 64 ** -0.5
    col, row = np.arange(Tk)[None, :], np.arange(Tq)[:, None]
    ok = (col < kv_valid) & ((col <= row) if causal else True)
    s = np.where(ok, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def _attention_f64(q, k, v, causal=False, kv_valid=None):
    return np.matmul(_softmax_f64(q, k, causal, kv_valid),
                     v.astype(np.float64))


FLASH_TERM_CASES = pytest.mark.parametrize("H,Tq,Tk,kw", [
    (6, 64, 1500, {}), (20, 64, 1500, {}),
    (6, 64, 1500, dict(kv_valid=1025)), (20, 64, 1500, dict(kv_valid=1025)),
    (6, 448, 448, dict(causal=True)), (20, 448, 448, dict(causal=True))],
    ids=["tiny", "large-v3", "tiny kv_valid", "large-v3 kv_valid",
         "tiny causal", "large-v3 causal"])

FLASH_TERM_CASES_X30 = pytest.mark.parametrize("Tq,Tk,kw", [
    (64, 1500, {}), (64, 1500, dict(kv_valid=1025)),
    (448, 448, dict(causal=True))], ids=["1500 keys", "kv_valid", "causal"])


class TestFlashF32Terms:
    """The term set of K16's f32 kernel (``F32_PAIRS``: hi.hi, hi.mid,
    mid.hi, hi.lo, lo.hi, mid.mid of the three-term bf16 splits), emulated
    in numpy against f64, before any chip run: for the scores q . k^T and
    for p . v (p the f64 softmax's, in f32) within chip_smoke's f32
    tolerance of f64 at the smoke's unit-normal draws and at 30x them, and
    the whole attention at the smoke's draws. (At 30x the scores reach
    about 1e3, where f32's own rounding of a score, 2^-24 of it, moves an
    output by more than that tolerance: the plain f32 version is 4e-5 to
    3e-4 from f64 there, so at that gain the whole attention is held to
    the plain f32 version's distance from f64.) Then that chip_smoke's
    check against f64 (``TOL_F32_TERMS``) sees each product: a split short
    of hi.lo, lo.hi or mid.mid misses it."""

    @pytest.mark.parametrize("gain", [1.0, 30.0], ids=["x1", "x30"])
    @FLASH_TERM_CASES
    def test_products_within_tolerance_of_f64(self, H, Tq, Tk, kw, gain):
        q, k, v = (a * np.float32(gain) for a in _qkv(11, 1, H, Tq, Tk=Tk))
        kt = np.swapaxes(k, -1, -2)
        want = np.matmul(q.astype(np.float64), kt.astype(np.float64))
        assert _rel(_terms_product(q, kt), want) <= TOL_F32
        p = _softmax_f64(q, k, **kw)
        want = np.matmul(p, v.astype(np.float64))
        assert _rel(_terms_product(p.astype(np.float32), v), want) <= TOL_F32

    @FLASH_TERM_CASES
    def test_attention_within_tolerance_of_f64(self, H, Tq, Tk, kw):
        q, k, v = _qkv(11, 1, H, Tq, Tk=Tk)
        err = _rel(_emulate_f32_flash(q, k, v, **kw),
                   _attention_f64(q, k, v, **kw))
        assert err <= TOL_F32, err

    def test_fewer_terms_miss(self):
        """The tolerance sees the terms: with hi.hi alone (plain bf16
        operands) the scores and the attention are far outside it."""
        q, k, v = _qkv(11, 1, 6, 64, Tk=1500)
        kt = np.swapaxes(k, -1, -2)
        want = np.matmul(q.astype(np.float64), kt.astype(np.float64))
        assert _rel(_terms_product(q, kt, ((0, 0),)), want) > 10 * TOL_F32
        got = _emulate_f32_flash(q, k, v, pairs=((0, 0),))
        assert _rel(got, _attention_f64(q, k, v)) > 10 * TOL_F32

    @pytest.mark.parametrize("short", [None, *F32_SHORT],
                             ids=["six products", *F32_SHORT])
    @pytest.mark.parametrize("H", [6, 20], ids=["tiny", "large-v3"])
    @pytest.mark.parametrize("Tq,Tk,causal", [(128, 64, False),
                                              (128, 64, True),
                                              (64, 128, False)],
                             ids=["one key tile", "causal", "two key tiles"])
    def test_terms_check_sees_each_product(self, short, H, Tq, Tk, causal):
        """chip_smoke's check of K16 f32 against f64 (``F32_TERM_FLASH``,
        ``TOL_F32_TERMS``) at three seeds: the six products are within
        it, and a split short of any one of hi.lo, lo.hi, mid.mid misses
        it at every seed (``TOL_F32`` against the plain version would not
        see these: they come 2e-6 to 8e-6 from it)."""
        pairs = F32_PAIRS if short is None else F32_SHORT[short]
        kw = dict(causal=causal)
        for seed in (11, 12, 13):
            q, k, v = _qkv(seed, 1, H, Tq, Tk=Tk)
            err = _rel(_emulate_f32_flash(q, k, v, pairs=pairs, **kw),
                       _attention_f64(q, k, v, **kw))
            assert (err <= TOL_F32_TERMS) == (short is None), (seed, err)

    @pytest.mark.parametrize("H", [6, 20], ids=["tiny", "large-v3"])
    @FLASH_TERM_CASES_X30
    def test_as_close_to_f64_as_plain_f32_at_x30(self, H, Tq, Tk, kw):
        """At 30x the smoke's draws (scores near 1e3) no f32 attention is
        within TOL_F32 of f64; the six products come about as far from
        f64 as the port's plain f32 attention (at most 1.5x: 0.36x-1.10x
        here), and each split short of one product more than twice as far
        (3.1x-19x)."""
        q, k, v = (a * np.float32(30) for a in _qkv(11, 1, H, Tq, Tk=Tk))
        want = _attention_f64(q, k, v, **kw)
        plain = _rel(tfa.flash_attention_plain(
            *(torch.from_numpy(a) for a in (q, k, v)), **kw).numpy(), want)
        assert _rel(_emulate_f32_flash(q, k, v, **kw), want) <= 1.5 * plain
        for pairs in F32_SHORT.values():
            got = _emulate_f32_flash(q, k, v, pairs=pairs, **kw)
            assert _rel(got, want) > 2 * plain


def _terms_matmul(x, w, terms=3):
    """K17 / K18's f32 x @ exactly widened weights w: x as its first
    ``terms`` bf16 terms, each step of 16 rows of K summed exactly and
    rounded once into the f32 sum."""
    tx = _bf16_terms(x)[:terms]
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for c in range(0, x.shape[1], 16):
        step = sum(np.matmul(t[:, c:c + 16].astype(np.float64),
                             w[c:c + 16].astype(np.float64)) for t in tx)
        acc = (acc + step).astype(np.float32)
    return acc


@pytest.mark.parametrize("terms", [3, 2], ids=["hi mid lo", "no lo"])
@pytest.mark.parametrize("K,N", [(384, 1536), (1280, 5120)],
                         ids=["tiny fc1", "large-v3 fc1"])
def test_f32_matmul_terms_against_f64(terms, K, N):
    """chip_smoke's check of K17 / K18 f32 against f64 (``TOL_F32_TERMS``
    at fc1's shape): x as three bf16 terms times int8 weights is within
    it; without x's lo term it misses it (and would pass ``TOL_F32``
    against the plain version)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, K)).astype(np.float32)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    s = (0.001 + 0.01 * rng.random(N)).astype(np.float32)
    want = (x.astype(np.float64) @ w.astype(np.float64)) * s
    err = _rel(_terms_matmul(x, w, terms) * s, want)
    assert (err <= TOL_F32_TERMS) == (terms == 3), err
    assert err <= TOL_F32


@pytest.fixture(scope="module")
def cfg():
    return ModelConfig(
        model_type="tiny", n_vocab=700, n_audio_ctx=64, n_audio_state=128,
        n_audio_head=2, n_audio_layer=2, n_text_ctx=24, n_text_state=128,
        n_text_head=2, n_text_layer=2, n_mels=80)


@pytest.fixture(scope="module")
def params(cfg):
    jp = init_params(cfg, seed=4)
    return jp, from_jax_params(jp)


def _specials(cfg, cls):
    V = cfg.n_vocab
    return cls(eot=V - 1, sot=V - 2, lang_base=V - 110, transcribe=V - 3,
               no_timestamps=V - 4, timestamp_base=V + 1000,
               is_multilingual=False, translate=V - 5, no_speech=V - 6,
               speaker_turn=V - 7, prev=V - 8)


class TestFlashEncoderAndEngine:
    def test_encode_matches_jax(self, cfg, params):
        jp, tp = params
        mel = np.random.default_rng(5).normal(
            size=(1, 2 * cfg.n_audio_ctx, cfg.n_mels)).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jencode(jp, jnp.asarray(mel), cfg,
                                      use_flash=True))
        got = tencode(tp, _t(mel), cfg, use_flash=True).numpy()
        assert np.abs(got - want).max() < 1e-4
        plain = tencode(tp, _t(mel), cfg).numpy()
        assert np.abs(got - plain).max() < 1e-4

    def test_engine_tokens_match_jax(self, cfg, params):
        """``use_flash_attention=True`` in both engines: the same tokens,
        through transcribe (greedy pipeline) and beam search (the
        engine's encode)."""
        jp, tp = params
        jeng = JWhisperApr(cfg, jp, specials=_specials(cfg, SpecialTokens),
                           compute=JCompute(use_flash_attention=True))
        teng = WhisperApr(cfg, tp, specials=_specials(cfg, TSpecials),
                          compute=TCompute(use_flash_attention=True),
                          device="cpu")
        assert jeng._use_flash and teng._use_flash
        audio = np.random.default_rng(6).normal(0, 0.1, 12_000).astype(
            np.float32)
        from whisper_apr_tpu import TranscribeOptions as JOptions
        for opts in (dict(language="en", max_tokens=12),
                     dict(language="en", max_tokens=8, strategy="beam",
                          beam_size=2)):
            with pltpu.force_tpu_interpret_mode():
                want = jeng.transcribe(audio, JOptions(**opts)).tokens
            got = teng.transcribe(audio, TranscribeOptions(**opts)).tokens
            assert got == want

    def test_selector_keeps_whisper_on_the_plain_path(self, cfg, params):
        """``use_flash_attention=None`` resolves through KernelSelector:
        the CPU never picks flash, and neither does a card at Whisper's
        1500 x 1500 (under the 4 << 20 threshold)."""
        _, tp = params
        eng = WhisperApr(cfg, tp, specials=_specials(cfg, TSpecials),
                         device="cpu")
        assert eng._use_flash is False
        card = tdispatch.DeviceCapabilities("cuda", "card", 1, 80 << 30)
        sel = tdispatch.KernelSelector(caps=card)
        assert sel.attention(1500, 1500) == tdispatch.KernelBackend.XLA
        assert tdispatch.DeviceCapabilities.detect("cpu").platform == "cpu"


class TestSelectorMatchesJax:
    @pytest.mark.parametrize("platform", ["cpu", "accelerator"])
    def test_choices(self, platform):
        jcaps = jdispatch.DeviceCapabilities(
            "cpu" if platform == "cpu" else "tpu", 1, 16 << 30, True,
            platform != "cpu", (128, 128))
        tcaps = tdispatch.DeviceCapabilities(
            "cpu" if platform == "cpu" else "cuda", "x", 1, 16 << 30)
        for prefer in (True, False):
            js = jdispatch.KernelSelector(
                jdispatch.SelectorConfig(prefer_pallas=prefer), jcaps)
            ts = tdispatch.KernelSelector(
                tdispatch.SelectorConfig(prefer_pallas=prefer), tcaps)
            for q, k in ((1500, 1500), (2048, 2048), (4096, 1500), (1, 1)):
                assert ts.attention(q, k).name == js.attention(q, k).name
            assert ts.attention(1, 1, tdispatch.KernelBackend.PALLAS) == \
                tdispatch.KernelBackend.PALLAS
            for bits in (4, 8):
                assert ts.dequant_matmul(bits).name == \
                    js.dequant_matmul(bits).name
            assert ts.matmul(8, 8, 8).name == js.matmul(8, 8, 8).name
        assert tdispatch.SelectorConfig().flash_attention_score_elements \
            == jdispatch.SelectorConfig().flash_attention_score_elements


def _mats(seed, M, K, N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, K)).astype(np.float32),
            rng.normal(size=(K, N)).astype(np.float32),
            rng.normal(size=(N,)).astype(np.float32))


# K17's edge rows: the decode kernel's one to four 8-row tiles (1, 9, 16,
# 17, 32), the tile kernel's first row (33); K not a multiple of a 16-row
# step, an odd width (rows not 16-byte aligned)
INT8_EDGES = [(M, 200, 999) for M in (1, 9, 16, 17, 32, 33)]


class TestInt8Plain:
    @pytest.mark.parametrize("shape", SHAPES + INT8_EDGES)
    @pytest.mark.parametrize("per_channel", [True, False])
    def test_matches_jax(self, shape, per_channel):
        x, w, b = _mats(0, *shape)
        jq = jquant.quantize_int8(w, per_channel=per_channel)
        tq = from_jax_params(jq)
        want = np.asarray(ji8.int8_matmul(jnp.asarray(x), jq.q, jq.scale,
                                          interpret=True))
        got = ti8.int8_matmul(_t(x), tq.q, tq.scale)
        assert _rel(got.numpy(), want) < 1e-5
        want = np.asarray(ji8.linear_int8(jnp.asarray(x[None]), jq,
                                          jnp.asarray(b), interpret=True))
        got = ti8.linear_int8(_t(x[None]), tq, _t(b))
        assert got.shape == want.shape and _rel(got.numpy(), want) < 1e-5

    def test_scale_shapes(self):
        """A layer slice's [1, N] scale, an int8 .apr's per-tensor [1, 1]
        and 0-d scales all reach the matmul as the dequantized weight."""
        x, w, _ = _mats(1, 5, 64, 40)
        stacked = quantize_int8(np.stack([w, 2 * w]), per_channel=True,
                                stacked=True)
        layer = stacked.map(lambda t: t[1])
        assert tuple(layer.scale.shape) == (1, 40)
        q = _t(np.clip(np.round(w * 20), -127, 127).astype(np.int8))
        for scale in (layer.scale, torch.tensor([[0.05]]),
                      torch.tensor(0.05)):
            qw = layer.q if scale is layer.scale else q
            got = ti8.int8_matmul(_t(x), qw, scale)
            ref = _t(x) @ dequant(type(layer)(qw, scale))
            assert _rel(got.numpy(), ref.numpy()) < 1e-5
        with pytest.raises(ValueError, match="scale"):
            ti8.int8_matmul(_t(x), q, torch.ones(3))


# K18's edges: rows either side of the decode kernel's 16 and of a
# 128-row tile, K not a multiple of a 32-deep slice, packed rows of 500
# bytes (not 16-byte aligned) at an even and an odd width
INT4_EDGES = [(17, 200, 1000), (17, 200, 999), (129, 200, 1000),
              (129, 200, 999)]


class TestInt4Plain:
    @pytest.mark.parametrize("shape", SHAPES + [(3, 64, 101)] + INT4_EDGES)
    def test_matches_dequant_and_jax(self, shape):
        """Per-channel int4, odd N included (the padded last column is
        cut by ``linear_int4``): the JAX kernel's values and
        x @ dequant(qt)."""
        M, K, N = shape
        x, w, b = _mats(2, M, K, N)
        jq = jquant.quantize_int4(w, per_channel=True)
        tq = from_jax_params(jq)
        ref = x @ np.asarray(jquant.dequant(jq))
        got = ti4.int4_matmul(_t(x), tq.q, tq.scale)[:, :N]
        assert _rel(got.numpy(), ref) < 1e-5
        lin = ti4.linear_int4(_t(x[None]), tq, _t(b))
        assert lin.shape == (1, M, N) and _rel(lin.numpy(), ref + b) < 1e-5
        want = np.asarray(ji4.int4_matmul(jnp.asarray(x), jq.q, jq.scale,
                                          interpret=True))[:, :N]
        assert _rel(got.numpy(), want) < 1e-5
        want = np.asarray(ji4.linear_int4(jnp.asarray(x[None]), jq,
                                          jnp.asarray(b), interpret=True))
        assert _rel(lin.numpy(), want) < 1e-5

    def test_nibble_layout(self):
        """Byte 0xF7 holds 7 (low nibble, even column) and -1 (high, odd);
        0x08 holds -8 and 0."""
        wq = torch.tensor([[-9, 8]], dtype=torch.int8)    # 0xF7, 0x08
        assert ti4.unpack_plain(wq).tolist() == [[7.0, -1.0, -8.0, 0.0]]


class TestInt4Plan:
    """``int4_plan``: how the CUDA kernel spreads K over blocks at most 16
    rows (one launch: a strip's splits are one cluster and are summed
    inside it, so the launch needs no scratch)."""

    @pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 9, 15, 16, 17, 1500])
    @pytest.mark.parametrize("K,N", [(384, 1536), (1536, 384), (1280, 5120),
                                     (5120, 1280), (200, 1000), (64, 2),
                                     (16, 2), (20000, 256)])
    def test_k_rows_covered_once(self, M, K, N):
        plan = ti4.int4_plan(M, K, N)
        ranges = plan.k_ranges(K)
        assert len(ranges) == plan.n_split
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        for (_, end), (start, _) in zip(ranges, ranges[1:]):
            assert end == start
        assert all(s < e for s, e in ranges)           # none empty
        if M > ti4.DECODE_ROWS:
            assert plan == ti4.SplitPlan(1, K)
        else:
            assert 1 <= plan.n_split <= ti4.MAX_SPLIT
            assert plan.split_rows % ti4.STEP == 0

    @pytest.mark.parametrize("M,K,N,n", [(8, 384, 1536, 12),
                                         (1, 1280, 5120, 4),
                                         (8, 1280, 5120, 4),
                                         (1, 5120, 1280, 16),
                                         (17, 1280, 5120, 1)],
                             ids=["tiny fc1 M=8", "large-v3 fc1 M=1",
                                  "large-v3 fc1 M=8", "large-v3 fc2 M=1",
                                  "17 rows: the tile"])
    def test_main_path_splits(self, M, K, N, n):
        """fc1 and fc2 at the decode rows: about ``BLOCKS`` blocks (6, 20
        and 5 strips of 256 columns), at most a cluster's 16 splits."""
        assert ti4.int4_plan(M, K, N).n_split == n

    @pytest.mark.parametrize("M,K,N", [(8, 384, 1536), (1, 64, 2),
                                       (1500, 1280, 5120), (3, 200, 1000)])
    def test_one_launch_without_scratch(self, monkeypatch, M, K, N):
        """``_int4_cuda`` makes one call of the C entry point with the
        plan's split and the stream, and asks for no scratch."""
        calls = []

        class Lib:
            def wa_int4_matmul(self, *args):
                calls.append(args)
                return 0

        def workspace(*args, **kwargs):
            raise AssertionError("K18 needs no scratch")

        monkeypatch.setattr(ti4._build, "library", Lib)
        monkeypatch.setattr(ti4._build, "stream", lambda: 7)
        monkeypatch.setattr(ti4._build, "workspace", workspace)
        rng = np.random.default_rng(8)
        x = _t(rng.normal(size=(M, K)).astype(np.float32))
        wq = _t(rng.integers(-128, 128, (K, N // 2)).astype(np.int8))
        before = ti4.LAUNCHES["int4_matmul"]
        y = ti4._int4_cuda(x, wq, torch.ones(N))
        assert y.shape == (M, N) and ti4.LAUNCHES["int4_matmul"] == before + 1
        assert len(calls) == 1
        args = calls[0]
        assert args[1:4] == (0, M, K) and args[5] == N and args[7] == N
        assert tuple(args[9:11]) == tuple(ti4.int4_plan(M, K, N))
        assert isinstance(args[11], int)     # where the kernel's route goes
        assert args[12] == 7 and len(args) == 13

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["f32", "bf16"])
    @pytest.mark.parametrize("M", [16, 17, 1500])
    def test_f32_tile_launches_counted(self, monkeypatch, dtype, M):
        """A launch on f32 x that the C entry point reports as the tile
        kernel's (above 16 rows: three bf16 terms) counts in
        ``int4_matmul_f32`` beside ``int4_matmul``."""
        def launch(self, *a):     # the entry point's report of its route
            ctypes.c_int.from_address(a[11]).value = int(M > 16)
            return 0

        monkeypatch.setattr(ti4._build, "library", lambda: type(
            "Lib", (), {"wa_int4_matmul": launch})())
        monkeypatch.setattr(ti4._build, "stream", lambda: 7)
        x = torch.zeros((M, 64), dtype=dtype)
        before = dict(ti4.LAUNCHES)
        ti4._int4_cuda(x, torch.zeros((64, 48), dtype=torch.int8),
                       torch.ones(96))
        tile = int(dtype == torch.float32 and M > 16)
        assert ti4.LAUNCHES == {
            "int4_matmul": before["int4_matmul"] + 1,
            "int4_matmul_f32": before["int4_matmul_f32"] + tile}


class TestInt8Plan:
    """``int8_plan``: how the int8 decode-row kernel (K17 at most 16 rows,
    K8 at most 32) spreads K over blocks (one launch: a strip's splits are
    one cluster and are summed inside it, so the launch needs no
    scratch)."""

    @pytest.mark.parametrize("M", [1, 8, 9, 16, 17, 32, 33, 1500])
    @pytest.mark.parametrize("K,N", [(384, 384), (384, 1152), (1280, 1280),
                                     (1280, 3840), (384, 51968),
                                     (1280, 51968), (5120, 1280),
                                     (200, 1000), (16, 999), (20000, 128)])
    def test_k_rows_covered_once(self, M, K, N):
        plan = ti8.int8_plan(M, K, N)
        ranges = plan.k_ranges(K)
        assert len(ranges) == plan.n_split
        assert ranges[0][0] == 0 and ranges[-1][1] == K
        for (_, end), (start, _) in zip(ranges, ranges[1:]):
            assert end == start
        assert all(s < e for s, e in ranges)           # none empty
        if M > ti8.DECODE_ROWS:
            assert plan == ti8.SplitPlan(1, K)
        else:
            assert 1 <= plan.n_split <= ti8.MAX_SPLIT
            steps = plan.split_rows // ti8.STEP
            assert plan.split_rows % ti8.STEP == 0
            # one round of the warps' steps, or whole rounds
            assert steps <= ti8.WARPS or steps % ti8.WARPS == 0

    @pytest.mark.parametrize("M,K,N,n,blocks", [
        (1, 384, 384, 12, 36), (1, 384, 1152, 12, 108),
        (1, 1280, 1280, 12, 120), (8, 1280, 3840, 4, 120),
        (8, 1280, 51968, 1, 406), (8, 1280, 5120, 3, 120),
        (8, 5120, 1280, 10, 100), (32, 1280, 5120, 2, 80)],
        ids=["tiny DxD", "tiny Dx3D", "large-v3 DxD", "large-v3 Dx3D",
             "large-v3 vocab", "large-v3 fc1", "large-v3 fc2",
             "large-v3 fc1 M=32"])
    def test_main_path_splits(self, M, K, N, n, blocks):
        """The scan step's projections and the FFN's linears spread over
        about 132 blocks (96 above 16 rows) where one block a strip of 128
        columns would give 3-40; a split past one round of the warps' steps
        takes whole rounds (fc1: 80 steps in 3 splits of 32, not 27); the
        vocab is not split."""
        plan = ti8.int8_plan(M, K, N)
        assert plan.n_split == n
        assert n * -(-N // ti8.STRIP) == blocks

    @pytest.mark.parametrize("M,K,N", [(8, 384, 1536), (1, 16, 999),
                                       (1500, 1280, 5120), (17, 200, 1000)])
    def test_one_launch_without_scratch(self, monkeypatch, M, K, N):
        """``_int8_cuda`` makes one call of the C entry point with the
        plan's split and the stream, and asks for no scratch."""
        calls = []

        class Lib:
            def wa_int8_matmul(self, *args):
                calls.append(args)
                return 0

        def workspace(*args, **kwargs):
            raise AssertionError("K17 needs no scratch")

        monkeypatch.setattr(ti8._build, "library", Lib)
        monkeypatch.setattr(ti8._build, "stream", lambda: 7)
        monkeypatch.setattr(ti8._build, "workspace", workspace)
        rng = np.random.default_rng(8)
        x = _t(rng.normal(size=(M, K)).astype(np.float32))
        wq = _t(rng.integers(-128, 128, (K, N)).astype(np.int8))
        before = ti8.LAUNCHES["int8_matmul"]
        y = ti8._int8_cuda(x, wq, torch.ones(N))
        assert y.shape == (M, N) and ti8.LAUNCHES["int8_matmul"] == before + 1
        assert len(calls) == 1
        args = calls[0]
        assert args[1:4] == (0, M, K) and args[5] == N and args[7] == N
        assert tuple(args[9:11]) == tuple(ti8.int8_plan(M, K, N))
        assert isinstance(args[11], int)     # where the kernel's route goes
        assert args[12] == 7 and len(args) == 13

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["f32", "bf16"])
    @pytest.mark.parametrize("M", [32, 33, 1500])
    def test_f32_tile_launches_counted(self, monkeypatch, dtype, M):
        """A launch on f32 x that the C entry point reports as the tile
        kernel's (above 32 rows: three bf16 terms) counts in
        ``int8_matmul_f32`` beside ``int8_matmul``."""
        def launch(self, *a):     # the entry point's report of its route
            ctypes.c_int.from_address(a[11]).value = int(M > 32)
            return 0

        monkeypatch.setattr(ti8._build, "library", lambda: type(
            "Lib", (), {"wa_int8_matmul": launch})())
        monkeypatch.setattr(ti8._build, "stream", lambda: 7)
        x = torch.zeros((M, 64), dtype=dtype)
        before = dict(ti8.LAUNCHES)
        ti8._int8_cuda(x, torch.zeros((64, 96), dtype=torch.int8),
                       torch.ones(96))
        tile = int(dtype == torch.float32 and M > 32)
        assert ti8.LAUNCHES == {
            "int8_matmul": before["int8_matmul"] + 1,
            "int8_matmul_f32": before["int8_matmul_f32"] + tile}


def _int8_widen(word: int, B: int) -> float:
    """The int8 kernels' widening of byte B of a 32-bit word, in numpy:
    the word ^ 0x80808080, byte B into the low byte of 0x4B000000
    (``__byte_perm(wx, 0x4B000000, 0x7440 | B)``, 2^23 + b + 128), minus
    2^23 + 128 as an f32; the result's high half read as a bf16."""
    wx = word ^ 0x80808080
    bits = ((wx >> 8 * B) & 0xFF) | 0x4B000000
    f = np.array([bits], np.uint32).view(np.float32) - np.float32(8388736)
    u = int(f.view(np.uint32)[0])
    # exact in f32 and its low half zero: the high half is the value as a
    # bf16, which the kernels' byte permute (0x7632) keeps
    assert u & 0xFFFF == 0 and float(f[0]) == int(float(f[0]))
    return float(np.array([u & 0xFFFF0000], np.uint32).view(np.float32)[0])


def _bf16_pair(lo: float, hi: float) -> int:
    """``bf16_pair``: the high halves of two f32 values in one word."""
    lo_u, hi_u = np.array([lo, hi], np.float32).view(np.uint32)
    return int(lo_u >> 16) | int(hi_u >> 16) << 16


def _pair_values(word: int) -> tuple:
    return tuple(float(np.array([h << 16], np.uint32).view(np.float32)[0])
                 for h in (word & 0xFFFF, word >> 16))


class TestInt8Widening:
    """The int8 kernels' widening to bf16 (no int -> float convert): every
    byte value at every byte position of a word, the others random; and
    the decode kernel's A fragments (bytes 2j and 2j + 1 of four K rows)
    in an mma m16n8k16 mirrored in numpy, against x @ W."""

    def test_all_bytes_every_position(self):
        rng = np.random.default_rng(10)
        for b in range(-128, 128):
            for B in range(4):
                other = int(rng.integers(0, 2 ** 32)) & ~(0xFF << 8 * B)
                word = other | (b & 0xFF) << 8 * B
                assert _int8_widen(word, B) == b, (b, B)

    def test_pairs_keep_order(self):
        word = 0x807F01FF                       # -128, 127, 1, -1
        vals = [_int8_widen(word, B) for B in range(4)]
        assert vals == [-1.0, 1.0, 127.0, -128.0]
        assert _pair_values(_bf16_pair(vals[0], vals[3])) == (-1.0, -128.0)

    def test_decode_fragments_mirror(self):
        """Lane (g, t) loads vector g (16 columns) of K rows 2t, 2t + 1,
        2t + 8, 2t + 9; mma j's A rows g and g + 8 are columns 2j and
        2j + 1 of the lane's vector; x rows are B's 8 columns; the epilogue
        puts sum e of mma j at column 16 g + 2j + (e >> 1), row 2t +
        (e & 1). Together: y = x @ W over a 16-row step of 128 columns."""
        rng = np.random.default_rng(11)
        W = rng.integers(-128, 128, (16, 128)).astype(np.int8)
        x = rng.integers(-4, 5, (8, 16)).astype(np.float32)
        y = np.zeros((8, 128), np.float32)
        words = W.view(np.uint8).reshape(16, 8, 4, 4)
        words = (words.astype(np.uint32)
                 << (8 * np.arange(4, dtype=np.uint32))).sum(-1)  # [k, v, wd]
        for j in range(8):
            A = np.zeros((8, 16, 16), np.float32)    # [g][row][k]
            for g in range(8):
                for t in range(4):
                    r = [int(words[k, g, j // 2]) for k in
                         (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
                    b0, b1 = 2 * (j % 2), 2 * (j % 2) + 1
                    a = [_bf16_pair(_int8_widen(r[0], b0),
                                    _int8_widen(r[1], b0)),
                         _bf16_pair(_int8_widen(r[0], b1),
                                    _int8_widen(r[1], b1)),
                         _bf16_pair(_int8_widen(r[2], b0),
                                    _int8_widen(r[3], b0)),
                         _bf16_pair(_int8_widen(r[2], b1),
                                    _int8_widen(r[3], b1))]
                    for i, (row, k) in enumerate(((g, 2 * t),
                                                  (g + 8, 2 * t),
                                                  (g, 2 * t + 8),
                                                  (g + 8, 2 * t + 8))):
                        A[g, row, k:k + 2] = _pair_values(a[i])
            # the mma's A is the same for every g: row g from lanes (g, .)
            Am = np.stack([A[g % 8, g] for g in range(16)])
            for g in range(8):
                D = Am @ x.T                            # [16, 8]
                for t in range(4):
                    for e in range(4):
                        row = (g if e < 2 else g + 8)
                        col = 16 * g + 2 * j + (e >> 1)
                        y[2 * t + (e & 1), col] = D[row, 2 * t + (e & 1)]
        np.testing.assert_array_equal(y, x @ W.astype(np.float32))


def _magic_bf16(byte: int) -> list:
    """The bf16 pair widening, in numpy: byte B of a word w and of w >> 4
    moved to the low and high halves (``__byte_perm(w, w >> 4, B | (4 +
    B) << 8)``), & 0x000F000F, ^ 0x43084308 (0x4300 | nibble ^ 8 in each
    half), each half read as bf16 minus 136."""
    out = []
    for B in range(4):
        w = byte << (8 * B)
        w4 = w >> 4
        v = ((w >> 8 * B) & 0xFF) | (((w4 >> 8 * B) & 0xFF) << 16)
        t = (v & 0x000F000F) ^ 0x43084308
        halves = np.array([(t & 0xFFFF) << 16, (t >> 16) << 16],
                          np.uint32).view(np.float32)
        d = halves - np.float32(136)
        # the f32 difference is a bf16 value (its low 16 bits 0), so the
        # kernel's bf16 subtraction gives it exactly
        assert np.all(d.view(np.uint32) & 0xFFFF == 0)
        out.append((float(d[0]), float(d[1])))
    return out


def _bf16_terms(v: np.ndarray) -> list:
    """The decode kernel's f32 x as three bf16 terms, in numpy: each the
    bf16 rounding (to nearest even) of what the terms before it left."""
    out, r = [], v.astype(np.float32)
    for _ in range(3):
        t = torch.from_numpy(r).to(torch.bfloat16).float().numpy()
        out.append(t)
        r = (r - t).astype(np.float32)
    return out


class TestWideningMagic:
    """The kernels' nibble widening (no int -> float convert) against
    ``unpack_plain`` over all 256 byte values, at every byte position of
    a word; and the f32 x split the decode kernel feeds the tensor cores."""

    def test_all_bytes(self):
        wq = torch.arange(-128, 128, dtype=torch.int8).reshape(256, 1)
        want = ti4.unpack_plain(wq).tolist()
        for b in range(256):
            got = _magic_bf16((b - 128) & 0xFF)
            assert got == [tuple(want[b])] * 4, b

    @pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
    def test_f32_as_three_bf16_terms(self, scale):
        """hi + mid + lo == x exactly, so the products with the exact
        int4 weights sum to f32's x @ w."""
        v = (np.random.default_rng(9).normal(size=4096) * scale).astype(
            np.float32)
        hi, mid, lo = _bf16_terms(v)
        assert np.array_equal((hi + mid) + lo, v)
        assert np.array_equal(hi + (mid + lo), v)


def _odd_qtensors(seed):
    """QTensors outside the kernels' contracts: group-scaled int4,
    asymmetric Q5_K planes, planar Q4_K."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(256, 64)).astype(np.float32)
    return {"q4 group": jquant.quantize_q4_block(w, 32),
            "q5k zero": jkq.quantize_q5k(w),
            "q4k kpack": jq4k.quantize_q4k(w)}


class TestLinearRouting:
    @pytest.mark.parametrize("kind", ["q4 group", "q5k zero", "q4k kpack"])
    def test_reference_fault_and_port_routing(self, kind):
        """JAX ``linear`` routes by ``w.int4`` alone: the kernels ignore
        group scales, zeros and packing, so their answer is not
        x @ dequant(qt). The port sends none of these QTensors to a kernel
        and its ``linear`` equals x @ dequant(qt)."""
        jq = _odd_qtensors(3)[kind]
        x = np.random.default_rng(4).normal(size=(4, 256)).astype(
            np.float32)
        ref = x @ np.asarray(jquant.dequant(jq))
        jlin = ji4.linear_int4 if jq.int4 else ji8.linear_int8
        try:
            bad = np.asarray(jlin(jnp.asarray(x), jq, interpret=True))
            assert bad.shape != ref.shape or _rel(bad, ref) > 1e-2
        except (TypeError, ValueError):
            pass          # the kernel cannot even take this QTensor
        tq = from_jax_params(jq)
        assert not ti8.takes(tq) and not ti4.takes(tq)
        cuda = torch.device("cuda")
        assert tbasic.kernel_route(tq, cuda, True, True) is None
        got = tbasic.linear(_t(x), tq).numpy()
        assert _rel(got, ref) < 1e-5

    def test_plain_qtensors_route_to_their_kernel(self):
        """With a switch on, a CUDA input sends plain int8 (per-channel,
        per-tensor, a layer slice) to K17 and per-channel int4 to K18; a
        CPU input, or the switch off, dequantizes."""
        w = np.random.default_rng(5).normal(size=(64, 33)).astype(
            np.float32)
        cuda, cpu = torch.device("cuda"), torch.device("cpu")
        i8c = from_jax_params(jquant.quantize_int8(w, per_channel=True))
        i8t = from_jax_params(jquant.quantize_int8(w, per_channel=False))
        i4c = from_jax_params(jquant.quantize_int4(w, per_channel=True))
        i4t = from_jax_params(jquant.quantize_int4(w, per_channel=False))
        stacked = quantize_int8(np.stack([w, w]), per_channel=True,
                                stacked=True).map(lambda t: t[0])
        for qt in (i8c, i8t, stacked):
            assert tbasic.kernel_route(qt, cuda, True, False) == "int8"
            assert tbasic.kernel_route(qt, cuda, False, True) is None
            assert tbasic.kernel_route(qt, cpu, True, True) is None
        assert tbasic.kernel_route(i4c, cuda, False, True) == "int4"
        assert tbasic.kernel_route(i4c, cuda, True, False) is None
        assert tbasic.kernel_route(i4t, cuda, True, True) is None
        # the switches on, CPU tensors: every QTensor dequantizes
        x = _t(np.random.default_rng(6).normal(size=(2, 64)).astype(
            np.float32))
        old = ti8.USE_PALLAS_INT8, ti4.USE_PALLAS_INT4
        ti8.USE_PALLAS_INT8 = ti4.USE_PALLAS_INT4 = True
        try:
            for qt in (i8c, i4c):
                want = x @ dequant(qt)
                assert torch.allclose(tbasic.linear(x, qt), want,
                                      rtol=1e-6, atol=1e-6)
        finally:
            ti8.USE_PALLAS_INT8, ti4.USE_PALLAS_INT4 = old
        assert ti8.USE_PALLAS_INT8 is False and ti4.USE_PALLAS_INT4 is False
