"""The port's k-quant path (Q4_K, Q5_K, Q6_K: codecs, dequant, K10-K14,
the decode steps, the int8 transcode and the engine) against the JAX
package, at a small width on the CPU.

The config is the JAX package's own k-quant test config (D = 256, 4
heads, 2 layers, vocab 512: the smallest width whose linears are all
256-aligned). Inputs are numpy draws from a seed handed to both sides;
weights cross through ``from_jax_params`` or one ``.apr`` file. The JAX
kernels run in interpret mode. Tolerances, each with its reason:

- codecs, planar triples, f32 dequant: exact (the same numpy code);
- plain K10-K14 against the JAX kernels in f32: 1e-4 of the largest
  magnitude (sums in another order, and the JAX GELU's A&S erf);
- in bf16: 2^-5 of it (the two round at other points: the JAX Q4_K
  kernels split the nibbles algebraically, (xe - xo/16)@lo + (xo/16)@byte,
  which rounds in bf16 where the exact lo/hi form does not; bf16 outputs
  may land an ulp apart, and an ulp of a value is 2^-7 of it);
- decode steps over 3 tokens in f32: 3e-4, the JAX package's own bound
  for these steps, with equal argmax;
- the int8 transcode: values equal but for entries one apart where the
  f32 dequant sits on a rounding edge; scales to 1e-6 relative;
- engine tokens: identical.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_apr_tpu.config import ComputeConfig as JCompute
from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.engine import TranscribeOptions as JOptions
from whisper_apr_tpu.engine import WhisperApr as JWhisperApr
from whisper_apr_tpu.model import qdecode as jqd
from whisper_apr_tpu.model.decoder import init_cache as jinit_cache
from whisper_apr_tpu.model.decoder import prefill as jprefill
from whisper_apr_tpu.model.params import init_params, quantize_params
from whisper_apr_tpu.ops import decode_blocks_kq as jkq
from whisper_apr_tpu.ops import kquants as jkquants
from whisper_apr_tpu.ops import q4k as jq4k
from whisper_apr_tpu.ops.decode_attention import quantize_rows as jqrows
from whisper_apr_tpu.ops.quant import dequant as jdequant
from whisper_apr_tpu.parallel.serving import BatchScheduler as JScheduler
from whisper_apr_tpu.tokenizer import SpecialTokens
from whisper_apr_tpu_torch import ComputeConfig as TCompute
from whisper_apr_tpu_torch import TranscribeOptions, WhisperApr
from whisper_apr_tpu_torch.format import AprWriter
from whisper_apr_tpu_torch.format.container import (QUANT_Q4K, QUANT_Q5K,
                                                    QUANT_Q6K)
from whisper_apr_tpu_torch.model import qdecode as tqd
from whisper_apr_tpu_torch.model.params import (from_jax_params,
                                                params_to_apr_tensors)
from whisper_apr_tpu_torch.ops import decode_blocks_kq as tkq
from whisper_apr_tpu_torch.ops import kquants as tkquants
from whisper_apr_tpu_torch.ops import q4k as tq4k
from whisper_apr_tpu_torch.ops.quant import dequant as tdequant
from whisper_apr_tpu_torch.parallel.serving import BatchScheduler
from whisper_apr_tpu_torch.tokenizer import SpecialTokens as TSpecials

MODES = ("q4k", "q5k", "q6k")
FILE_CODES = {"q4k": QUANT_Q4K, "q5k": QUANT_Q5K, "q6k": QUANT_Q6K}
F32_TOL = 1e-4
BF16_TOL = 2.0 ** -5
STEP_TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(d: int = 256, heads: int = 4) -> ModelConfig:
    return ModelConfig(
        model_type="tiny", n_vocab=512, n_audio_ctx=32, n_audio_state=d,
        n_audio_head=heads, n_audio_layer=2, n_text_ctx=16, n_text_state=d,
        n_text_head=heads, n_text_layer=2, n_mels=80)


@pytest.fixture(scope="module")
def f32_params():
    return init_params(_cfg(), seed=7)


@pytest.fixture(scope="module")
def kq_params(f32_params):
    """mode -> (JAX params, port params, JAX qd, port qd)."""
    out = {}
    for mode in MODES:
        jp = quantize_params(f32_params, mode)
        tp = from_jax_params(jp)
        jprep = jqd.prepare_q4k_decode if mode == "q4k" \
            else jqd.prepare_kq_decode
        tprep = tqd.prepare_q4k_decode if mode == "q4k" \
            else tqd.prepare_kq_decode
        out[mode] = (jp, tp, jprep(jp, _cfg()), tprep(tp, _cfg()))
    return out


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _rel(got, want) -> float:
    g, w = _np(got), _np(want)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def _tol(dtype) -> float:
    return BF16_TOL if dtype == "bf16" else F32_TOL


def _close(got, want, dtype: str, mode: str, attends: bool = False) -> None:
    """Within the tolerance of the dtype; in bf16 over Q5_K/Q6_K planes
    (no algebraic nibble split on the JAX side) and without attention (the
    JAX kernels round q.k to bf16, the port keeps f32) the outputs round at
    the same points, so at most 1 % of them may differ, by one bf16 ulp
    (sums in another order land on the other side of a rounding edge)."""
    assert _rel(got, want) <= _tol(dtype)
    if dtype == "bf16" and mode != "q4k" and not attends:
        g, w = _np(got), _np(want)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (g != w).mean() <= 0.01 and np.all(np.abs(g - w) <= ulp)


DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


# ---------------------------------------------------------------------------
# codecs and dequant
# ---------------------------------------------------------------------------

class TestCodecs:
    RAW = {"q4k": (jq4k.quantize_q4k_raw, tq4k.quantize_q4k_raw),
           "q5k": (jkquants.quantize_q5k_raw, tkquants.quantize_q5k_raw),
           "q6k": (jkquants.quantize_q6k_raw, tkquants.quantize_q6k_raw)}
    PLANAR = {"q4k": (jq4k.planar_from_raw, tq4k.planar_from_raw),
              "q5k": (jkquants.planar_from_raw_q5k,
                      tkquants.planar_from_raw_q5k),
              "q6k": (jkquants.planar_from_raw_q6k,
                      tkquants.planar_from_raw_q6k)}
    QUANT = {"q4k": (jq4k.quantize_q4k, tq4k.quantize_q4k),
             "q5k": (jkquants.quantize_q5k, tkquants.quantize_q5k),
             "q6k": (jkquants.quantize_q6k, tkquants.quantize_q6k)}

    @pytest.mark.parametrize("mode", MODES)
    def test_raw_blocks_and_planar_triples_identical(self, mode):
        w = np.random.default_rng(1).normal(0, 0.05, (2, 512, 96)).astype(
            np.float32)
        w[0, :, 3] = 0.0                    # an all-zero column: d = 0
        jraw, traw = self.RAW[mode]
        wt = np.swapaxes(w, -1, -2)
        a, b = jraw(wt), traw(wt)
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
        jq, tq = self.QUANT[mode]
        ja, tb = jq(w, stacked=True), tq(w, stacked=True)
        for part in ("q", "scale", "zero"):
            x, y = getattr(ja, part), getattr(tb, part)
            assert (x is None) == (y is None)
            if x is not None:
                assert y.dtype == {np.dtype("int8"): torch.int8,
                                   np.dtype("float32"): torch.float32}[
                    np.asarray(x).dtype]
                assert np.array_equal(np.asarray(x), y.numpy())
        assert (tb.int4, tb.group, tb.kpack) == (ja.int4, ja.group, ja.kpack)
        jp, tp = self.PLANAR[mode]
        raw = jraw(wt[1])                     # one [d_out, d_in] weight
        ja, tb = jp(raw, 96, 512), tp(raw, 96, 512)
        assert np.array_equal(np.asarray(ja.q), tb.q.numpy())
        assert np.array_equal(np.asarray(ja.scale), tb.scale.numpy())
        # the planar triple dequantizes to the raw file's values
        dq = {"q4k": tq4k.dequantize_q4k_raw,
              "q5k": tkquants.dequantize_q5k_raw,
              "q6k": tkquants.dequantize_q6k_raw}[mode](raw).reshape(96, 512)
        np.testing.assert_array_equal(tdequant(tb).numpy(), dq.T)

    @pytest.mark.parametrize("mode", ["int8", "int4", "mixed", "q4", *MODES])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_dequant_every_form(self, f32_params, mode, dtype):
        """Every QTensor form, stacked and layer-sliced: f32 exact, bf16
        within one bf16 ulp (XLA may keep the product in f32 before the
        zero's subtraction)."""
        tdt, jdt = DTYPES[dtype]
        jp = quantize_params(f32_params, mode)
        tp = from_jax_params(jp)
        for name in ("fc1", "fc2"):
            ja = jp["decoder"]["blocks"][name]["w"]
            tb = tp["decoder"]["blocks"][name]["w"]
            want, got = jdequant(ja, jdt), tdequant(tb, tdt)
            assert got.dtype == tdt and tuple(got.shape) == want.shape
            if dtype == "f32":
                np.testing.assert_array_equal(_np(got), _np(want))
            else:
                assert _rel(got, want) <= 2.0 ** -7
            sliced = tdequant(tb.map(lambda t: t[1]), tdt)
            assert torch.equal(sliced, got[1])


# ---------------------------------------------------------------------------
# K10, K11
# ---------------------------------------------------------------------------

def _byte_perm(x: int, y: int, s: int) -> int:
    """``__byte_perm(x, y, s)``: byte i of the result is byte (s >> 4i) & 7
    of the 8 bytes of y:x."""
    b = [(x >> 8 * i) & 0xFF for i in range(4)] \
        + [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(s >> 4 * i) & 7] << 8 * i for i in range(4))


def _bf16(bits: int) -> float:
    return float(np.array([bits << 16], np.uint32).view(np.float32)[0])


def _kq_pair(mode: str, e: int, o: int, b: int):
    """csrc ``kq_pair``: byte b of e and of o, masked into the mantissa of
    a bf16 128 (Q6_K: with bit 5 flipped), less 128 (Q6_K: 160); the two
    halves' values. The subtraction is exact where its result is a bf16,
    which the integers of the range are."""
    mask, bias = (0x007F007F, 0x43004300) if mode == "q5k" \
        else (0x003F003F, 0x43204320)
    v = (_byte_perm(e, o, b | ((4 + b) << 8)) & mask) ^ bias
    off = _bf16(bias & 0xFFFF)
    return (_bf16(v & 0xFFFF) - off, _bf16(v >> 16) - off)


def _check_kq_plan(plan, K: int, N: int, M: int, sub: int) -> None:
    """K10's / K11's launch: every split whole ``sub``-groups, none empty,
    the splits covering every K row once, in order; clusters within the
    plan's limit, the launch within ``BLOCKS`` blocks once split; shared
    memory within 227 KB."""
    assert 1 <= plan.n_split <= tq4k.MAX_SPLIT
    assert plan.n_split == 1 or \
        plan.n_split * -(-N // tq4k.STRIP) <= tq4k.BLOCKS
    assert plan.split_rows % sub == 0
    ranges = plan.k_ranges(K)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a < b and (b - a) % sub == 0 for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0]
               for i in range(len(ranges) - 1))
    assert tq4k.kq_smem(M, plan) <= 227 * 1024


class TestMatvecs:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("M", [1, 3])
    def test_matvec_matches_jax(self, kq_params, mode, dtype, M):
        tdt, jdt = DTYPES[dtype]
        jp, tp, _, _ = kq_params[mode]
        jw = jp["decoder"]["blocks"]["fc1"]["w"]
        tw = tp["decoder"]["blocks"]["fc1"]["w"]
        x = np.random.default_rng(M).normal(0, 1, (M, 256)).astype(
            np.float32)
        xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
        if mode == "q4k":
            want = jq4k.q4k_matvec_stacked(xj, jw.q, jw.scale, jw.zero, 1,
                                           interpret=True)
            got = tq4k.q4k_matvec_stacked(xt, tw.q, tw.scale, tw.zero, 1)
        else:
            want = jkquants.kq_matvec_stacked(xj, jw.q, jw.scale, jw.zero,
                                              1, interpret=True)
            got = tkquants.kq_matvec_stacked(xt, tw.q, tw.scale, tw.zero, 1)
        assert got.dtype == tdt and tuple(got.shape) == (M, 1024)
        _close(got, want, dtype, mode)

    @pytest.mark.parametrize("mode", MODES)
    def test_inputs_round_before_dot_and_group_sums(self, kq_params, mode):
        """The blocks' matvec (``kq_mv``) rounds its f32 input to the
        compute dtype before the dot AND before the group sums of the zero
        term, as the JAX kernels do: in bf16 it equals, to f32 summation
        order, a float64 evaluation on the bf16-rounded input, which the
        unrounded input misses by far more."""
        _, tp, _, tq = kq_params[mode]
        tri = tq["blk"]["fc1"]
        h = torch.from_numpy(np.random.default_rng(3).normal(
            0, 1, (2, 256)).astype(np.float32))
        w = tdequant(tp["decoder"]["blocks"]["fc1"]["w"]).double()[1]

        def ref(x):
            return (x.double() @ w).numpy()
        got = tkq.kq_mv(h, tri, 1, torch.bfloat16).double().numpy()
        want = ref(h.to(torch.bfloat16).float())
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-5 * scale
        assert np.abs(ref(h) - want).max() > 1e-3 * scale

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("N", [128, 384])
    @pytest.mark.parametrize("K", [32, 96, 288])
    @pytest.mark.parametrize("M", [1, 9, 17, 32, 33])
    def test_q4k_matvec_edges(self, M, K, N, dtype):
        """K10's plain version against the JAX kernel at the edges of the
        card kernel's cut: 8-row tiles and 32-row chunks (M 9, 17, 33), odd
        group counts (K / 32 = 1, 3, 9: splits end mid-range) and a strip
        and a half of 128 columns (N 384)."""
        tdt, jdt = DTYPES[dtype]
        rng = np.random.default_rng(M * 1000 + K + N)
        wq = rng.integers(-128, 128, (2, K // 2, N), dtype=np.int8)
        s = rng.uniform(0.5, 1.5, (2, K // 32, N)).astype(np.float32) \
            / (7.5 * np.sqrt(K))
        z = s * 7.5 * rng.uniform(0.9, 1.1, s.shape).astype(np.float32)
        x = rng.normal(0, 1, (M, K)).astype(np.float32)
        xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
        want = jq4k.q4k_matvec_stacked(xj, jnp.asarray(wq), jnp.asarray(s),
                                       jnp.asarray(z), 1, interpret=True)
        got = tq4k.q4k_matvec_stacked(xt, *(torch.from_numpy(a)
                                            for a in (wq, s, z)), 1)
        assert got.dtype == tdt and tuple(got.shape) == (M, N)
        _close(got, want, dtype, "q4k")

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    @pytest.mark.parametrize("N", [32, 160])
    @pytest.mark.parametrize("G", [1, 3, 9])
    @pytest.mark.parametrize("M", [1, 9, 17, 33])
    @pytest.mark.parametrize("mode", ["q5k", "q6k"])
    def test_kq_matvec_edges(self, mode, M, G, N, dtype):
        """K11's plain version against the JAX kernel at the edges of the
        card kernel's cut: 8-row tiles and 32-row chunks (M 9, 17, 33), odd
        group counts (K of 1, 3, 9 groups: 32, 96, 288 for Q5_K, 16, 48,
        144 for Q6_K; splits end mid-range) and part strips of 128 columns
        (N 32, 160). Values span each format's range (Q5_K 0..31, Q6_K
        -32..31). The JAX kernel takes N in lanes of 128: it runs on the
        weights padded with zero columns, which leave the real columns'
        sums as they are, and its first N columns are compared."""
        tdt, jdt = DTYPES[dtype]
        sub = 16 if mode == "q6k" else 32
        K = G * sub
        lo, amp = (-32, 16.0) if mode == "q6k" else (0, 15.5)
        rng = np.random.default_rng(M * 1000 + K + N)
        wq = rng.integers(lo, 32, (2, K, N), dtype=np.int8)
        s = rng.uniform(0.5, 1.5, (2, G, N)).astype(np.float32) \
            / (amp * np.sqrt(K))
        z = None if mode == "q6k" else \
            s * amp * rng.uniform(0.9, 1.1, s.shape).astype(np.float32)
        x = rng.normal(0, 1, (M, K)).astype(np.float32)
        pad = ((0, 0), (0, 0), (0, -N % 128))
        xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
        want = jkquants.kq_matvec_stacked(
            xj, jnp.asarray(np.pad(wq, pad)), jnp.asarray(np.pad(s, pad)),
            None if z is None else jnp.asarray(np.pad(z, pad)), 1,
            interpret=True)[:, :N]
        got = tkquants.kq_matvec_stacked(
            xt, torch.from_numpy(wq), torch.from_numpy(s),
            None if z is None else torch.from_numpy(z), 1)
        assert got.dtype == tdt and tuple(got.shape) == (M, N)
        _close(got, want, dtype, mode)

    @pytest.mark.parametrize("D", [384, 512, 1280])
    @pytest.mark.parametrize("M", [1, 8, 17, 32])
    def test_q4k_plan(self, D, M):
        """K10's launch at the scan step's four shapes (D x 3D, D x D, fc1
        D x 4D, fc2 4D x D) of the whisper-tiny, base and large-v3 widths:
        every split whole 32-groups, none empty, the splits covering every
        K row once, in order; clusters within the plan's limit, the launch
        within ``BLOCKS`` blocks once split; shared memory within
        227 KB."""
        for K, N in ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D)):
            _check_kq_plan(tq4k.kq_plan(K, N), K, N, M, 32)

    @pytest.mark.parametrize("D", [384, 512, 1280])
    @pytest.mark.parametrize("M", [1, 8, 17, 32])
    @pytest.mark.parametrize("mode", ["q5k", "q6k"])
    def test_kq_plan(self, mode, D, M):
        """K11's launch at the scan step's four shapes of the whisper-tiny,
        base and large-v3 widths, with ``test_q4k_plan``'s assertions in
        the format's groups (Q6_K's 16)."""
        sub = 16 if mode == "q6k" else 32
        for K, N in ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D)):
            _check_kq_plan(tq4k.kq_plan(K, N, sub), K, N, M, sub)

    @pytest.mark.parametrize("mode", MODES)
    def test_matvec_one_call_per_chunk(self, monkeypatch, mode):
        """``kq_matvec_cuda`` calls ``wa_kq_matvec`` once per chunk of at
        most 32 rows (40 rows: 32, then 8), each call with one argument
        per ctypes type, the chunk's pointer offsets and the plan of K10
        (q4k) or K11 (q5k, q6k) in the format's groups, and counts each
        launch."""
        calls = []

        class Lib:
            def wa_kq_matvec(self, *args):
                calls.append(args)
                return 0

        monkeypatch.setattr(tq4k._build, "library", Lib)
        monkeypatch.setattr(tq4k._build, "stream", lambda: 7)
        K, N, sub = 512, 1536, 16 if mode == "q6k" else 32
        rows = K // 2 if mode == "q4k" else K
        wq = torch.zeros((2, rows, N), dtype=torch.int8)
        s = torch.ones((2, K // sub, N))
        z = None if mode == "q6k" else torch.zeros((2, K // sub, N))
        x = torch.zeros((40, K), dtype=torch.bfloat16)
        launches = {"mv": 0}
        y = tq4k.kq_matvec_cuda(x, wq, s, z, 1, mode, "mv", launches)
        assert y.shape == (40, N) and y.dtype == x.dtype
        assert launches["mv"] == 2 and len(calls) == 2
        for args, (r0, m) in zip(calls, ((0, 32), (32, 8))):
            assert len(args) == len(tq4k._build._SIGNATURES["wa_kq_matvec"])
            assert args[0] == x.data_ptr() + r0 * K * 2
            assert args[2:5] == (m, K, tq4k.KQ_FMT[mode])
            assert args[5] == wq.data_ptr() + rows * N
            assert args[9] == y.data_ptr() + r0 * N * 2
            assert tuple(args[10:12]) == tuple(tq4k.kq_plan(K, N, sub))
            assert (args[8] is None) == (mode == "q6k") and args[-1] == 7

    @pytest.mark.parametrize("mode", ["q5k", "q6k"])
    def test_kq_pair_exact_over_the_range(self, mode):
        """csrc ``kq_pair`` in numpy: for every pair of values of the
        format's range (Q5_K 0..31, Q6_K -32..31) at every byte position
        of the two words, the bf16 pair it makes is (even row's value, odd
        row's value), exactly."""
        rng = np.random.default_rng(11)
        vals = range(0, 32) if mode == "q5k" else range(-32, 32)
        for e, o in itertools.product(vals, vals):
            for b in range(4):
                we, wo = (int(w) for w in rng.integers(0, 2 ** 32, 2))
                we = we & ~(0xFF << 8 * b) | (e & 0xFF) << 8 * b
                wo = wo & ~(0xFF << 8 * b) | (o & 0xFF) << 8 * b
                assert _kq_pair(mode, we, wo, b) == (e, o)

    @pytest.mark.parametrize("mode", ["q5k", "q6k"])
    def test_kq_fragments_mirror(self, mode):
        """K11's reader in numpy, over one group of a 128-column strip that
        holds every value of the format's range: lane (g, t) loads the
        16-byte vectors at vector g of value rows 2t, 2t + 1, 2t + 8,
        2t + 9 of each k16 step (csrc ``fetch_w``), and its A registers of
        mma j (``kq_pair``) hold the weights at their (row, k) of the
        m16n8k16 layout: A row g is column 16g + 2j, row g + 8 column
        16g + 2j + 1; a0 K 2t, 2t + 1 of row g, a1 of row g + 8, a2 and a3
        K 2t + 8, 2t + 9."""
        sub, lo = (32, 0) if mode == "q5k" else (16, -32)
        n_vals = 32 if mode == "q5k" else 64
        rng = np.random.default_rng(12)
        W = rng.permutation(np.arange(sub * 128) % n_vals + lo).astype(
            np.int8).reshape(sub, 128)
        wb = W.view(np.uint8)

        def words(row, g):
            v = wb[row, 16 * g:16 * g + 16]
            return [int.from_bytes(bytes(v[4 * i:4 * i + 4]), "little")
                    for i in range(4)]

        for lane in range(32):
            g, t = lane >> 2, lane & 3
            rows = [16 * (i // 4) + 2 * t + (i & 1) + 8 * ((i >> 1) & 1)
                    for i in range(2 * sub // 8)]
            r = [words(row, g) for row in rows]
            for s in range(sub // 16):
                k = 16 * s + 2 * t
                for j in range(8):
                    wd, b0 = j // 2, 2 * (j % 2)
                    c0, c1 = 16 * g + 2 * j, 16 * g + 2 * j + 1
                    a = [_kq_pair(mode, r[4 * s][wd], r[4 * s + 1][wd], b0),
                         _kq_pair(mode, r[4 * s][wd], r[4 * s + 1][wd],
                                  b0 + 1),
                         _kq_pair(mode, r[4 * s + 2][wd], r[4 * s + 3][wd],
                                  b0),
                         _kq_pair(mode, r[4 * s + 2][wd], r[4 * s + 3][wd],
                                  b0 + 1)]
                    assert a == [(W[k, c0], W[k + 1, c0]),
                                 (W[k, c1], W[k + 1, c1]),
                                 (W[k + 8, c0], W[k + 9, c0]),
                                 (W[k + 8, c1], W[k + 9, c1])]

    def test_q4k_nibbles_zero_extend(self):
        """Bytes >= 0x80 (negative as int8) split into 8..15 high
        nibbles: a weight of all 0xF7 bytes is lo 7, hi 15."""
        wq = torch.full((1, 16, 32), -9, dtype=torch.int8)      # 0xF7
        s = torch.ones((1, 1, 32))
        z = torch.zeros((1, 1, 32))
        x = torch.zeros((1, 32))
        x[0, 0], x[0, 1] = 1.0, 1.0 / 16                    # k = 0 and 1
        y = tq4k.q4k_matvec_stacked(x, wq, s, z, 0)
        assert torch.allclose(y, torch.full((1, 32), 7 + 15 / 16))


# ---------------------------------------------------------------------------
# K12-K14
# ---------------------------------------------------------------------------

def _caches(rows: str, dtype: str, seed: int, T: int):
    """(JAX, port) (kq, ks, vq, vs) of one [2, 1, T, 256] cache: rows in
    the compute dtype, or int8 with f32 row scales."""
    rng = np.random.default_rng(seed)
    k, v = (rng.normal(0, 1, (2, 1, T, 256)).astype(np.float32)
            for _ in range(2))
    _, jdt = DTYPES[dtype]
    if rows == "int8":
        (kq, ks), (vq, vs) = jqrows(jnp.asarray(k)), jqrows(jnp.asarray(v))
        j = (kq, ks, vq, vs)
    else:
        j = (jnp.asarray(k, jdt), None, jnp.asarray(v, jdt), None)
    return j, tuple(from_jax_params(a) for a in j)


class TestBlocks:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("dtype,rows", [("f32", "rows"),
                                            ("bf16", "rows"),
                                            ("f32", "int8")])
    def test_blocks_match_jax(self, kq_params, mode, dtype, rows):
        tdt, jdt = DTYPES[dtype]
        _, _, jqdd, tqdd = kq_params[mode]
        jblk, tblk = dict(jqd.kq_block_operands(jqdd)), dict(tqdd["blk"])
        # init_params has zero biases and unit LayerNorms: draw them
        rng = np.random.default_rng(5)
        for k in ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "ln3_w", "ln3_b",
                  "bqkv", "b_self_o", "b_cross_q", "b_cross_o", "b_fc1",
                  "b_fc2"):
            a = rng.normal(1.0 if k.endswith("_w") else 0.0, 0.1,
                           tblk[k].shape).astype(np.float32)
            jblk[k], tblk[k] = jnp.asarray(a.reshape(jblk[k].shape)), \
                torch.from_numpy(a)
        x = np.random.default_rng(2).normal(0, 1, (1, 256)).astype(
            np.float32)
        xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
        jc, tc = _caches(rows, dtype, seed=3, T=256)
        for pos, layer in ((0, 0), (130, 1)):
            want = jkq.self_block_kq(xj, jblk, *jc, pos, layer, 4,
                                     interpret=True)
            got = tkq.self_block_kq(xt, tblk, *tc, pos, layer, 4)
            assert got[0].dtype == tdt
            _close(got[0], want[0], dtype, mode, attends=True)
            if rows == "int8":
                for g, w in ((got[1], want[1]), (got[3], want[3])):
                    assert int((g.int() - torch.from_numpy(
                        np.asarray(w).astype(np.int32))).abs().max()) <= 1
            else:
                _close(got[1], want[1], dtype, mode)
        jc, tc = _caches(rows, dtype, seed=4, T=256)
        want = jkq.cross_block_kq(xj, jblk, *jc, 200, 1, 4, interpret=True)
        got = tkq.cross_block_kq(xt, tblk, *tc, 200, 1, 4)
        _close(got, want, dtype, mode, attends=True)
        want = jkq.ffn_block_kq(xj, jblk, 1, interpret=True)
        got = tkq.ffn_block_kq(xt, tblk, 1)
        assert got.dtype == tdt
        _close(got, want, dtype, mode)

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("dtype,rows", [("f32", "rows"),
                                            ("bf16", "rows"),
                                            ("f32", "int8"),
                                            ("bf16", "int8")])
    def test_cross_block_enc_len_edges(self, kq_params, mode, dtype, rows):
        """K13 at the cross lengths that cut its attention apart: none
        (every padded row at NEG), one row, either side of a 32-row group
        and the whole cache."""
        tdt, jdt = DTYPES[dtype]
        _, _, jqdd, tqdd = kq_params[mode]
        jblk, tblk = dict(jqd.kq_block_operands(jqdd)), dict(tqdd["blk"])
        rng = np.random.default_rng(6)
        for k in ("ln2_w", "ln2_b", "b_cross_q", "b_cross_o"):
            a = rng.normal(1.0 if k.endswith("_w") else 0.0, 0.1,
                           tblk[k].shape).astype(np.float32)
            jblk[k], tblk[k] = jnp.asarray(a.reshape(jblk[k].shape)), \
                torch.from_numpy(a)
        T = 256                 # the JAX kernel's row block
        jc, tc = _caches(rows, dtype, seed=8, T=T)
        for i, enc_len in enumerate((0, 1, 31, 32, 33, T)):
            x = rng.normal(0, 1, (1, 256)).astype(np.float32)
            xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
            want = jkq.cross_block_kq(xj, jblk, *jc, enc_len, i % 2, 4,
                                      interpret=True)
            got = tkq.cross_block_kq(xt, tblk, *tc, enc_len, i % 2, 4)
            assert got.dtype == tdt
            _close(got, want, dtype, mode, attends=True)

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("dtype,rows", [("f32", "rows"),
                                            ("bf16", "rows"),
                                            ("f32", "int8"),
                                            ("bf16", "int8")])
    def test_self_block_pos_edges(self, kq_params, mode, dtype, rows):
        """K12 at the positions that cut its attention apart: no history,
        one row, either side of the JAX kernel's 128-row block and the
        last row of a 256-row cache; the new k/v rows as the cache holds
        them (int8 rows within one step)."""
        tdt, jdt = DTYPES[dtype]
        _, _, jqdd, tqdd = kq_params[mode]
        jblk, tblk = dict(jqd.kq_block_operands(jqdd)), dict(tqdd["blk"])
        rng = np.random.default_rng(11)
        for k in ("ln1_w", "ln1_b", "bqkv", "b_self_o"):
            a = rng.normal(1.0 if k.endswith("_w") else 0.0, 0.1,
                           tblk[k].shape).astype(np.float32)
            jblk[k], tblk[k] = jnp.asarray(a.reshape(jblk[k].shape)), \
                torch.from_numpy(a)
        T = 256                 # two of the JAX kernel's 128-row blocks
        jc, tc = _caches(rows, dtype, seed=12, T=T)
        for i, pos in enumerate((0, 1, 127, 128, 129, T - 1)):
            x = rng.normal(0, 1, (1, 256)).astype(np.float32)
            xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
            want = jkq.self_block_kq(xj, jblk, *jc, pos, i % 2, 4,
                                     interpret=True)
            got = tkq.self_block_kq(xt, tblk, *tc, pos, i % 2, 4)
            assert got[0].dtype == tdt
            _close(got[0], want[0], dtype, mode, attends=True)
            if rows == "int8":
                for g, w in ((got[1], want[1]), (got[3], want[3])):
                    assert int((g.int() - torch.from_numpy(
                        np.asarray(w).astype(np.int32))).abs().max()) <= 1
            else:
                _close(got[1], want[1], dtype, mode)
                _close(got[3], want[3], dtype, mode)

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("D,H", [(384, 6), (512, 8), (768, 12),
                                     (1280, 20)])
    def test_self_kq_plan(self, mode, D, H):
        """K12's launch at the tiny, base, small and large-v3 widths:
        clusters of at most 16 blocks, every block's share of the QKV
        rows whole groups (none empty, in rank order, all of D), every
        history row in some block, shared memory at 192 projected
        columns a head within 227 KB."""
        sub = tkq.KQ_SUB[mode]
        for pos, cache_size in ((0, 1), (1, 2), (128, 2), (447, 4),
                                (448, 1)):
            plan = tkq.cross_kq_plan(H, D, pos, cache_size, mode)
            assert 1 <= plan.cluster <= min(16, D // sub)
            assert plan.rows * plan.cluster >= pos
            shares = tkq.kq_shares(D, plan.cluster, mode)
            assert shares[0][0] == 0 and shares[-1][1] == D
            assert all(a < b and a % sub == 0 and b % sub == 0
                       for a, b in shares)
            assert all(shares[i][1] == shares[i + 1][0]
                       for i in range(len(shares) - 1))
            smem = tkq.head_smem(D, plan.cluster, plan.chunk, cache_size,
                                 mode, W=192)
            assert tkq.head_smem(D, plan.cluster, plan.chunk, cache_size,
                                 mode) < smem <= 227 * 1024

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("rows", ["int8", "bf16"])
    def test_self_block_one_launch(self, kq_params, monkeypatch, mode,
                                   rows):
        """``_self_block_kq_cuda`` makes one call of the C entry point
        with one argument per ctypes type, the format, the plan for its
        history rows and K1's scratch (the head-ordered partials, the
        tickets and, on int8 rows only, the projection between the two
        launches), and counts one launch."""
        _, _, _, tqdd = kq_params[mode]
        blk = tqdd["blk"]
        calls, spaces = [], []

        class Lib:
            def wa_self_block_kq(self, *args):
                calls.append(args)
                return 0

        def workspace(st, dev, name, n, dtype=torch.float32, zero=False):
            spaces.append((name, n, dtype, zero))
            return 1000 + len(spaces)

        monkeypatch.setattr(tkq._build, "library", Lib)
        monkeypatch.setattr(tkq._build, "stream", lambda: 7)
        monkeypatch.setattr(tkq._build, "workspace", workspace)
        _, (kq, ks, vq, vs) = _caches("int8" if rows == "int8" else "rows",
                                      "bf16", seed=13, T=256)
        x = torch.zeros((1, 256), dtype=torch.bfloat16)
        before = tkq.LAUNCHES["self_block_kq"]
        out = tkq._self_block_kq_cuda(x, blk, kq, ks, vq, vs, 130, 1, 4)
        assert out[0].shape == x.shape and out[1].dtype == kq.dtype
        assert tkq.LAUNCHES["self_block_kq"] == before + 1
        args = calls[0]
        assert len(calls) == 1
        assert len(args) == len(tkq._build._SIGNATURES["wa_self_block_kq"])
        assert args[4] == tkq.KQ_FMT[mode] and args[16:18] == (256, 130)
        assert tuple(args[27:30]) == tuple(tkq.cross_kq_plan(
            4, 256, 130, kq.element_size(), mode))
        assert args[-1] == 7
        assert (args[9] is None) == (mode == "q6k")      # the QKV's zeros
        want = [("self_y", 4 * 256, torch.float32, False),
                ("self_tickets", 16, torch.int32, True)]
        if rows == "int8":
            want.append(("self_qkv", 3 * 256, torch.float32, False))
        assert spaces == want
        assert args[30:32] == (1001, 1002)
        assert args[32] == (1003 if rows == "int8" else None)

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("D,H", [(384, 6), (512, 8), (768, 12),
                                     (1280, 20)])
    def test_cross_kq_plan(self, mode, D, H):
        """K13's launch at the tiny, base, small and large-v3 widths:
        clusters of at most 16 blocks, every block's share of Wq whole
        groups (none empty, in rank order, all of D), a head's 64 rows of
        Wo whole groups, every cross row in some block, shared memory
        within 227 KB."""
        sub = tkq.KQ_SUB[mode]
        assert 64 % sub == 0
        for n_loop, cache_size in ((1500, 1), (1, 2), (1536, 4), (448, 1)):
            plan = tkq.cross_kq_plan(H, D, n_loop, cache_size, mode)
            assert 1 <= plan.cluster <= 16
            assert plan.rows * plan.cluster >= n_loop
            shares = tkq.kq_shares(D, plan.cluster, mode)
            assert shares[0][0] == 0 and shares[-1][1] == D
            assert all(a < b and a % sub == 0 and b % sub == 0
                       for a, b in shares)
            assert all(shares[i][1] == shares[i + 1][0]
                       for i in range(len(shares) - 1))
            assert tkq.head_smem(D, plan.cluster, plan.chunk, cache_size,
                                 mode) <= 227 * 1024

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("enc_len", [200, 0])
    def test_cross_block_one_launch(self, kq_params, monkeypatch, mode,
                                    enc_len):
        """``_cross_block_kq_cuda`` makes one call of the C entry point
        with one argument per ctypes type, the format, the plan for its
        rows (all T of them when enc_len is 0) and K2's scratch, and
        counts one launch."""
        _, _, _, tqdd = kq_params[mode]
        blk = tqdd["blk"]
        calls, spaces = [], []

        class Lib:
            def wa_cross_block_kq(self, *args):
                calls.append(args)
                return 0

        def workspace(st, dev, name, n, dtype=torch.float32, zero=False):
            spaces.append((name, n, dtype, zero))
            return 1000 + len(spaces)

        monkeypatch.setattr(tkq._build, "library", Lib)
        monkeypatch.setattr(tkq._build, "stream", lambda: 7)
        monkeypatch.setattr(tkq._build, "workspace", workspace)
        _, (kq, ks, vq, vs) = _caches("int8", "f32", seed=9, T=256)
        x = torch.zeros((1, 256))
        before = tkq.LAUNCHES["cross_block_kq"]
        y = tkq._cross_block_kq_cuda(x, blk, kq, ks, vq, vs, enc_len, 1, 4)
        assert y.shape == x.shape
        assert tkq.LAUNCHES["cross_block_kq"] == before + 1
        args = calls[0]
        assert len(calls) == 1
        assert len(args) == len(tkq._build._SIGNATURES["wa_cross_block_kq"])
        assert args[4] == tkq.KQ_FMT[mode] and args[16:18] == (256, enc_len)
        assert tuple(args[23:26]) == tuple(tkq.cross_kq_plan(
            4, 256, enc_len or 256, 1, mode))
        assert args[-1] == 7
        assert (args[9] is None) == (mode == "q6k")      # Wq's zero plane
        assert spaces == [("cross_y", 4 * 256, torch.float32, False),
                          ("cross_tickets", 16, torch.int32, True)]

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("D", [384, 512, 768, 1024, 1280])
    def test_ffn_kq_plan(self, mode, D):
        """K14's launch at the tiny, base, small, medium and large-v3
        widths: every block's hidden units whole groups of fc2's input
        rows (q4k: whole groups of byte rows), the units of all blocks
        covering the hidden layer once, clusters of 8 blocks (within K3's
        16 tickets), and a shared-memory layout of 16-byte aligned regions
        that adds up to ``ffn_kq_smem`` and stays within 227 KB."""
        H, sub = 4 * D, tkq.KQ_SUB[mode]
        vpb, planes = tkq.KQ_VPB[mode], tkq.KQ_PLANES[mode]
        U = tkq.ffn_kq_units(H, mode)
        assert U % sub == 0 and (U // vpb) % (sub // vpb) == 0
        C = tkq.FFN_CLUSTER
        assert C <= 16 and H % (C * U) == 0
        units = [u for cl in range(H // (C * U)) for r in range(C)
                 for u in range((cl * C + r) * U, (cl * C + r + 1) * U)]
        assert sorted(units) == list(range(H))
        regions = [4 * D, D // vpb * U, planes * (D // sub) * U * 4,
                   U // vpb * D, planes * (U // sub) * D * 4,
                   16 * -(-(D // sub + U // sub) // 4), 8 * U * 4, U * 4,
                   4 * D, 16, 16]
        assert all(r % 16 == 0 for r in regions)
        assert sum(regions) == tkq.ffn_kq_smem(D, H, mode) <= 227 * 1024

    @pytest.mark.parametrize("mode", MODES)
    def test_ffn_block_one_launch(self, kq_params, monkeypatch, mode):
        """``_ffn_block_kq_cuda`` makes one call of the C entry point with
        one argument per ctypes type and the format, hands it K3's scratch
        (the clusters' sums, sized by ``wa_ffn_scratch``, and the tickets,
        zeroed once) and no GELU scratch, and counts one launch."""
        _, _, _, tqdd = kq_params[mode]
        blk = tqdd["blk"]
        calls, spaces = [], []

        class Lib:
            def wa_ffn_block_kq(self, *args):
                calls.append(args)
                return 0

            def wa_ffn_scratch(self, D, H):
                return H // 256 * D

        def workspace(st, dev, name, n, dtype=torch.float32, zero=False):
            spaces.append((name, n, dtype, zero))
            return 1000 + len(spaces)

        monkeypatch.setattr(tkq._build, "library", Lib)
        monkeypatch.setattr(tkq._build, "stream", lambda: 7)
        monkeypatch.setattr(tkq._build, "workspace", workspace)
        x = torch.zeros((1, 256), dtype=torch.bfloat16)
        before = tkq.LAUNCHES["ffn_block_kq"]
        y = tkq._ffn_block_kq_cuda(x, blk, 1)
        assert y.shape == x.shape and y.dtype == x.dtype
        assert tkq.LAUNCHES["ffn_block_kq"] == before + 1
        assert len(calls) == 1
        args = calls[0]
        assert len(args) == len(tkq._build._SIGNATURES["wa_ffn_block_kq"])
        assert args[2:5] == (256, 1024, tkq.KQ_FMT[mode])
        assert (args[9] is None) == (args[13] is None) == (mode == "q6k")
        assert spaces == [("ffn_y", 1024 // 256 * 256, torch.float32, False),
                          ("ffn_tickets", 16, torch.int32, True)]
        assert args[16:] == (1001, 1002, 7)

    def test_weight_fmt(self, kq_params):
        for mode in MODES:
            blk = kq_params[mode][3]["blk"]
            assert all(tkq.weight_fmt(blk[k]) == mode
                       for k in ("qkv", "self_o", "cross_q", "cross_o",
                                 "fc1", "fc2"))


# ---------------------------------------------------------------------------
# decode steps, transcode
# ---------------------------------------------------------------------------

def _prefilled(jp, seed: int = 0, max_len: int = 8):
    cfg = _cfg()
    rng = np.random.default_rng(seed)
    enc = jnp.asarray(rng.normal(0, 0.5, (1, cfg.n_audio_ctx, 256)).astype(
        np.float32))
    cache = jinit_cache(jp, enc, cfg, max_len=max_len)
    _, cache = jprefill(jp, jnp.full((1, 2), 5, jnp.int32), enc, cache, cfg)
    return cache


class TestDecodeSteps:
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("step", ["scan", "fused"])
    def test_three_steps_match_jax(self, kq_params, mode, step):
        cfg = _cfg()
        jp, tp, jqdd, tqdd = kq_params[mode]
        jcache = _prefilled(jp)
        if step == "fused":
            jcache = jqd.quantize_cache(jcache, mode="cross8")
            jfn, tfn = jqd.decode_step_qf, tqd.decode_step_qf
        else:
            jfn, tfn = jqd.decode_step_q, tqd.decode_step_q
        tcache = from_jax_params(jcache)
        tok = np.array([7], np.int32)
        for i in range(3):
            la, jcache = jfn(jp, jqdd, jnp.asarray(tok), jnp.int32(2 + i),
                             jcache, cfg, compute_dtype=jnp.float32,
                             interpret=True)
            lb, tcache = tfn(tp, tqdd, torch.from_numpy(tok), 2 + i, tcache,
                             cfg, compute_dtype=torch.float32)
            np.testing.assert_allclose(lb.numpy(), np.asarray(la),
                                       **STEP_TOL)
            assert np.array_equal(lb.numpy().argmax(-1),
                                  np.asarray(la).argmax(-1))
            tok = np.asarray(la).argmax(-1).astype(np.int32)

    def test_fused_rejects_batch(self, kq_params):
        jp, tp, _, tqdd = kq_params["q4k"]
        assert tqd.qf_supported(tqdd, 1) and not tqd.qf_supported(tqdd, 2)
        cache = from_jax_params(jqd.quantize_cache(
            _prefilled(jp), mode="bf16"))
        with pytest.raises(NotImplementedError):
            tqd.decode_step_qf(tp, tqdd, torch.tensor([1, 2], dtype=torch.int32),
                               2, cache, _cfg())

    @pytest.mark.parametrize("mode", MODES)
    def test_transcode_matches_jax(self, kq_params, mode):
        cfg = _cfg()
        jp, tp, _, _ = kq_params[mode]
        want, got = jqd.transcode_kq_to_int8(jp, cfg), \
            tqd.transcode_kq_to_int8(tp, cfg)
        assert "mode" not in got
        for k in ("wqkv", "self_wo", "wcq", "cross_wo", "w1", "w2"):
            w, g = np.asarray(want["blk"][k]).astype(np.int32), \
                got["blk"][k].numpy().astype(np.int32)
            d = np.abs(w - g)
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, k
        for k in ("sqkv", "self_wos", "scq", "cross_wos", "s1", "fc2_s"):
            np.testing.assert_allclose(got["blk"][k].numpy(),
                                       np.asarray(want["blk"][k]),
                                       rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the engine and the scheduler
# ---------------------------------------------------------------------------

def _specials(cls, V: int = 512):
    return cls(eot=V - 1, sot=V - 2, lang_base=V - 110, transcribe=V - 3,
               no_timestamps=V - 4, timestamp_base=V + 1000,
               is_multilingual=False, translate=V - 5, no_speech=V - 6,
               speaker_turn=V - 7, prev=V - 8)


def _audio(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    return (0.3 * np.sin(2 * np.pi * 330 * t)
            + rng.normal(0, 0.05, n)).astype(np.float32)


def _apr_bytes(cfg, f32_params, mode) -> bytes:
    w = AprWriter.from_config(cfg, quantization=FILE_CODES[mode])
    for name, arr in params_to_apr_tensors(from_jax_params(
            f32_params)).items():
        w.add_tensor(name, arr)
    return w.to_bytes()


def _force_qd(jeng):
    """The JAX engine gates its kernel path off the CPU: force it on."""
    cfg = jeng.config
    jeng._qdecode_cache = (jqd.prepare_qdecode(jeng.params, cfg)
                           or jqd.prepare_q4k_decode(jeng.params, cfg)
                           or jqd.prepare_kq_decode(jeng.params, cfg))
    return jeng


def _jax(fn, *a, **kw):
    jqd.INTERPRET = True
    try:
        return fn(*a, **kw)
    finally:
        jqd.INTERPRET = False


OPTS = dict(language="en", max_tokens=6)


class TestEngine:
    @pytest.mark.parametrize("mode,source", [("q4k", "apr"),
                                             ("q5k", "quantize"),
                                             ("q6k", "quantize")])
    def test_greedy_tokens_match_jax(self, f32_params, mode, source):
        cfg = _cfg()
        spec = dict(specials=_specials(SpecialTokens))
        if source == "apr":
            data = _apr_bytes(cfg, f32_params, mode)
            jeng = JWhisperApr.load_from_apr(
                data, JCompute(quantization=mode), **spec)
            teng = WhisperApr.load_from_apr(
                data, TCompute(quantization=mode),
                specials=_specials(TSpecials), device="cpu")
            assert teng._qdecode["mode"] == mode
            fc1 = teng.params["decoder"]["blocks"]["fc1"]["w"]
            assert np.array_equal(
                fc1.q.numpy(),
                np.asarray(jeng.params["decoder"]["blocks"]["fc1"]["w"].q))
        else:
            jeng = JWhisperApr(cfg, f32_params, compute=JCompute(
                quantization=mode), **spec)
            jeng.params = quantize_params(f32_params, mode)
            teng = WhisperApr(cfg, from_jax_params(jeng.params),
                              specials=_specials(TSpecials),
                              compute=TCompute(quantization=mode),
                              device="cpu")
        _force_qd(jeng)
        audio = _audio(8_000, seed=1)
        want = _jax(jeng.transcribe, audio, JOptions(**OPTS))
        got = teng.transcribe(audio, TranscribeOptions(**OPTS))
        assert got.tokens == want.tokens
        np.testing.assert_allclose(got.avg_logprob, want.avg_logprob,
                                   rtol=0, atol=1e-4)

    def test_scan_and_batch_match_jax(self, f32_params):
        """kv_mode "scan" at B = 1 (K10 over Q4_K) and transcribe_batch
        of 2 clips (K5-K8 over the int8 transcode)."""
        cfg = _cfg()
        jp = quantize_params(f32_params, "q4k")
        tp = from_jax_params(jp)
        audios = [_audio(8_000, seed=2), _audio(12_000, seed=3)]
        for kv_mode in ("scan", "auto"):
            jeng = _force_qd(JWhisperApr(
                cfg, jp, specials=_specials(SpecialTokens),
                compute=JCompute(quantization="q4k", kv_mode=kv_mode)))
            teng = WhisperApr(cfg, tp, specials=_specials(TSpecials),
                              compute=TCompute(quantization="q4k",
                                               kv_mode=kv_mode),
                              device="cpu")
            if kv_mode == "scan":
                want = _jax(jeng.transcribe, audios[0], JOptions(**OPTS))
                got = teng.transcribe(audios[0], TranscribeOptions(**OPTS))
                assert got.tokens == want.tokens
            else:
                want = _jax(jeng.transcribe_batch, audios, JOptions(**OPTS))
                got = teng.transcribe_batch(audios,
                                            TranscribeOptions(**OPTS))
                assert teng._qdecode_batched["blk"]["wqkv"].dtype \
                    == torch.int8
                assert [r.tokens for r in got.results] == \
                    [r.tokens for r in want.results]

    def test_scheduler_serves_kquant_engine(self, f32_params):
        """A scheduler over a Q4_K engine serves its slots through the
        int8 transcode, with the JAX scheduler's completions."""
        cfg = _cfg()
        jp = quantize_params(f32_params, "q4k")
        jeng = _force_qd(JWhisperApr(cfg, jp,
                                     specials=_specials(SpecialTokens),
                                     compute=JCompute(quantization="q4k")))
        teng = WhisperApr(cfg, from_jax_params(jp),
                          specials=_specials(TSpecials),
                          compute=TCompute(quantization="q4k"), device="cpu")
        audios = [_audio(3000 + 500 * i, seed=10 + i) for i in range(3)]
        js, ts = JScheduler(jeng, n_slots=2), BatchScheduler(teng, n_slots=2)
        assert ts._qd is teng._qdecode_batched and ts._qf == "int8"

        def drain(sched):
            ids = [sched.submit(a, "en", max_tokens=6) for a in audios]
            sched.run_until_drained()
            return [sched.result(i).tokens for i in ids]
        assert drain(ts) == _jax(drain, js)

    def test_f32_file_quantized_at_load(self, f32_params):
        """An f32 .apr with ComputeConfig(quantization="q5k") is quantized
        at load to the k-quant params quantize_params gives, bit for bit,
        and takes the Q5_K qd."""
        cfg = _cfg()
        w = AprWriter.from_config(cfg)
        for name, arr in params_to_apr_tensors(from_jax_params(
                f32_params)).items():
            w.add_tensor(name, arr)
        teng = WhisperApr.load_from_apr(
            w.to_bytes(), TCompute(quantization="q5k"),
            specials=_specials(TSpecials), device="cpu")
        assert teng._qdecode["mode"] == "q5k"
        want = quantize_params(f32_params, "q5k")["decoder"]["blocks"]
        for name in ("fc1", "fc2"):
            got = teng.params["decoder"]["blocks"][name]["w"]
            assert np.array_equal(got.q.numpy(),
                                  np.asarray(want[name]["w"].q))
            assert np.array_equal(got.scale.numpy(),
                                  np.asarray(want[name]["w"].scale))

    @pytest.mark.parametrize("mode", ["int4", "q4"])
    def test_int4_modes_decode_plain_like_jax(self, f32_params, mode):
        """int4 and group-int4 weights have no kernel path in either
        package: no qd, the plain step, the JAX engine's tokens."""
        cfg = _cfg()
        jp = quantize_params(f32_params, mode)
        teng = WhisperApr(cfg, from_jax_params(jp),
                          specials=_specials(TSpecials),
                          compute=TCompute(quantization=mode), device="cpu")
        assert teng._qdecode is None
        jeng = JWhisperApr(cfg, jp, specials=_specials(SpecialTokens),
                           compute=JCompute(quantization=mode))
        audio = _audio(8_000, seed=6)
        got = teng.transcribe(audio, TranscribeOptions(**OPTS))
        want = jeng.transcribe(audio, JOptions(**OPTS))
        assert got.tokens == want.tokens
        np.testing.assert_allclose(got.avg_logprob, want.avg_logprob,
                                   rtol=0, atol=1e-4)

    def test_tiny_width_falls_back_to_q4(self):
        """At whisper-tiny's width (384, not 256-aligned) "q4k" quantizes
        the attention linears and fc1 to group int4 (fc2, K = 1536, stays
        Q4_K): no k-quant qd in either package, the plain step in both,
        the same tokens."""
        cfg = _cfg(d=384, heads=6)
        jp = quantize_params(init_params(cfg, seed=5), "q4k")
        tp = from_jax_params(jp)
        blocks = tp["decoder"]["blocks"]
        assert blocks["self_attn"]["q_w"].group == 32 \
            and not blocks["self_attn"]["q_w"].kpack
        assert blocks["fc2"]["w"].kpack
        assert jqd.prepare_q4k_decode(jp, cfg) is None
        teng = WhisperApr(cfg, tp, specials=_specials(TSpecials),
                          compute=TCompute(quantization="q4k"), device="cpu")
        assert teng._qdecode is None
        jeng = JWhisperApr(cfg, jp, specials=_specials(SpecialTokens),
                           compute=JCompute(quantization="q4k"))
        audio = _audio(8_000, seed=4)
        assert teng.transcribe(audio, TranscribeOptions(**OPTS)).tokens == \
            jeng.transcribe(audio, JOptions(**OPTS)).tokens
