"""Port kernels K1-K4 (plain PyTorch versions) against the JAX package's
Pallas kernels run in interpret mode, at a small width and B=1.

Same inputs (numpy seeds) go to both; weights cross through
``from_jax_params``. Tolerances are f32: rtol/atol 1e-5 — the only
algorithmic difference is the JAX kernels' A&S erf (|err| < 1.5e-7)
against the exact erf. Token outputs are exact.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.model import qdecode as jqd
from whisper_apr_tpu.model.params import init_params, quantize_params
from whisper_apr_tpu.ops import decode_blocks as jdb
from whisper_apr_tpu.ops.decode_attention import quantize_row as jquantize_row
from whisper_apr_tpu.ops.qmatvec import qmatvec_greedy_head as jhead
from whisper_apr_tpu_torch.model import qdecode as tqd
from whisper_apr_tpu_torch.model.params import from_jax_params
from whisper_apr_tpu_torch.ops import decode_blocks as tdb
from whisper_apr_tpu_torch.ops import qmatvec as tqm
from whisper_apr_tpu_torch.ops.decode_attention import quantize_row


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TOL = dict(rtol=1e-5, atol=1e-5)
SELF_T, CROSS_T = 256, 512          # padded cache lengths (qdecode pads)
ROW_MODES = ("f32", "bf16", "int8", "fp8")


@pytest.fixture(scope="module")
def cfg():
    return ModelConfig(
        model_type="tiny", n_vocab=700, n_audio_ctx=32, n_audio_state=128,
        n_audio_head=4, n_audio_layer=2, n_text_ctx=24, n_text_state=128,
        n_text_head=4, n_text_layer=3, n_mels=80)


@pytest.fixture(scope="module")
def qd(cfg):
    jp = quantize_params(init_params(cfg, seed=3), "int8")
    return jqd.prepare_qdecode(jp, cfg), tqd.prepare_qdecode(
        from_jax_params(jp), cfg)


def _to_torch(a) -> torch.Tensor:
    """JAX array -> torch tensor with the same bits (bf16 / fp8 too)."""
    arr = np.asarray(a)
    name = arr.dtype.name
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    if name == "float8_e4m3fn":
        return torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(arr.copy())


def _cache(mode: str, T: int, D: int, L: int, seed: int):
    """One cache pair (K, V) in ``mode`` as (jax kq, ks, vq, vs) and the
    same bits as torch."""
    rng = np.random.default_rng(seed)
    out_j = []
    for _ in range(2):
        rows = rng.normal(0, 1.0, (L, 1, T, D)).astype(np.float32)
        if mode == "int8":
            q = rng.integers(-127, 128, (L, 1, T, D)).astype(np.int8)
            s = (rng.random((L, 1, T, 1)) * 0.02 + 1e-3).astype(np.float32)
            out_j += [jnp.asarray(q), jnp.asarray(s)]
        else:
            dt = {"f32": jnp.float32, "bf16": jnp.bfloat16,
                  "fp8": jnp.float8_e4m3fn}[mode]
            out_j += [jnp.asarray(rows).astype(dt), None]
    kq, ks, vq, vs = out_j
    conv = [None if a is None else _to_torch(a) for a in out_j]
    return (kq, ks, vq, vs), tuple(conv)


def _x(D: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 1.0, (1, D)).astype(
        np.float32)


class TestSelfBlock:
    @pytest.mark.parametrize("mode", ROW_MODES)
    @pytest.mark.parametrize("pos", [1, 127, 128, 129])
    def test_matches_jax(self, cfg, qd, mode, pos):
        jq, tq = qd
        D, L = cfg.n_text_state, cfg.n_text_layer
        jc, tc = _cache(mode, SELF_T, D, L, seed=pos)
        x = _x(D, seed=pos + 1)
        layer = pos % L
        a = jdb.self_block(jnp.asarray(x), jq["blk"], *jc, pos, layer,
                           cfg.n_text_head, block_t=128, interpret=True)
        b = tdb.self_block(torch.from_numpy(x), tq["blk"], *tc, pos, layer,
                           cfg.n_text_head)
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), **TOL)
        # the emitted rows (in the cache's dtype) and their scales
        for i in range(1, 5):
            assert b[i].dtype == _to_torch(a[i]).dtype
            np.testing.assert_allclose(b[i].float().numpy(),
                                       np.asarray(a[i]).astype(np.float32),
                                       **TOL)

    def test_reads_only_rows_below_pos(self, cfg, qd):
        """Rows >= pos hold no history: garbage there changes nothing."""
        _, tq = qd
        D, L = cfg.n_text_state, cfg.n_text_layer
        _, (kq, ks, vq, vs) = _cache("f32", SELF_T, D, L, seed=5)
        x = torch.from_numpy(_x(D, seed=6))
        ref = tdb.self_block(x, tq["blk"], kq, ks, vq, vs, 40, 1, 4)[0]
        kq2, vq2 = kq.clone(), vq.clone()
        kq2[:, :, 40:] = 1e4
        vq2[:, :, 40:] = -1e4
        got = tdb.self_block(x, tq["blk"], kq2, ks, vq2, vs, 40, 1, 4)[0]
        assert torch.equal(got, ref)

    def test_int8_current_row_attends_dequantized(self, cfg, qd):
        """With an int8 self cache the current token attends to its own
        int8 row times its scale (what later steps will read), not to the
        f32 projection."""
        _, tq = qd
        D, L, H = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
        _, (kq, ks, vq, vs) = _cache("int8", SELF_T, D, L, seed=7)
        x = torch.from_numpy(_x(D, seed=8))
        pos, l = 0, 2          # no history: the output is the current row
        out, k8, ksc, v8, vsc = tdb.self_block(x, tq["blk"], kq, ks, vq, vs,
                                               pos, l, H)
        vc = v8.float() * vsc[:, None]
        want = tdb._out_proj(vc, x.float(), tq["blk"]["self_wo"][l],
                             tq["blk"]["self_wos"][l],
                             tq["blk"]["self_wob"][l], torch.float32)
        torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
        assert not torch.equal(vc, vc.round())     # a real dequantization


class TestCrossBlock:
    @pytest.mark.parametrize("mode", ROW_MODES)
    @pytest.mark.parametrize("enc_len", [1, 300])
    def test_matches_jax(self, cfg, qd, mode, enc_len):
        jq, tq = qd
        D, L = cfg.n_text_state, cfg.n_text_layer
        jc, tc = _cache(mode, CROSS_T, D, L, seed=enc_len)
        x = _x(D, seed=enc_len + 1)
        layer = enc_len % L
        a = jdb.cross_block(jnp.asarray(x), jq["blk"], *jc, enc_len, layer,
                            cfg.n_text_head, block_t=256, interpret=True)
        b = tdb.cross_block(torch.from_numpy(x), tq["blk"], *tc, enc_len,
                            layer, cfg.n_text_head)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)

    def test_masked_scores_are_finite_negatives(self, cfg, qd):
        """enc_len = 0 masks every row: with -0.7*f32max (not -inf) and
        the 1e-30 clamp the JAX kernel averages all padded rows
        uniformly instead of producing NaN; the port does the same."""
        jq, tq = qd
        D, L = cfg.n_text_state, cfg.n_text_layer
        jc, tc = _cache("f32", CROSS_T, D, L, seed=11)
        x = _x(D, seed=12)
        a = jdb.cross_block(jnp.asarray(x), jq["blk"], *jc, 0, 1,
                            cfg.n_text_head, block_t=256, interpret=True)
        b = tdb.cross_block(torch.from_numpy(x), tq["blk"], *tc, 0, 1,
                            cfg.n_text_head)
        assert torch.isfinite(b).all()
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


class TestFfnBlock:
    @pytest.mark.parametrize("layer", [0, 1, 2])
    def test_matches_jax(self, cfg, qd, layer):
        jq, tq = qd
        x = _x(cfg.n_text_state, seed=20 + layer)
        a = jdb.ffn_block(jnp.asarray(x), jq["blk"], layer, block_h=256,
                          interpret=True)
        b = tdb.ffn_block(torch.from_numpy(x), tq["blk"], layer)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


class TestGreedyHead:
    def _inputs(self, qd, seed):
        jq, tq = qd
        rng = np.random.default_rng(seed)
        D = jq["vocab_qT"].shape[1]
        x = rng.normal(0, 1.0, (1, D)).astype(np.float32)
        return jq, tq, x

    @pytest.mark.parametrize("first,second", [(37, 600), (64, 65)])
    def test_tie_takes_first_index(self, qd, first, second):
        """Two identical columns with the top bias tie exactly; the token
        is the first of them (jnp.argmax), across and within blocks."""
        jq, tq, x = self._inputs(qd, seed=first)
        wq = np.asarray(jq["vocab_qT"]).copy()
        wq[0, :, second] = wq[0, :, first]
        bias = np.zeros((1, wq.shape[2]), np.float32)
        bias[0, [first, second]] = 1e4
        bias[0, [3, 17, 123]] = -np.inf            # real suppressions
        a = jhead(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(bias), 700,
                  interpret=True)
        b = tqm.qmatvec_greedy_head(torch.from_numpy(x),
                                    torch.from_numpy(wq),
                                    torch.from_numpy(bias), 700)
        assert int(b[0][0]) == int(np.asarray(a[0])[0]) == first
        np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), **TOL)
        np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), **TOL)

    def test_padding_and_suppressed_columns_add_nothing(self, qd):
        """Columns >= n_vocab (lane padding) are masked even when their
        weights would win; -inf columns drop out of the logsumexp."""
        jq, tq, x = self._inputs(qd, seed=3)
        wq = np.asarray(jq["vocab_qT"]).copy()
        wq[0, :, 700:] = 127 * np.sign(x[0])[:, None].astype(np.int8)
        bias = np.zeros((1, wq.shape[2]), np.float32)
        bias[0, :350] = -np.inf
        a = jhead(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(bias), 700,
                  interpret=True)
        tok, mx, lse = tqm.qmatvec_greedy_head(
            torch.from_numpy(x), torch.from_numpy(wq),
            torch.from_numpy(bias), 700)
        logits = x @ wq[0, :, 350:700].astype(np.float32)
        assert 350 <= int(tok[0]) < 700
        assert int(tok[0]) == int(np.asarray(a[0])[0])
        np.testing.assert_allclose(
            lse.numpy(), np.log(np.exp(logits - logits.max()).sum())
            + logits.max(), rtol=1e-5)
        np.testing.assert_allclose(mx.numpy(), np.asarray(a[1]), **TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(a[2]), **TOL)


    @pytest.mark.parametrize("cdt", ["f32", "bf16"])
    @pytest.mark.parametrize("M", [1, 9, 17, 32, 33, 40])
    def test_strip_edges_match_jax(self, qd, M, cdt):
        """K4 at the kernel's 128-column strip edges over M rows (the
        32-row chunking above 32), f32 and bf16 x: two identical columns
        with the top bias tie exactly in every row, within one strip (5,
        120) and across strips (127 / 128, 255 / 256), and the first wins;
        a winner in the last real column beside padding columns that
        would win if not masked; a row whose logits are all -inf gives
        token 0 and max -inf. Tokens exact, max and lse within TOL. For
        the all -inf row the JAX kernel's lse is NaN (0 * exp(-inf -
        -inf)); the port's is the contract's m + log(max(z, 1e-30)) =
        -inf."""
        jq, _ = qd
        rng = np.random.default_rng(70 + M)
        jdt, tdt = {"f32": (jnp.float32, torch.float32),
                    "bf16": (jnp.bfloat16, torch.bfloat16)}[cdt]
        x = rng.normal(0, 1.0, (M, jq["vocab_qT"].shape[1])).astype(
            np.float32)
        xt = torch.from_numpy(x).to(tdt)
        xj = jnp.asarray(x, jdt)
        base = np.asarray(jq["vocab_qT"]).copy()

        def both(wq, bias):
            a = jhead(xj, jnp.asarray(wq), jnp.asarray(bias), 700,
                      interpret=True)
            b = tqm.qmatvec_greedy_head(xt, torch.from_numpy(wq),
                                        torch.from_numpy(bias), 700)
            assert b[0].tolist() == np.asarray(a[0]).tolist()
            np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), **TOL)
            return a, b

        for first, second in ((5, 120), (127, 128), (255, 256)):
            wq = base.copy()
            wq[0, :, second] = wq[0, :, first]
            bias = rng.normal(0, 0.1, (1, wq.shape[2])).astype(np.float32)
            bias[0, [first, second]] = 1e4
            a, b = both(wq, bias)
            assert b[0].tolist() == [first] * M
            np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), **TOL)
        wq = base.copy()
        wq[0, :, 700:] = 127
        x_sum = x.sum(1)
        bias = np.zeros((1, wq.shape[2]), np.float32)
        bias[0, 699] = 1e4
        bias[0, 700:] = 2e4 + 127 * np.abs(x_sum).max()
        a, b = both(wq, bias)
        assert b[0].tolist() == [699] * M
        np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), **TOL)
        bias = np.full((1, wq.shape[2]), -np.inf, np.float32)
        a, b = both(wq, bias)
        assert b[0].tolist() == [0] * M
        assert b[1].tolist() == b[2].tolist() == [float("-inf")] * M


class TestRowQuantization:
    def test_round_half_to_even_and_clip(self):
        """s = max(amax, 1e-12)/127, round half to even, clip +-127 — the
        JAX rounding, bit for bit."""
        x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 3.0]],
                     np.float32)
        q, s = quantize_row(torch.from_numpy(x))
        jq, js = jquantize_row(jnp.asarray(x))
        assert q.tolist() == [[127, 0, 2, 2, 0, -2, 126, 3]]
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))

    def test_zero_row_scale_floor(self):
        q, s = quantize_row(torch.zeros(1, 8))
        assert float(s[0]) == np.float32(1e-12) / np.float32(127.0)
        assert not q.any()


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version(self, cfg, qd):
        """On CPU tensors the wrappers run the plain versions and never
        touch the kernel library or its launch counters."""
        _, tq = qd
        tdb.reset_launches()
        tqm.reset_launches()
        x = torch.from_numpy(_x(cfg.n_text_state, seed=1))
        tdb.ffn_block(x, tq["blk"], 0)
        tdb.ffn_block_batched(x.repeat(3, 1), tq["blk"], 0)
        tqm.qmatvec_stacked(x, tq["vocab_qT"], tq["vocab_ones"], 0)
        blk = tq["blk"]
        tqm.ffn_fused(x, blk["w1"], blk["s1"], blk["b1"], blk["w2"], 0)
        assert tdb.LAUNCHES == dict.fromkeys(
            ["self_block", "cross_block", "ffn_block", "self_block_batched",
             "cross_block_batched", "ffn_block_batched"], 0)
        assert tqm.LAUNCHES == {"qmatvec_greedy_head": 0,
                                "qmatvec_stacked": 0, "ffn_fused": 0}

    @pytest.mark.parametrize("bad", ["layer", "batch", "shape", "dtype",
                                     "scales"])
    def test_kernel_operands_checked_before_launch(self, cfg, qd, bad):
        """What the kernels do not take is rejected before the library is
        touched (so this runs without a GPU): the per-call operands by
        the CUDA wrapper, a cache's layout by ``check_cache``, which
        ``quantize_cache`` runs once per cache."""
        _, tq = qd
        D, L, H = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
        _, (kq, ks, vq, vs) = _cache("int8", SELF_T, D, L, seed=9)
        tdb.check_blk(tq["blk"])
        tdb.check_cache(kq, ks, vq, vs)
        x = torch.from_numpy(_x(D, seed=9))
        layer = L if bad == "layer" else 0
        if bad == "batch":
            x = x.repeat(2, 1)
        if bad == "shape":
            kq = kq[:, :, :128].contiguous()
        if bad == "dtype":
            x = x.half()
        if bad == "scales":
            ks = vs = None
        with pytest.raises((ValueError, TypeError, NotImplementedError)):
            if bad in ("shape", "scales"):
                tdb.check_cache(kq, ks, vq, vs)
            else:
                tdb._self_block_cuda(x, tq["blk"], kq, ks, vq, vs, 5, layer,
                                     H)

    def test_cache_of_other_width_rejected_per_call(self, cfg, qd):
        """A cache that passed ``check_cache`` but belongs to another model
        width is caught at the launch."""
        _, tq = qd
        D, L, H = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
        _, (kq, ks, vq, vs) = _cache("bf16", SELF_T, D // 2, L, seed=9)
        tdb.check_cache(kq, ks, vq, vs)
        x = torch.from_numpy(_x(D, seed=9))
        with pytest.raises(ValueError, match="does not match"):
            tdb._self_block_cuda(x, tq["blk"], kq, ks, vq, vs, 5, 0, H)

    def test_blk_layout_checked_once(self, qd):
        """``check_blk`` (run by ``prepare_qdecode``) rejects a stack of
        the wrong dtype or shape."""
        _, tq = qd
        blk = dict(tq["blk"])
        blk["w2"] = blk["w2"].float()
        with pytest.raises(TypeError, match="w2"):
            tdb.check_blk(blk)
        blk = dict(tq["blk"])
        blk["cross_wob"] = blk["cross_wob"][:, :, :64].contiguous()
        with pytest.raises(ValueError, match="cross_wob"):
            tdb.check_blk(blk)

    def test_head_operands_checked_before_launch(self, qd):
        _, tq = qd
        x = torch.zeros((1, 64))
        with pytest.raises(ValueError, match="shapes"):
            tqm._greedy_head_cuda(x, tq["vocab_qT"],
                                  torch.zeros((1, 768)), 700)

    def test_other_devices_raise(self, cfg, qd):
        _, tq = qd
        x = torch.empty((1, cfg.n_text_state), device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            tdb.ffn_block(x, tq["blk"], 0)


# K2's one-launch kernel splits each head's rows over a cluster of blocks:
# the plain version against JAX at the edges of that split (no valid row,
# one row, either side of a 64-row group, every row) and every cache dtype
CROSS_EDGES = (0, 1, 63, 64, 65, CROSS_T)


class TestCrossBlockEdges:
    @pytest.mark.parametrize("mode", ROW_MODES)
    @pytest.mark.parametrize("enc_len", CROSS_EDGES)
    def test_plain_matches_jax(self, cfg, qd, mode, enc_len):
        jq, tq = qd
        D, L, H = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
        jc, tc = _cache(mode, CROSS_T, D, L, seed=100 + enc_len)
        x = _x(D, seed=200 + enc_len)
        layer = (enc_len + 1) % L
        a = jdb.cross_block(jnp.asarray(x), jq["blk"], *jc, enc_len, layer,
                            H, block_t=256, interpret=True)
        b = tdb.cross_block_plain(torch.from_numpy(x), tq["blk"], *tc,
                                  enc_len, layer, H)
        assert torch.isfinite(b).all()
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


# (heads, width) of whisper-tiny and large-v3, and ragged head counts
PLAN_WIDTHS = [(6, 384), (20, 1280), (1, 64), (3, 192), (7, 448), (8, 512),
               (16, 1024), (32, 2048)]
PLAN_ROWS = (1, 63, 64, 65, 255, 256, 257, 1499, 1500, 1536, 4096)


class TestCrossPlan:
    """``cross_plan``: how K2's launch spreads a head's work over the
    blocks of its cluster (the grid is one cluster a head)."""

    @pytest.mark.parametrize("cache_size", [1, 2, 4],
                             ids=["int8/fp8", "bf16", "f32"])
    @pytest.mark.parametrize("H,D", PLAN_WIDTHS,
                             ids=[f"H{h}" for h, _ in PLAN_WIDTHS])
    def test_rows_covered_once(self, H, D, cache_size):
        """Every cache row below n_loop in exactly one block of a cluster
        (block r: rows [r rows, (r + 1) rows)); chunks of whole 64-row
        groups that fit the stage and hold no more than a block's rows
        need."""
        from collections import Counter
        for n_loop in PLAN_ROWS:
            plan = tdb.cross_plan(H, D, n_loop, cache_size)
            assert 1 <= plan.cluster <= tdb.CROSS_MAX_CLUSTER
            assert plan.cluster * H <= max(tdb.CROSS_BLOCKS, H)
            assert plan.chunk % tdb.CROSS_GROUPS == 0
            assert tdb.CROSS_GROUPS <= plan.chunk <= tdb.CROSS_MAX_CHUNK
            assert plan.chunk * 2 * (tdb.HEAD_DIM * cache_size + 4) \
                <= tdb.CROSS_STAGE_BYTES
            assert plan.chunk < plan.rows + tdb.CROSS_GROUPS
            rows = Counter()
            for r in range(plan.cluster):
                rows.update(range(min(n_loop, r * plan.rows),
                                  min(n_loop, (r + 1) * plan.rows)))
            assert rows == Counter(range(n_loop))

    @pytest.mark.parametrize("H,D,n", [(6, 384, 16), (20, 1280, 8)],
                             ids=["tiny", "large-v3"])
    def test_main_path_clusters(self, H, D, n):
        """1500 int8 rows: 96 blocks at tiny, 160 at large-v3, one chunk
        a block."""
        plan = tdb.cross_plan(H, D, 1500, 1)
        assert plan.cluster == n
        assert plan.chunk >= plan.rows

    @pytest.mark.parametrize("enc_len,dtype", [(1500, torch.int8),
                                               (0, torch.int8),
                                               (63, torch.bfloat16),
                                               (1, torch.float32)])
    def test_one_launch(self, cfg, qd, monkeypatch, enc_len, dtype):
        """``_cross_block_cuda`` makes one call of the C entry point with
        the plan for its rows (all T of them when enc_len is 0), an f32
        [H, D] scratch and zeroed tickets, and counts one launch."""
        _, tq = qd
        D, L, H = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
        T = 1536
        calls, spaces = [], []

        class Lib:
            def wa_cross_block(self, *args):
                calls.append(args)
                return 0

        def workspace(st, dev, name, n, dtype=torch.float32, zero=False):
            spaces.append((name, n, dtype, zero))
            return 1000 + len(spaces)

        monkeypatch.setattr(tdb._build, "library", Lib)
        monkeypatch.setattr(tdb._build, "stream", lambda: 7)
        monkeypatch.setattr(tdb._build, "workspace", workspace)
        kq = torch.zeros((L, 1, T, D), dtype=dtype)
        ks = torch.ones((L, 1, T, 1)) if dtype == torch.int8 else None
        x = torch.from_numpy(_x(D, seed=3))
        before = tdb.LAUNCHES["cross_block"]
        y = tdb._cross_block_cuda(x, tq["blk"], kq, ks, kq, ks, enc_len, 1, H)
        assert y.shape == x.shape
        assert tdb.LAUNCHES["cross_block"] == before + 1 and len(calls) == 1
        args = calls[0]
        assert args[14:16] == (T, enc_len)
        plan = tdb.cross_plan(H, D, enc_len or T, kq.element_size())
        assert tuple(args[20:23]) == tuple(plan)
        assert args[-1] == 7 and len(args) == 26
        assert ("cross_y", H * D, torch.float32, False) in spaces
        assert ("cross_tickets", tdb.CROSS_MAX_CLUSTER, torch.int32,
                True) in spaces


# (width, hidden) of whisper-tiny, base, small, medium, large-v3, and the
# narrow model of these tests
FFN_WIDTHS = [(384, 1536), (512, 2048), (768, 3072), (1024, 4096),
              (1280, 5120), (128, 512)]


def _ffn_blk(D: int, H: int, L: int = 2) -> dict:
    """A K3 operand set of zeros in the ``prepare_qdecode`` layout."""
    f32, i8 = torch.float32, torch.int8
    return {"ln3_w": torch.zeros((L, 1, D), dtype=f32),
            "ln3_b": torch.zeros((L, 1, D), dtype=f32),
            "w1": torch.zeros((L, D, H), dtype=i8),
            "s1": torch.zeros((L, 1, H), dtype=f32),
            "b1": torch.zeros((L, 1, H), dtype=f32),
            "w2": torch.zeros((L, H, D), dtype=i8),
            "fc2_s": torch.zeros((L, 1, D), dtype=f32),
            "fc2_b": torch.zeros((L, 1, D), dtype=f32)}


class TestFfnLaunch:
    """K3's wrapper: the kernel cuts the hidden layer over clusters of
    blocks itself (csrc ``ffn_units``); the wrapper passes the operands and
    the scratch the kernel asks for."""

    @pytest.mark.parametrize("D,H", FFN_WIDTHS,
                             ids=[f"D{d}" for d, _ in FFN_WIDTHS])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_one_launch(self, monkeypatch, D, H, dtype):
        """``_ffn_block_cuda`` makes one call of the C entry point with an
        f32 scratch of the size ``wa_ffn_scratch`` gives for (D, H) and
        zeroed tickets (K1's and K2's count), and counts one launch."""
        calls, spaces, asked = [], [], []

        class Lib:
            def wa_ffn_block(self, *args):
                calls.append(args)
                return 0

            def wa_ffn_scratch(self, *args):
                asked.append(args)
                return 3 * args[0]

        def workspace(st, dev, name, n, dtype=torch.float32, zero=False):
            spaces.append((name, n, dtype, zero))
            return 1000 + len(spaces)

        monkeypatch.setattr(tdb._build, "library", Lib)
        monkeypatch.setattr(tdb._build, "stream", lambda: 7)
        monkeypatch.setattr(tdb._build, "workspace", workspace)
        x = torch.zeros((1, D), dtype=dtype)
        before = tdb.LAUNCHES["ffn_block"]
        y = tdb._ffn_block_cuda(x, _ffn_blk(D, H), 1)
        assert y.shape == x.shape and y.dtype == dtype
        assert tdb.LAUNCHES["ffn_block"] == before + 1 and len(calls) == 1
        assert asked == [(D, H)]
        args = calls[0]
        assert args[1:4] == (tdb._build.DTYPE_CODES[dtype], D, H)
        assert args[13:15] == (1001, 1002)
        assert args[-1] == 7 and len(args) == 16
        assert spaces == [
            ("ffn_y", 3 * D, torch.float32, False),
            ("ffn_tickets", tdb.CROSS_MAX_CLUSTER, torch.int32, True)]

    def test_signature_matches_the_call(self):
        """The ctypes signature of the entry has one type per argument the
        wrapper passes; the scratch query takes (D, H)."""
        sig = tdb._build._SIGNATURES
        assert len(sig["wa_ffn_block"]) == 16
        assert sig["wa_ffn_scratch"] == [ctypes.c_int, ctypes.c_int]


def _self_blk(D: int, L: int = 2) -> dict:
    """A K1 operand set of zeros in the ``prepare_qdecode`` layout."""
    f32, i8 = torch.float32, torch.int8
    return {"ln1_w": torch.zeros((L, 1, D), dtype=f32),
            "ln1_b": torch.zeros((L, 1, D), dtype=f32),
            "wqkv": torch.zeros((L, D, 3 * D), dtype=i8),
            "sqkv": torch.zeros((L, 1, 3 * D), dtype=f32),
            "bqkv": torch.zeros((L, 1, 3 * D), dtype=f32),
            "self_wo": torch.zeros((L, D, D), dtype=i8),
            "self_wos": torch.zeros((L, 1, D), dtype=f32),
            "self_wob": torch.zeros((L, 1, D), dtype=f32)}


SELF_DTYPES = [torch.float32, torch.bfloat16, torch.int8,
               torch.float8_e4m3fn]


class TestSelfPlan:
    """K1 launches the kernel K2 does, one thread block cluster a head,
    with ``cross_plan`` over its ``pos`` history rows."""

    @pytest.mark.parametrize("H,D", [(6, 384), (20, 1280)],
                             ids=["tiny", "large-v3"])
    def test_history_rows_covered_once(self, H, D):
        """At every position of a 448-token window (no history at 0) each
        history row lies in one block, in one staged chunk."""
        from collections import Counter
        for pos in range(448):
            plan = tdb.cross_plan(H, D, pos, 2)
            assert plan.rows * plan.cluster >= pos
            assert plan.chunk >= min(plan.rows, pos)
            rows = Counter()
            for r in range(plan.cluster):
                rows.update(range(min(pos, r * plan.rows),
                                  min(pos, (r + 1) * plan.rows)))
            assert rows == Counter(range(pos))

    @pytest.mark.parametrize("H,D", [(6, 384), (20, 1280)],
                             ids=["tiny", "large-v3"])
    @pytest.mark.parametrize("dtype", SELF_DTYPES,
                             ids=["f32", "bf16", "int8", "fp8"])
    def test_one_launch(self, monkeypatch, H, D, dtype):
        """``_self_block_cuda`` makes one call of the C entry point with the
        plan for its pos rows, an f32 [H, D] scratch, zeroed tickets and,
        for int8 rows only, an f32 [3D] scratch for the projection between
        the kernel's two launches; it counts one launch."""
        calls, spaces = [], []

        class Lib:
            def wa_self_block(self, *args):
                calls.append(args)
                return 0

        def workspace(st, dev, name, n, dtype=torch.float32, zero=False):
            spaces.append((name, n, dtype, zero))
            return 1000 + len(spaces)

        monkeypatch.setattr(tdb._build, "library", Lib)
        monkeypatch.setattr(tdb._build, "stream", lambda: 7)
        monkeypatch.setattr(tdb._build, "workspace", workspace)
        L, T, pos = 2, 512, 129
        kq = torch.zeros((L, 1, T, D), dtype=dtype)
        ks = torch.ones((L, 1, T, 1)) if dtype == torch.int8 else None
        x = torch.zeros((1, D), dtype=torch.bfloat16)
        before = tdb.LAUNCHES["self_block"]
        out = tdb._self_block_cuda(x, _self_blk(D, L), kq, ks, kq, ks, pos,
                                   1, H)
        assert out[0].shape == x.shape and out[1].dtype == dtype
        assert tdb.LAUNCHES["self_block"] == before + 1 and len(calls) == 1
        args = calls[0]
        assert args[13:16] == (tdb._build.DTYPE_CODES[dtype], T, pos)
        plan = tdb.cross_plan(H, D, pos, kq.element_size())
        assert tuple(args[24:27]) == tuple(plan)
        assert args[-1] == 7 and len(args) == 31
        want = [("self_y", H * D, torch.float32, False),
                ("self_tickets", tdb.CROSS_MAX_CLUSTER, torch.int32, True)]
        if dtype == torch.int8:
            want.append(("self_qkv", 3 * D, torch.float32, False))
        assert spaces == want
        assert (args[29] is None) == (dtype != torch.int8)
