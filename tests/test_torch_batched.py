"""The port's batched decode path (B > 1) against the JAX package, at a
small width: kernels K5-K8 and K4 at M > 1 (their plain PyTorch versions
against the JAX Pallas kernels in interpret mode), ``decode_step_qf`` at
B = 3, and batched transcription as a whole.

Same inputs (numpy seeds) go to both; weights, ``prepare_qdecode``
operands and caches cross through ``from_jax_params``. Tolerances:

- f32 compute: rtol/atol 1e-5, the tolerance of the JAX package's own
  batched-kernel tests (``tests/test_qdecode.py``). The only algorithmic
  difference is the JAX kernels' A&S erf (|err| < 1.5e-7).
- bf16 compute: within 2^-5 of the reference's largest magnitude. The JAX
  batched kernels round q, the elementwise k*q products, p and p*v to
  bf16 before accumulating in f32; the port keeps them in f32. Each
  rounding is at most 2^-9 relative, and the attention output and the
  residual stream after it move by a few of those (one bf16 ulp of the
  output is 2^-8 of its magnitude), so 2^-5 holds with room and still
  catches a wrong row, slot or scale.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_apr_tpu.audio.mel import MelFilterbank as JMel
from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.inference.processors import WhisperTokenSuppressor
from whisper_apr_tpu.model import decoder as jdec
from whisper_apr_tpu.model import qdecode as jqd
from whisper_apr_tpu.model.params import init_params, quantize_params
from whisper_apr_tpu.ops import decode_blocks as jdb
from whisper_apr_tpu.ops.qmatvec import qmatvec_greedy_head as jhead
from whisper_apr_tpu.ops.qmatvec import qmatvec_stacked as jstacked
from whisper_apr_tpu.pipeline import fused_transcribe_step
from whisper_apr_tpu.tokenizer import SpecialTokens
from whisper_apr_tpu_torch import ComputeConfig as TCompute
from whisper_apr_tpu_torch import TranscribeOptions, WhisperApr
from whisper_apr_tpu_torch.model import decoder as tdec
from whisper_apr_tpu_torch.model import qdecode as tqd
from whisper_apr_tpu_torch.model.kv_variants import decode_steps_multi
from whisper_apr_tpu_torch.model.params import from_jax_params
from whisper_apr_tpu_torch.ops import decode_blocks as tdb
from whisper_apr_tpu_torch.ops import qmatvec as tqm
from whisper_apr_tpu_torch.tokenizer import SpecialTokens as TSpecials

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = 2.0 ** -5
SELF_T, CROSS_T = 256, 512          # padded cache lengths (qdecode pads)
SLOT_POS = {2: [63, 129], 3: [0, 5, 17]}     # per-slot positions at B
EOT_BOOST = 0.75       # the seeded rows then end at 5, 7 and 5 tokens


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
def qd(cfg, params):
    """The JAX qd, and the same operands carried across."""
    jq = jqd.prepare_qdecode(params[0], cfg)
    return jq, from_jax_params(jq)


def _cache(mode: str, B: int, T: int, D: int, L: int, seed: int):
    """One cache pair (K, V) [L, B, T, D] in ``mode`` as JAX arrays, and
    the same bits as torch."""
    rng = np.random.default_rng(seed)
    out_j = []
    for _ in range(2):
        if mode == "int8":
            q = rng.integers(-127, 128, (L, B, T, D)).astype(np.int8)
            s = (rng.random((L, B, T, 1)) * 0.02 + 1e-3).astype(np.float32)
            out_j += [jnp.asarray(q), jnp.asarray(s)]
        else:
            rows = rng.normal(0, 1.0, (L, B, T, D)).astype(np.float32)
            dt = {"f32": jnp.float32, "bf16": jnp.bfloat16,
                  "fp8": jnp.float8_e4m3fn}[mode]
            out_j += [jnp.asarray(rows).astype(dt), None]
    return tuple(out_j), from_jax_params(tuple(out_j))


def _x(B: int, D: int, seed: int, cdt="f32", scale: float = 1.0):
    x = np.random.default_rng(seed).normal(0, scale, (B, D)).astype(
        np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if cdt == "bf16" else
                               jnp.float32)
    return jx, from_jax_params(jx)


def _close(got: torch.Tensor, ref, cdt) -> None:
    """f32: rtol/atol 1e-5; bf16: within 2^-5 of the largest |ref|."""
    r = np.asarray(ref).astype(np.float32)
    g = got.float().numpy()
    if cdt == "bf16":
        assert np.abs(g - r).max() <= BF16_TOL * np.abs(r).max()
    else:
        np.testing.assert_allclose(g, r, **TOL)


class TestSelfBlockBatched:
    @pytest.mark.parametrize("B", [2, 3])
    @pytest.mark.parametrize("mode,cdt", [("bf16", "f32"), ("int8", "f32"),
                                          ("fp8", "f32"), ("int8", "bf16"),
                                          ("bf16", "bf16")])
    def test_matches_jax(self, cfg, qd, B, mode, cdt):
        """Per-slot positions (a slot at 0 attends to its current row only;
        positions on both sides of a 64-row split)."""
        jq, tq = qd
        D, L, H = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
        jc, tc = _cache(mode, B, SELF_T, D, L, seed=B)
        jx, tx = _x(B, D, seed=B + 1, cdt=cdt)
        pos = np.asarray(SLOT_POS[B], np.int32)
        layer = B % L
        a = jdb.self_block_batched(jx, jq["blk"], *jc, jnp.asarray(pos),
                                   layer, H, block_t=128, interpret=True)
        b = tdb.self_block_batched(tx, tq["blk"], *tc, torch.from_numpy(pos),
                                   layer, H)
        _close(b[0], a[0], cdt)
        if cdt == "f32":     # the emitted rows (cache dtype) and scales
            for i in range(1, 5):
                assert b[i].dtype == from_jax_params(a[i]).dtype
                np.testing.assert_allclose(
                    b[i].float().numpy(), np.asarray(a[i]).astype(np.float32),
                    **TOL)

    def test_slots_read_only_their_own_rows(self, cfg, qd):
        """Rows >= pos[b] of slot b, and every row of the other slots,
        hold nothing slot b reads."""
        _, tq = qd
        D, L, H = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
        _, (kq, ks, vq, vs) = _cache("int8", 3, SELF_T, D, L, seed=9)
        _, x = _x(3, D, seed=10)
        pos = torch.tensor([4, 40, 0], dtype=torch.int32)
        ref = tdb.self_block_batched(x, tq["blk"], kq, ks, vq, vs, pos, 1, H)
        kq2, vq2 = kq.clone(), vq.clone()
        for b, p in enumerate(pos.tolist()):
            kq2[:, b, p:] = 127
            vq2[:, b, p:] = -127
        got = tdb.self_block_batched(x, tq["blk"], kq2, ks, vq2, vs, pos, 1,
                                     H)
        for r, g in zip(ref, got):
            assert torch.equal(r, g)
        # slot 1 alone gives its row of the batch
        one = tdb.self_block(x[1:2], tq["blk"], kq[:, 1:2].contiguous(),
                             ks[:, 1:2].contiguous(),
                             vq[:, 1:2].contiguous(),
                             vs[:, 1:2].contiguous(), 40, 1, H)
        torch.testing.assert_close(one[0][0], ref[0][1], rtol=1e-6,
                                   atol=1e-6)


class TestCrossBlockBatched:
    @pytest.mark.parametrize("B", [2, 3])
    @pytest.mark.parametrize("mode,cdt", [("int8", "f32"), ("bf16", "f32"),
                                          ("int8", "bf16")])
    def test_matches_jax(self, cfg, qd, B, mode, cdt):
        """enc_len 300 of 512 padded rows: the rows past it (zero rows in
        a real padded cache) take no part."""
        jq, tq = qd
        D, L, H = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
        jc, tc = _cache(mode, B, CROSS_T, D, L, seed=20 + B)
        jx, tx = _x(B, D, seed=21 + B, cdt=cdt)
        a = jdb.cross_block_batched(jx, jq["blk"], *jc, 300, B - 1, H,
                                    block_t=128, interpret=True)
        b = tdb.cross_block_batched(tx, tq["blk"], *tc, 300, B - 1, H)
        _close(b, a, cdt)

    def test_no_valid_row_averages_all_rows(self, cfg, qd):
        """enc_len 0: every row scores -0.7*f32max, as in the JAX kernel,
        and the output stays finite."""
        jq, tq = qd
        D, L, H = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
        jc, tc = _cache("f32", 2, CROSS_T, D, L, seed=30)
        jx, tx = _x(2, D, seed=31)
        a = jdb.cross_block_batched(jx, jq["blk"], *jc, 0, 0, H,
                                    block_t=128, interpret=True)
        b = tdb.cross_block_batched(tx, tq["blk"], *tc, 0, 0, H)
        assert torch.isfinite(b).all()
        _close(b, a, "f32")


# K5's and K6's new edges at B = 2: per-slot positions either side of one
# and of 64 rows (the plan's run and chunk boundaries), enc_len none, one,
# one chunk group and every padded row
SELF_EDGE_POS = ((0, 1), (63, 64), (65, 0))
CROSS_EDGE_LENS = (0, 1, 64, CROSS_T)


class TestBatchedEdges:
    @pytest.mark.parametrize("pos", SELF_EDGE_POS,
                             ids=[f"pos{a}-{b}" for a, b in SELF_EDGE_POS])
    def test_self_plain_matches_jax(self, cfg, qd, pos):
        jq, tq = qd
        D, L, H = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
        jc, tc = _cache("int8", 2, SELF_T, D, L, seed=60 + pos[0])
        jx, tx = _x(2, D, seed=61 + pos[0])
        p = np.asarray(pos, np.int32)
        a = jdb.self_block_batched(jx, jq["blk"], *jc, jnp.asarray(p), 1, H,
                                   block_t=128, interpret=True)
        b = tdb.self_block_plain(tx, tq["blk"], *tc, torch.from_numpy(p), 1,
                                 H)
        for got, ref in zip(b, a):
            assert got.dtype == from_jax_params(ref).dtype
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(ref).astype(np.float32),
                                       **TOL)

    @pytest.mark.parametrize("enc_len", CROSS_EDGE_LENS)
    def test_cross_plain_matches_jax(self, cfg, qd, enc_len):
        jq, tq = qd
        D, L, H = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
        jc, tc = _cache("int8", 2, CROSS_T, D, L, seed=70 + enc_len)
        jx, tx = _x(2, D, seed=71 + enc_len)
        a = jdb.cross_block_batched(jx, jq["blk"], *jc, enc_len, 2, H,
                                    block_t=128, interpret=True)
        b = tdb.cross_block_plain(tx, tq["blk"], *tc, enc_len, 2, H)
        assert torch.isfinite(b).all()
        _close(b, a, "f32")


# (heads, width) of whisper-tiny, large-v3, base, medium and the narrow
# model of these tests; slot counts; cache rows at the split edges
PLAN_WIDTHS = [(6, 384), (20, 1280), (8, 512), (16, 1024), (4, 128)]
PLAN_SLOTS = (2, 3, 5, 8, 17, 32)
PLAN_ROWS = (0, 1, 63, 64, 65, 447, 1500)


def _partition(runs, n: int) -> bool:
    """True when the half-open runs [a, b) cover [0, n) once each."""
    runs = sorted(r for r in runs if r[1] > r[0])
    at = 0
    for a, b in runs:
        if a != at:
            return False
        at = b
    return at == n


class TestBatchedPlan:
    """``batched_plan``: how K5's and K6's launch spreads B slots over
    thread block clusters, one a (head, tile of slots), and
    ``batched_blocks``: the kernel's cut of a tile's work over the blocks
    of its cluster."""

    @pytest.mark.parametrize("cache_size", [1, 2, 4],
                             ids=["int8/fp8", "bf16", "f32"])
    @pytest.mark.parametrize("H,D", PLAN_WIDTHS,
                             ids=[f"H{h}" for h, _ in PLAN_WIDTHS])
    def test_every_row_weight_row_and_column_once(self, H, D, cache_size):
        """Every (slot, head, cache row) in one block of the grid, every Wq
        row and Wo column of a head in one block of each cluster: K6 with
        every slot at each ``PLAN_ROWS`` length, K5 with the slots' rows
        mixed from them. Clusters of 16 blocks at most, tiles of
        ``BATCHED_CROSS_SLOTS`` (K6) or ``BATCHED_SELF_SLOTS`` (K5) slots at
        most, chunks of whole 64-row groups
        that fit the stage (64 rows at least), every block's projection
        shares within their budget; K6's plan and K5's (192 columns)."""
        for B, width in ((B, w) for B in PLAN_SLOTS for w in (64, 192)):
            for n_loop in PLAN_ROWS:
                plan = tdb.batched_plan(H, D, B, n_loop, cache_size, width)
                assert 1 <= plan.cluster <= 16
                assert 1 <= plan.slots <= min(B, tdb.BATCHED_CROSS_SLOTS
                                              if width == 64 else
                                              tdb.BATCHED_SELF_SLOTS)
                assert plan.cluster * plan.slots * width * 4 \
                    <= tdb.BATCHED_SHARE_BYTES
                assert plan.chunk % tdb.CROSS_GROUPS == 0
                assert tdb.CROSS_GROUPS <= plan.chunk <= tdb.CROSS_MAX_CHUNK
                assert plan.chunk == tdb.CROSS_GROUPS or plan.chunk * 2 * (
                    tdb.HEAD_DIM * cache_size + 4) <= tdb.BATCHED_STAGE_BYTES
                tiles = [range(b0, min(B, b0 + plan.slots))
                         for b0 in range(0, B, plan.slots)]
                assert sorted(b for t in tiles for b in t) == list(range(B))
                mixed = [PLAN_ROWS[(3 * b + n_loop) % len(PLAN_ROWS)]
                         for b in range(B)]
                for lens_all in ([n_loop] * B, mixed):
                    for tile in tiles:
                        lens = [lens_all[b] for b in tile]
                        blocks = tdb.batched_blocks(plan, D, lens)
                        assert len(blocks) == plan.cluster
                        assert _partition([bl["wq_rows"] for bl in blocks],
                                          D)
                        assert _partition([bl["wo_cols"] for bl in blocks],
                                          D)
                        assert all((c1 - c0) % 16 == 0 for c0, c1 in
                                   (bl["wo_cols"] for bl in blocks))
                        for s, n in enumerate(lens):
                            assert _partition(
                                [(t0, t1) for bl in blocks
                                 for ss, t0, t1 in bl["rows"] if ss == s], n)
                        # every head's cluster cuts alike: H x the rows
                        assert H * sum(t1 - t0 for bl in blocks
                                       for _, t0, t1 in bl["rows"]) \
                            == H * sum(lens)

    @pytest.mark.parametrize("H,D,cross,self_,blocks",
                             [(6, 384, (4, 1, 192), (4, 4, 64), (192, 48)),
                              (20, 1280, (4, 3, 128), (8, 4, 64),
                               (240, 320))],
                             ids=["tiny", "large-v3"])
    def test_serving_tick_plan(self, H, D, cross, self_, blocks):
        """B = 8 slots, int8 rows: K6 over 1500 cross rows in 192 blocks
        at tiny (eight tiles of a slot), 240 at large-v3 (tiles of 3, 3 and
        2 slots); K5 in two tiles of 4 slots, clusters of 8 at large-v3
        (a block's share of a head's 192 Wq columns: 160 rows)."""
        for width, want, n_loop, n in ((64, cross, 1500, blocks[0]),
                                       (192, self_, 448, blocks[1])):
            plan = tdb.batched_plan(H, D, 8, n_loop, 1, width)
            assert tuple(plan) == want
            assert plan.cluster * H * math.ceil(8 / plan.slots) == n

    @pytest.mark.parametrize("B", [1, 8, 32, 40])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.int8, torch.float8_e4m3fn],
                             ids=["f32", "bf16", "int8", "fp8"])
    def test_one_launch_per_chunk(self, monkeypatch, cfg, qd, B, dtype):
        """K6's and K5's wrappers call their C entry once per 32-slot chunk,
        at the chunk's pointer offsets, with ``batched_plan`` for the
        chunk's slots, the [H, B, D] o-proj scratch and zeroed tickets, and
        count one launch a chunk. K5 passes the projection's scratch (the
        entry's two launches) for int8 rows only."""
        _, tq = qd
        D, L, H = cfg.n_text_state, cfg.n_text_layer, cfg.n_text_head
        calls, spaces = {"self": [], "cross": []}, []

        class Lib:
            def wa_self_block_batched(self, *args):
                calls["self"].append(args)
                return 0

            def wa_cross_block_batched(self, *args):
                calls["cross"].append(args)
                return 0

        def workspace(st, dev, name, n, dtype=torch.float32, zero=False):
            spaces.append((name, n, dtype, zero))
            return 1000 + len(spaces)

        monkeypatch.setattr(tdb._build, "library", Lib)
        monkeypatch.setattr(tdb._build, "stream", lambda: 7)
        monkeypatch.setattr(tdb._build, "workspace", workspace)
        T, layer = 96, 1
        kq = torch.zeros((L, B, T, D), dtype=dtype)
        ks = torch.ones((L, B, T, 1)) if dtype == torch.int8 else None
        x = torch.zeros((B, D), dtype=torch.bfloat16)
        pos = torch.arange(B, dtype=torch.int32)
        chunks = [min(32, B - r) for r in range(0, B, 32)]
        before = dict(tdb.LAUNCHES)
        out = tdb._self_block_batched_cuda(x, tq["blk"], kq, ks, kq, ks, pos,
                                           layer, H)
        y = tdb._cross_block_batched_cuda(x, tq["blk"], kq, ks, kq, ks, 50,
                                          layer, H)
        assert out[0].shape == y.shape == x.shape and out[1].dtype == dtype
        for k in ("self_block_batched", "cross_block_batched"):
            assert tdb.LAUNCHES[k] == before[k] + len(chunks)
        assert [c[2] for c in calls["self"]] == chunks
        assert [c[2] for c in calls["cross"]] == chunks
        n = min(B, 32)
        cs = kq.element_size()
        for i, m in enumerate(chunks):
            r0 = 32 * i
            a = calls["self"][i]
            assert len(a) == 33 and a[-1] == 7
            assert a[0] == x.data_ptr() + 2 * r0 * D
            assert a[10] == kq.data_ptr() + cs * (layer * B + r0) * T * D
            assert a[16] == pos.data_ptr() + 4 * r0
            assert tuple(a[25:28]) == tuple(tdb.batched_plan(H, D, m, T, cs,
                                                             3 * 64))
            assert (a[30] is None) == (a[31] is None) == (dtype != torch.int8)
            a = calls["cross"][i]
            assert len(a) == 27 and a[-1] == 7 and a[16] == 50
            assert a[10] == kq.data_ptr() + cs * (layer * B + r0) * T * D
            assert tuple(a[21:24]) == tuple(tdb.batched_plan(H, D, m, 50,
                                                             cs))
        assert ("batched_y", H * n * D, torch.float32, False) in spaces
        assert ("batched_tickets", tdb.BATCHED_TICKETS, torch.int32,
                True) in spaces
        assert (("batched_qkv", n * 3 * D, torch.float32, False) in spaces) \
            == (dtype == torch.int8)


# the decoder widths of whisper-tiny, base, small, medium and large-v3
FFN_WIDTHS = (384, 512, 768, 1024, 1280)
FFN_ROWS = (1, 2, 5, 8, 9, 16, 17, 32)


class TestFfnPlan:
    """``ffn_plan``: how K7's and K9's kernel (one kernel for both) spreads
    the hidden layer and the output columns over thread block clusters,
    and ``ffn_blocks``: what each block of its grid owns."""

    @pytest.mark.parametrize("x_size", [2, 4], ids=["bf16", "f32"])
    @pytest.mark.parametrize("D", FFN_WIDTHS,
                             ids=["tiny", "base", "small", "medium",
                                  "large-v3"])
    def test_every_unit_and_column_once_in_one_wave(self, D, x_size):
        """At every ``FFN_ROWS`` row count: each tile's blocks own every
        hidden unit once; each cluster's blocks own every output column
        once, in whole 16-byte vectors, and their w2 slabs span the
        cluster's units; the tiles cover the rows once. A block's shared
        memory fits (227 KB), and the grid is one wave at the blocks an SM
        that memory allows (two at every width and dtype here)."""
        H = 4 * D
        for M in FFN_ROWS:
            plan = tdb.ffn_plan(D, H, M, x_size)
            U, C, S = plan
            assert U in (16, 32) and 1 <= C <= tdb.FFN_MAX_CLUSTER
            assert 1 <= S <= M and D % (16 * C) == 0 and H % (U * C) == 0
            smem = tdb.ffn_smem(D, U, C, S, x_size)
            assert smem <= tdb.FFN_MAX_SMEM
            per_sm = tdb.ffn_blocks_per_sm(smem)
            assert per_sm == tdb.FFN_BLOCKS_PER_SM
            blocks = tdb.ffn_blocks(plan, D, H, M)
            assert len(blocks) <= tdb.FFN_SMS * per_sm
            tiles = sorted({b["slots"] for b in blocks})
            assert _partition(tiles, M)
            for tile in tiles:
                mine = [b for b in blocks if b["slots"] == tile]
                assert _partition([b["units"] for b in mine], H)
                for j0 in sorted({b["cluster_units"][0] for b in mine}):
                    cl = [b for b in mine if b["cluster_units"][0] == j0]
                    assert len(cl) == C
                    assert _partition([b["cols"] for b in cl], D)
                    assert all((c1 - c0) % 16 == 0
                               for c0, c1 in (b["cols"] for b in cl))
                    span = cl[0]["cluster_units"]
                    assert _partition([(u0 - span[0], u1 - span[0])
                                       for u0, u1 in (b["units"]
                                                      for b in cl)],
                                      span[1] - span[0])

    @pytest.mark.parametrize("D,plan", [(384, (16, 12, 8)),
                                        (1280, (32, 16, 8))],
                             ids=["tiny", "large-v3"])
    def test_serving_tick_plan(self, D, plan):
        """B = 8 in bf16: whisper-tiny in 8 clusters of 12 blocks of 16
        units (96 blocks), large-v3 in 10 clusters of 16 blocks of 32
        units (160 blocks); both one tile of 8 slots."""
        assert tuple(tdb.ffn_plan(D, 4 * D, 8, 2)) == plan

    @pytest.mark.parametrize("B", [1, 8, 32, 40])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["f32", "bf16"])
    def test_one_launch_per_chunk(self, monkeypatch, cfg, qd, B, dtype):
        """K7's and K9's wrappers call their C entry once per 32-row chunk,
        at the chunk's pointer offsets, with ``ffn_plan`` for the chunk's
        rows, the clusters' [G, rows, D] f32 scratch and zeroed tickets,
        and count one launch a chunk."""
        _, tq = qd
        blk = tq["blk"]
        D, L = cfg.n_text_state, cfg.n_text_layer
        H = 4 * D
        calls, spaces = {"k7": [], "k9": []}, []

        class Lib:
            def wa_ffn_block_batched(self, *args):
                calls["k7"].append(args)
                return 0

            def wa_ffn_fused(self, *args):
                calls["k9"].append(args)
                return 0

        def workspace(st, dev, name, n, dtype=torch.float32, zero=False):
            spaces.append((name, n, dtype, zero))
            return 1000 + len(spaces)

        monkeypatch.setattr(tdb._build, "library", Lib)
        monkeypatch.setattr(tdb._build, "stream", lambda: 7)
        monkeypatch.setattr(tdb._build, "workspace", workspace)
        layer = 1
        x = torch.zeros((B, D), dtype=dtype)
        chunks = [min(32, B - r) for r in range(0, B, 32)]
        before = (tdb.LAUNCHES["ffn_block_batched"],
                  tqm.LAUNCHES["ffn_fused"])
        y7 = tdb._ffn_block_batched_cuda(x, blk, layer)
        y9 = tqm._ffn_fused_cuda(x, blk["w1"], blk["s1"], blk["b1"],
                                 blk["w2"], layer)
        assert y7.shape == y9.shape == x.shape
        assert y7.dtype == y9.dtype == dtype
        assert tdb.LAUNCHES["ffn_block_batched"] == before[0] + len(chunks)
        assert tqm.LAUNCHES["ffn_fused"] == before[1] + len(chunks)
        assert [c[2] for c in calls["k7"]] == chunks
        assert [c[2] for c in calls["k9"]] == chunks
        es = x.element_size()
        for i, m in enumerate(chunks):
            r0 = 32 * i
            plan = tdb.ffn_plan(D, H, m, es)
            G = H // (plan.units * plan.cluster)
            assert ("ffn_b_y", G * m * D, torch.float32, False) in spaces
            a = calls["k7"][i]
            assert len(a) == 20 and a[-1] == 7
            assert a[0] == x.data_ptr() + es * r0 * D and a[3:5] == (D, H)
            assert a[7] == blk["w1"].data_ptr() + layer * D * H
            assert a[10] == blk["w2"].data_ptr() + layer * H * D
            assert a[13] == y7.data_ptr() + es * r0 * D
            assert tuple(a[14:17]) == tuple(plan)
            a = calls["k9"][i]
            assert len(a) == 16 and a[-1] == 7
            assert a[0] == x.data_ptr() + es * r0 * D and a[3:5] == (D, H)
            assert a[5] == blk["w1"].data_ptr() + layer * D * H
            assert a[9] == y9.data_ptr() + es * r0 * D
            assert tuple(a[10:13]) == tuple(plan)
        assert ("ffn_b_tickets", tdb.FFN_TICKETS, torch.int32,
                True) in spaces


class TestFfnBlockBatched:
    @pytest.mark.parametrize("B", [1, 2, 3, 9])
    @pytest.mark.parametrize("cdt", ["f32", "bf16"])
    def test_matches_jax(self, cfg, qd, B, cdt):
        jq, tq = qd
        jx, tx = _x(B, cfg.n_text_state, seed=40 + B, cdt=cdt)
        layer = (B - 1) % cfg.n_text_layer   # B = 2, 3: layers 1, 2
        a = jdb.ffn_block_batched(jx, jq["blk"], layer, block_h=256,
                                  interpret=True)
        b = tdb.ffn_block_batched(tx, tq["blk"], layer)
        _close(b, a, cdt)


class TestQmatvecStacked:
    @pytest.mark.parametrize("B", [2, 3])
    @pytest.mark.parametrize("cdt,out", [("f32", None), ("bf16", None),
                                         ("bf16", "f32")])
    def test_matches_jax(self, cfg, qd, B, cdt, out):
        """A layer > 0 of the stacked fc1 weights, and the vocab logits
        (f32 out of bf16 input, as the serving tail runs it)."""
        jq, tq = qd
        # activations of LayerNorm-output size: the stacks' scales make
        # raw N(0, 1) inputs sum to hundreds, where f32 cancellation alone
        # exceeds 1e-5
        jx, tx = _x(B, cfg.n_text_state, seed=50 + B, cdt=cdt, scale=0.02)
        jout = None if out is None else jnp.float32
        tout = None if out is None else torch.float32
        a = jstacked(jx, jq["blk"]["w1"], jq["blk"]["s1"], 2,
                     out_dtype=jout, interpret=True)
        b = tqm.qmatvec_stacked(tx, tq["blk"]["w1"], tq["blk"]["s1"], 2,
                                out_dtype=tout)
        assert b.dtype == from_jax_params(a).dtype
        _close(b, a, cdt)
        a = jstacked(jx, jq["vocab_qT"], jq["vocab_ones"], 0,
                     out_dtype=jnp.float32, interpret=True)
        b = tqm.qmatvec_stacked(tx, tq["vocab_qT"], tq["vocab_ones"], 0,
                                out_dtype=torch.float32)
        _close(b, a, cdt)

    @pytest.mark.parametrize("M", [1, 9, 16, 17, 32])
    @pytest.mark.parametrize("cdt,out", [("f32", None), ("bf16", "f32")])
    def test_edge_rows_match_jax(self, cfg, qd, M, cdt, out):
        """The rows either side of the decode kernel's 8-row tiles and of
        K17's 16-row limit, up to one launch's 32."""
        jq, tq = qd
        jx, tx = _x(M, cfg.n_text_state, seed=60 + M, cdt=cdt, scale=0.02)
        jout = None if out is None else jnp.float32
        tout = None if out is None else torch.float32
        a = jstacked(jx, jq["blk"]["w1"], jq["blk"]["s1"], 1,
                     out_dtype=jout, interpret=True)
        b = tqm.qmatvec_stacked(tx, tq["blk"]["w1"], tq["blk"]["s1"], 1,
                                out_dtype=tout)
        assert b.shape == (M, 4 * cfg.n_text_state)
        assert b.dtype == from_jax_params(a).dtype
        _close(b, a, cdt)

    @pytest.mark.parametrize("M", [1, 32, 40])
    def test_one_launch_per_chunk_with_the_plan(self, monkeypatch, qd, M):
        """The CUDA wrapper launches once per 32-row chunk, at the
        layer's weight and scale, with ``int8_plan``'s split for the
        chunk's rows and no scratch."""
        from whisper_apr_tpu_torch.ops import int8_matmul as ti8
        _, tq = qd
        w, s = tq["blk"]["w1"], tq["blk"]["s1"]
        L, K, N = w.shape
        calls = []

        class Lib:
            def wa_qmatvec_stacked(self, *args):
                calls.append(args)
                return 0

        def workspace(*args, **kwargs):
            raise AssertionError("K8 needs no scratch")

        monkeypatch.setattr(tqm._build, "library", Lib)
        monkeypatch.setattr(tqm._build, "stream", lambda: 7)
        monkeypatch.setattr(tqm._build, "workspace", workspace)
        x = torch.zeros((M, K), dtype=torch.bfloat16)
        before = tqm.LAUNCHES["qmatvec_stacked"]
        y = tqm._stacked_cuda(x, w, s, 2, torch.float32)
        assert y.shape == (M, N) and y.dtype == torch.float32
        chunks = [min(32, M - r) for r in range(0, M, 32)]
        assert tqm.LAUNCHES["qmatvec_stacked"] == before + len(chunks)
        assert [c[2] for c in calls] == chunks
        for i, (args, m) in enumerate(zip(calls, chunks)):
            assert args[0] == x.data_ptr() + 2 * 32 * i * K
            assert args[4] == w.data_ptr() + 2 * K * N
            assert args[6] == s.data_ptr() + 4 * 2 * N
            assert args[8] == 0 and args[11] == 7 and len(args) == 12
            assert tuple(args[9:11]) == tuple(ti8.int8_plan(m, K, N))

    def test_unstacked_wrapper(self, qd):
        _, tq = qd
        x = torch.randn(2, 128, generator=torch.Generator().manual_seed(1))
        w = tq["blk"]["wcq"][1]
        got = tqm.qmatvec(x, w, 0.5)
        torch.testing.assert_close(got, (x @ w.float()) * 0.5)


class TestGreedyHeadRows:
    def test_three_rows_with_a_planted_tie(self, qd):
        """K4 at M = 3: each row its own argmax; row 1 has two identical
        top columns in different blocks and takes the first."""
        jq, tq = qd
        rng = np.random.default_rng(60)
        x = rng.normal(0, 1.0, (3, 128)).astype(np.float32)
        wq = np.asarray(jq["vocab_qT"]).copy()
        wq[0, :, 600] = wq[0, :, 37]
        bias = np.zeros((1, wq.shape[2]), np.float32)
        bias[0, [3, 17, 123]] = -np.inf
        x[1] = 0.0
        bias[0, [37, 600]] = 1e4           # row 1: all logits = bias
        a = jhead(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(bias), 700,
                  interpret=True)
        b = tqm.qmatvec_greedy_head(torch.from_numpy(x), torch.from_numpy(wq),
                                    torch.from_numpy(bias), 700)
        assert b[0].tolist() == np.asarray(a[0]).tolist()
        assert int(b[0][1]) == 37
        np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), **TOL)
        np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), **TOL)

    @pytest.mark.parametrize("M", [1, 32, 40])
    @pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
    def test_one_call_per_chunk(self, monkeypatch, qd, M, cdt):
        """The CUDA wrapper calls ``wa_greedy_head`` once per 32-row
        chunk, each at its rows of x and of the outputs, over the whole
        vocab, with [3, chunk, N / 128] int64 partials (three words for
        each 128-column strip of the kernel) and an int64 ticket, both
        zeroed when allocated, and counts one launch each."""
        _, tq = qd
        wq = tq["vocab_qT"]
        K, N = wq.shape[1], wq.shape[2]
        bias = torch.zeros((1, N))
        calls, spaces = [], []

        class Lib:
            def wa_greedy_head(self, *args):
                calls.append(args)
                return 0

        def workspace(st, dev, name, n, dtype=torch.float32, zero=False):
            spaces.append((name, n, dtype, zero))
            return 1000 + len(spaces)

        monkeypatch.setattr(tqm._build, "library", Lib)
        monkeypatch.setattr(tqm._build, "stream", lambda: 7)
        monkeypatch.setattr(tqm._build, "workspace", workspace)
        x = torch.zeros((M, K), dtype=cdt)
        before = tqm.LAUNCHES["qmatvec_greedy_head"]
        tok, mx, lse = tqm._greedy_head_cuda(x, wq, bias, 700)
        assert tok.shape == mx.shape == lse.shape == (M,)
        chunks = [min(32, M - r) for r in range(0, M, 32)]
        assert len(calls) == len(chunks)
        assert tqm.LAUNCHES["qmatvec_greedy_head"] == before + len(chunks)
        n_part = min(M, 32) * (N // 128)
        assert spaces == [("head_part", 3 * n_part, torch.int64, True),
                          ("head_ticket", 1, torch.int64, True)]
        sig = tqm._build._SIGNATURES["wa_greedy_head"]
        for i, (args, m) in enumerate(zip(calls, chunks)):
            assert len(args) == len(sig) and args[-1] == 7
            assert args[0] == x.data_ptr() + x.element_size() * 32 * i * K
            assert args[1:6] == (tqm._build.DTYPE_CODES[cdt], m, K,
                                 wq.data_ptr(), N)
            assert args[7] == 700 and args[8:10] == (1001, 1002)
            assert args[10:13] == (tok.data_ptr() + 4 * 32 * i,
                                   mx.data_ptr() + 4 * 32 * i,
                                   lse.data_ptr() + 4 * 32 * i)

    def test_grown_partials_start_zero(self, monkeypatch, qd):
        """Each launch finds K4's partials and ticket zero where the
        wrapper grew them for more rows: words that an earlier launch left
        marked written (low half 1, the kernel's mark of a partial) in the
        old buffer are not in the new one, so no merge can take them for a
        strip of this launch. (That every launch leaves the buffers it
        reuses zero, the ticket too, is the kernel's part, checked on
        the card.)"""
        _, tq = qd
        wq = tq["vocab_qT"]
        K, N = wq.shape[1], wq.shape[2]
        seen = []

        def buf_at(ptr):
            return next(b for b in tqm._build._workspaces.values()
                        if b.data_ptr() == ptr)

        class Lib:
            def wa_greedy_head(self, *args):
                part, ticket = buf_at(args[8]), buf_at(args[9])
                seen.append((part.numel(), bool(part.any()),
                             bool(ticket.any())))
                part.fill_((1 << 32) | 1)      # stale words, marked written
                return 0

        monkeypatch.setattr(tqm._build, "_workspaces", {})
        monkeypatch.setattr(tqm._build, "library", Lib)
        monkeypatch.setattr(tqm._build, "stream", lambda: 7)
        for M in (1, 4, 32):
            tqm._greedy_head_cuda(torch.zeros((M, K)), wq,
                                  torch.zeros((1, N)), 700)
        S = N // 128
        assert [n for n, _, _ in seen] == [3 * S, 12 * S, 96 * S]
        assert not any(dirty for _, dirty, _ in seen)
        assert not seen[0][2]                   # the ticket, new


@pytest.fixture(scope="module")
def prefilled3(cfg, params):
    """A JAX KVCache prefilled for three sequences (their own encoder
    outputs and prompts)."""
    jp, _ = params
    rng = np.random.default_rng(70)
    enc = rng.normal(0, 0.5, (3, cfg.n_audio_ctx, cfg.n_text_state)).astype(
        np.float32)
    prompt = np.array([[697, 696, 7], [697, 696, 8], [697, 695, 9]],
                      np.int32)
    jc = jdec.init_cache(jp, jnp.asarray(enc), cfg, max_len=cfg.n_text_ctx)
    _, jc = jdec.prefill(jp, jnp.asarray(prompt), jnp.asarray(enc), jc, cfg)
    return jc


class TestDecodeStepBatched:
    @pytest.mark.parametrize("mode", ["int8", "cross8"])
    @pytest.mark.parametrize("per_slot", [False, True])
    def test_three_steps_match_jax(self, cfg, params, qd, prefilled3, mode,
                                   per_slot):
        """B = 3, three steps, an aligned (scalar) or per-slot [B] pos: the
        logits tail and the fused head's tokens against JAX, and the
        cache rows with their scales written at each slot's row.

        With int8 self rows a new row's element can round to the other
        int8 neighbour (the f32 sums run in another order), which moves
        later logits by about 1e-4: int8 rows are held within one step and
        the logits within atol 1e-3, the int8-KV tolerance the reference
        states for its fused step (``decoder.py:339-344``); with float self
        rows (cross8) everything holds to 1e-5."""
        jp, tp = params
        jq, tq = qd
        a = jqd.quantize_cache(prefilled3, mode=mode)
        b = from_jax_params(a)
        gb = np.zeros((1, 768), np.float32)
        gb[0, [3, 17, 123]] = -np.inf
        tok = np.array([9, 10, 11], np.int32)
        base = np.array([3, 5, 4] if per_slot else [3, 3, 3], np.int32)
        atol = 1e-3 if mode == "int8" else 1e-5
        for step in range(3):
            p = base + step
            jpos = jnp.asarray(p) if per_slot else jnp.int32(int(p[0]))
            tpos = torch.from_numpy(p) if per_slot else int(p[0])
            (ja, _, _), _ = jqd.decode_step_qf(
                jp, jq, jnp.asarray(tok), jpos, a, cfg,
                compute_dtype=jnp.float32, interpret=True,
                greedy_bias=jnp.asarray(gb))
            jl, a = jqd.decode_step_qf(jp, jq, jnp.asarray(tok), jpos, a,
                                       cfg, compute_dtype=jnp.float32,
                                       interpret=True)
            # the head step writes the same rows the logits step then
            # writes again (both read only rows < pos)
            (ta, _, _), b = tqd.decode_step_qf(
                tp, tq, torch.from_numpy(tok), tpos, b, cfg,
                compute_dtype=torch.float32,
                greedy_bias=torch.from_numpy(gb))
            tl, b = tqd.decode_step_qf(tp, tq, torch.from_numpy(tok), tpos,
                                       b, cfg, compute_dtype=torch.float32)
            assert tl.shape == (3, cfg.n_vocab)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=1e-5, atol=atol)
            assert ta.tolist() == np.asarray(ja).tolist()
            tok = np.asarray(ja).astype(np.int32)
        for x, y in zip(a, b):
            if x is None:
                assert y is None
                continue
            np.testing.assert_allclose(
                y.float().numpy(), np.asarray(x).astype(np.float32),
                rtol=1e-5, atol=1.0 if y.dtype == torch.int8 else 1e-5)
        # each slot's three new rows landed at its own positions
        if b.self_ks is not None:
            for s, p0 in enumerate(base.tolist()):
                assert (b.self_ks[:, s, p0:p0 + 3] > 1e-9).all()
                assert (b.self_ks[:, s, p0 + 3:] < 1e-9).all()

    def test_fused_head_matches_jax(self, cfg, params, qd, prefilled3):
        """The fused head at B = 3 (K4 at M = 3), per-slot positions."""
        jp, tp = params
        jq, tq = qd
        a = jqd.quantize_cache(prefilled3, mode="int8")
        b = from_jax_params(a)
        gb = np.zeros((1, 768), np.float32)
        gb[0, [3, 17, 123]] = -np.inf
        tok = np.array([9, 10, 11], np.int32)
        p = np.array([3, 6, 4], np.int32)
        (ja, jm, jz), _ = jqd.decode_step_qf(
            jp, jq, jnp.asarray(tok), jnp.asarray(p), a, cfg,
            compute_dtype=jnp.float32, interpret=True,
            greedy_bias=jnp.asarray(gb))
        (ta, tm, tz), _ = tqd.decode_step_qf(
            tp, tq, torch.from_numpy(tok), torch.from_numpy(p), b, cfg,
            compute_dtype=torch.float32, greedy_bias=torch.from_numpy(gb))
        assert ta.tolist() == np.asarray(ja).tolist()
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)

    @pytest.mark.parametrize("cdt", ["f32", "bf16"])
    def test_embed_per_row_positions(self, params, cdt):
        """The embedding with per-row starts [B] (the per-slot step's
        form) equals the JAX embedding of each row at its own start."""
        jp, tp = params
        jdt, tdt = ((jnp.float32, torch.float32) if cdt == "f32"
                    else (jnp.bfloat16, torch.bfloat16))
        tok = np.array([[9], [650], [11]], np.int32)
        pos = np.array([0, 17, 5], np.int32)
        got = tdec.embed(tp, torch.from_numpy(tok), torch.from_numpy(pos),
                         tdt)
        assert got.shape == (3, 1, 128) and got.dtype == tdt
        for b in range(3):
            want = jdec.embed(jp, jnp.asarray(tok[b:b + 1]), int(pos[b]), jdt)
            np.testing.assert_allclose(
                got[b:b + 1].float().numpy(),
                np.asarray(want).astype(np.float32), **TOL)

    def test_positions_checked_on_the_host(self, cfg, params, qd,
                                           prefilled3):
        _, tp = params
        _, tq = qd
        b = from_jax_params(jqd.quantize_cache(prefilled3, mode="int8"))
        with pytest.raises(ValueError, match="outside the self cache"):
            tqd.decode_step_qf(tp, tq, torch.tensor([1, 2, 3]),
                               torch.tensor([3, 256, 4]), b, cfg)
        with pytest.raises(ValueError, match="want \\(3,\\)"):
            tqd.decode_step_qf(tp, tq, torch.tensor([1, 2, 3]),
                               torch.tensor([3, 4]), b, cfg)

    def test_multi_step_tick_clamps_positions(self, cfg, params, qd,
                                              prefilled3):
        """decode_steps_multi clamps each slot's position to the last cache
        row, as the JAX tick does, and returns [B, n_steps] tokens."""
        _, tp = params
        _, tq = qd
        b = from_jax_params(jqd.quantize_cache(prefilled3, mode="int8"))
        T = 16                  # a cache shorter than the position table
        b = tqd.QKVCache(*(t[:, :, :T].contiguous() for t in b[:4]), *b[4:])
        bias = torch.zeros(cfg.n_vocab)
        toks, b = decode_steps_multi(tp, torch.tensor([1, 2, 3],
                                                      dtype=torch.int32),
                                     np.array([3, T - 1, T + 5]), bias, b,
                                     cfg, n_steps=2, qd=tq)
        assert toks.shape == (3, 2) and toks.dtype == torch.int32
        assert (b.self_ks[:, 0, 3:5] > 1e-9).all()
        assert (b.self_ks[:, 1:, T - 1] > 1e-9).all()
        assert (b.self_ks[:, 1:, 3:T - 1] < 1e-9).all()


def _specials(cfg, cls):
    V = cfg.n_vocab
    return cls(eot=V - 1, sot=V - 2, lang_base=V - 110, transcribe=V - 3,
               no_timestamps=V - 4, timestamp_base=V + 1000,
               is_multilingual=False, translate=V - 5, no_speech=V - 6,
               speaker_turn=V - 7, prev=V - 8)


def _audio(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16_000
    return (0.3 * np.sin(2 * np.pi * (300 + 50 * seed) * t)
            + rng.normal(0, 0.05, n)).astype(np.float32)


class TestBatchedTranscription:
    def test_transcribe_batch_matches_fused_transcribe_step(self, cfg,
                                                            params):
        """WhisperApr(device="cpu").transcribe_batch of three clips against
        the JAX fused_transcribe_step at B = 3 (cross8, f32, the batched
        kernels in interpret mode): identical tokens and lengths,
        sum_logprob within 1e-4."""
        jp, tp = params
        audios = [_audio(8_000 + 1_500 * i, seed=i) for i in range(3)]
        eng = WhisperApr(cfg, tp, specials=_specials(cfg, TSpecials),
                         compute=TCompute(quantization="int8",
                                          compute_dtype="float32"),
                         device="cpu")
        res = eng.transcribe_batch(audios, TranscribeOptions(language="en"))

        sp = _specials(cfg, SpecialTokens)
        prompt = [sp.sot, sp.transcribe, sp.no_timestamps]
        bias = WhisperTokenSuppressor(True, cfg.n_vocab, tokens=sp).bias()
        fb = JMel.create(cfg.n_mels)
        batch = np.zeros((3, 2 * cfg.n_audio_ctx * 160), np.float32)
        for i, a in enumerate(audios):
            batch[i, : a.size] = a[: batch.shape[1]]
        jqd.INTERPRET = True
        try:
            ref = fused_transcribe_step(
                jp, jnp.asarray(batch), fb._window, fb._basis,
                fb._filters_t, jnp.asarray(np.array([prompt] * 3, np.int32)),
                jnp.asarray(bias), sp.eot, cfg, max_len=cfg.n_text_ctx,
                prompt_len=len(prompt), compute_dtype=jnp.float32,
                fidelity=True, no_speech=sp.no_speech,
                qd=jqd.prepare_qdecode(jp, cfg), qf_mode="cross8")
        finally:
            jqd.INTERPRET = False
        lengths = np.asarray(ref.lengths)
        for i, r in enumerate(res.results):
            n = int(lengths[i])
            assert r.tokens == np.asarray(ref.tokens)[i, :n].tolist()
            gen = max(n - len(prompt), 1)
            np.testing.assert_allclose(
                r.avg_logprob * gen, float(np.asarray(ref.sum_logprob)[i]),
                rtol=0, atol=1e-4)
            np.testing.assert_allclose(
                r.no_speech_prob, float(np.asarray(ref.no_speech_prob)[i]),
                rtol=0, atol=1e-5)

    def test_greedy_body_matches_jax(self, cfg, params, qd):
        """greedy_generate_body at B = 3 against the JAX body: rows that
        reach EOT early are held at EOT and add nothing to their
        log-prob while the others go on."""
        from whisper_apr_tpu_torch.model import decoder as tdec
        jp, tp = params
        jq, tq = qd
        eot = cfg.n_vocab - 1
        rng = np.random.default_rng(80)
        enc = rng.normal(0, 0.5, (3, cfg.n_audio_ctx,
                                  cfg.n_text_state)).astype(np.float32)
        prompt = np.array([[5, 6]] * 3, np.int32)
        bias = np.zeros(cfg.n_vocab, np.float32)
        bias[eot] = EOT_BOOST
        jqd.INTERPRET = True
        try:
            ref = jdec.greedy_generate_body(
                jp, jnp.asarray(enc), jnp.asarray(prompt), jnp.asarray(bias),
                eot, cfg, max_len=12, prompt_len=2, fidelity=True, qd=jq,
                qf_mode="int8")
        finally:
            jqd.INTERPRET = False
        res = tdec.greedy_generate_body(
            tp, torch.from_numpy(enc), torch.from_numpy(prompt).long(),
            torch.from_numpy(bias), eot, cfg, max_len=12, prompt_len=2,
            qd=tq, qf_mode="int8")
        lengths = np.asarray(ref.lengths).tolist()
        assert len(set(lengths)) > 1, lengths       # rows end apart
        assert res.lengths.tolist() == lengths
        assert res.tokens.tolist() == np.asarray(ref.tokens).tolist()
        np.testing.assert_allclose(res.sum_logprob.numpy(),
                                   np.asarray(ref.sum_logprob), rtol=0,
                                   atol=1e-4)
