"""The port's paged KV path against the JAX package's, at a small width on
the CPU: K15's plain version against the JAX paged-attention kernel (in
interpret mode), the page allocator, the batched paged decode step from
one converted pool, the paged scheduler (batched and staged admission)
against the JAX paged scheduler and the port's own dense one, the
sliding-window cache and the per-sequence ``generate_paged``.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX side runs as its own tests run it (``interpret=True``,
``paged_decode.INTERPRET`` set and restored). Compute is f32 unless a
test says otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_apr_tpu.config import ComputeConfig as JCompute
from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.engine import WhisperApr as JWhisperApr
from whisper_apr_tpu.errors import InferenceError as JInferenceError
from whisper_apr_tpu.model import kv_variants as jkv
from whisper_apr_tpu.model import paged_decode as jpd
from whisper_apr_tpu.model.params import init_params, quantize_params
from whisper_apr_tpu.ops import paged_attention as jpa
from whisper_apr_tpu.parallel.serving import BatchScheduler as JScheduler
from whisper_apr_tpu.tokenizer import SpecialTokens
from whisper_apr_tpu_torch import ComputeConfig as TCompute
from whisper_apr_tpu_torch import WhisperApr
from whisper_apr_tpu_torch.errors import InferenceError
from whisper_apr_tpu_torch.model import kv_variants as tkv
from whisper_apr_tpu_torch.model import paged_decode as tpd
from whisper_apr_tpu_torch.model.params import from_jax_params
from whisper_apr_tpu_torch.ops import paged_attention as tpa
from whisper_apr_tpu_torch.parallel.serving import BatchScheduler
from whisper_apr_tpu_torch.tokenizer import SpecialTokens as TSpecials

PAGE = 16


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
        n_audio_head=2, n_audio_layer=2, n_text_ctx=48, n_text_state=128,
        n_text_head=2, n_text_layer=2, n_mels=80)


@pytest.fixture(scope="module")
def params(cfg):
    jp = init_params(cfg, seed=7)
    return jp, from_jax_params(jp)


def _specials(cfg, cls):
    V = cfg.n_vocab
    return cls(eot=V - 1, sot=V - 2, lang_base=V - 110, transcribe=V - 3,
               no_timestamps=V - 4, timestamp_base=V + 1000,
               is_multilingual=False, translate=V - 5, no_speech=V - 6,
               speaker_turn=V - 7, prev=V - 8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_bf16(a: np.ndarray):
    """One bf16 array for both packages (bits equal)."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


class TestPagedAttentionPlain:
    """K15's plain version against the JAX kernel in interpret mode."""

    def _case(self, seed):
        rng = np.random.default_rng(seed)
        B, D, H, L, NP, P = 4, 128, 2, 3, 11, 3
        k = rng.normal(0, 0.5, (L, NP, PAGE, D)).astype(np.float32)
        v = rng.normal(0, 0.5, (L, NP, PAGE, D)).astype(np.float32)
        q = rng.normal(0, 0.5, (B, D)).astype(np.float32)
        # non-contiguous, out-of-order page ids; lengths crossing page
        # edges, one past the table's width (the inactive slot resting at
        # its last position) and one of a single row
        tables = np.array([[7, 2, 0], [3, 9, 5], [10, 1, 4], [6, 0, 0]],
                          np.int32)
        lengths = np.array([17, 41, 100, 1], np.int32)
        return q, k, v, tables, lengths, H

    @pytest.mark.parametrize("layer", [0, 2])
    def test_f32_matches_jax(self, layer):
        q, k, v, tables, lengths, H = self._case(0)
        want = np.asarray(jpa.paged_attention_stacked(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(lengths), layer, H,
            interpret=True))
        got = tpa.paged_attention_stacked(_t(q), _t(k), _t(v), _t(tables),
                                          _t(lengths), layer, H)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)

    def test_bf16_matches_jax(self):
        q, k, v, tables, lengths, H = self._case(1)
        (tq, jq), (tk, jk), (tv, jv) = map(_to_bf16, (q, k, v))
        want = np.asarray(jpa.paged_attention_stacked(
            jq, jk, jv, jnp.asarray(tables), jnp.asarray(lengths), 1, H,
            interpret=True)).astype(np.float32)
        got = tpa.paged_attention_stacked(tq, tk, tv, _t(tables),
                                          _t(lengths), 1, H)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2.0 ** -6 * np.abs(want).max(), err

    def test_one_layer_form_and_garbage_past_length(self):
        """``paged_attention`` over one-layer pools; rows past a slot's
        length (here NaN) never reach the output."""
        q, k, v, tables, lengths, H = self._case(2)
        k0, v0 = k[0].copy(), v[0].copy()
        want = np.asarray(jpa.paged_attention(
            jnp.asarray(q), jnp.asarray(k0), jnp.asarray(v0),
            jnp.asarray(tables), jnp.asarray(lengths), H, interpret=True))
        # slot 0 holds 17 rows: page 7 and row 0 of page 2; its third
        # page (0) and the rest of page 2 lie past its length
        for page, rows in ((2, slice(1, None)), (0, slice(None))):
            k0[page, rows], v0[page, rows] = np.nan, np.nan
        got = tpa.paged_attention(_t(q), _t(k0), _t(v0), _t(tables),
                                  _t(lengths), H).numpy()
        for b in (0, 3):
            np.testing.assert_allclose(got[b], want[b], rtol=1e-4,
                                       atol=1e-5)


# K15's edges (table width P in pages, slot lengths): an empty slot
# (averaged over all 16 P rows), a one-page table, lengths either side of
# one and two pages and of the table's end, a length past the table
PAGED_EDGES = [
    (1, [0, 1, 15, 16, 40]),
    (2, [16, 17, 0, 32, 33, 3]),
    (3, [0, 15, 16, 17, 32, 33, 48, 60]),
]


class TestPagedAttentionEdges:
    """K15's plain version against the JAX kernel at the edges of its
    pages, and its launch plan (pure Python)."""

    @pytest.mark.parametrize("P,lengths", PAGED_EDGES)
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_edges_match_jax(self, P, lengths, dtype):
        rng = np.random.default_rng(P)
        B, D, H = len(lengths), 128, 2
        n_pages = B * P + 1
        k = rng.normal(0, 0.5, (2, n_pages, PAGE, D)).astype(np.float32)
        v = rng.normal(0, 0.5, (2, n_pages, PAGE, D)).astype(np.float32)
        q = rng.normal(0, 0.5, (B, D)).astype(np.float32)
        tables = rng.permutation(n_pages)[: B * P].reshape(B, P).astype(
            np.int32)
        lens = np.array(lengths, np.int32)
        if dtype == "f32":
            tq, tk, tv = _t(q), _t(k), _t(v)
            jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        else:
            (tq, jq), (tk, jk), (tv, jv) = map(_to_bf16, (q, k, v))
        want = np.asarray(jpa.paged_attention_stacked(
            jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens), 1, H,
            interpret=True)).astype(np.float32)
        got = tpa.paged_attention_stacked(tq, tk, tv, _t(tables), _t(lens),
                                          1, H).float().numpy()
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        else:
            err = np.abs(got - want).max()
            assert err <= 2.0 ** -6 * np.abs(want).max(), err
        # the empty slot is the mean of V over its table's rows
        b = lengths.index(0) if 0 in lengths else None
        if b is not None and dtype == "f32":
            rows = v[1][tables[b]].reshape(P * PAGE, D)
            np.testing.assert_allclose(got[b], rows.mean(0), rtol=1e-4,
                                       atol=1e-5)

    @pytest.mark.parametrize("bad,jax_reads", [(-1, 4), (-7, 0), (8, 4)])
    def test_out_of_range_page_ids(self, bad, jax_reads):
        """A reference fault, recorded: the JAX kernel in interpret mode
        wraps a page id in [-n_pages, 0) to id + n_pages and clamps the
        rest; the port clamps every id into [0, n_pages). They agree but
        for ids -n_pages .. -1."""
        rng = np.random.default_rng(11)
        B, D, H, NP = 2, 128, 2, 5
        k = rng.normal(0, 0.5, (1, NP, PAGE, D)).astype(np.float32)
        v = rng.normal(0, 0.5, (1, NP, PAGE, D)).astype(np.float32)
        q = rng.normal(0, 0.5, (B, D)).astype(np.float32)
        lens = np.array([30, 20], np.int32)

        def jax_at(tables):
            return np.asarray(jpa.paged_attention_stacked(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(tables), jnp.asarray(lens), 0, H,
                interpret=True))
        tables = np.array([[1, bad], [3, 2]], np.int32)
        got = tpa.paged_attention_stacked(*map(_t, (q, k, v, tables, lens)),
                                          0, H).numpy()
        clamped = tables.clip(0, NP - 1)
        np.testing.assert_allclose(got, jax_at(clamped), rtol=1e-5,
                                   atol=1e-6)
        read = tables.copy()
        read[0, 1] = jax_reads          # the page the JAX kernel reads
        np.testing.assert_allclose(jax_at(tables), jax_at(read), rtol=1e-5,
                                   atol=1e-6)
        assert (jax_reads == clamped[0, 1]) == (bad >= 0 or bad < -NP)

    @pytest.mark.parametrize("B,P,H,D", [(8, 28, 6, 384), (8, 29, 6, 384),
                                         (1, 1, 6, 384), (16, 2, 8, 512),
                                         (8, 28, 12, 768), (8, 28, 20, 1280),
                                         (32, 29, 20, 1280),
                                         (4, 64, 16, 1024)])
    @pytest.mark.parametrize("elem", [2, 4])
    def test_plan(self, B, P, H, D, elem):
        """Every (slot, page, head) is owned by exactly one block; a
        slot's runs fit one cluster of at most 16; the head groups divide
        H; shared memory fits 227 KB; the grid is from shapes alone."""
        plan = tpa.paged_plan(B, P, H, D, elem)
        assert 1 <= plan.run <= tpa.PAGED_MAX_RUN
        assert -(-P // plan.run) <= tpa.PAGED_MAX_CLUSTER
        assert H % plan.groups == 0
        owned = [(b, p, h) for b, pages, heads in tpa.paged_blocks(
            plan, B, P, H) for p in pages for h in heads]
        assert sorted(owned) == [(b, p, h) for b in range(B)
                                 for p in range(P) for h in range(H)]
        assert tpa.paged_smem(D, H, elem, *plan, P) <= 227 * 1024


    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_one_launch(self, monkeypatch, dtype):
        """``_paged_cuda`` makes one call of the C entry point with one
        argument per ctypes type, the layer's pool block and the plan from
        the host's shapes, and counts one launch; ``lengths`` is not read
        on the host."""
        calls = []

        class Lib:
            def wa_paged_attention(self, *args):
                calls.append(args)
                return 0

        class Lengths(torch.Tensor):
            def tolist(self):
                raise AssertionError("lengths read on the host")

            def item(self):
                raise AssertionError("lengths read on the host")

        monkeypatch.setattr(tpa._build, "library", Lib)
        monkeypatch.setattr(tpa._build, "stream", lambda: 7)
        B, P, H, D, L, NP = 8, 28, 6, 384, 2, 225
        q = torch.zeros((B, D), dtype=dtype)
        pool = torch.zeros((L, NP, PAGE, D), dtype=dtype)
        tables = torch.zeros((B, P), dtype=torch.int32)
        lengths = torch.zeros(B, dtype=torch.int32).as_subclass(Lengths)
        before = tpa.LAUNCHES["paged_attention_stacked"]
        out = tpa._paged_cuda(q, pool, pool, tables, lengths, 1, H)
        assert out.shape == q.shape and out.dtype == dtype
        assert tpa.LAUNCHES["paged_attention_stacked"] == before + 1
        args = calls[0]
        assert len(calls) == 1
        assert len(args) == len(tpa._build._SIGNATURES["wa_paged_attention"])
        assert args[5] == pool.data_ptr() + NP * PAGE * D * q.element_size()
        assert tuple(args[12:14]) == tuple(tpa.paged_plan(
            B, P, H, D, q.element_size()))
        assert args[-1] == 7


class TestPagedKVCache:
    def _stream(self, pk, err):
        """An alloc / extend / free stream with an exhaustion in it."""
        pk.alloc(-1, 1)
        pk.alloc(0, 20)
        pk.alloc(1, 3)
        pk.extend(1, 14)
        pk.free(0)
        pk.alloc(2, 40)
        pk.extend(1, 1)
        before = (list(pk._free), {k: list(v) for k, v in pk._tables.items()},
                  dict(pk._lengths))
        with pytest.raises(err, match="out of KV pages"):
            pk.extend(2, 5 * PAGE)
        with pytest.raises(err, match="out of KV pages"):
            pk.alloc(3, 6 * PAGE)
        after = (list(pk._free), {k: list(v) for k, v in pk._tables.items()},
                 dict(pk._lengths))
        assert after == before          # rollback: nothing mutated
        pk.free(2)
        pk.alloc(4, 2)
        return after, (list(pk._free), dict(pk._tables), dict(pk._lengths),
                       pk.page_table(4, 3).tolist(), pk.page_table(1, 3)
                       .tolist())

    def test_default_device_is_the_card(self, cfg, monkeypatch):
        """Like every entry point of the port, the cache defaults to
        "cuda" and raises the engine's message where there is no card."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="needs a CUDA device; pass "
                           "device='cpu'"):
            tkv.PagedKVCache(cfg, n_pages=2)
        with pytest.raises(RuntimeError, match="needs a CUDA device; pass "
                           "device='cpu'"):
            WhisperApr(cfg, {}, device="cuda")

    def test_page_ids_match_jax(self, cfg):
        jpk = jkv.PagedKVCache(cfg, n_pages=9)
        tpk = tkv.PagedKVCache(cfg, n_pages=9, device="cpu")
        assert self._stream(tpk, InferenceError) == \
            self._stream(jpk, JInferenceError)
        assert tpk.free_pages == jpk.free_pages
        assert tpk.seq_len(1) == jpk.seq_len(1) == 18

    def test_write_and_gather_match_jax(self, cfg):
        rng = np.random.default_rng(3)
        L, D = cfg.n_text_layer, cfg.n_text_state
        jpk = jkv.PagedKVCache(cfg, n_pages=6)
        tpk = tkv.PagedKVCache(cfg, n_pages=6, device="cpu")
        for pk in (jpk, tpk):
            pk.alloc(0, 0)
            pk.alloc(1, 0)
        for pos in range(19):
            for sid in (0, 1):
                kv = rng.normal(size=(2, L, D)).astype(np.float32)
                for pk, conv in ((jpk, jnp.asarray), (tpk, _t)):
                    pk.extend(sid, 1)
                    pk.write_token(sid, conv(kv[0]), conv(kv[1]), pos)
        conv = from_jax_params(jpk)
        assert conv._tables == tpk._tables and conv._free == tpk._free
        np.testing.assert_array_equal(conv.k_pool.numpy(),
                                      tpk.k_pool.numpy())
        for got, want in zip(tpk.gather(1), jpk.gather(1)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(tpk.gather_layer(0, 1, upto=17),
                             jpk.gather_layer(0, 1, upto=17)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestPagedDecodeStep:
    def test_three_steps_from_one_pool(self, cfg, params):
        """Slots 0 and 1 active (lengths across a page edge), slot 2
        inactive at position 47, whose page index (2) lies past the
        bucketed width (2): the JAX gather clamps it to the table's last
        entry, the garbage page, and so does the port."""
        jp, tp = params
        rng = np.random.default_rng(5)
        L, D, S = cfg.n_text_layer, cfg.n_text_state, cfg.n_audio_ctx
        B, W = 3, 2
        jpk = jkv.PagedKVCache(cfg, n_pages=10)
        jpk.alloc(-1, 1)
        garbage = jpk._tables[-1][0]
        jpk.alloc(0, 14)
        jpk.alloc(1, 5)
        pool = rng.normal(0, 0.5, (2, L, 10, PAGE, D)).astype(np.float32)
        jpk.k_pool, jpk.v_pool = jnp.asarray(pool[0]), jnp.asarray(pool[1])
        tpk = from_jax_params(jpk)
        cross = rng.normal(0, 0.5, (2, L, B, S, D)).astype(np.float32)
        tok = np.array([11, 23, 5], np.int32)
        pos = np.array([14, 5, 47], np.int32)
        jk, jv = jpk.k_pool, jpk.v_pool
        tk, tv = tpk.k_pool, tpk.v_pool
        for _ in range(3):
            tables = np.full((B, W), garbage, np.int32)
            for sid in (0, 1):
                jpk.extend(sid, 1)
                tpk.extend(sid, 1)
                t = jpk._tables[sid]
                assert t == tpk._tables[sid]
                tables[sid, :len(t)] = t
            want, jk, jv = jpd.paged_decode_step(
                jp, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(tables),
                jk, jv, jnp.asarray(cross[0]), jnp.asarray(cross[1]), cfg,
                interpret=True)
            got, tk, tv = tpd.paged_decode_step(
                tp, _t(tok), _t(pos), _t(tables), tk, tv, _t(cross[0]),
                _t(cross[1]), cfg)
            want = np.asarray(want)
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-4 * np.abs(want).max(), err
            for a, b in ((tk, jk), (tv, jv)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-5, rtol=0)
            nxt = got.argmax(-1).numpy().astype(np.int32)
            assert np.array_equal(nxt, want.argmax(-1))
            tok, pos = nxt, pos + np.array([1, 1, 0], np.int32)

    def test_steps_loop_and_prefill_writes(self, cfg, params):
        """``paged_decode_steps`` equals stepping by hand; the batched
        prefill scatter equals the per-sequence one, duplicate rows
        included."""
        _, tp = params
        rng = np.random.default_rng(9)
        L, D, S = cfg.n_text_layer, cfg.n_text_state, cfg.n_audio_ctx
        pk = tkv.PagedKVCache(cfg, n_pages=6, device="cpu")
        pk.alloc(0, 4)
        pk.alloc(1, 4)
        sk = _t(rng.normal(size=(L, 3, 3, D)).astype(np.float32))
        sv = _t(rng.normal(size=(L, 3, 3, D)).astype(np.float32))
        sk[:, 2], sv[:, 2] = sk[:, 1], sv[:, 1]      # the pad repeats slot 1
        pages = torch.tensor([pk._tables[s] * 3 for s in (0, 1, 1)])
        offs = torch.arange(3).repeat(3, 1)
        k2, v2 = pk.k_pool.clone(), pk.v_pool.clone()
        tpd.write_prefills_to_pool(pk.k_pool, pk.v_pool, sk, sv, pages, offs)
        for i, s in enumerate((0, 1)):
            tpd.write_prefill_to_pool(k2, v2, sk[:, i:i + 1], sv[:, i:i + 1],
                                      np.asarray(pk._tables[s]), 3)
        assert torch.equal(k2, pk.k_pool) and torch.equal(v2, pk.v_pool)
        cross = _t(rng.normal(size=(2, L, 2, S, D)).astype(np.float32))
        tables = torch.tensor([pk._tables[0], pk._tables[1]],
                              dtype=torch.int32)
        bias = torch.zeros(cfg.n_vocab)
        tok, pos = torch.tensor([3, 4], dtype=torch.int32), torch.tensor([3, 3])
        k1, v1 = pk.k_pool.clone(), pk.v_pool.clone()
        toks, _, _ = tpd.paged_decode_steps(tp, tok, pos, bias, tables, k1,
                                            v1, cross[0], cross[1], cfg,
                                            n_steps=3)
        for i in range(3):
            logits, k2, v2 = tpd.paged_decode_step(
                tp, tok, pos + i, tables, k2, v2, cross[0], cross[1], cfg)
            tok = logits.argmax(-1).to(torch.int32)
            assert torch.equal(toks[:, i], tok)
        assert torch.equal(k1, k2)


def _jax_engine(cfg, jp, **compute):
    return JWhisperApr(cfg, jp, specials=_specials(cfg, SpecialTokens),
                       compute=JCompute(**compute))


def _port_engine(cfg, tp, **compute):
    return WhisperApr(cfg, tp, specials=_specials(cfg, TSpecials),
                      compute=TCompute(**compute), device="cpu")


def _audios(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.1, 3000 + 400 * i).astype(np.float32)
            for i in range(n)]


def _drain(sched, audios, max_tokens):
    ids = [sched.submit(a, "en", max_tokens=max_tokens) for a in audios]
    sched.run_until_drained(max_steps=500)
    return [sched.result(i).tokens for i in ids], sched.stats()


class TestPagedScheduler:
    @pytest.mark.parametrize("quant", ["none", "int8"])
    def test_matches_jax_and_dense(self, cfg, params, quant):
        """Batched and staged admission over the page pool give the JAX
        paged scheduler's tokens and the port's dense scheduler's, with
        requests longer than one page and more requests than slots."""
        jp, tp = params
        if quant == "int8":
            jp = quantize_params(jp, "int8")
            tp = from_jax_params(jp)
        jeng = _jax_engine(cfg, jp, quantization=quant, kv_mode="scan")
        teng = _port_engine(cfg, tp, quantization=quant, kv_mode="scan")
        audios = _audios(3, seed=3)
        jpd.INTERPRET = True
        try:
            want, jst = _drain(JScheduler(jeng, n_slots=2, max_len=40,
                                          paged=True), audios, 20)
        finally:
            jpd.INTERPRET = False
        got = {}
        for name, kw in (("paged", dict(paged=True)),
                         ("staged", dict(paged=True,
                                         batched_admission=False)),
                         ("dense", {})):
            sched = BatchScheduler(teng, n_slots=2, max_len=40, **kw)
            got[name], st = _drain(sched, audios, 20)
            if name == "paged":
                assert {k: st[k] for k in ("ticks", "tokens_generated")} \
                    == {k: jst[k] for k in ("ticks", "tokens_generated")}
                # every page is back in the pool but the garbage page
                assert sched._paged_kv.free_pages == \
                    sched._paged_kv.n_pages - 1
        assert max(map(len, want)) > PAGE + 4
        assert got["paged"] == want
        assert got["staged"] == want
        assert got["dense"] == want

    def test_bucket_pad_repeats_last_slot(self, cfg, params):
        """Three requests into four slots pad to the 4-bucket by
        repeating the last real slot (duplicate, identical pool writes);
        the pool size and garbage page follow the JAX scheduler."""
        jp, tp = params
        teng = _port_engine(cfg, tp)
        jeng = _jax_engine(cfg, jp)
        ts = BatchScheduler(teng, n_slots=4, max_len=32, paged=True)
        js = JScheduler(jeng, n_slots=4, max_len=32, paged=True)
        assert ts._paged_kv.n_pages == js._paged_kv.n_pages == 4 * 2 + 1
        assert ts._garbage_page == js._garbage_page
        audios = _audios(3, seed=8)
        jpd.INTERPRET = True
        try:
            want, _ = _drain(js, audios, 6)
        finally:
            jpd.INTERPRET = False
        got, _ = _drain(ts, audios, 6)
        assert got == want
        dense, _ = _drain(BatchScheduler(teng, n_slots=4, max_len=32),
                          audios, 6)
        assert dense == got

    def test_pool_size_and_exhaustion(self, cfg, params):
        """``n_pages`` sizes the pool; a pool too small for a tick's
        extension raises the allocator's error."""
        _, tp = params
        teng = _port_engine(cfg, tp)
        sched = BatchScheduler(teng, n_slots=2, max_len=40, paged=True,
                               n_pages=3)
        assert sched._paged_kv.n_pages == 3
        for a in _audios(2, seed=4):
            sched.submit(a, "en", max_tokens=30)
        with pytest.raises(InferenceError, match="out of KV pages"):
            sched.run_until_drained(max_steps=100)


class TestSlidingAndPerSequence:
    def test_sliding_cache_matches_jax(self, cfg, params):
        """A ring of 8 rows over 13 tokens (it wraps), then a second
        cache warmed up with the last 3 tokens; stats and logits as the
        JAX cache's."""
        jp, tp = params
        rng = np.random.default_rng(6)
        enc = rng.normal(0, 0.5, (2, cfg.n_audio_ctx, cfg.n_text_state)
                         ).astype(np.float32)
        sc = jkv.SlidingConfig(8, 3)
        js = jkv.SlidingKVCache(jp, jnp.asarray(enc), cfg, sc)
        ts = tkv.SlidingKVCache(tp, _t(enc), cfg,
                                tkv.SlidingConfig(8, 3))
        tok = np.array([5, 9], np.int32)
        for _ in range(13):
            want = np.asarray(js.step(jp, jnp.asarray(tok)))
            got = ts.step(tp, _t(tok)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            assert np.array_equal(got.argmax(-1), want.argmax(-1))
            tok = want.argmax(-1).astype(np.int32)
        assert ts.stats() == tkv.SlidingCacheStats(8, 13, 5)
        assert js.stats().slides == 5 and ts.stats().utilization == 1.0
        js2 = jkv.SlidingKVCache(jp, jnp.asarray(enc), cfg, sc)
        ts2 = tkv.SlidingKVCache(tp, _t(enc), cfg,
                                 tkv.SlidingConfig(8, 3))
        js2.warm_up(js)
        ts2.warm_up(ts)
        assert ts2.tokens_seen == js2.tokens_seen == 3
        want = np.asarray(js2.step(jp, jnp.asarray(tok)))
        np.testing.assert_allclose(ts2.step(tp, _t(tok)).numpy(), want,
                                   rtol=1e-4, atol=1e-4)
        assert (tkv.SlidingConfig.standard(), tkv.SlidingConfig.low_latency(),
                tkv.SlidingConfig.ultra_low_latency()) == (
            tkv.SlidingConfig(448, 64), tkv.SlidingConfig(64, 16),
            tkv.SlidingConfig(32, 8))

    def test_generate_paged_matches_jax(self, cfg, params):
        """Greedy decode of one sequence over the paged pool (page
        gathers, no kernel): the JAX tokens, and every page freed."""
        jp, tp = params
        rng = np.random.default_rng(2)
        enc = rng.normal(0, 0.5, (1, cfg.n_audio_ctx, cfg.n_text_state)
                         ).astype(np.float32)
        eot = cfg.n_vocab - 1
        bias = np.zeros(cfg.n_vocab, np.float32)
        bias[eot] = -np.inf           # decode to the cap across pages
        jpk = jkv.PagedKVCache(cfg, n_pages=4)
        tpk = tkv.PagedKVCache(cfg, n_pages=4, device="cpu")
        want = jkv.generate_paged(jp, jnp.asarray(enc), [1, 2, 3], jpk, 0,
                                  eot, cfg, max_tokens=22,
                                  suppress_bias=jnp.asarray(bias))
        got = tkv.generate_paged(tp, _t(enc), [1, 2, 3], tpk, 0, eot, cfg,
                                 max_tokens=22, suppress_bias=_t(bias))
        assert got == want and len(got) == 22
        assert tpk.free_pages == 4
