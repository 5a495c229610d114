"""The port's continuous-batching scheduler against the JAX package's, at
a small width on the CPU.

Both engines hold the same int8 weights (the JAX package's seeded
``init_params``, carried across by ``from_jax_params``); the JAX
scheduler is driven as its own tests drive it on the CPU: the qd forced
through ``eng._qdecode_cache`` and the Pallas kernels in interpret mode.
Compute is f32 on both sides. Completions must be identical and the
counters of ``stats()`` must agree.
"""

import numpy as np
import pytest
import torch

from whisper_apr_tpu.config import ComputeConfig as JCompute
from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.engine import WhisperApr as JWhisperApr
from whisper_apr_tpu.model import qdecode as jqd
from whisper_apr_tpu.model.params import init_params, quantize_params
from whisper_apr_tpu.parallel.serving import BatchScheduler as JScheduler
from whisper_apr_tpu.tokenizer import SpecialTokens
from whisper_apr_tpu_torch import ComputeConfig as TCompute
from whisper_apr_tpu_torch import TranscribeOptions, WhisperApr
from whisper_apr_tpu_torch.model.decoder import KVCache
from whisper_apr_tpu_torch.model.params import from_jax_params
from whisper_apr_tpu_torch.ops import decode_blocks as tdb
from whisper_apr_tpu_torch.parallel.serving import BatchScheduler
from whisper_apr_tpu_torch.tokenizer import SpecialTokens as TSpecials

COUNTS = ("completed_ok", "cancelled", "timeout", "tokens_generated",
          "admitted", "ticks", "completed_total")


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


def _specials(cfg, cls):
    V = cfg.n_vocab
    return cls(eot=V - 1, sot=V - 2, lang_base=V - 110, transcribe=V - 3,
               no_timestamps=V - 4, timestamp_base=V + 1000,
               is_multilingual=False, translate=V - 5, no_speech=V - 6,
               speaker_turn=V - 7, prev=V - 8)


def _engines(cfg, params, mode):
    jp, tp = params
    jeng = JWhisperApr(cfg, jp, specials=_specials(cfg, SpecialTokens),
                       compute=JCompute(quantization="int8", kv_mode=mode))
    jeng._qdecode_cache = jqd.prepare_qdecode(jp, cfg)  # CPU: forced on
    teng = WhisperApr(cfg, tp, specials=_specials(cfg, TSpecials),
                      compute=TCompute(quantization="int8", kv_mode=mode),
                      device="cpu")
    return jeng, teng


def _audios(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.1, 3000 + 500 * i).astype(np.float32)
            for i in range(n)]


def _drain(sched, audios, max_tokens: int = 8):
    ids = [sched.submit(a, "en", max_tokens=max_tokens) for a in audios]
    sched.run_until_drained()
    return [sched.result(i) for i in ids]


def _run_jax(sched, audios, **kw):
    jqd.INTERPRET = True
    try:
        return _drain(sched, audios, **kw)
    finally:
        jqd.INTERPRET = False


class _OneDeviceMesh:
    """A 1 x 1 stand-in for a ``DeviceMesh``: a mesh of one device runs no
    collective, so the scheduler needs no process group."""

    mesh_dim_names = ("dp", "tp")
    shape = (1, 1)

    def get_coordinate(self):
        return [0, 0]


class TestSchedulerMatchesJax:
    @pytest.mark.parametrize("mode", ["int8", "bf16"])
    def test_completions_and_stats(self, cfg, params, mode):
        """n_slots = 2 over 3 clips: the third waits for a free slot."""
        jeng, teng = _engines(cfg, params, mode)
        audios = _audios(3, seed=5)
        js, ts = JScheduler(jeng, n_slots=2), BatchScheduler(teng, n_slots=2)
        assert ts._qf == js._qf == mode
        want = _run_jax(js, audios)
        got = _drain(ts, audios)
        for w, g in zip(want, got):
            assert (g.tokens, g.status, g.prompt_len) == \
                (w.tokens, w.status, w.prompt_len)
        jst, tst = js.stats(), ts.stats()
        assert {k: tst[k] for k in COUNTS} == {k: jst[k] for k in COUNTS}
        assert tst["n_slots"] == 2 and tst["active_slots"] == 0

    def test_cross8_is_served_as_int8(self, cfg, params):
        """The reference serves kv mode cross8 (explicit, or "auto") with
        full int8 slot caches; the port reproduces it."""
        for mode in ("cross8", "auto"):
            _, teng = _engines(cfg, params, mode)
            sched = BatchScheduler(teng, n_slots=2)
            assert sched._qf == "int8"
            assert sched._cache.self_kq.dtype == torch.int8
            assert sched._cache.self_ks is not None

    @pytest.mark.parametrize("mode", ["int8", "bf16"])
    def test_staged_admission_matches_batched(self, cfg, params, mode):
        _, teng = _engines(cfg, params, mode)
        audios = _audios(2, seed=6)
        out = {}
        for staged in (False, True):
            sched = BatchScheduler(teng, n_slots=2,
                                   batched_admission=not staged)
            out[staged] = [c.tokens for c in _drain(sched, audios,
                                                    max_tokens=6)]
        assert out[True] == out[False]

    def test_slots_match_transcribe(self, cfg, params):
        """Each completion starts with the tokens ``transcribe`` gives for
        its clip alone (int8 KV on both: the engine's kv mode)."""
        _, teng = _engines(cfg, params, "int8")
        audios = _audios(3, seed=7)
        opts = TranscribeOptions(language="en", max_tokens=8)
        expected = [teng.transcribe(a, opts).tokens for a in audios]
        got = _drain(BatchScheduler(teng, n_slots=2), audios)
        for g, e in zip(got, expected):
            assert g.tokens[: len(e)] == e


class TestSchedulerControl:
    def test_cancel_queued_and_in_flight(self, cfg, params):
        _, teng = _engines(cfg, params, "int8")
        audios = _audios(3, seed=8)
        sched = BatchScheduler(teng, n_slots=2)
        ids = [sched.submit(a, "en", max_tokens=12) for a in audios]
        assert sched.cancel(ids[2])            # still queued
        sched.step()                           # admits 0 and 1
        assert sched.cancel(ids[0])            # in flight
        sched.run_until_drained()
        c0, c1, c2 = (sched.result(i) for i in ids)
        assert c2.status == "cancelled" and c2.tokens == []
        assert c0.status == "cancelled" and len(c0.tokens) > c0.prompt_len
        assert c1.status == "ok"
        assert not sched.cancel(ids[1])        # already complete
        st = sched.stats()
        assert st["cancelled"] == 2 and st["completed_ok"] == 1

    def test_deadlines_time_out(self, cfg, params):
        """A request past its deadline completes with status "timeout":
        in the queue with no tokens, in a slot with its partial tokens."""
        _, teng = _engines(cfg, params, "int8")
        audios = _audios(2, seed=9)
        sched = BatchScheduler(teng, n_slots=1)
        late = sched.submit(audios[0], "en", timeout_s=-1.0)
        live = sched.submit(audios[1], "en", max_tokens=12)
        sched.step()
        sched._req[0].deadline = 0.0           # expires while decoding
        sched.run_until_drained()
        assert sched.result(late).status == "timeout"
        assert sched.result(late).tokens == []
        c = sched.result(live)
        assert c.status == "timeout" and len(c.tokens) > c.prompt_len
        assert sched.stats()["timeout"] == 2

    def test_background_thread_drains(self, cfg, params):
        import time
        _, teng = _engines(cfg, params, "int8")
        sched = BatchScheduler(teng, n_slots=2)
        sched.start()
        try:
            ids = [sched.submit(a, "en", max_tokens=4)
                   for a in _audios(2, seed=10)]
            t0 = time.time()
            while any(sched.result(i) is None for i in ids) \
                    and time.time() - t0 < 120:
                time.sleep(0.01)
        finally:
            sched.stop()
        comps = [sched.result(i) for i in ids]
        assert all(c is not None and c.status == "ok" for c in comps)
        text = sched.decode_text(comps[0])
        assert isinstance(text, str)

    def test_ticks_run_the_batched_kernels(self, cfg, params, monkeypatch):
        """Every tick is one decode_step_qf at B = n_slots: the batched
        self/cross/FFN sub-blocks once per layer, the logits tail, never
        the B = 1 sub-blocks."""
        _, teng = _engines(cfg, params, "int8")
        calls = {"self_block_batched": 0, "self_block": 0}
        for name in calls:
            real = getattr(tdb, name)

            def spy(*a, _real=real, _name=name):
                calls[_name] += 1
                return _real(*a)
            monkeypatch.setattr(tdb, name, spy)
        sched = BatchScheduler(teng, n_slots=2)
        _drain(sched, _audios(3, seed=11), max_tokens=4)
        assert calls["self_block"] == 0
        assert calls["self_block_batched"] == \
            cfg.n_text_layer * sched.stats()["ticks"]

    @pytest.mark.parametrize("kw,slice_", [
        pytest.param(dict(mesh=_OneDeviceMesh()), "slice 7",
                     id="kw1-slice 7")])
    def test_later_slices_raise(self, cfg, params, kw, slice_):
        """Serving on a mesh, once refused here, now serves (the id keeps
        the refusal's old name): on a one-device mesh an int8 engine
        ticks the plain dense step, as JAX's mesh scheduler does, and
        completes JAX's tokens; paged slots stay refused on a mesh. (The
        multi-rank meshes: tests/test_torch_parallel.py.)"""
        from whisper_apr_tpu.parallel.mesh import make_mesh
        jeng, teng = _engines(cfg, params, "int8")
        ts = BatchScheduler(teng, n_slots=2, **kw)
        assert ts._qf is None and ts._qd is None
        assert isinstance(ts._cache, KVCache)
        jm = make_mesh(1, tp=1)
        js = JScheduler(jeng, n_slots=2, mesh=jm)
        audios = _audios(3, seed=13)
        with jm:
            want = _drain(js, audios, max_tokens=4)
        got = _drain(ts, audios, max_tokens=4)
        assert [g.tokens for g in got] == [w.tokens for w in want]
        with pytest.raises(ValueError, match="paged serving is per-device"):
            BatchScheduler(teng, n_slots=2, paged=True, **kw)


class TestDenseSlots:
    """Engines without a fused-step cache mode serve dense ``KVCache``
    slots, as the JAX scheduler does: kv_mode "scan" ticks through the
    scan step (K8 and K9), f32 weights through the plain
    ``decode_step_multi``."""

    def test_scan_engine_matches_jax(self, cfg, params):
        jeng, teng = _engines(cfg, params, "scan")
        audios = _audios(3, seed=12)
        js, ts = JScheduler(jeng, n_slots=2), BatchScheduler(teng, n_slots=2)
        assert ts._qf is None and js._qf is None
        assert ts._cache.self_k.dtype == torch.float32
        want = _run_jax(js, audios)
        got = _drain(ts, audios)
        assert [g.tokens for g in got] == [w.tokens for w in want]
        jst, tst = js.stats(), ts.stats()
        assert {k: tst[k] for k in COUNTS} == {k: jst[k] for k in COUNTS}

    def test_f32_engine_matches_jax(self, cfg, params):
        jp = init_params(cfg, seed=3)
        jeng = JWhisperApr(cfg, jp, specials=_specials(cfg, SpecialTokens))
        teng = WhisperApr(cfg, from_jax_params(jp),
                          specials=_specials(cfg, TSpecials), device="cpu")
        assert teng._qdecode is None
        audios = _audios(3, seed=13)
        js, ts = JScheduler(jeng, n_slots=2), BatchScheduler(teng, n_slots=2)
        want = _drain(js, audios)
        got = _drain(ts, audios)
        assert [g.tokens for g in got] == [w.tokens for w in want]

    @pytest.mark.parametrize("staged", [False, True])
    def test_scan_slots_follow_transcribe(self, cfg, params, staged):
        """Each completion over the scan engine starts with the tokens
        scan ``transcribe`` gives for its clip alone, with batched or
        staged admission."""
        _, teng = _engines(cfg, params, "scan")
        audios = _audios(3, seed=14)
        opts = TranscribeOptions(language="en", max_tokens=8)
        expected = [teng.transcribe(a, opts).tokens for a in audios]
        got = _drain(BatchScheduler(teng, n_slots=2,
                                    batched_admission=not staged), audios)
        for g, e in zip(got, expected):
            assert g.tokens[: len(e)] == e

    def test_scan_ticks_run_k8_and_k9(self, cfg, params, monkeypatch):
        """Every scan tick is one decode_step_q at B = n_slots: K8 4L + 1
        times and K9 L times, no per-block kernel."""
        from whisper_apr_tpu_torch.ops import qmatvec as tqm
        _, teng = _engines(cfg, params, "scan")
        calls = {"qmatvec_stacked": 0, "ffn_fused": 0, "self_block_batched": 0}
        mods = {"qmatvec_stacked": tqm, "ffn_fused": tqm,
                "self_block_batched": tdb}
        for name, mod in mods.items():
            real = getattr(mod, name)

            def spy(*a, _real=real, _name=name, **kw):
                calls[_name] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(mod, name, spy)
        sched = BatchScheduler(teng, n_slots=2)
        _drain(sched, _audios(3, seed=15), max_tokens=4)
        L, n = cfg.n_text_layer, sched.stats()["ticks"]
        assert calls == {"qmatvec_stacked": (4 * L + 1) * n,
                         "ffn_fused": L * n, "self_block_batched": 0}
