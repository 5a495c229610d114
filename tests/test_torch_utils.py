"""The port's measuring utils and the rest of its weights surface against
the JAX package's, on the CPU: the roofline formulas (every preset, on
the V5E data row the JAX package uses), memory planning, checkpoints
crossing between the packages, trace events, the pipeline benchmark's
split, the quantization error metrics, parameter counts and sizes, and
the transformers bridge (``params_from_hf_model``, ``from_hf_model``)
on a random-init ``WhisperForConditionalGeneration`` built from a local
``WhisperConfig``.

Inputs are made with numpy from fixed seeds and handed to both packages.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_hf_twin, small_config, small_specials
from whisper_apr_tpu.config import ModelConfig
from whisper_apr_tpu.engine import TranscribeOptions as JOptions
from whisper_apr_tpu.engine import WhisperApr as JWhisperApr
from whisper_apr_tpu.model import params as jparams
from whisper_apr_tpu.ops import quant as jquant
from whisper_apr_tpu.utils import benchmark as jbench
from whisper_apr_tpu.utils import checkpoint as jckpt
from whisper_apr_tpu.utils import memory as jmem
from whisper_apr_tpu.utils import roofline as jroof
from whisper_apr_tpu.utils import trace as jtrace
from whisper_apr_tpu_torch import ModelConfig as TModelConfig
from whisper_apr_tpu_torch import TranscribeOptions, WhisperApr
from whisper_apr_tpu_torch.model import params as tparams
from whisper_apr_tpu_torch.model.params import from_jax_params
from whisper_apr_tpu_torch.ops import quant as tquant
from whisper_apr_tpu_torch.tokenizer import SpecialTokens as TSpecials
from whisper_apr_tpu_torch.utils import benchmark as tbench
from whisper_apr_tpu_torch.utils import checkpoint as tckpt
from whisper_apr_tpu_torch.utils import memory as tmem
from whisper_apr_tpu_torch.utils import roofline as troof
from whisper_apr_tpu_torch.utils import trace as ttrace

PRESETS = ["tiny", "base", "small", "medium", "large-v3", "large-v3-turbo"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(cfg):
    return TModelConfig(**dataclasses.asdict(cfg))


def _tspecials(cfg):
    return TSpecials(**dataclasses.asdict(small_specials(cfg)))


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

ROOF_CALLS = {
    "decoder_weight_bytes": lambda m, c: [
        m.decoder_weight_bytes(c, q) for q in
        ("f32", "bf16", "int8", "q6k", "q5k", "q4k", "q4", "int4")],
    "decode_step_floor_ms": lambda m, c: [
        m.decode_step_floor_ms(c, q, pos=p, kv=kv, batch=b, chip=m.V5E)
        for q in ("int8", "q4k") for p in (1, 112, 447)
        for kv in ("bf16", "int8", "fp8", "f32") for b in (1, 8)],
    "encoder_flops": lambda m, c: [m.encoder_flops(c)],
    "encoder_floor_ms": lambda m, c: [
        m.encoder_floor_ms(c, chip=m.V5E, dtype=d) for d in ("bf16", "int8")],
    "rtf_floor": lambda m, c: [
        m.rtf_floor(c, decode_tokens=t, quant=q, kv=kv, chip=m.V5E)
        for t in (32, 224) for q in ("int8", "bf16") for kv in ("bf16",
                                                                 "int8")],
    "encoder_weight_bytes": lambda m, c: [
        m.encoder_weight_bytes(c, q) for q in ("f32", "int8", "q4k")],
    "kv_cache_bytes_per_stream": lambda m, c: [
        m.kv_cache_bytes_per_stream(c, kv, n) for kv in ("bf16", "int8")
        for n in (224, 448)],
    "streams_per_chip_floor": lambda m, c: [
        m.streams_per_chip_floor(c, q, kv, chip=m.V5E)
        for q in ("int8", "q4k") for kv in ("bf16", "int8")],
}


class TestRoofline:
    @pytest.mark.parametrize("fn", sorted(ROOF_CALLS))
    @pytest.mark.parametrize("preset", PRESETS)
    def test_formulas_equal_jax_on_v5e(self, fn, preset):
        cfg = ModelConfig.from_name(preset)
        want = ROOF_CALLS[fn](jroof, cfg)
        got = ROOF_CALLS[fn](troof, _tcfg(cfg))
        assert got == want

    def test_h100_is_the_default(self):
        cfg = TModelConfig.large_v3()
        assert troof.H100 == troof.ChipSpec("nvidia-h100-sxm", 989.0,
                                            1979.0, 3350.0, 80.0)
        assert troof.decode_step_floor_ms(cfg) == \
            troof.decode_step_floor_ms(cfg, chip=troof.H100)
        # bandwidth floors scale with the rate: 819 / 3350 of the V5E's
        np.testing.assert_allclose(
            troof.decode_step_floor_ms(cfg),
            troof.decode_step_floor_ms(cfg, chip=troof.V5E) * 819 / 3350,
            rtol=1e-12)
        assert troof.encoder_floor_ms(cfg) == pytest.approx(
            troof.encoder_flops(cfg) / 989e12 * 1e3)


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

class TestMemory:
    @pytest.mark.parametrize("preset", PRESETS)
    @pytest.mark.parametrize("batch,pb,cb", [(1, 4, 4), (8, 1, 2)])
    def test_plan_equals_jax(self, preset, batch, pb, cb):
        cfg = ModelConfig.from_name(preset)
        want = jmem.plan_memory(cfg, batch, pb, cb)
        got = tmem.plan_memory(_tcfg(cfg), batch, pb, cb)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.total_bytes == want.total_bytes
        for hbm in (1 << 30, 16 << 30, 80 << 30):
            assert got.fits(hbm) == want.fits(hbm)

    @pytest.mark.parametrize("hbm_gib", [1, 2, 4, 16, 80])
    @pytest.mark.parametrize("quant", ["int8", "none", "bfloat16"])
    def test_recommend_equals_jax(self, hbm_gib, quant):
        assert tmem.recommend_model(hbm_gib << 30, 2, quant) == \
            jmem.recommend_model(hbm_gib << 30, 2, quant)

    @pytest.mark.parametrize("mode", ["none", "int8", "int4", "q4", "q4k"])
    def test_tree_bytes_equals_jax(self, mode):
        cfg = small_config(n_text_state=256, n_audio_state=256)
        jp = jparams.quantize_params(jparams.init_params(cfg, seed=0), mode)
        tp = from_jax_params(jp)
        assert tmem.tree_bytes(tp) == jmem.tree_bytes(jp)

    def test_stats_need_a_card(self):
        assert tmem.device_memory_stats("cpu") is None
        s = tmem.MemoryStats(5, 10, 7)
        assert s.utilization == 0.5
        assert tmem.MemoryStats(0, 0, 0).utilization == 0.0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _same(got, want):
    """Port tree == from_jax_params(JAX tree), leaf for leaf."""
    want = from_jax_params(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, tquant.QTensor):
        assert (got.int4, got.orig_last, got.group, got.kpack) == \
            (want.int4, want.orig_last, want.group, want.kpack)
        for f in ("q", "scale", "zero"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None)
            if w is not None:
                assert g.dtype == w.dtype and torch.equal(g, w)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


class TestCheckpoint:
    @pytest.mark.parametrize("mode", ["none", "int8", "int4", "q4k"])
    def test_jax_saves_port_loads(self, tmp_path, mode):
        cfg = small_config(n_text_state=256, n_audio_state=256)
        jp = jparams.quantize_params(jparams.init_params(cfg, seed=1), mode)
        path = str(tmp_path / "ck.npz")
        jckpt.save_params(path, jp)
        _same(tckpt.load_params(path), jp)

    @pytest.mark.parametrize("mode", ["none", "int8", "q5k"])
    def test_port_saves_jax_loads(self, tmp_path, mode):
        cfg = small_config(n_text_state=256, n_audio_state=256)
        tp = tparams.quantize_params(
            tparams.init_params(_tcfg(cfg), seed=2), mode)
        path = str(tmp_path / "ck.npz")
        tckpt.save_params(path, tp)
        jp = jckpt.load_params(path, device_put=False)
        _same(tp, jp)
        assert tckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION

    def test_lists_tuples_and_none(self, tmp_path):
        tree = {"a": [torch.arange(3), (torch.ones(2), None)]}
        path = str(tmp_path / "ck.npz")
        tckpt.save_params(path, tree)
        got = tckpt.load_params(path)
        assert isinstance(got["a"], list) and isinstance(got["a"][1], tuple)
        assert torch.equal(got["a"][0], torch.arange(3))
        assert got["a"][1][1] is None

    def test_refuses_bf16_and_other_versions(self, tmp_path):
        with pytest.raises(TypeError, match="float32"):
            tckpt.save_params(str(tmp_path / "x.npz"),
                              {"w": torch.ones(2, dtype=torch.bfloat16)})
        path = str(tmp_path / "old.npz")
        meta = {"version": 1, "n_leaves": 0, "spec": {"t": "none"}}
        with open(path, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                               dtype=np.uint8))
        with pytest.raises(ValueError, match="version 1"):
            tckpt.load_params(path)


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def _spans(mod):
    mod.enable_tracing(True)
    mod.drain_events()
    try:
        with mod.trace_span("load"):
            with mod.trace_span("inner"):
                pass
        with mod.trace_span("decode"):
            pass
        return mod.drain_events()
    finally:
        mod.enable_tracing(False)


class TestTrace:
    def test_events_equal_jax(self):
        want = _spans(jtrace)
        got = _spans(ttrace)
        assert [e[0] for e in got] == [e[0] for e in want] == [
            "inner", "load", "decode"]
        assert all(d >= 0 for _, _, d in got)
        (_, t_in, d_in), (_, t_load, d_load), (_, t_dec, _) = got
        assert t_load <= t_in and t_in + d_in <= t_load + d_load <= t_dec

    def test_off_records_nothing(self):
        ttrace.enable_tracing(False)
        ttrace.drain_events()
        with ttrace.trace_span("x", rows=1):
            with ttrace.trace_span("y"):
                ttrace.annotate(live=1)
        assert ttrace.drain_events() == [] and not ttrace.tracing_enabled()

    def test_profile_writes_a_chrome_trace(self, tmp_path):
        ttrace.enable_tracing(True)
        try:
            with ttrace.profile(str(tmp_path)):
                with ttrace.trace_span("matmul_span"):
                    torch.ones(8, 8) @ torch.ones(8, 8)
        finally:
            ttrace.enable_tracing(False)
            ttrace.drain_events()
        text = (tmp_path / "trace.json").read_text()
        assert "matmul_span" in text and json.loads(text)


# ---------------------------------------------------------------------------
# benchmark
# ---------------------------------------------------------------------------

class TestBenchmark:
    def test_components_equal_jax(self):
        kw = dict(audio_seconds=2.0, decode_tokens=3, emit="json")
        want = json.loads(jbench.run_pipeline_benchmark(**kw))
        got = json.loads(tbench.run_pipeline_benchmark(device="cpu", **kw))
        assert [c["name"] for c in got["components"]] == \
            [c["name"] for c in want["components"]] == ["mel", "encode",
                                                         "decode"]
        assert got["device"].startswith("cpu")
        assert got["audio_seconds"] == want["audio_seconds"]
        assert sum(c["fraction"] for c in got["components"]) <= 1.0001
        assert got["rtf_floor"] > 0

    def test_report_text_and_csv(self):
        rep = tbench.BenchmarkReport(
            30.0, 3.0, [tbench.ComponentTiming("mel", 1.0, 1 / 3),
                        tbench.ComponentTiming("decode", 2.0, 2 / 3)], 224,
            rtf_floor=0.01, device="cpu")
        j = jbench.BenchmarkReport(
            30.0, 3.0, [jbench.ComponentTiming("mel", 1.0, 1 / 3),
                        jbench.ComponentTiming("decode", 2.0, 2 / 3)], 224,
            rtf_floor=0.01)
        assert rep.bottleneck() == j.bottleneck() == "decode"
        assert rep.to_csv() == j.to_csv()
        got = json.loads(rep.to_json())
        assert got.pop("device") == "cpu"
        assert got == json.loads(j.to_json())
        assert "cpu" in rep.to_text() and "bottleneck: decode" in \
            rep.to_text()

    def test_needs_a_card_by_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            tbench.run_pipeline_benchmark()


# ---------------------------------------------------------------------------
# quantization metrics, counts and sizes
# ---------------------------------------------------------------------------

class TestQuantMetrics:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_error_and_sqnr_equal_jax(self, seed):
        rng = np.random.default_rng(seed)
        w = rng.normal(0, 0.1, (64, 48)).astype(np.float32)
        jq = jquant.quantize_int8(w, per_channel=True)
        deq = np.asarray(jquant.dequant(jq, jnp.float32))
        for a, b in ((w, deq), (w, w), (np.zeros(4), np.ones(4))):
            assert tquant.quantization_error(torch.from_numpy(np.array(a)),
                                             b) == \
                jquant.quantization_error(a, b)
            assert tquant.compute_sqnr(a, torch.from_numpy(
                np.array(b))) == jquant.compute_sqnr(a, b)

    def test_qtensor_size(self):
        qt = tquant.quantize_int8(np.ones((3, 5), np.float32))
        jt = jquant.quantize_int8(np.ones((3, 5), np.float32))
        assert qt.size == jt.size == 15

    @pytest.mark.parametrize("mode", ["none", "int8", "int4", "q4", "q4k",
                                      "q6k"])
    def test_counts_and_sizes_equal_jax(self, mode):
        cfg = small_config(n_text_state=256, n_audio_state=256)
        jp = jparams.quantize_params(jparams.init_params(cfg, seed=0), mode)
        tp = from_jax_params(jp)
        assert tparams.count_params(tp) == jparams.count_params(jp)
        assert tparams.quantized_size_bytes(tp) == \
            jparams.quantized_size_bytes(jp)


# ---------------------------------------------------------------------------
# transformers bridge
# ---------------------------------------------------------------------------

class TestHF:
    @pytest.fixture(scope="class")
    def hf(self):
        return make_hf_twin(small_config(), seed=3)

    def test_state_dict_names_equal_jax(self, hf):
        sd = hf.state_dict()
        want = jparams.hf_state_dict_to_apr_tensors(
            {k: v.detach().numpy() for k, v in sd.items()})
        got = tparams.hf_state_dict_to_apr_tensors(sd)
        assert list(got) == list(want)
        assert "proj_out.weight" not in got
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])

    def test_params_equal_jax(self, hf):
        cfg = small_config()
        want = jparams.params_from_hf_model(hf, cfg)
        got = tparams.params_from_hf_model(hf, _tcfg(cfg))
        _same(got, want)

    @pytest.mark.parametrize("quant", ["none", "int8"])
    def test_engines_give_the_same_tokens(self, hf, quant):
        from whisper_apr_tpu.config import ComputeConfig as JCompute
        from whisper_apr_tpu_torch import ComputeConfig as TCompute
        cfg = small_config()
        jeng = JWhisperApr.from_hf_model(hf, cfg,
                                         compute=JCompute(quantization=quant),
                                         specials=small_specials(cfg))
        teng = WhisperApr.from_hf_model(hf, _tcfg(cfg),
                                        compute=TCompute(quantization=quant),
                                        specials=_tspecials(cfg),
                                        device="cpu")
        audio = np.random.default_rng(5).normal(0, 0.1, 3200).astype(
            np.float32)
        opts = dict(language="en", max_tokens=6)
        want = jeng.transcribe(audio, JOptions(**opts))
        got = teng.transcribe(audio, TranscribeOptions(**opts))
        assert len(got.tokens) > 3
        assert got.tokens == want.tokens

    def test_no_transformers_import(self):
        """The port reads only ``state_dict()``: transformers is never
        imported by the package itself."""
        import subprocess
        import sys
        code = ("import sys, whisper_apr_tpu_torch.engine, "
                "whisper_apr_tpu_torch.model.params; "
                "print('transformers' in sys.modules)")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, cwd=os.path.dirname(
                                 os.path.dirname(__file__)), check=True)
        assert out.stdout.strip() == "False"
