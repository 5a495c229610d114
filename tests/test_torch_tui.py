"""The port's terminal dashboard (``whisper_apr_tpu_torch.cli.tui``)
against the JAX package's, on the CPU: every renderer's strings, every
``TuiApp`` frame, ``live_decode``'s tokens over the same ``.apr``, and
``run_tui`` with curses faked."""

import argparse
import sys
import time

import numpy as np
import pytest
import torch

import whisper_apr_tpu.cli.tui as jtui
import whisper_apr_tpu_torch.cli.tui as ttui
from test_torch_cli import speech_like, write_model
from whisper_apr_tpu.cli import commands as jcommands
from whisper_apr_tpu.inference.processors import \
    WhisperTokenSuppressor as JSuppressor
from whisper_apr_tpu_torch.audio.wav import write_wav
from whisper_apr_tpu_torch.cli import commands as tcommands
from whisper_apr_tpu_torch.inference.processors import \
    WhisperTokenSuppressor as TSuppressor


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RNG = np.random.default_rng(0)
WAVE = np.sin(np.arange(6000) * 0.01).astype(np.float32) * np.linspace(
    0, 1, 6000, dtype=np.float32)
MEL = RNG.normal(size=(100, 80)).astype(np.float32)
ATTN = RNG.random((7, 50)).astype(np.float32)


def _timings(m, **kw):
    base = dict(mel_s=0.0123, encode_s=0.0456, decode_s=0.5, tokens=17,
                max_tokens=32, audio_s=1.5)
    base.update(kw)
    return m.StageTimings(**base)


def _layers(m, n=20):
    return [m.EncoderLayerMetrics(i, 0.1 * i, 1.5 + i, 2.0 - 0.05 * i)
            for i in range(n)]


def _tokens(m, n=15):
    return [m.DecoderToken(100 + i, f" w{i}" + ("\n" if i == 3 else ""),
                           -0.3 * i) for i in range(n)]


RENDERS = {
    "waveform": lambda m: m.render_waveform(WAVE, width=40),
    "waveform_short": lambda m: m.render_waveform(WAVE[:7], width=12),
    "waveform_empty": lambda m: m.render_waveform(np.zeros(0), width=10),
    "mel": lambda m: m.render_mel(MEL, 30, 6),
    "mel_flat": lambda m: m.render_mel(np.ones((5, 80)), 8, 3),
    "mel_not_2d": lambda m: m.render_mel(np.zeros(5), 10, 3),
    "progress": lambda m: [m.render_progress(f, 20)
                           for f in (-0.5, 0.0, 0.333, 1.0, 2.0)],
    "stage_panel": lambda m: [m.render_stage_panel(s, _timings(m), 60)
                              for s in m.PipelineState],
    "stage_panel_narrow": lambda m: m.render_stage_panel(
        m.PipelineState.DECODE, _timings(m), 20),
    "dashboard": lambda m: [m.render_dashboard(
        s, WAVE, MEL, "hello " * 30, 12.3456, 72, _timings(m))
        for s in m.PipelineState],
    "dashboard_empty": lambda m: m.render_dashboard(
        m.PipelineState.IDLE, None, None, "", 0.0),
    "waveform_rows": lambda m: m.render_waveform_rows(WAVE, 40, 9),
    "waveform_rows_even": lambda m: m.render_waveform_rows(-WAVE, 33, 6),
    "waveform_rows_one": lambda m: m.render_waveform_rows(WAVE, 40, 1),
    "waveform_rows_empty": lambda m: m.render_waveform_rows(
        np.zeros(0), 10, 0),
    "attention": lambda m: m.render_attention_heatmap(ATTN, 30, 5),
    "attention_bad": lambda m: m.render_attention_heatmap(np.zeros(3)),
    "encoder_table": lambda m: m.render_encoder_table(_layers(m), 68, 12),
    "encoder_table_short": lambda m: m.render_encoder_table(
        _layers(m, 3), 30),
    "encoder_table_empty": lambda m: m.render_encoder_table([]),
    "token_table": lambda m: m.render_token_table(_tokens(m), 68, 10),
    "token_table_empty": lambda m: m.render_token_table([]),
    "metrics": lambda m: m.render_metrics_rows(_timings(m), 68, "tiny",
                                               "int8"),
    "metrics_zero": lambda m: m.render_metrics_rows(m.StageTimings()),
    "help": lambda m: m.render_help_rows(40),
    "tabs": lambda m: [m.render_tabs(p, w) for p in m.Panel
                       for w in (72, 30)],
    "status": lambda m: [m.render_status(s, "msg " * 30, 50)
                         for s in m.PipelineState],
    "titles_keys": lambda m: (m.Panel.titles(), [
        m.Panel.from_key(ord(c)) and m.Panel.from_key(ord(c)).value
        for c in "0123456789?x"]),
    "timings": lambda m: (_timings(m).tokens_per_s, _timings(m).rtf,
                          m.StageTimings().tokens_per_s,
                          m.StageTimings().rtf),
}


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_renderer_equals_jax(name):
    assert RENDERS[name](ttui) == RENDERS[name](jtui)


def _app(m, state, panel):
    app = m.TuiApp(model_name="tiny", quant="f32")
    app.load_audio(WAVE)
    app.mel = MEL
    app.encoder_metrics = _layers(m, 6)
    app.tokens = _tokens(m, 5)
    app.attention = ATTN
    app.text = "the quick brown fox " * 8
    app.timings = _timings(m)
    app.state = state
    app.panel = panel
    if state == m.PipelineState.ERROR:
        app.fail("kernel exploded")
    return app


@pytest.mark.parametrize("state", ["idle", "decoding", "complete", "error"])
def test_app_frames_equal_jax(monkeypatch, state):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    for p in jtui.Panel:
        j = _app(jtui, jtui.PipelineState(state), jtui.Panel(p.value))
        t = _app(ttui, ttui.PipelineState(state), ttui.Panel(p.value))
        for w, h in ((72, 24), (100, 40), (40, 10)):
            assert t.frame(w, h) == j.frame(w, h), (p, w, h)


def test_app_keys_and_reset_equal_jax(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    keys = [ord(c) for c in "3l\th?5"] + [353, 27, ord("q"), ord("z")]
    j = _app(jtui, jtui.PipelineState.COMPLETE, jtui.Panel.WAVEFORM)
    t = _app(ttui, ttui.PipelineState.COMPLETE, ttui.Panel.WAVEFORM)
    for k in keys:
        assert t.handle_key(k) == j.handle_key(k)
        assert t.panel.value == j.panel.value
        assert t.frame() == j.frame()
    j.reset()
    t.reset()
    assert t.frame() == j.frame()
    assert t.timings == ttui.StageTimings(audio_s=j.timings.audio_s,
                                          max_tokens=j.timings.max_tokens)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("tui") / "m.apr"))


@pytest.fixture(scope="module")
def engines(model):
    args = dict(model=model, fp32=True, flash_attn=False, verbose=False)
    return (jcommands._load_engine(argparse.Namespace(**args)),
            tcommands._load_engine(argparse.Namespace(**args,
                                                      device="cpu")))


@pytest.mark.parametrize("max_tokens", [6, 14])
def test_live_decode_tokens_equal_jax(engines, max_tokens):
    audio = speech_like(1.0, seed=0)
    seen = []
    for m, eng, Sup in ((jtui, engines[0], JSuppressor),
                        (ttui, engines[1], TSuppressor)):
        enc = eng.encode(eng.compute_mel(audio))
        prompt = eng.get_initial_tokens("en")
        bias = np.asarray(Sup(n_vocab=eng.config.n_vocab,
                              tokens=eng.specials).bias())
        grown, steps = [], []
        gen = m.live_decode(eng, enc, prompt, bias, max_tokens,
                            lambda g: grown.append(list(g)),
                            on_step=lambda tok, lp: steps.append((tok, lp)))
        seen.append((gen, grown, steps))
    (jgen, jgrown, jsteps), (tgen, tgrown, tsteps) = seen
    assert tgen == jgen and tgrown == jgrown
    assert len(tgen) == max_tokens - 4       # no EOT in this decode
    assert [s[0] for s in tsteps] == [s[0] for s in jsteps]
    np.testing.assert_allclose([s[1] for s in tsteps],
                               [s[1] for s in jsteps], rtol=0, atol=1e-4)


def _stub_curses(keys):
    lines = []

    class StubScreen:
        def nodelay(self, *_):
            pass

        def erase(self):
            pass

        def getmaxyx(self):
            return (40, 100)

        def addnstr(self, y, x, s, n):
            lines.append(s)

        def refresh(self):
            pass

        def getch(self):
            return keys.pop(0) if keys else ord("q")

    class StubCurses:
        error = Exception

        @staticmethod
        def wrapper(fn):
            return fn(StubScreen())

        @staticmethod
        def curs_set(*_):
            pass

    return StubCurses, lines


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tui") / "c.wav")
    write_wav(path, speech_like(1.0, seed=0), 16_000)
    return path


def test_run_tui_equals_jax_with_curses_faked(model, clip, monkeypatch):
    """The keys of test_tui_panels' run: '3' during the live decode shows
    the encoder panel, '5' after it the attention panel; both sides
    decode the same tokens and show the same panels."""
    runs = []
    for m, extra in ((jtui, {}), (ttui, {"device": "cpu"})):
        stub, lines = _stub_curses([-1, -1, ord("3")] + [-1] * 20
                                   + [ord("5")])
        monkeypatch.setitem(sys.modules, "curses", stub)
        real = m.live_decode
        decoded = []

        def spy(*a, real=real, decoded=decoded, **k):
            decoded.append(real(*a, **k))
            return decoded[-1]
        monkeypatch.setattr(m, "live_decode", spy)
        args = argparse.Namespace(model=model, audio=clip, language="en",
                                  max_tokens=12, verbose=False, fp32=True,
                                  **extra)
        assert m.run_tui(args) == 0
        runs.append((decoded, "\n".join(lines)))
    (jdec, jtext), (tdec, ttext) = runs
    assert tdec == jdec and len(tdec) == 1 and tdec[0]
    for want in ("attn entropy", "tokens (rows) x audio frames",
                 "complete", "x decoding"):
        assert want in ttext and want in jtext


def test_run_tui_error_path_and_rerun(model, clip, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("kernel exploded")
    monkeypatch.setattr(ttui, "live_decode", boom)
    stub, lines = _stub_curses([-1, -1, -1, -1, ord("r")] + [-1] * 4)
    monkeypatch.setitem(sys.modules, "curses", stub)
    args = argparse.Namespace(model=model, audio=clip, language="en",
                              max_tokens=4, verbose=False, device="cpu")
    assert ttui.run_tui(args) == 0
    assert "\n".join(lines).count("kernel exploded") >= 2
