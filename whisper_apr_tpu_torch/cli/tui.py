"""Terminal dashboard for transcription: port of
``whisper_apr_tpu/cli/tui.py``. The renderers and ``TuiApp`` are copies;
``live_decode`` and ``run_tui``'s traced panels run the port's
``model/decoder`` and ``model/traced`` on the engine's device.

(reference: src/tui/ — ratatui dashboard with the pipeline state machine
Idle -> Mel -> Encode -> Decode -> Complete at app.rs:76, panels and
waveform/mel ASCII visualization at visualization.rs:13,51, live per-stage
state during a real run at app.rs:152.)

Pure-stdlib curses. Rendering helpers are pure string functions so they
are testable headless; the curses loop is a thin shell around them. The
decode stage streams LIVE: a host-stepped greedy loop emits one token per
device step and the dashboard redraws with the growing transcript, the
token rate, and per-stage timings.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, List, Optional

import numpy as np


class PipelineState(enum.Enum):
    """(reference: src/tui/app.rs:76)"""

    IDLE = "idle"
    MEL = "computing mel"
    ENCODE = "encoding"
    DECODE = "decoding"
    COMPLETE = "complete"
    ERROR = "error"


@dataclasses.dataclass
class StageTimings:
    """Per-stage wall times, filled as the pipeline advances
    (reference: the per-stage state panel, app.rs:152)."""

    mel_s: float = 0.0
    encode_s: float = 0.0
    decode_s: float = 0.0
    tokens: int = 0
    max_tokens: int = 0
    audio_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.decode_s if self.decode_s > 0 else 0.0

    @property
    def rtf(self) -> float:
        total = self.mel_s + self.encode_s + self.decode_s
        return total / self.audio_s if self.audio_s > 0 else 0.0


# -- pure visualization helpers (reference: src/tui/visualization.rs) --------

_BLOCKS = " ▁▂▃▄▅▆▇█"


def render_waveform(audio: np.ndarray, width: int = 60) -> str:
    """Audio -> one-line block-character waveform (visualization.rs:13)."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.size == 0:
        return " " * width
    n = audio.size // width if audio.size >= width else 1
    chunks = [audio[i * n:(i + 1) * n] for i in range(min(width, audio.size))]
    peaks = np.array([np.abs(c).max() if len(c) else 0.0 for c in chunks])
    top = peaks.max() or 1.0
    out = "".join(_BLOCKS[int(p / top * (len(_BLOCKS) - 1))] for p in peaks)
    return out.ljust(width)


def render_mel(mel: np.ndarray, width: int = 60, height: int = 8) -> List[str]:
    """[T, n_mels] log-mel -> ASCII heat rows (visualization.rs:51)."""
    mel = np.asarray(mel, dtype=np.float32)
    if mel.ndim != 2 or mel.size == 0:
        return [" " * width] * height
    T, M = mel.shape
    t_idx = np.linspace(0, T - 1, width).astype(int)
    m_idx = np.linspace(0, M - 1, height).astype(int)
    grid = mel[np.ix_(t_idx, m_idx)]
    lo, hi = float(grid.min()), float(grid.max())
    span = (hi - lo) or 1.0
    rows = []
    for m in reversed(range(height)):  # high mel bands on top
        row = "".join(
            _BLOCKS[int((grid[t, m] - lo) / span * (len(_BLOCKS) - 1))]
            for t in range(width))
        rows.append(row)
    return rows


def render_progress(fraction: float, width: int = 40) -> str:
    done = int(max(0.0, min(1.0, fraction)) * width)
    return "[" + "#" * done + "-" * (width - done) + f"] {100 * fraction:3.0f}%"


def render_stage_panel(state: PipelineState, t: StageTimings,
                       width: int = 68) -> List[str]:
    """Per-stage status rows: a check, a spinner marker, or a dash.

    (reference: the stage list panel, app.rs:152-230)"""
    order = [PipelineState.MEL, PipelineState.ENCODE, PipelineState.DECODE]
    cur = order.index(state) if state in order else (
        len(order) if state in (PipelineState.COMPLETE,
                                PipelineState.ERROR) else -1)
    rows = []
    vals = {PipelineState.MEL: f"{t.mel_s * 1e3:7.1f} ms",
            PipelineState.ENCODE: f"{t.encode_s * 1e3:7.1f} ms",
            PipelineState.DECODE:
                f"{t.decode_s * 1e3:7.1f} ms  {t.tokens:4d} tok  "
                f"{t.tokens_per_s:6.1f} tok/s"}
    for n, st in enumerate(order):
        mark = "x" if n < cur else (">" if n == cur else "-")
        rows.append(f"  {mark} {st.value:<14} {vals[st]}"[:width])
    if state == PipelineState.DECODE and t.max_tokens:
        rows.append("    " + render_progress(
            t.tokens / t.max_tokens, min(40, width - 12)))
    if state == PipelineState.COMPLETE:
        rows.append(f"    RTF {t.rtf:7.4f}  "
                    f"({1.0 / t.rtf if t.rtf else 0:5.0f}x realtime)")
    return rows


def render_dashboard(state: PipelineState, audio: Optional[np.ndarray],
                     mel: Optional[np.ndarray], text: str,
                     elapsed: float, width: int = 72,
                     timings: Optional[StageTimings] = None) -> List[str]:
    """Full frame as text lines (panel layout, reference: src/tui/app.rs)."""
    lines = []
    lines.append("=" * width)
    lines.append(f" whisper-apr-tpu   state: {state.value:<16} "
                 f"elapsed: {elapsed:6.2f}s")
    lines.append("=" * width)
    lines.append(" pipeline")
    for row in render_stage_panel(state, timings or StageTimings(),
                                  width - 2):
        lines.append(row)
    lines.append("-" * width)
    lines.append(" waveform")
    lines.append("  " + (render_waveform(audio, width - 4)
                         if audio is not None else " " * (width - 4)))
    lines.append(" mel spectrogram")
    for row in (render_mel(mel, width - 4, 6) if mel is not None
                else [" " * (width - 4)] * 6):
        lines.append("  " + row)
    lines.append("-" * width)
    lines.append(" transcript")
    body = text if text else "(pending)"
    for i in range(0, max(len(body), 1), width - 4):
        lines.append("  " + body[i: i + width - 4])
    lines.append("=" * width)
    return lines


def live_decode(engine, enc, prompt_list: List[int], bias_np: np.ndarray,
                max_tokens: int,
                on_token: Callable[[List[int]], None],
                on_step: Optional[Callable[[int, float], None]] = None
                ) -> List[int]:
    """Host-stepped greedy decode emitting each token as it lands.

    The fused on-device loop cannot surface per-token progress; this loop
    (the hotword-path pattern, engine._transcribe_hotwords) trades ~one
    dispatch per token for a live view. Returns generated tokens (no
    prompt, no EOT). ``on_step`` (optional) additionally receives each
    ``(token_id, log_prob)`` pair — the data the decoder panel tabulates
    (reference: src/tui/app.rs:109 DecoderToken). ``enc`` is the
    engine's encoder output [1, S, D] on its device; each step's logits
    come to the host."""
    import torch

    from ..model.decoder import decode_step, init_cache, prefill

    cache = init_cache(engine.params, enc, engine.config, max_tokens,
                       compute_dtype=engine._compute_dtype)
    prompt = torch.tensor([prompt_list], dtype=torch.int64,
                          device=engine.device)
    logits, cache = prefill(engine.params, prompt, enc, cache, engine.config,
                            compute_dtype=engine._compute_dtype)
    eot = engine.specials.eot
    gen: List[int] = []
    pos = len(prompt_list)
    logits_np = logits.float().cpu().numpy()
    while pos < max_tokens:
        biased = logits_np[0] + bias_np
        tok = int(np.argmax(biased))
        if tok == eot:
            break
        gen.append(tok)
        if on_step is not None:
            # greedy log-prob of the chosen token under the biased dist
            m = biased.max()
            logp = float(biased[tok] - m
                         - np.log(np.exp(biased - m).sum()))
            on_step(tok, logp)
        on_token(gen)
        if pos + 1 >= max_tokens:
            break
        logits, cache = decode_step(
            engine.params, torch.tensor([tok], device=engine.device), pos,
            cache, engine.config, compute_dtype=engine._compute_dtype)
        logits_np = logits.float().cpu().numpy()
        pos += 1
    return gen


# -- panel system (reference: src/tui/app.rs:10 WhisperPanel, panels.rs) -----

class Panel(enum.Enum):
    """Active dashboard panel (reference: src/tui/app.rs:10)."""

    WAVEFORM = 0
    MEL = 1
    ENCODER = 2
    DECODER = 3
    ATTENTION = 4
    TRANSCRIPT = 5
    METRICS = 6
    HELP = 7

    @staticmethod
    def titles() -> List[str]:
        """Tab-bar titles (reference: app.rs:32)."""
        return ["Waveform [1]", "Mel [2]", "Encoder [3]", "Decoder [4]",
                "Attention [5]", "Transcript [6]", "Metrics [7]", "Help [?]"]

    @staticmethod
    def from_key(ch: int) -> Optional["Panel"]:
        """Key -> panel: digits 1-7 plus '?' (reference: app.rs:228)."""
        if ord("1") <= ch <= ord("7"):
            return Panel(ch - ord("1"))
        if ch == ord("?"):
            return Panel.HELP
        return None


@dataclasses.dataclass
class EncoderLayerMetrics:
    """Per-layer encoder panel row (reference: src/tui/app.rs:96)."""

    layer: int
    mean_activation: float
    max_activation: float
    attention_entropy: float


@dataclasses.dataclass
class DecoderToken:
    """Per-token decoder panel row (reference: src/tui/app.rs:109)."""

    id: int
    text: str
    log_prob: float


def _heat_rows(grid: np.ndarray, width: int, height: int) -> List[str]:
    """Downsample a 2-D [rows, cols]-oriented array to block-char rows."""
    if grid.ndim != 2 or grid.size == 0:
        return [" " * width] * height
    R, C = grid.shape
    r_idx = np.linspace(0, R - 1, height).astype(int)
    c_idx = np.linspace(0, C - 1, width).astype(int)
    g = grid[np.ix_(r_idx, c_idx)].astype(np.float64)
    lo, hi = float(g.min()), float(g.max())
    span = (hi - lo) or 1.0
    return ["".join(_BLOCKS[int((g[r, c] - lo) / span * (len(_BLOCKS) - 1))]
                    for c in range(width)) for r in range(height)]


def render_waveform_rows(audio: np.ndarray, width: int,
                         height: int) -> List[str]:
    """Multi-row centered waveform: per-column +/- peaks drawn about a
    midline (reference: visualization.rs:95 render_waveform, which is
    also height-aware)."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.size == 0 or height < 1:
        return [" " * width] * max(height, 1)
    if height == 1:
        return [render_waveform(audio, width)]
    n = max(1, audio.size // width)
    hi = np.zeros(width)
    lo = np.zeros(width)
    for c in range(width):
        chunk = audio[c * n:(c + 1) * n]
        if len(chunk):
            hi[c] = max(chunk.max(), 0.0)
            lo[c] = min(chunk.min(), 0.0)
    peak = max(hi.max(), -lo.min()) or 1.0
    mid = height // 2
    up_rows = mid                      # rows above the midline
    dn_rows = height - mid - 1         # rows below
    grid = [[" "] * width for _ in range(height)]
    for c in range(width):
        u = int(round(hi[c] / peak * up_rows))
        d = int(round(-lo[c] / peak * dn_rows))
        grid[mid][c] = "-"
        for r in range(1, u + 1):
            grid[mid - r][c] = "█" if r < u else "▄"
        for r in range(1, d + 1):
            grid[mid + r][c] = "█" if r < d else "▀"
    return ["".join(row) for row in grid]


def render_attention_heatmap(weights: np.ndarray, width: int = 60,
                             height: int = 10) -> List[str]:
    """[T_text, T_audio] cross-attention -> heat rows
    (reference: visualization.rs:227 render_attention_heatmap)."""
    return _heat_rows(np.asarray(weights, np.float32), width, height)


def render_encoder_table(metrics: List[EncoderLayerMetrics],
                         width: int = 68, max_rows: int = 12) -> List[str]:
    """Encoder panel table (reference: panels.rs:131 render_encoder_panel)."""
    if not metrics:
        return ["  (encoder not run yet)"]
    rows = [f"  {'layer':>5}  {'mean|act|':>10}  {'max|act|':>10}  "
            f"{'attn entropy':>12}"]
    shown = metrics if len(metrics) <= max_rows else (
        metrics[: max_rows - 1] + [metrics[-1]])
    last = None
    for m in shown:
        if last is not None and m.layer != last + 1:
            rows.append("   ...")
        rows.append(f"  {m.layer:>5}  {m.mean_activation:>10.4f}  "
                    f"{m.max_activation:>10.4f}  "
                    f"{m.attention_entropy:>12.4f}"[:width])
        last = m.layer
    return rows


def render_token_table(tokens: List[DecoderToken], width: int = 68,
                       max_rows: int = 12) -> List[str]:
    """Decoder panel: latest tokens with log-probs + confidence bars
    (reference: panels.rs render_decoder_panel)."""
    if not tokens:
        return ["  (no tokens yet)"]
    rows = [f"  {'#':>4}  {'id':>6}  {'log p':>7}  conf       text"]
    base = max(0, len(tokens) - max_rows)
    for n, tok in enumerate(tokens[-max_rows:], start=base):
        conf = float(np.exp(min(tok.log_prob, 0.0)))
        bar = "#" * int(conf * 8)
        text = tok.text.replace("\n", "\\n")
        rows.append(f"  {n:>4}  {tok.id:>6}  {tok.log_prob:>7.2f}  "
                    f"{bar:<8}  {text}"[:width])
    return rows


def render_metrics_rows(t: StageTimings, width: int = 68,
                        model: str = "", quant: str = "") -> List[str]:
    """Metrics panel (reference: panels.rs render_metrics_panel,
    app.rs:122 PipelineMetrics)."""
    total = t.mel_s + t.encode_s + t.decode_s
    rows = [
        f"  model           {model}  {quant}",
        f"  audio           {t.audio_s:8.2f} s",
        f"  mel             {t.mel_s * 1e3:8.1f} ms",
        f"  encode          {t.encode_s * 1e3:8.1f} ms",
        f"  decode          {t.decode_s * 1e3:8.1f} ms"
        f"   ({t.tokens} tok, {t.tokens_per_s:.1f} tok/s)",
        f"  total           {total * 1e3:8.1f} ms",
        f"  RTF             {t.rtf:8.4f}"
        + (f"   ({1.0 / t.rtf:.0f}x realtime)" if t.rtf else ""),
    ]
    return [r[:width] for r in rows]


def render_help_rows(width: int = 68) -> List[str]:
    """Help panel (reference: panels.rs render_help_panel)."""
    return [r[:width] for r in [
        "  keys",
        "    1-7      switch panel (waveform/mel/encoder/decoder/",
        "             attention/transcript/metrics)",
        "    ?        this help",
        "    tab / l  next panel        shift-tab / h  previous panel",
        "    r        re-run the decode (after completion)",
        "    q / ESC  quit",
        "",
        "  the decode panel streams live; attention fills in after the",
        "  decode completes (one traced forward over the final tokens).",
    ]]


def render_tabs(active: Panel, width: int = 72) -> str:
    """Tab bar with the active panel highlighted
    (reference: panels.rs:37 render_tabs)."""
    parts = []
    for p, title in zip(Panel, Panel.titles()):
        parts.append(f"[{title[:-4].strip()}]" if p == active
                     else f" {title[:-4].strip()} ")
    return "|".join(parts)[:width]


def render_status(state: PipelineState, msg: str, width: int = 72) -> str:
    """Status bar (reference: panels.rs:33 render_status_bar)."""
    return f" {state.value:<16} {msg}"[:width].ljust(width)


class TuiApp:
    """Dashboard state: pipeline data + active panel + key handling.

    (reference: src/tui/app.rs:152 WhisperApp — the state machine the
    panels render from; pure so every frame is testable headless.)
    """

    def __init__(self, model_name: str = "", quant: str = "") -> None:
        self.panel = Panel.WAVEFORM
        self.state = PipelineState.IDLE
        self.model_name = model_name
        self.quant = quant
        self.audio: Optional[np.ndarray] = None
        self.mel: Optional[np.ndarray] = None
        self.encoder_metrics: List[EncoderLayerMetrics] = []
        self.tokens: List[DecoderToken] = []
        self.attention: Optional[np.ndarray] = None  # [T_text, T_audio]
        self.text = ""
        self.timings = StageTimings()
        self.error = ""
        self.t0 = time.time()

    # -- state transitions (reference: app.rs:267-441) -----------------------
    def load_audio(self, audio: np.ndarray) -> None:
        self.audio = audio
        self.timings.audio_s = len(audio) / 16_000.0
        self.state = PipelineState.IDLE

    def reset(self) -> None:
        """(reference: app.rs:247)"""
        self.mel = None
        self.encoder_metrics = []
        self.tokens = []
        self.attention = None
        self.text = ""
        self.timings = StageTimings(audio_s=self.timings.audio_s,
                                    max_tokens=self.timings.max_tokens)
        self.state = PipelineState.IDLE
        self.error = ""
        self.t0 = time.time()

    def fail(self, msg: str) -> None:
        self.state = PipelineState.ERROR
        self.error = msg

    # -- keys (reference: app.rs:228 handle_key) -----------------------------
    def handle_key(self, ch: int) -> bool:
        """Returns True when the key quits the app."""
        if ch in (ord("q"), 27):
            return True
        p = Panel.from_key(ch)
        if p is not None:
            self.panel = p
        elif ch in (ord("\t"), ord("l")):
            self.panel = Panel((self.panel.value + 1) % len(Panel))
        elif ch in (353, ord("h")):  # shift-tab / vi-left
            self.panel = Panel((self.panel.value - 1) % len(Panel))
        return False

    # -- frame ---------------------------------------------------------------
    def frame(self, width: int = 72, height: int = 24) -> List[str]:
        """Full dashboard frame: tabs / stage strip / panel / status."""
        lines = [render_tabs(self.panel, width), "=" * width]
        for row in render_stage_panel(
                self.state, self.timings, width - 2):
            lines.append(row)
        lines.append("-" * width)
        body_h = max(4, height - len(lines) - 2)
        lines += self._panel_body(width, body_h)[:body_h]
        lines.append("-" * width)
        msg = self.error if self.state == PipelineState.ERROR else \
            f"elapsed {time.time() - self.t0:6.2f}s   [1-7] panels  " \
            f"[?] help  [q] quit"
        lines.append(render_status(self.state, msg, width))
        return lines

    def _panel_body(self, width: int, height: int) -> List[str]:
        w = width - 4
        if self.panel == Panel.WAVEFORM:
            if self.audio is None:
                return ["  (no audio loaded)"]
            return ["  " + r for r in
                    render_waveform_rows(self.audio, w, height)]
        if self.panel == Panel.MEL:
            if self.mel is None:
                return ["  (mel not computed yet)"]
            return ["  " + r for r in render_mel(self.mel, w, height)]
        if self.panel == Panel.ENCODER:
            return render_encoder_table(self.encoder_metrics, width,
                                        max_rows=height)
        if self.panel == Panel.DECODER:
            return render_token_table(self.tokens, width,
                                      max_rows=height - 1)
        if self.panel == Panel.ATTENTION:
            if self.attention is None:
                return ["  (attention fills in after the decode: one",
                        "   traced forward over the final tokens)"]
            return ["  tokens (rows) x audio frames (cols)"] + \
                ["  " + r for r in render_attention_heatmap(
                    self.attention, w, height - 1)]
        if self.panel == Panel.TRANSCRIPT:
            body = self.text or "(pending)"
            out = []
            for i in range(0, max(len(body), 1), w):
                out.append("  " + body[i: i + w])
            return out
        if self.panel == Panel.METRICS:
            return render_metrics_rows(self.timings, width,
                                       self.model_name, self.quant)
        return render_help_rows(width)


# -- curses app ---------------------------------------------------------------

def run_tui(args) -> int:
    """Interactive transcription dashboard: live decode + switchable
    panels (waveform/mel/encoder/decoder/attention/transcript/metrics;
    reference: src/tui/ — app.rs state machine, panels.rs layout)."""
    import curses

    import torch

    from ..inference.processors import WhisperTokenSuppressor
    from .commands import _load_audio, _load_engine

    engine = _load_engine(args)
    audio = _load_audio(args.audio)
    max_tokens = min(getattr(args, "max_tokens", None)
                     or engine.config.n_text_ctx, engine.config.n_text_ctx)

    app = TuiApp(model_name=engine.config.model_type,
                 quant=getattr(engine, "quant_mode", "") or "f32")
    app.load_audio(audio)
    app.timings.max_tokens = max_tokens

    def main(stdscr):
        curses.curs_set(0)
        stdscr.nodelay(True)

        def draw():
            # panel keys are live even mid-pipeline; 'q' only quits from
            # the final wait loop (the decode is not abortable mid-step)
            ch = stdscr.getch()
            if ch != -1:
                p = Panel.from_key(ch)
                if p is not None:
                    app.panel = p
            stdscr.erase()
            maxy, maxx = stdscr.getmaxyx()
            for i, line in enumerate(
                    app.frame(min(maxx - 1, 100), maxy - 1)[: maxy - 1]):
                stdscr.addnstr(i, 0, line, maxx - 1)
            stdscr.refresh()

        def run_pipeline():
            t = app.timings
            app.state = PipelineState.MEL
            draw()
            t0 = time.time()
            app.mel = engine.compute_mel(audio)
            t.mel_s = time.time() - t0
            app.state = PipelineState.ENCODE
            draw()
            t0 = time.time()
            enc = engine.encode(app.mel)
            t.encode_s = time.time() - t0
            # per-layer metrics: one extra traced forward (debug data the
            # encoder panel tabulates; skipped silently on failure)
            try:
                from ..model.traced import encoder_forward_traced
                _, ms = encoder_forward_traced(
                    engine.params,
                    torch.as_tensor(app.mel, device=engine.device)[None],
                    engine.config)
                app.encoder_metrics = [EncoderLayerMetrics(**m) for m in ms]
            except Exception:
                app.encoder_metrics = []
            app.state = PipelineState.DECODE
            draw()

            lang = getattr(args, "language", None) or "en"
            prompt_list = engine.get_initial_tokens(lang)
            bias = WhisperTokenSuppressor(
                n_vocab=engine.config.n_vocab,
                tokens=engine.specials).bias()
            t0 = time.time()

            def on_step(tok, logp):
                text = (engine.tokenizer.decode_with_options(
                    [tok], skip_special=True) if engine.tokenizer else "")
                app.tokens.append(DecoderToken(tok, text, logp))

            def on_token(gen):
                t.tokens = len(gen)
                t.decode_s = time.time() - t0
                app.text = engine.tokenizer.decode_with_options(
                    gen, skip_special=True) if engine.tokenizer else ""
                draw()

            gen = live_decode(engine, enc, prompt_list, np.asarray(bias),
                              max_tokens, on_token, on_step=on_step)
            t.decode_s = time.time() - t0
            t.tokens = len(gen)
            # post-hoc cross-attention (averaged over layers+heads) for
            # the attention panel (reference captures it during decode)
            if gen:
                try:
                    from ..model.traced import decoder_forward_traced
                    toks = torch.tensor([prompt_list + gen],
                                        device=engine.device)
                    _, _, wts = decoder_forward_traced(
                        engine.params, toks, enc, engine.config)
                    w = wts.float().mean(dim=(0, 1, 2)).cpu().numpy()
                    app.attention = w[len(prompt_list):]
                except Exception:
                    app.attention = None
            app.state = PipelineState.COMPLETE
            draw()

        try:
            run_pipeline()
        except Exception as e:  # surface, don't crash the terminal
            app.fail(str(e)[:200])
            draw()
        while True:
            ch = stdscr.getch()
            if ch == ord("r") and app.state in (PipelineState.COMPLETE,
                                                PipelineState.ERROR):
                app.reset()
                try:
                    run_pipeline()
                except Exception as e:
                    app.fail(str(e)[:200])
                    draw()
                continue
            if ch != -1 and app.handle_key(ch):
                return
            if ch != -1:
                draw()
            time.sleep(0.05)

    curses.wrapper(main)
    return 0
