"""The port's CLI (``whisper_apr_tpu_torch.cli``) against the JAX
package's (``whisper_apr_tpu.cli``) on the CPU.

Both run through their ``run`` entry on one f32 ``.apr`` written here: a
small-width random-init transformers Whisper with every matrix drawn
again at std 0.2 (so that decodes follow the audio), the full 51865-token
vocabulary of " w<id>" words and the slaney filterbank. Clips are made
from numpy seeds. The port side adds ``--device cpu`` (the plain
versions). Parsed arguments, formatter output and stdout must be equal
(less the numbers that are wall times); written files byte-equal.
"""

import ast
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import make_hf_twin, small_config
from whisper_apr_tpu import cli as jcli
from whisper_apr_tpu.alignment import WordTimestamp as JWord
from whisper_apr_tpu.cli.args import build_parser as j_build_parser
from whisper_apr_tpu.cli.args import expand_response_files as j_expand
from whisper_apr_tpu.cli.output import format_result as j_format
from whisper_apr_tpu.cli.parity import ParityResult as JParity
from whisper_apr_tpu.cli.parity import calculate_wer as j_wer
from whisper_apr_tpu.cli.parity import levenshtein as j_lev
from whisper_apr_tpu.engine import TranscriptionResult as JResult
from whisper_apr_tpu.timestamps import Segment as JSegment
from whisper_apr_tpu_torch import cli as tcli
from whisper_apr_tpu_torch.alignment import WordTimestamp as TWord
from whisper_apr_tpu_torch.audio.mel import mel_filterbank
from whisper_apr_tpu_torch.audio.wav import write_wav
from whisper_apr_tpu_torch.cli.args import build_parser as t_build_parser
from whisper_apr_tpu_torch.cli.args import expand_response_files as t_expand
from whisper_apr_tpu_torch.cli.output import FORMATS
from whisper_apr_tpu_torch.cli.output import format_result as t_format
from whisper_apr_tpu_torch.cli.parity import ParityResult as TParity
from whisper_apr_tpu_torch.cli.parity import calculate_wer as t_wer
from whisper_apr_tpu_torch.cli.parity import levenshtein as t_lev
from whisper_apr_tpu_torch.config import ModelConfig as TModelConfig
from whisper_apr_tpu_torch.engine import TranscriptionResult as TResult
from whisper_apr_tpu_torch.format import AprWriter, MelFilterbankData
from whisper_apr_tpu_torch.model.params import hf_state_dict_to_apr_tensors
from whisper_apr_tpu_torch.timestamps import Segment as TSegment
from whisper_apr_tpu_torch.tokenizer import Vocabulary

REPO = Path(__file__).resolve().parent.parent
SR = 16_000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- shared helpers (also used by test_torch_serve, _tui and _tools) --------

def write_model(path: str, seed: int = 1) -> str:
    """The f32 .apr both CLIs load: see the module docstring."""
    cfg = small_config(n_vocab=51_865)
    hf = make_hf_twin(cfg, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in hf.parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    w = AprWriter.from_config(TModelConfig(**dataclasses.asdict(cfg)))
    for name, arr in hf_state_dict_to_apr_tensors(hf.state_dict()).items():
        w.add_tensor(name, arr)
    vocab = Vocabulary.with_base_tokens()
    while len(vocab) < cfg.n_vocab:
        vocab.add_token(b" w%d" % len(vocab))
    w.set_vocabulary(vocab.to_bytes())
    w.set_mel_filterbank(MelFilterbankData(80, 201, mel_filterbank(80)))
    w.write_file(path)
    return path


def speech_like(seconds: float, seed: int = 0, sr: int = SR,
                freq: float = 220.0) -> np.ndarray:
    """A loud tone with a slow vibrato and noise (VAD-positive)."""
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    return (0.5 * np.sin(2 * np.pi * freq * t * (1 + 0.3 * np.sin(t)))
            + 0.1 * rng.normal(size=t.size)).astype(np.float32)


def bursts(seed: int = 0) -> np.ndarray:
    """2 s speech, 1 s near-silence, 2 s speech, 1 s near-silence."""
    rng = np.random.default_rng(seed)
    quiet = lambda s: (1e-4 * rng.normal(size=int(s * SR))).astype(np.float32)
    return np.concatenate([speech_like(2, seed), quiet(1),
                           speech_like(2, seed + 1, freq=330), quiet(1)])


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return write_model(str(tmp_path_factory.mktemp("cli") / "m.apr"))


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    out = {"one": speech_like(1.0, seed=0), "long": speech_like(2.5, seed=3),
           "burst": bursts(seed=5)}
    paths = {}
    for name, audio in out.items():
        paths[name] = str(d / f"{name}.wav")
        write_wav(paths[name], audio, SR)
    paths["44k"] = str(d / "44k.wav")
    write_wav(paths["44k"], speech_like(1.2, seed=7, sr=44_100), 44_100)
    return paths


def run_cli(run, argv, stdin: bytes = None, monkeypatch=None):
    """(exit code, stdout, stderr) of ``run(argv)``; ``stdin`` pipes raw
    bytes in."""
    out, err = io.StringIO(), io.StringIO()
    if stdin is not None:
        class Pipe(io.TextIOWrapper):
            def isatty(self):
                return False
        monkeypatch.setattr(sys, "stdin", Pipe(io.BytesIO(stdin)))
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run(argv)
    return rc, out.getvalue(), err.getvalue()


def both(argv, stdin: bytes = None, monkeypatch=None):
    """The JAX CLI's and the port's (``--device cpu``) results."""
    j = run_cli(jcli.run, argv, stdin, monkeypatch)
    t = run_cli(tcli.run, argv + ["--device", "cpu"], stdin, monkeypatch)
    return j, t


def same(argv, mask=None, stdin=None, monkeypatch=None):
    """Both CLIs exit alike and print the same stdout (``mask`` blanks
    what is a wall time); returns the port's stdout."""
    (jrc, jout, jerr), (trc, tout, terr) = both(argv, stdin, monkeypatch)
    assert trc == jrc, (jerr, terr)
    if mask is not None:
        jout, tout = re.sub(mask, "#", jout), re.sub(mask, "#", tout)
    assert tout == jout
    return tout


# -- arguments ----------------------------------------------------------------

ARGV = [
    ["transcribe", "a.wav", "-m", "m.apr"],
    ["translate", "a.wav", "-m", "m.apr", "--beam-size", "5"],
    ["transcribe", "a.wav", "-m", "m.apr", "-l", "de", "-bs", "8",
     "--best-of", "3", "--temperature", "0.2", "--entropy-thold", "2.0",
     "--logprob-thold", "-0.5", "--no-speech-thold", "0.4", "--threads",
     "4", "--flash-attn", "--timestamps", "-of", "vtt", "--hotword",
     "hello:2", "--n-best", "3", "--no-fallback", "--speculative"],
    ["batch", "a.wav", "b.wav", "-m", "m.apr", "-of", "srt",
     "--processors", "2"],
    ["stream", "a.wav", "-m", "m.apr", "--chunk-seconds", "2"],
    ["detect-language", "a.wav", "-m", "m.apr", "--fp32"],
    ["model", "-m", "m.apr"],
    ["validate", "-m", "m.apr"],
    ["quantize", "-m", "m.apr", "-o", "out.apr", "-f", "q5k"],
    ["convert", "in_dir", "out.apr", "--int8", "--v2"],
    ["benchmark", "--duration", "10", "--emit", "json"],
    ["parity", "a.wav", "ref.txt", "-m", "m.apr"],
    ["diagnose"],
    ["test", "-m", "m.apr"],
    ["serve", "-m", "m.apr", "--port", "8123", "--slots", "4",
     "--single-thread", "--staged-admission"],
    ["tui", "a.wav", "-m", "m.apr"],
    ["record", "-m", "m.apr", "--sample-format", "s16le", "--rate",
     "8000", "--seconds", "3"],
    ["command", "a.wav", "cmds.txt", "-m", "m.apr", "--threshold", "0.3"],
]
# subcommands that load a model (or probe the device) take --device
DEVICE_CMDS = {"transcribe", "translate", "batch", "stream",
               "detect-language", "benchmark", "parity", "diagnose", "test",
               "serve", "tui", "record", "command"}


@pytest.mark.parametrize("argv", ARGV, ids=lambda a: a[0])
def test_namespace_equals_jax(argv):
    want = vars(j_build_parser().parse_args(argv))
    got = vars(t_build_parser().parse_args(argv))
    if argv[0] in DEVICE_CMDS:
        assert got.pop("device") == "cuda"
    else:
        assert "device" not in got
    assert got == want


def _subcommands(parser):
    return parser._subparsers._group_actions[0].choices


def test_subcommands_equal_jax():
    def names(parser):
        return sorted(_subcommands(parser))
    assert names(t_build_parser()) == names(j_build_parser())
    assert {a[0] for a in ARGV} == set(names(j_build_parser()))


def test_device_flag_parses():
    args = t_build_parser().parse_args(
        ["transcribe", "a.wav", "-m", "m.apr", "--device", "cpu"])
    assert args.device == "cpu"


def test_response_files_equal_jax(tmp_path):
    rf = tmp_path / "args.txt"
    rf.write_text("transcribe a.wav\n -m m.apr  -of srt")
    argv = [f"@{rf}", "--fp32", "@", f"@{tmp_path / 'missing.txt'}"]
    assert t_expand(argv) == j_expand(argv)
    assert t_expand(argv)[:6] == ["transcribe", "a.wav", "-m", "m.apr",
                                 "-of", "srt"]


def test_single_thread_help_gives_no_tpu_reason():
    text = _subcommands(t_build_parser())["serve"].format_help()
    assert "--single-thread" in text and "TPU" not in text
    assert "tunnel" not in text.lower()


# -- formatters ---------------------------------------------------------------

def _results(kind: str):
    """The same result in JAX's and the port's classes."""
    segs = [(0.0, 1.5, " hello, world", [1, 2]),
            (1.5, 3.2554, ' say "hi"', [3]),
            (3725.4449, 3726.0, " late | one", [4, 5, 6])]
    words = [(" hello", 0.0, 0.4, 0.9, [1]), (" world", 0.4, 1.49, 0.8, [2])]
    out = []
    for R, S, W in ((JResult, JSegment, JWord), (TResult, TSegment, TWord)):
        if kind == "segments":
            r = R("hello, world say \"hi\" late | one", "en",
                  [S(*s) for s in segs], [1, 2, 3, 4, 5, 6],
                  words=[W(*w) for w in words])
        elif kind == "no_words":
            r = R("hello", "de", [S(*segs[0])], [1, 2])
        else:   # no segments: the whole text as one span
            r = R("héllo wörld", "fr", [], [7, 8])
        out.append(r)
    return out


@pytest.mark.parametrize("kind", ["segments", "no_words", "empty"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_format_result_equals_jax(fmt, kind):
    j, t = _results(kind)
    assert t_format(t, fmt).encode() == j_format(j, fmt).encode()


def test_unknown_format_raises_like_jax():
    j, t = _results("segments")
    with pytest.raises(ValueError) as je:
        j_format(j, "xml")
    with pytest.raises(ValueError) as te:
        t_format(t, "xml")
    assert str(te.value) == str(je.value)


# -- WER / parity ----------------------------------------------------------------

PAIRS = [("hello world", "Hello, World!"), ("the cat sat", "the dog sat"),
         ("a b c", "a c"), ("a c", "a b c"), ("", ""), ("", "word"),
         ("don't stop-me now", "dont stop me now now"),
         ("one two three four five", "five four three two one")]


@pytest.mark.parametrize("ref,hyp", PAIRS)
def test_wer_and_levenshtein_equal_jax(ref, hyp):
    assert t_wer(ref, hyp) == j_wer(ref, hyp)
    assert t_lev(ref.split(), hyp.split()) == j_lev(ref.split(), hyp.split())
    assert t_lev(ref, hyp) == j_lev(ref, hyp)


def test_parity_summary_equals_jax():
    args = (0.25, 0.0123, 12.5, 0.15375, "text")
    assert TParity(*args).summary() == JParity(*args).summary()


# -- commands ------------------------------------------------------------------

DECODE = ["--fp32", "--no-fallback", "-l", "en"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_transcribe_stdout_equals_jax(model, wavs, fmt):
    out = same(["transcribe", wavs["one"], "-m", model, "-of", fmt]
               + DECODE)
    assert out.strip()


@pytest.mark.parametrize("extra", [
    ["--fp32", "--logprob-thold=-1e9", "--entropy-thold", "-1"],  # fallback
    ["--no-fallback", "-l", "en"],                                  # bf16
    DECODE + ["--timestamps", "-of", "json-full"],
    DECODE + ["--hotword", "w23097:3", "--max-tokens", "10", "-of",
              "json-full"],
    ["--fp32", "-l", "en", "--beam-size", "3", "--n-best", "2"],
    DECODE + ["--max-tokens", "9", "-of", "json-full"],
], ids=["fallback", "bf16", "timestamps", "hotword", "nbest", "max_tokens"])
def test_transcribe_options_equal_jax(model, wavs, extra):
    same(["transcribe", wavs["one"], "-m", model] + extra)


@pytest.mark.parametrize("clip", ["long", "44k"])
def test_transcribe_long_and_resampled_equal_jax(model, wavs, clip):
    out = same(["transcribe", wavs[clip], "-m", model, "-of", "srt"]
               + DECODE)
    assert out.count("-->") >= 1


def test_transcribe_to_file_verbose(model, wavs, tmp_path):
    argv = ["transcribe", wavs["one"], "-m", model, "-of", "vtt", "-v",
            *DECODE, "-o"]
    jrc, jout, jerr = run_cli(jcli.run, argv + [str(tmp_path / "j.vtt")])
    trc, tout, terr = run_cli(tcli.run, argv + [str(tmp_path / "t.vtt"),
                                                "--device", "cpu"])
    assert jrc == trc == 0 and jout == tout == ""
    assert (tmp_path / "t.vtt").read_bytes() == \
        (tmp_path / "j.vtt").read_bytes()
    # the load progress and the summary line, as JAX's, to stderr
    mask = lambda e: re.sub(r"rtf=[0-9.]+", "rtf=#", e)
    assert mask(terr) == mask(jerr)
    assert "[load] finalize" in terr and "rtf=" in terr


def test_translate_equals_jax(model, wavs):
    same(["translate", wavs["one"], "-m", model, "--fp32", "--no-fallback",
          "-l", "de", "-of", "json"])


def test_detect_language_equals_jax(model, wavs):
    out = same(["detect-language", wavs["one"], "-m", model, "--fp32"])
    assert len(out.splitlines()) == 5


def test_batch_equals_jax(model, wavs, tmp_path):
    outs = []
    for side in ("jax", "torch"):
        d = tmp_path / side
        d.mkdir()
        files = []
        for name in ("one", "long"):
            files.append(str(d / f"{name}.wav"))
            Path(files[-1]).write_bytes(Path(wavs[name]).read_bytes())
        argv = ["batch", *files, "-m", model, "-of", "json-full",
                "--processors", "1"] + DECODE
        rc, out, err = (run_cli(jcli.run, argv) if side == "jax" else
                        run_cli(tcli.run, argv + ["--device", "cpu"]))
        assert rc == 0, err
        out = re.sub(r"in [0-9.]+s", "in #s", out.replace(str(d), "D"))
        outs.append((out, [Path(f[:-4] + ".json").read_bytes()
                           for f in files]))
    assert outs[1] == outs[0]
    assert outs[1][0].endswith("batch: 2 files in #s\n")


def test_model_info_equals_jax_but_h100_floors(model):
    (jrc, jout, _), (trc, tout, _) = (run_cli(jcli.run, ["model", "-m",
                                                         model]),
                                      run_cli(tcli.run, ["model", "-m",
                                                         model]))
    assert jrc == trc == 0
    jl, tl = jout.splitlines(), tout.splitlines()
    assert len(jl) == len(tl)
    assert [l for l in tl if "floors" not in l] == \
        [l for l in jl if "floors" not in l]
    floors = [l for l in tl if "floors" in l]
    assert len(floors) == 1 and floors[0].startswith("nvidia-h100-sxm "
                                                     "floors (bf16)")
    assert "v5e" not in tout.lower()


def test_validate_equals_jax(model):
    out = run_cli(tcli.run, ["validate", "-m", model])
    assert out == run_cli(jcli.run, ["validate", "-m", model])
    assert out[0] == 0 and "checks passed" in out[1]


def test_parity_equals_jax(model, wavs, tmp_path):
    ref = tmp_path / "ref.txt"
    ref.write_text("w23097 w29850 w15953 w1 w2")
    out = same(["parity", wavs["one"], str(ref), "-m", model] + DECODE,
               mask=r"RTF [0-9.]+ \([0-9.]+s")
    assert out.startswith("WER ") and "\nref: w23097" in out


def test_stream_equals_jax(model, wavs):
    out = same(["stream", wavs["burst"], "-m", model, "--fp32",
                "--chunk-seconds", "0.5"])
    assert "[final]" in out


@pytest.mark.parametrize("fmt", ["f32le", "s16le"])
def test_record_equals_jax(model, monkeypatch, fmt):
    audio = bursts(seed=9)
    raw = (audio.astype("<f4").tobytes() if fmt == "f32le" else
           (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    out = same(["record", "-m", model, "--fp32", "-l", "en",
                "--sample-format", fmt, "--chunk-seconds", "0.5"],
               stdin=raw, monkeypatch=monkeypatch)
    assert out.strip()


def test_record_without_pipe_is_usage_error(model, monkeypatch):
    class Tty(io.StringIO):
        def isatty(self):
            return True
    monkeypatch.setattr(sys, "stdin", Tty())
    assert run_cli(tcli.run, ["record", "-m", model, "--device",
                              "cpu"])[0] == 2


@pytest.mark.parametrize("match", [True, False])
def test_command_equals_jax(model, wavs, tmp_path, match):
    heard = run_cli(tcli.run, ["transcribe", wavs["one"], "-m", model,
                               "--device", "cpu"] + DECODE)[1].strip()
    cmds = tmp_path / "cmds.txt"
    cmds.write_text("\n".join(["turn on the lights", "stop"]
                              + ([heard] if match else [])) + "\n")
    (jrc, jout, _), (trc, tout, _) = both(
        ["command", wavs["one"], str(cmds), "-m", model] + DECODE)
    assert (trc, tout) == (jrc, jout)
    assert trc == (0 if match else 3)


@pytest.mark.parametrize("fmt", ["int8", "f16", "q4k", "q5k", "q6k"])
def test_quantize_file_equals_jax(model, tmp_path, fmt):
    jpath, tpath = str(tmp_path / "j.apr"), str(tmp_path / "t.apr")
    jrc, jout, _ = run_cli(jcli.run, ["quantize", "-m", model, "-o", jpath,
                                      "-f", fmt])
    trc, tout, _ = run_cli(tcli.run, ["quantize", "-m", model, "-o", tpath,
                                      "-f", fmt])
    assert jrc == trc == 0 and tout == jout
    assert Path(tpath).read_bytes() == Path(jpath).read_bytes()


def test_quantize_already_quantized_refused(model, tmp_path):
    q = str(tmp_path / "q.apr")
    run_cli(tcli.run, ["quantize", "-m", model, "-o", q])
    rc, _, err = run_cli(tcli.run, ["quantize", "-m", q, "-o",
                                    str(tmp_path / "qq.apr")])
    assert rc == 1 and "already quantized" in err


def test_benchmark_json_keys_equal_jax():
    argv = ["benchmark", "--duration", "1", "--tokens", "3", "--emit",
            "json"]
    (jrc, jout, _), (trc, tout, _) = both(argv)
    assert jrc == trc == 0
    j, t = json.loads(jout), json.loads(tout)
    # the port's report also names the device it ran on
    assert sorted(set(t) - {"device"}) == sorted(j)
    assert [c["name"] for c in t["components"]] == \
        [c["name"] for c in j["components"]]
    assert t["device"] == "cpu (host times)"


def test_diagnose_on_cpu(model):
    rc, out, _ = run_cli(tcli.run, ["diagnose", "-m", model, "--device",
                                    "cpu"])
    assert rc == 0, out
    assert "[OK] torch device: cpu" in out
    assert "[OK] kernels: skipped (device cpu)" in out
    assert "[OK] model file: 89 tensors, CRC ok" in out
    assert "jax" not in out.lower()


def test_speculative_is_a_clean_error(model, wavs, monkeypatch):
    """``--speculative``, once refused, decodes through the speculative
    path: the JAX CLI's stdout, and the same stdout as without it
    (speculative greedy is token-exact)."""
    from whisper_apr_tpu_torch.inference import speculative as tspec
    argv = ["transcribe", wavs["one"], "-m", model, "--device", "cpu"] \
        + DECODE
    rc, plain, _ = run_cli(tcli.run, argv)
    assert rc == 0 and plain
    calls = []
    real = tspec.speculative_greedy_generate
    monkeypatch.setattr(tspec, "speculative_greedy_generate",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    spec = same(argv[:4] + DECODE + ["--speculative"])
    rc, out, err = run_cli(tcli.run, argv + ["--speculative"])
    assert rc == 0 and err == ""
    assert out == plain == spec
    assert calls == [1, 1]


@pytest.mark.parametrize("argv", [
    ["model", "-m", "/nonexistent.apr"],
    ["transcribe", "/nonexistent.wav", "-m", "{model}", "--device", "cpu"],
    ["transcribe", "{wav}", "-m", "/nonexistent.apr", "--device", "cpu"],
], ids=["model", "audio", "transcribe_model"])
def test_missing_file_is_clean_error(model, wavs, argv):
    argv = [a.format(model=model, wav=wavs["one"]) for a in argv]
    rc, out, err = run_cli(tcli.run, argv)
    assert rc == 1 and out == ""
    assert err.startswith("error: ") and "No such file" in err


# -- the card is never replaced by the CPU -----------------------------------

@pytest.fixture(scope="module")
def textfile(tmp_path_factory):
    path = tmp_path_factory.mktemp("text") / "lines.txt"
    path.write_text("stop\ngo\n")
    return str(path)


NO_CARD = [
    ["transcribe", "{wav}", "-m", "{model}"],
    ["translate", "{wav}", "-m", "{model}"],
    ["batch", "{wav}", "-m", "{model}"],
    ["stream", "{wav}", "-m", "{model}"],
    ["detect-language", "{wav}", "-m", "{model}"],
    ["parity", "{wav}", "{text}", "-m", "{model}"],
    ["command", "{wav}", "{text}", "-m", "{model}"],
    ["record", "-m", "{model}"],
    ["serve", "-m", "{model}", "--port", "0"],
    ["tui", "{wav}", "-m", "{model}"],
    ["benchmark", "--duration", "1", "--tokens", "2"],
]


@pytest.mark.parametrize("argv", NO_CARD, ids=lambda a: a[0])
def test_cuda_without_a_card_exits_1(model, wavs, textfile, monkeypatch,
                                     argv):
    """The default device is the card: without one each command fails
    through ``resolve_device`` and nothing decodes on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from whisper_apr_tpu_torch.engine import WhisperApr
    from whisper_apr_tpu_torch.model import decoder

    def never(*a, **k):
        raise AssertionError("decoded on the CPU")
    monkeypatch.setattr(WhisperApr, "transcribe_batch", never)
    monkeypatch.setattr(decoder, "greedy_generate_body", never)
    argv = [a.format(model=model, wav=wavs["one"], text=textfile)
            for a in argv]
    rc, out, err = run_cli(tcli.run, argv, stdin=b"\0" * 64,
                           monkeypatch=monkeypatch)
    assert rc == 1 and out == ""
    assert err.startswith("error: ") and "needs a CUDA device" in err


def test_diagnose_cuda_without_a_card_fails(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, _ = run_cli(tcli.run, ["diagnose", "-m", model])
    assert rc == 1
    assert "[FAIL] torch device:" in out and "needs a CUDA device" in out


def test_module_entry_lists_every_jax_subcommand():
    out = subprocess.run(
        ["timeout", "120", sys.executable, "-m", "whisper_apr_tpu_torch.cli",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=150)
    assert out.returncode == 0, out.stderr
    usage = out.stdout.split("positional arguments:")[0]
    for a in ARGV:
        assert a[0] in usage


# -- no JAX in the port's new modules ------------------------------------------

PORT_FILES = sorted(
    [*(REPO / "whisper_apr_tpu_torch" / "cli").glob("*.py"),
     REPO / "whisper_apr_tpu_torch" / "tools" / "convert.py",
     REPO / "whisper_apr_tpu_torch" / "tools" / "golden.py"])


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "whisper_apr_tpu"), \
                f"{path.name}:{node.lineno} imports {name}"
