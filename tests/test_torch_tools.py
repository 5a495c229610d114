"""The port's ``tools/convert.py`` and ``tools/golden.py`` against the JAX
package's, on the CPU.

Convert: a random-init transformers Whisper saved by ``save_pretrained``
(safetensors, or ``pytorch_model.bin``) with a vocab.json, merges.txt and
added_tokens.json, converted by both to byte-equal ``.apr`` files (v1 and
v2, f32 and int8); the port's own safetensors reader against the
``safetensors`` package's. Golden: both engines' captured stages over one
``.apr`` pass ``compare``'s gates, and their stats agree.
"""

import argparse
import json
import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import make_hf_twin, small_config
from test_torch_cli import run_cli, speech_like, write_model
from whisper_apr_tpu import cli as jcli
from whisper_apr_tpu.cli import commands as jcommands
from whisper_apr_tpu.errors import FormatError as JFormatError
from whisper_apr_tpu.format import QUANT_INT8
from whisper_apr_tpu.tools import golden as jgolden
from whisper_apr_tpu.tools.convert import convert_hf_to_apr as j_convert
from whisper_apr_tpu_torch import cli as tcli
from whisper_apr_tpu_torch.cli import commands as tcommands
from whisper_apr_tpu_torch.errors import FormatError as TFormatError
from whisper_apr_tpu_torch.tools import golden as tgolden
from whisper_apr_tpu_torch.tools.convert import _config_from_hf_json
from whisper_apr_tpu_torch.tools.convert import _load_safetensors
from whisper_apr_tpu_torch.tools.convert import convert_hf_to_apr as t_convert


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes, and torch's spinning thread pools would
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokenizer_files(d: str, n_vocab: int) -> None:
    vocab = {f"<x{i}>": i for i in range(n_vocab - 2)}
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "added_tokens.json"), "w") as f:
        json.dump({"<|endoftext|>": n_vocab - 2,
                   "<|startoftranscript|>": n_vocab - 1}, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n! !\n< x\n")


@pytest.fixture(scope="module", params=["safetensors", "bin"])
def hf_dir(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(f"hf_{request.param}"))
    cfg = small_config()
    make_hf_twin(cfg, seed=11).save_pretrained(
        d, safe_serialization=request.param == "safetensors")
    weights = ("model.safetensors" if request.param == "safetensors"
               else "pytorch_model.bin")
    assert os.listdir(d).count(weights) == 1
    _tokenizer_files(d, cfg.n_vocab)
    return d


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("quant", ["f32", "int8"])
def test_convert_file_equals_jax(hf_dir, tmp_path, version, quant):
    q = QUANT_INT8 if quant == "int8" else 0
    j, t = str(tmp_path / "j.apr"), str(tmp_path / "t.apr")
    assert j_convert(hf_dir, j, quantization=q,
                     container_version=version) == j
    assert t_convert(hf_dir, t, quantization=q,
                     container_version=version) == t
    assert Path(t).read_bytes() == Path(j).read_bytes()


def test_convert_command_equals_jax(hf_dir, tmp_path):
    j, t = str(tmp_path / "j.apr"), str(tmp_path / "t.apr")
    jrc, jout, _ = run_cli(jcli.run, ["convert", hf_dir, j, "--int8",
                                      "--v2"])
    trc, tout, _ = run_cli(tcli.run, ["convert", hf_dir, t, "--int8",
                                      "--v2"])
    assert jrc == trc == 0
    assert (jout, tout) == (f"wrote {j}\n", f"wrote {t}\n")
    assert Path(t).read_bytes() == Path(j).read_bytes()


@pytest.mark.parametrize("what", ["config", "weights"])
def test_convert_missing_files_raise_like_jax(tmp_path, what):
    if what == "weights":
        (tmp_path / "config.json").write_text(json.dumps({
            "d_model": 64, "encoder_layers": 2, "decoder_layers": 2,
            "vocab_size": 100, "max_source_positions": 10,
            "max_target_positions": 10, "encoder_attention_heads": 2,
            "decoder_attention_heads": 2}))
    with pytest.raises(JFormatError) as je:
        j_convert(str(tmp_path), str(tmp_path / "x.apr"))
    with pytest.raises(TFormatError) as te:
        t_convert(str(tmp_path), str(tmp_path / "x.apr"))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("dims", [
    (384, 4, 4, 80), (512, 6, 6, 80), (1280, 32, 32, 128),
    (1280, 32, 4, 128), (1280, 32, 32, 80), (100, 3, 3, 80)])
def test_config_from_hf_json_equals_jax(dims):
    from whisper_apr_tpu.tools.convert import _config_from_hf_json as j_cfg
    d, enc, dec, mels = dims
    cfg = {"d_model": d, "encoder_layers": enc, "decoder_layers": dec,
           "num_mel_bins": mels, "vocab_size": 51865,
           "max_source_positions": 1500, "max_target_positions": 448,
           "encoder_attention_heads": 4, "decoder_attention_heads": 4}
    assert _config_from_hf_json(cfg).__dict__ == j_cfg(cfg).__dict__


# -- the port's safetensors reader ---------------------------------------------

def _arrays(dtype):
    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(7, 5)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "scalar": np.array(2.5, np.float32),
            "empty": np.zeros((0, 3), np.float32),
            "big": (rng.normal(size=(3, 4)) * 3e4).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["f32", "f16", "bf16"])
def test_safetensors_reader_equals_safetensors(tmp_path, dtype):
    path = str(tmp_path / "m.safetensors")
    arrays = _arrays(dtype)
    if dtype == "bf16":
        from safetensors.torch import load_file, save_file
        save_file({k: torch.from_numpy(v).to(torch.bfloat16)
                   for k, v in arrays.items()}, path)
        want = {k: v.float().numpy() for k, v in load_file(path).items()}
    else:
        from safetensors.numpy import load_file, save_file
        np_dtype = np.float32 if dtype == "f32" else np.float16
        save_file({k: v.astype(np_dtype) for k, v in arrays.items()}, path,
                  metadata={"format": "np"})
        want = {k: v.astype(np.float32) for k, v in load_file(path).items()}
    got = _load_safetensors(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def test_safetensors_reader_integer_tensors(tmp_path):
    from safetensors.numpy import save_file
    path = str(tmp_path / "i.safetensors")
    ints = {"i64": np.arange(6, dtype=np.int64).reshape(2, 3) - 3,
            "u8": np.arange(250, 256, dtype=np.uint8)}
    save_file(ints, path)
    got = _load_safetensors(path)
    for k, v in ints.items():
        np.testing.assert_array_equal(got[k], v.astype(np.float32))


@pytest.mark.parametrize("damage", ["short", "header_past_end", "json",
                                    "dtype", "offsets"])
def test_safetensors_reader_rejects_malformed(tmp_path, damage):
    def header(h: dict, data: bytes = b"") -> bytes:
        raw = json.dumps(h).encode()
        return struct.pack("<Q", len(raw)) + raw + data
    good = {"t": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}}
    blob = {"short": b"\x01\x02",
            "header_past_end": struct.pack("<Q", 10_000) + b"{}",
            "json": struct.pack("<Q", 3) + b"{x}",
            "dtype": header({"t": {**good["t"], "dtype": "F8_E4M3"}},
                            b"\0" * 8),
            "offsets": header(good, b"\0" * 4)}[damage]
    path = tmp_path / "bad.safetensors"
    path.write_bytes(blob)
    with pytest.raises(TFormatError):
        _load_safetensors(str(path))


# -- golden traces ---------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    model = write_model(str(tmp_path_factory.mktemp("golden") / "m.apr"))
    args = dict(model=model, fp32=True, flash_attn=False, verbose=False)
    return (jcommands._load_engine(argparse.Namespace(**args)),
            tcommands._load_engine(argparse.Namespace(**args,
                                                      device="cpu")))


@pytest.mark.parametrize("tokens", [None, [50258, 50259, 50359, 50363, 7]],
                         ids=["no_tokens", "tokens"])
def test_golden_capture_passes_jax_gates(engines, tmp_path, tokens):
    audio = speech_like(1.0, seed=0)
    jt = jgolden.GoldenTrace(str(tmp_path / "jax"))
    tt = tgolden.GoldenTrace(str(tmp_path / "torch"))
    jfiles = jt.capture_pipeline(engines[0], audio, tokens)
    tfiles = tt.capture_pipeline(engines[1], audio, tokens)
    assert sorted(tfiles) == sorted(jfiles) == sorted(
        ["audio", "mel", "encoder"] + (["logits"] if tokens else []))
    assert tt.GATES == jt.GATES
    for trace, other in ((tt, jt), (jt, tt)):
        comps = trace.compare(other.directory)
        assert [c.name for c in comps] == sorted(tfiles, key=list(
            tt.GATES).index)
        assert all(c.passed for c in comps), tgolden.GoldenTrace.summary(
            comps)
    for name in tfiles:
        with open(os.path.join(tt.directory, f"{name}.json")) as f:
            ts = json.load(f)
        with open(os.path.join(jt.directory, f"{name}.json")) as f:
            js = json.load(f)
        assert ts["name"] == js["name"] and ts["shape"] == js["shape"]
        np.testing.assert_allclose(
            [ts[k] for k in ("mean", "std", "min", "max")],
            [js[k] for k in ("mean", "std", "min", "max")],
            rtol=1e-4, atol=1e-5)


def test_golden_compare_and_summary_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 80)).astype(np.float32)
    out = []
    for m in (jgolden, tgolden):
        base = m.GoldenTrace(str(tmp_path / m.__name__ / "a"))
        other = m.GoldenTrace(str(tmp_path / m.__name__ / "b"))
        base.dump("mel", a)
        other.dump("mel", a + 0.01)
        base.dump("encoder", a)
        other.dump("encoder", a[:2])                 # shape differs
        base.dump("audio", a[0])
        other.dump("audio", -a[0])                   # fails its gate
        comps = base.compare(other.directory)
        stats = m.StageStats.compute("x", a).to_dict()
        out.append(([c.__dict__ for c in comps], m.GoldenTrace.summary(comps),
                    stats, m.cosine(a, a + 1), m.cosine(a * 0, a),
                    m.cosine(a * 0, a * 0), base.load("logits")))
    assert out[1] == out[0]
    assert [c["passed"] for c in out[1][0]] == [False, True, False]
