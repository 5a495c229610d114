"""chip_smoke.py's ``cli`` phase rehearsed on the CPU at a small width
through the plain versions: the CLI commands in process and as a
subprocess, the threaded server's burst, async, cancel and session, and
the f32 ``--single-thread`` server's tokens following per-clip
transcribe. Nothing launches on the CPU, so the counts are not held."""

import importlib.util
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


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
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_phase_on_cpu(smoke, tmp_path):
    from whisper_apr_tpu_torch import ModelConfig
    # the full vocabulary: the CLI loads the .apr with the specials of
    # its vocabulary size
    cfg = ModelConfig(model_type="tiny", n_vocab=51_865, n_audio_ctx=32,
                      n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                      n_text_ctx=40, n_text_state=128, n_text_head=2,
                      n_text_layer=2, n_mels=80)
    apr = tmp_path / "tiny-small.apr"
    smoke.write_random_apr(apr, cfg)
    out = smoke.phase_cli(apr, tmp_path, "cpu", device="cpu", max_tokens=12,
                          clip_seconds=1.5, serve_seconds=(1, 2, 1, 3),
                          session_seconds=8, f32_clips=2, f32_tokens=8)
    assert sorted(out["commands"]) == sorted([
        "transcribe json", "transcribe srt", "batch", "detect-language",
        "model", "validate", "diagnose", "transcribe --fp32"])
    # 1.5 s is three windows of 0.64 s: one decode of three rows
    assert [c[0] for c in out["commands"]["transcribe json"]["decodes"]] \
        == [3]
    assert [c[0] for c in out["commands"]["batch"]["decodes"]] == [4]
    s = out["server"]
    assert s["requests"] == 4 and s["ticks"] > 0
    assert s["session_partials"] > 0
    assert s["latency_ms_p50"] > 0 and s["tokens_per_decode_second"] > 0
    assert len(out["f32_gaps"]) == 2
    assert len(out["launches"]) == 8 + 2
    assert all(not any(c.values()) for c in out["launches"])
