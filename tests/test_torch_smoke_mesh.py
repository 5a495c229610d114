"""chip_smoke.py's mesh and speculative phases, rehearsed on the CPU at a
small width through the plain versions: the mesh runs over gloo ranks on
the CPU (NCCL needs a card), the speculative phase over a small int8
``.apr`` (its kernels' plain versions stand in for K1-K4)."""

import importlib.util
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
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


def _small():
    from whisper_apr_tpu_torch import ModelConfig
    from whisper_apr_tpu_torch.tokenizer import SpecialTokens
    cfg = ModelConfig(model_type="tiny", n_vocab=700, n_audio_ctx=32,
                      n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                      n_text_ctx=40, n_text_state=128, n_text_head=2,
                      n_text_layer=2, n_mels=80)
    V = cfg.n_vocab
    sp = SpecialTokens(eot=V - 1, sot=V - 2, lang_base=V - 110,
                       transcribe=V - 3, no_timestamps=V - 4,
                       timestamp_base=V + 1000, is_multilingual=False,
                       translate=V - 5, no_speech=V - 6, speaker_turn=V - 7,
                       prev=V - 8)
    return cfg, sp


def test_mesh_phase_on_cpu(smoke):
    """The mesh phase's runs as gloo ranks on the CPU at the dry run's
    small shapes (its 16 text positions cut the lengths): (a) one rank in
    this process, (b) and (c) one launch of two ranks; every case's ranks
    pass their checks and complete alike, and the report carries the
    figures the phase prints."""
    fit = ["--max-len", "12", "--sched-len", "16", "--tf-tokens", "5"]
    runs = tuple((name, n, "gloo", [("small", tp) for _, tp in cases],
                  extra + fit)
                 for name, n, _, cases, extra in smoke.MESH_RUNS)
    out = smoke.phase_mesh("cpu", device="cpu", runs=runs, timeout=120)
    assert set(out) == {"a", "b", "c", "wall_s"}
    assert out["a"]["mesh"] == {"dp": 1, "tp": 1}
    assert out["b"]["mesh"] == {"dp": 2, "tp": 1}
    assert out["c"]["mesh"] == {"dp": 1, "tp": 2}
    for name in "abc":
        r = out[name]
        assert all(r["ok"].values()) and r["greedy_exact"]
        assert r["serve_exact"] and r["ms_per_token"]["tokens"] > 0
    assert len(out["a"]["completions"]) == 2
    assert len(out["b"]["completions"]) == len(out["c"]["completions"]) == 5


def test_mesh_runs_are_the_phase_contract(smoke):
    """(a) one NCCL rank on a 1 x 1 mesh, (b) two gloo ranks dp=2 and (c)
    tp=2 at large-v3's widths (the vocab that splits), 24 tokens."""
    shape = [(name, n, backend, cases)
             for name, n, backend, cases, _ in smoke.MESH_RUNS]
    assert shape == [("a", 1, "nccl", [("tiny", 1)]),
                     ("b, c", 2, "gloo", [("tiny", 1), ("large-v3-4x4", 2)])]
    assert smoke.MESH_COMMON == ["--max-len", "24", "--tf-tokens", "24",
                                 "--tol", "1e-4", "--clip-samples", "48000",
                                 "--sched-len", "32", "--sched-tokens", "16"]
    from whisper_apr_tpu_torch.parallel.dryrun import named_config
    big = named_config("large-v3-4x4")
    assert (big.n_text_state, big.n_text_head, big.n_vocab, big.n_mels,
            big.n_audio_ctx) == (1280, 20, 51866, 128, 1500)
    assert (big.n_audio_layer, big.n_text_layer) == (4, 4)


def test_speculative_phase_on_cpu(smoke, tmp_path):
    """The speculative phase at a small width: every case follows plain
    greedy, nothing launches, a draft of every layer accepts all."""
    from whisper_apr_tpu_torch import ComputeConfig, WhisperApr
    cfg, sp = _small()
    apr = tmp_path / "small.apr"
    smoke.write_random_apr(apr, cfg)
    bf16 = WhisperApr.load_from_apr(
        str(apr), ComputeConfig(quantization="int8",
                                compute_dtype="bfloat16"),
        specials=sp, device="cpu")
    out = smoke.phase_speculative(apr, bf16, "cpu", device="cpu",
                                  specials=sp, max_tokens=10)
    assert len(out["cases"]) == 2 * len(smoke.SPEC_CASES)
    for c in out["cases"]:
        assert c["near_tie_gap"] is None and c["verify_passes"] > 0
        if c["draft_layers"] == cfg.n_text_layer:
            assert c["accepted"] == c["draft_tokens"] * c["verify_passes"]
    assert 0 <= out["bf16_mismatches"] <= 2
