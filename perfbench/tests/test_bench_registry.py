"""Every piece of the benchmark is found by its name, and a new mix joins
with files and entries alone."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from perfbench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    c = spec.resolve(name)
    assert c.dims.d_model == c.config["d_model"]
    assert spec.driver(c.traffic["driver"]).run
    assert c.limits["logit_gap_max"]["limit"] > 0
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found(name):
    assert callable(spec.metric_reader(name))


def test_configs_and_paths():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        assert c["reduced"] == []
        json.loads((spec.REPO / c["file"]).read_text())
    assert BENCH["paths"] == ["perfbench"]
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_mix_is_found_without_editing(tmp_path):
    shutil.copytree(spec.REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    before = _digest(tmp_path / "perfbench")
    mix = json.loads((tmp_path / "perfbench" / "traffic" /
                      "serve.chunks.json").read_text())
    mix["rate_rps"] = 3.0
    (tmp_path / "perfbench" / "traffic" / "serve.chunks.slow.json") \
        .write_text(json.dumps(mix))
    (tmp_path / "perfbench" / "limits" / "large-v3.serve.chunks.slow.json") \
        .write_text(json.dumps({"logit_gap_max": {"limit": 0.5}}))
    bench["workloads"].append({"name": "large-v3.serve.chunks.slow",
                               "config": "large-v3",
                               "traffic": "serve.chunks.slow", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "large-v3.serve.chunks" in m.get("workloads", []):
            m["workloads"].append("large-v3.serve.chunks.slow")
    for c in bench["configs"]:
        c["file"] = str(Path(c["file"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.resolve("large-v3.serve.chunks.slow", root=tmp_path)
    assert c.traffic["rate_rps"] == 3.0
    assert c.limits["logit_gap_max"]["limit"] == 0.5
    assert spec.driver(c.traffic["driver"], root=tmp_path).run
    after = _digest(tmp_path / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_unknown_cell():
    with pytest.raises(KeyError):
        spec.resolve("no.such.cell")
