"""Resolve a cell of ``BENCHMARK.json`` into its pieces, by name.

A cell names a configuration (``configs/<config>.json`` through the
configuration's ``file``) and a traffic mix (``traffic/<traffic>.json``);
the mix names its driver (``drivers/<driver>.py``); every metric is a
reader of its own (``metrics/<metric name>.py``); the limits of the
comparison that decides ``correct`` are ``limits/<cell>.json``. A later
change adds a cell by adding files and entries: nothing here names a cell,
a mix, a driver or a metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

REPO = Path(__file__).resolve().parent.parent   # the checkout


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes of a Whisper configuration file, by their HF names."""

    name: str
    d_model: int
    encoder_layers: int
    decoder_layers: int
    heads: int
    ffn: int
    vocab: int
    n_mels: int
    n_audio_ctx: int
    n_text_ctx: int
    eot: int
    sot: int

    @staticmethod
    def from_config(name: str, c: dict) -> "Dims":
        if c["encoder_attention_heads"] != c["decoder_attention_heads"]:
            raise ValueError(f"{name}: encoder and decoder heads differ")
        if c["encoder_ffn_dim"] != c["decoder_ffn_dim"]:
            raise ValueError(f"{name}: encoder and decoder FFN widths differ")
        return Dims(name, c["d_model"], c["encoder_layers"],
                    c["decoder_layers"], c["encoder_attention_heads"],
                    c["encoder_ffn_dim"], c["vocab_size"], c["num_mel_bins"],
                    c["max_source_positions"], c["max_target_positions"],
                    c["eos_token_id"], c["decoder_start_token_id"])


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the workloads entry
    config: dict           # the configuration file
    dims: Dims
    traffic: dict          # the mix file
    limits: dict           # limits/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = REPO) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell_name: str, bench: Optional[dict] = None,
            root: Path = REPO) -> Cell:
    """The cell named ``cell_name`` with its configuration, mix, limits and
    the metrics it reports; raises KeyError for an unknown name."""
    bench = bench if bench is not None else load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in entries:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(root / "perfbench" / "traffic" / f"{entry['traffic']}.json") \
            as f:
        traffic = json.load(f)
    limits_path = root / "perfbench" / "limits" / f"{cell_name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() \
        else {}
    return Cell(cell_name, entry, config,
                Dims.from_config(cfg_entry["name"], config), traffic, limits,
                [m for m in bench["end_to_end"] if _reports(m, cell_name)],
                [m for m in bench["per_layer"] if _reports(m, cell_name)])


def _load_file(path: Path, modname: str):
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, root: Path = REPO):
    """The driver module ``drivers/<name>.py``."""
    return _load_file(root / "perfbench" / "drivers" / f"{name}.py",
                      f"perfbench_driver_{name}")


def metric_reader(name: str, root: Path = REPO) -> Callable:
    """``read(record)`` of ``metrics/<name>.py``: the metric's value, or
    None where the record holds nothing to read."""
    mod = _load_file(root / "perfbench" / "metrics" / f"{name}.py",
                     "perfbench_metric_" + name.replace(".", "_")
                     .replace("-", "_"))
    return mod.read


def read_metrics(metrics: List[dict], record) -> Dict[str, dict]:
    """Every metric of the list that its reader finds, in order."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value = metric_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
