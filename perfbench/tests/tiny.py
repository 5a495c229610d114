"""A benchmark cell cut to a size the CPU tests can run: Whisper tiny's
widths with 2 + 2 layers, a few slots, a low rate and short outputs."""

import dataclasses
import json

from perfbench import spec

TINY = dict(d_model=384, encoder_layers=2, decoder_layers=2,
            encoder_attention_heads=6, decoder_attention_heads=6,
            encoder_ffn_dim=1536, decoder_ffn_dim=1536, vocab_size=51865,
            num_mel_bins=80)


def cell(name: str, limit: float = 1.0) -> spec.Cell:
    c = spec.resolve(name)
    config = dict(c.config, **TINY)
    mix = dict(c.traffic)
    if mix["driver"] == "serve":
        mix.update(n_slots=4, rate_rps=2.0, preroll_s=0.5, warm_buckets=[1],
                   tokens={"kind": "uniform", "lo": 24, "hi": 32},
                   check={"sample": 3}, recording_s=60)
    else:
        mix.update(file_s={"lo": 40.0, "hi": 70.0},
                   max_tokens={"lo": 24, "hi": 30}, recording_s=80, block=3,
                   check={"files": 1, "windows_per_file": 2})
    return dataclasses.replace(
        c, config=config, dims=spec.Dims.from_config("tiny", config),
        traffic=mix, limits={"logit_gap_max": {"limit": limit}})


def dims() -> spec.Dims:
    with open(spec.REPO / "perfbench" / "configs" / "large-v3.json") as f:
        return spec.Dims.from_config("tiny", dict(json.load(f), **TINY))
