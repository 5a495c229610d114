"""The system under test: the port's engine over the benchmark's weights,
and the benchmark's spans around the port's entry points.

Only this module and the drivers import the port. Spans are placed from
here, around calls into the port, by replacing a module attribute or an
instance method with a wrapper for the length of a run; no file of the
port changes.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List

import torch

from .spec import Dims
from .weights import sinusoids


def model_config(dims: Dims):
    from whisper_apr_tpu_torch.config import ModelConfig
    return ModelConfig(dims.name, dims.vocab, dims.n_audio_ctx, dims.d_model,
                       dims.heads, dims.encoder_layers, dims.n_text_ctx,
                       dims.d_model, dims.heads, dims.decoder_layers,
                       dims.n_mels)


def port_params(w: Dict[str, object], dims: Dims) -> dict:
    """The port's parameter tree (``model/params.py``'s layout) over the
    drawn tensors: the int8 pairs become ``QTensor``s, nothing is copied
    or converted."""
    from whisper_apr_tpu_torch.ops.quant import QTensor

    def qt(name):
        q, s = w[name]
        return QTensor(q, s)

    def ln(p):
        return {"w": w[f"{p}.w"], "b": w[f"{p}.b"]}

    def attn(p):
        out = {}
        for x in "qkvo":
            out[f"{x}_w"] = qt(f"{p}.{x}")
            out[f"{x}_b"] = w[f"{p}.{x}.b"]
        return out

    def fc(p):
        return {"w": qt(p), "b": w[f"{p}.b"]}

    dev = w["enc.conv1.w"].device
    encoder = {
        "conv1": {"w": w["enc.conv1.w"], "b": w["enc.conv1.b"]},
        "conv2": {"w": w["enc.conv2.w"], "b": w["enc.conv2.b"]},
        "pos_emb": sinusoids(dims.n_audio_ctx, dims.d_model).to(dev),
        "blocks": {"ln1": ln("enc.ln1"), "attn": attn("enc.attn"),
                   "ln2": ln("enc.ln2"), "fc1": fc("enc.fc1"),
                   "fc2": fc("enc.fc2")},
        "ln_post": ln("enc.ln_post"),
    }
    decoder = {
        "token_emb": qt("dec.tok"),
        "pos_emb": w["dec.pos"],
        "blocks": {"ln1": ln("dec.ln1"), "self_attn": attn("dec.self"),
                   "ln2": ln("dec.ln2"), "cross_attn": attn("dec.cross"),
                   "ln3": ln("dec.ln3"), "fc1": fc("dec.fc1"),
                   "fc2": fc("dec.fc2")},
        "ln_post": ln("dec.ln_post"),
    }
    return {"encoder": encoder, "decoder": decoder}


def engine(w: Dict[str, object], dims: Dims, served: dict, device):
    """``WhisperApr`` over the drawn weights with the configuration's
    ``served`` compute settings; checks that the engine's special tokens
    are the configuration's."""
    from whisper_apr_tpu_torch.config import ComputeConfig
    from whisper_apr_tpu_torch.engine import WhisperApr
    compute = ComputeConfig(quantization=served["quantization"],
                            compute_dtype=served["compute_dtype"],
                            kv_mode=served["kv_mode"])
    eng = WhisperApr(model_config(dims), port_params(w, dims),
                     compute=compute, device=device)
    if eng.specials.eot != dims.eot or eng.specials.sot != dims.sot:
        raise RuntimeError(
            f"the engine's eot / sot {eng.specials.eot} / "
            f"{eng.specials.sot} are not the configuration's "
            f"{dims.eot} / {dims.sot}")
    return eng


def prompt(eng, language: str) -> List[int]:
    return list(eng.get_initial_tokens(language, "transcribe"))


class Spans:
    """Benchmark spans placed around port calls for the length of a run:
    ``wrap_attr(module, name, label)`` and ``wrap_method(obj, name,
    label)`` put a ``torch.profiler.record_function`` range around each
    call; ``close`` puts every original back."""

    def __init__(self) -> None:
        self._undo: List[Callable[[], None]] = []

    @staticmethod
    def _wrapped(fn, label: str):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return wrapper

    def wrap_attr(self, module, name: str, label: str) -> None:
        orig = getattr(module, name)
        setattr(module, name, self._wrapped(orig, label))
        self._undo.append(lambda: setattr(module, name, orig))

    def wrap_method(self, obj, name: str, label: str) -> None:
        orig = getattr(obj, name)
        own = obj.__dict__.get(name)
        setattr(obj, name, self._wrapped(orig, label))
        if own is None:
            self._undo.append(lambda: obj.__dict__.pop(name, None))
        else:
            self._undo.append(lambda: setattr(obj, name, own))

    def close(self) -> None:
        while self._undo:
            self._undo.pop()()


@contextlib.contextmanager
def span(label: str):
    with torch.profiler.record_function(label):
        yield
