"""The WhisperApr engine: load, transcribe, detect language.

Port of ``whisper_apr_tpu/engine.py``: transcription of a batch of
clips by greedy search (with or without timestamp tokens), sampling
(temperature, best-of, top-k, top-p) or beam search, the temperature
fallback and n-best lists:

    audio (host) -> log-mel (torch) -> encoder (torch)
                 -> decode (Python loop over the per-token step)
                 -> BPE decode (host)

The decode step follows ``ComputeConfig.kv_mode`` and the weights: int8
weights with a cache mode run the per-block CUDA kernels (K1-K3 for one
row, K5-K7 for several) with the fused greedy head K4 or the logits tail
K8; kv_mode "scan" runs ``decode_step_q`` (K8 and K9); k-quant weights
(Q4_K, Q5_K, Q6_K) run K12-K14 for one row and, for several, K5-K7 over
their int8 transcode, and in kv_mode "scan" K10 (Q4_K) or K11; f32, int4
and group-int4 weights the plain step. ``ComputeConfig.
use_flash_attention`` (resolved once per engine, ``KernelSelector`` when
None) runs every encode's self-attention through the flash kernel K16;
the switches ``ops.int8_matmul.USE_PALLAS_INT8`` and ``ops.int4_matmul.
USE_PALLAS_INT4`` send the quantized linears (encoder, prefill, cross
K/V) through K17 and K18. The engine lives on one ``device`` ("cuda" by
default; "cpu" runs the kernels' plain PyTorch versions).
Continuous-batching serving over an engine, dense or paged, is
``parallel/serving.BatchScheduler``.

Audio of any length (``transcribe_long``: every 30 s window of a file in
one ``transcribe_batch``), VAD-gated transcription, streaming sessions
with prefix-reuse partials (``transcribe_prefixed``), hotwords (a
host-stepped greedy loop over the plain step, the trie applied to the
logits each step) and word timestamps (the traced forward's
cross-attention, aligned by DTW) are the JAX engine's, on the engine's
device, and so is speculative greedy decoding (``speculative`` with one
clip, greedy at temperature 0, no timestamps: the model's first
``draft_layers`` layers draft ``draft_tokens`` tokens and one full pass
verifies them, ``inference/speculative.py``; the plain step, no kernel,
as in JAX).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from .audio.mel import MelFilterbank
from .audio.resample import SincResampler
from .audio.wav import parse_wav
from .config import ComputeConfig, ModelConfig, SAMPLE_RATE
from .detection import LanguageProbs
from .errors import ModelError
from .format import AprReader, AprReaderV2, is_v2
from .inference.beam import beam_generate
from .inference.processors import WhisperTokenSuppressor
from .inference.sampling import (DEFAULT_TEMPERATURES, compression_ratio,
                                 is_silence, needs_fallback, sample_generate)
from .model.decoder import init_cache, prefill
from .ops.dispatch import resolve_device
from .model.encoder import encode as encode_fn
from .model.params import (Params, load_params_from_apr,
                           params_from_hf_model, to_device)
from .timestamps import Segment, extract_segments, has_timestamps
from .tokenizer import BpeTokenizer, SpecialTokens, Vocabulary
from .tokenizer import special_tokens as st
from .utils.progress import ProgressTracker
from .utils.trace import trace_span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


@dataclasses.dataclass
class TranscribeOptions:
    """(reference: src/lib.rs:170 TranscribeOptions; the JAX package's
    fields, so options move between the two unchanged)"""

    language: Optional[str] = None  # None/"auto" -> detect
    task: str = "transcribe"  # or "translate"
    strategy: str = "greedy"  # or "beam"
    beam_size: int = 5
    best_of: int = 1
    patience: float = 1.0
    temperature: float = 0.0
    max_tokens: Optional[int] = None
    word_timestamps: bool = False
    word_alignment: str = "dtw"
    timestamps: bool = False
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0
    logprob_thold: float = -1.0
    compression_ratio_thold: float = 2.4
    entropy_thold: float = 2.4
    no_speech_thold: float = 0.6
    hotwords: Optional[List] = None
    speculative: bool = False
    draft_tokens: int = 4
    draft_layers: int = 0


@dataclasses.dataclass
class TranscriptionResult:
    """(reference: src/lib.rs:200 TranscriptionResult)"""

    text: str
    language: str
    segments: List[Segment]
    tokens: List[int] = dataclasses.field(default_factory=list)
    words: List = dataclasses.field(default_factory=list)
    avg_logprob: float = 0.0
    no_speech_prob: float = 0.0
    compression_ratio: float = 0.0
    temperature: float = 0.0


@dataclasses.dataclass
class BatchTranscriptionResult:
    """(reference: src/lib.rs:211 BatchTranscriptionResult)"""

    results: List[TranscriptionResult]
    total_duration_secs: float

    def __len__(self) -> int:
        return len(self.results)


class WhisperApr:
    """The transcription engine (reference: src/lib.rs:270)."""

    def __init__(self, config: ModelConfig, params: Params,
                 tokenizer: Optional[BpeTokenizer] = None,
                 mel_filters: Optional[MelFilterbank] = None,
                 compute: Optional[ComputeConfig] = None,
                 specials: Optional[SpecialTokens] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        with trace_span("engine.init"):
            self._init(config, params, tokenizer, mel_filters, compute,
                       specials, device)

    def _init(self, config, params, tokenizer, mel_filters, compute,
              specials, device) -> None:
        self.device = resolve_device(device, "WhisperApr")
        self.config = config
        self.params = to_device(params, self.device)
        if tokenizer is None:
            # fallback vocabulary covering every model id
            v = Vocabulary.with_base_tokens()
            while len(v) < config.n_vocab:
                v.add_token(b"<|tok%d|>" % len(v))
            tokenizer = BpeTokenizer(v)
        self.tokenizer = tokenizer
        self.mel_filters = mel_filters or MelFilterbank.create(config.n_mels)
        self.compute = compute or ComputeConfig()
        self.specials = specials or SpecialTokens.for_vocab_size(config.n_vocab)
        if self.specials.sot >= config.n_vocab or self.specials.eot >= config.n_vocab:
            raise ModelError(
                f"special tokens (sot={self.specials.sot}, eot={self.specials.eot}) "
                f"out of range for n_vocab={config.n_vocab}; pass explicit "
                f"`specials` fitted to this vocabulary")
        if self.compute.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {list(_DTYPES)}")

    # -- constructors --------------------------------------------------------
    @staticmethod
    def load_from_apr(path_or_bytes: Union[str, bytes],
                      compute: Optional[ComputeConfig] = None,
                      verify_crc: bool = True,
                      specials: Optional[SpecialTokens] = None,
                      progress: Optional[Callable] = None,
                      device: Union[str, torch.device] = "cuda"
                      ) -> "WhisperApr":
        """Load a model from an .apr container, v1 or v2 (``is_v2``).
        Quantized files stay quantized on the device: int8 with the file's
        scales, q4k/q5k/q6k bit-exact from the super-blocks (block linears
        whose d_in is a multiple of 256; the others load dequantized),
        when ``compute.quantization`` is "none" or the file's own mode;
        other files are quantized at load to ``compute.quantization``.

        ``progress`` receives :class:`~.utils.progress.Progress` updates
        through the weighted read / parse / encoder / decoder / finalize
        phases, the same sequence as the JAX engine's."""
        device = resolve_device(device, "WhisperApr")
        tracker = ProgressTracker.model_loading() if progress else None

        def emit(msg: str = "") -> None:
            if tracker is not None:
                progress(tracker.to_progress(msg))

        if tracker is not None:
            tracker.start_phase("read")
            emit("opening container")
        if isinstance(path_or_bytes, str):
            with open(path_or_bytes, "rb") as f:
                data = f.read()
        else:
            data = path_or_bytes
        reader = AprReaderV2(data) if is_v2(data) else AprReader(data)
        if tracker is not None:
            tracker.advance()  # -> parse
            emit("header + checksum")
        if verify_crc and not reader.verify_crc():
            raise ModelError("corrupt .apr file: CRC32 mismatch")
        config = reader.header.to_model_config()
        compute = compute or ComputeConfig()
        dtype = _DTYPES.get(compute.param_dtype, torch.float32)
        file_mode = {2: "int8", 4: "q4k", 5: "q5k", 6: "q6k"}.get(
            reader.header.quantization)
        keep = file_mode is not None \
            and compute.quantization in ("none", file_mode)
        on_tensor = None
        if tracker is not None:
            # tensor reads per section (attention 8, LayerNorm 2, fc 2 each)
            totals = {"encoder": 7 + 16 * config.n_audio_layer,
                      "decoder": 4 + 26 * config.n_text_layer}
            counts = {"encoder": 0, "decoder": 0}

            def on_tensor(name: str, _i: int) -> None:
                ph = "encoder" if name.startswith("encoder.") else "decoder"
                counts[ph] += 1
                tracker.start_phase(ph)
                tracker.update_phase_progress(
                    min(counts[ph] / totals[ph], 1.0))
                emit(name)

        params = load_params_from_apr(reader, dtype=dtype, keep_quantized=keep,
                                      on_tensor=on_tensor)
        if compute.quantization != "none" and not keep:
            from .model.params import quantize_params
            params = quantize_params(params, compute.quantization)

        if tracker is not None:
            tracker.start_phase("finalize")
            emit("vocabulary + filterbank")
        tokenizer = None
        vb = reader.read_vocabulary_bytes()
        if vb is not None:
            tokenizer = BpeTokenizer(Vocabulary.from_bytes(vb))
        mel_filters = None
        fb = reader.read_mel_filterbank()
        if fb is not None:
            mel_filters = MelFilterbank.from_apr_data(fb)
        eng = WhisperApr(config, params, tokenizer, mel_filters, compute,
                         specials, device=device)
        if tracker is not None:
            tracker.update_phase_progress(1.0)
            emit("done")
        return eng

    @staticmethod
    def from_hf_model(hf_model, config: ModelConfig,
                      tokenizer: Optional[BpeTokenizer] = None,
                      compute: Optional[ComputeConfig] = None,
                      specials: Optional[SpecialTokens] = None,
                      device: Union[str, torch.device] = "cuda"
                      ) -> "WhisperApr":
        """Build from a transformers Whisper model (the test oracle; the
        JAX ``from_hf_model``)."""
        compute = compute or ComputeConfig()
        params = params_from_hf_model(
            hf_model, config,
            dtype=_DTYPES.get(compute.param_dtype, torch.float32))
        if compute.quantization != "none":
            from .model.params import quantize_params
            params = quantize_params(params, compute.quantization)
        return WhisperApr(config, params, tokenizer, None, compute, specials,
                          device=device)

    # -- pipeline stages ------------------------------------------------------
    @property
    def _compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute.compute_dtype]

    @property
    def _use_flash(self) -> bool:
        """The encoder's attention choice, resolved once: the explicit
        ``use_flash_attention``, else ``KernelSelector`` on the engine's
        device at the encoder's shape (JAX ``engine.py:263-277``)."""
        if not hasattr(self, "_use_flash_cache"):
            opt = self.compute.use_flash_attention
            if opt is None:
                from .ops.dispatch import (DeviceCapabilities, KernelBackend,
                                           KernelSelector)
                choice = KernelSelector(
                    caps=DeviceCapabilities.detect(self.device)).attention(
                    q_len=self.config.n_audio_ctx,
                    k_len=self.config.n_audio_ctx)
                opt = choice == KernelBackend.PALLAS
            self._use_flash_cache = bool(opt)
        return self._use_flash_cache

    @property
    def _qdecode(self):
        """Kernel operands of the quantized decode steps, prepared once:
        an int8 qd, else a Q4_K, else a Q5_K/Q6_K one; None for other
        weights (f32, int4, group int4: the plain step)."""
        if not hasattr(self, "_qdecode_cache"):
            from .model.qdecode import (prepare_kq_decode,
                                        prepare_q4k_decode, prepare_qdecode)
            with trace_span("qdecode.prepare"):
                qd = prepare_qdecode(self.params, self.config)
                if qd is None:
                    qd = prepare_q4k_decode(self.params, self.config)
                if qd is None:
                    qd = prepare_kq_decode(self.params, self.config)
            self._qdecode_cache = qd
        return self._qdecode_cache

    @property
    def _qdecode_batched(self):
        """qd of a batched (B > 1) fused decode: the int8 qd itself, or for
        k-quant params their per-channel int8 transcode
        (``qdecode.transcode_kq_to_int8``), built once at first use, so
        that B > 1 runs K5-K8; storage and the B = 1 path stay k-quant."""
        if not hasattr(self, "_qdecode_batched_cache"):
            from .model.qdecode import KQ_MODES, transcode_kq_to_int8
            qd = self._qdecode
            if qd is not None and str(qd.get("mode", "int8")) in KQ_MODES:
                qd = transcode_kq_to_int8(self.params, self.config) or qd
            self._qdecode_batched_cache = qd
        return self._qdecode_batched_cache

    def _qd_for(self, batch: int):
        """The qd serving a decode at this batch size."""
        from .model.qdecode import qf_supported
        qd = self._qdecode
        if qd is not None and not qf_supported(qd, batch):
            return self._qdecode_batched
        return qd

    @property
    def _qf_mode(self) -> Optional[str]:
        """Cache mode of the fused decode step (ComputeConfig.kv_mode):
        "auto" resolves to "cross8" as in the JAX package; "scan" (and
        weights without the int8 step) to None: the scan step
        ``decode_step_q``, or the plain step for f32 weights."""
        if self._qdecode is None:
            return None
        mode = self.compute.kv_mode
        if mode == "scan":
            return None
        return "cross8" if mode == "auto" else mode

    def compute_mel(self, audio: np.ndarray) -> np.ndarray:
        """30 s-padded log-mel [2*n_audio_ctx, n_mels] (host array)."""
        return self.mel_filters.compute_30s(
            np.asarray(audio, dtype=np.float32),
            n_frames=2 * self.config.n_audio_ctx)

    def _encode_clips(self, audios: Sequence[np.ndarray]) -> torch.Tensor:
        """Encoder features [B, S, D] of 30 s-padded clips, mel on the
        device."""
        return self.encode(torch.stack([
            self.mel_filters.compute_30s_device(
                np.asarray(a, np.float32),
                n_frames=2 * self.config.n_audio_ctx, device=self.device)
            for a in audios]))

    def encode(self, mel) -> torch.Tensor:
        """Encoder features; accepts [T, M] or [B, T, M]."""
        mel = torch.as_tensor(mel, device=self.device)
        if mel.ndim == 2:
            mel = mel[None]
        return encode_fn(self.params, mel, self.config, self._compute_dtype,
                         self._use_flash)

    def get_initial_tokens(self, language: str, task: str = "transcribe",
                           timestamps: bool = False) -> List[int]:
        """[SOT, lang?, task, NO_TIMESTAMPS?] (reference: src/lib.rs:455)."""
        sp = self.specials
        tokens = [sp.sot]
        if sp.is_multilingual:
            off = st.language_offset(language)
            tokens.append(sp.lang_base + (off if off is not None else 0))
        tokens.append(sp.translate if task == "translate" else sp.transcribe)
        if not timestamps:
            tokens.append(sp.no_timestamps)
        bad = [t for t in tokens if t >= self.config.n_vocab]
        if bad:
            raise ModelError(
                f"prompt tokens {bad} out of range for n_vocab="
                f"{self.config.n_vocab}")
        return tokens

    # -- language detection ----------------------------------------------------
    def detect_language(self, audio: np.ndarray) -> LanguageProbs:
        """(reference: src/lib.rs:495 detect_language)"""
        return self.detect_language_from_features(
            self.encode(self.compute_mel(audio)))

    def detect_language_from_features(self, enc_out: torch.Tensor
                                      ) -> LanguageProbs:
        cache = init_cache(self.params, enc_out, self.config, max_len=8,
                           compute_dtype=self._compute_dtype)
        sot = torch.full((enc_out.shape[0], 1), self.specials.sot,
                         dtype=torch.int64, device=self.device)
        logits, _ = prefill(self.params, sot, enc_out, cache, self.config,
                            compute_dtype=self._compute_dtype)
        return LanguageProbs.from_logits(logits[0].float().cpu().numpy(),
                                         lang_base=self.specials.lang_base)

    # -- transcription -----------------------------------------------------------
    def transcribe(self, audio: np.ndarray,
                   options: Optional[TranscribeOptions] = None
                   ) -> TranscriptionResult:
        """Transcribe one clip (reference: src/lib.rs:364)."""
        return self.transcribe_batch([audio], options).results[0]

    def _needs_retry(self, result: TranscriptionResult,
                     options: TranscribeOptions) -> bool:
        prompt_n = len(self.get_initial_tokens(
            result.language or "en", options.task, options.timestamps))
        gen = max(len(result.tokens) - prompt_n, 1)  # generated incl. EOT
        return needs_fallback(
            result.text, result.avg_logprob, gen,
            logprob_thold=options.logprob_thold,
            compression_thold=options.compression_ratio_thold,
            entropy_thold=options.entropy_thold,
            tokens=result.tokens,
            no_speech_prob=result.no_speech_prob,
            no_speech_thold=options.no_speech_thold)

    def _skip_if_silence(self, result: TranscriptionResult,
                         options: TranscribeOptions) -> TranscriptionResult:
        if is_silence(result.no_speech_prob, result.avg_logprob,
                      no_speech_thold=options.no_speech_thold,
                      logprob_thold=options.logprob_thold):
            # segment skipped as silence (OpenAI's should_skip rule)
            return dataclasses.replace(
                result, text="", segments=[], tokens=[], words=[])
        return result

    def transcribe_with_fallback(self, audio: np.ndarray,
                                 options: Optional[TranscribeOptions] = None,
                                 temperatures: Sequence[float] = DEFAULT_TEMPERATURES
                                 ) -> TranscriptionResult:
        """whisper.cpp-style temperature fallback: retry at increasing
        temperature until the quality gates pass (average log-prob,
        compression ratio, token entropy). A high no-speech probability
        never retries; if the average log-prob is also below its threshold
        the clip is skipped as silence (empty text)."""
        options = options or TranscribeOptions()
        result = None
        for t in temperatures:
            opts = dataclasses.replace(
                options, temperature=t,
                strategy="greedy" if t == 0.0 else "sampling")
            result = self.transcribe(audio, opts)
            if not self._needs_retry(result, options):
                break
        return self._skip_if_silence(result, options) if result else result

    def transcribe_batch_with_fallback(
            self, audios: Sequence[np.ndarray],
            options: Optional[TranscribeOptions] = None,
            temperatures: Sequence[float] = DEFAULT_TEMPERATURES
            ) -> BatchTranscriptionResult:
        """Batched temperature fallback: the whole batch decodes at the
        first temperature in one call; only the clips that fail the gates
        decode again at each higher temperature."""
        t0 = time.time()
        options = options or TranscribeOptions()
        first = dataclasses.replace(
            options, temperature=temperatures[0],
            strategy="greedy" if temperatures[0] == 0.0 else "sampling")
        results = list(self.transcribe_batch(audios, first).results)
        pending = [i for i, r in enumerate(results)
                   if self._needs_retry(r, options)]
        for t in temperatures[1:]:
            if not pending:
                break
            opts = dataclasses.replace(options, temperature=t,
                                       strategy="sampling")
            retry = self.transcribe_batch([audios[i] for i in pending], opts)
            still = []
            for i, r in zip(pending, retry.results):
                results[i] = r
                if self._needs_retry(r, options):
                    still.append(i)
            pending = still
        results = [self._skip_if_silence(r, options) for r in results]
        return BatchTranscriptionResult(results, time.time() - t0)

    def _language(self, audio: np.ndarray, language: Optional[str]) -> str:
        """The given language, or the one detected from ``audio``."""
        if language not in (None, "auto"):
            return language
        if not self.specials.is_multilingual:
            return "en"
        mel = self.mel_filters.compute_30s_device(
            audio, n_frames=2 * self.config.n_audio_ctx, device=self.device)
        return self.detect_language_from_features(self.encode(mel)).best[0]

    def _suppress_bias(self, timestamps: bool) -> torch.Tensor:
        return torch.from_numpy(WhisperTokenSuppressor(
            suppress_timestamps=not timestamps, n_vocab=self.config.n_vocab,
            tokens=self.specials).bias()).to(self.device)

    @property
    def _no_speech_id(self) -> int:
        ns = self.specials.no_speech
        return ns if ns < self.config.n_vocab else -1

    def _max_tokens(self, options: TranscribeOptions) -> int:
        return min(options.max_tokens or self.config.n_text_ctx,
                   self.config.n_text_ctx)

    def transcribe_batch(self, audios: Sequence[np.ndarray],
                         options: Optional[TranscribeOptions] = None
                         ) -> BatchTranscriptionResult:
        """Transcription of a batch of clips in one decode (the language,
        when not given, is detected from the first clip): greedy through
        ``pipeline.fused_transcribe_step`` (timestamp tokens with
        ``timestamps``), sampling (``strategy="sampling"``, or greedy at a
        temperature above 0: ``best_of`` samples per clip, the best by
        average log-prob; ``top_k``, ``top_p``; a generator seeded from
        ``seed``) or beam search (``beam_size``, ``patience``)."""
        with trace_span("batch", windows=len(audios)):
            return self._transcribe_batch(audios, options)

    def _transcribe_batch(self, audios: Sequence[np.ndarray],
                          options: Optional[TranscribeOptions]
                          ) -> BatchTranscriptionResult:
        t0 = time.time()
        options = options or TranscribeOptions()
        if not audios:
            raise ValueError("transcribe_batch needs at least one clip")

        lang = self._language(audios[0], options.language)
        prompt_list = self.get_initial_tokens(lang, options.task,
                                              options.timestamps)
        P = len(prompt_list)
        prompt = torch.tensor([prompt_list] * len(audios), dtype=torch.int64,
                              device=self.device)
        bias = self._suppress_bias(options.timestamps
                                   or options.word_timestamps)
        if options.hotwords:
            return self._transcribe_hotwords(audios, options, lang,
                                             prompt_list, bias, t0)
        if (options.speculative and len(audios) == 1
                and options.strategy == "greedy"
                and options.temperature == 0.0 and not options.timestamps):
            return self._transcribe_speculative(audios[0], options, lang,
                                                prompt, bias, t0)
        eot = self.specials.eot
        common = dict(max_len=self._max_tokens(options), prompt_len=P,
                      compute_dtype=self._compute_dtype,
                      no_speech=self._no_speech_id, qf_mode=self._qf_mode)

        if options.strategy == "sampling" or (
                options.strategy == "greedy" and options.temperature > 0):
            enc = self._encode_clips(audios)
            B, n = enc.shape[0], max(1, options.best_of)
            # best_of: n independent samples per clip as one batch, the
            # winner by length-normalized log-prob
            gen = torch.Generator(device=self.device).manual_seed(
                options.seed)
            res = sample_generate(
                self.params, enc.repeat_interleave(n, dim=0),
                prompt.repeat_interleave(n, dim=0), bias, eot, gen,
                self.config, temperature=options.temperature,
                top_k=options.top_k, top_p=options.top_p,
                qd=self._qd_for(B * n), **common)
            lens = res.lengths.reshape(B, n)
            sum_lp = res.sum_logprob.reshape(B, n)
            avg = sum_lp / torch.clamp_min(lens - P, 1).float()
            best = torch.argmax(avg, dim=1)[:, None]
            tokens = res.tokens.reshape(B, n, -1).gather(
                1, best[:, :, None].expand(-1, -1, res.tokens.shape[1]))[:, 0]
            lengths = lens.gather(1, best)[:, 0]
            sum_lp = sum_lp.gather(1, best)[:, 0]
            ns_prob = res.no_speech_prob.reshape(B, n)[:, 0]
        elif options.strategy == "beam":
            enc = self._encode_clips(audios)
            res = beam_generate(
                self.params, enc, prompt, bias, eot, self.config,
                beam_size=options.beam_size, patience=options.patience,
                qd=self._qd_for(enc.shape[0] * options.beam_size), **common)
            tokens, lengths = res.tokens, res.lengths
            sum_lp, ns_prob = res.sum_logprob, res.no_speech_prob
        else:
            from .pipeline import fused_transcribe_step, pad_audio_batch
            n_samples = 2 * self.config.n_audio_ctx * 160
            batch = torch.from_numpy(pad_audio_batch(audios, n_samples)).to(
                self.device)
            ts_base = self.specials.timestamp_base
            res = fused_transcribe_step(
                self.params, batch, *self.mel_filters.constants(self.device),
                prompt, bias, eot, self.config,
                timestamp_base=(ts_base if options.timestamps
                                and ts_base < self.config.n_vocab else -1),
                qd=self._qd_for(len(audios)), use_flash=self._use_flash,
                **common)
            tokens, lengths = res.tokens, res.lengths
            sum_lp, ns_prob = res.sum_logprob, res.no_speech_prob
        with trace_span("batch.host"):
            return self._batch_results(audios, options, lang, P, tokens,
                                       lengths, sum_lp, ns_prob, t0)

    def _batch_results(self, audios, options: TranscribeOptions, lang: str,
                       P: int, tokens, lengths, sum_lp, ns_prob,
                       t0: float) -> BatchTranscriptionResult:
        """Detokenized results and segments of a decoded batch."""
        with trace_span("sync"):
            tokens_np = tokens.cpu().numpy()
            lengths_np = lengths.cpu().numpy()
            sum_lp_np = sum_lp.cpu().numpy().astype(np.float64)
            ns_prob_np = ns_prob.cpu().numpy().astype(np.float64)

        results = []
        for i in range(len(audios)):
            toks = tokens_np[i, : lengths_np[i]].tolist()
            gen = toks[P:]
            text = self.tokenizer.decode_with_options(gen, skip_special=True)
            if has_timestamps(gen, self.specials.timestamp_base):
                segments = extract_segments(
                    gen, self.tokenizer,
                    timestamp_base=self.specials.timestamp_base,
                    eot=self.specials.eot,
                    default_end=len(audios[i]) / SAMPLE_RATE)
            else:
                segments = [Segment(0.0, len(audios[i]) / SAMPLE_RATE,
                                    text, gen)] if text.strip() else []
            results.append(TranscriptionResult(
                text=text.strip(), language=lang, segments=segments,
                tokens=toks,
                avg_logprob=float(sum_lp_np[i] / max(len(gen), 1)),
                no_speech_prob=float(ns_prob_np[i]),
                compression_ratio=compression_ratio(text.strip()),
                temperature=options.temperature))
        if options.word_timestamps:
            self._attach_word_timestamps(results, audios,
                                         method=options.word_alignment)
        return BatchTranscriptionResult(results, time.time() - t0)

    def _transcribe_speculative(self, audio: np.ndarray,
                                options: TranscribeOptions, lang: str,
                                prompt: torch.Tensor, bias: torch.Tensor,
                                t0: float) -> BatchTranscriptionResult:
        """One clip by ``speculative_greedy_generate`` (the JAX engine's
        branch, engine.py:536-570): ``draft_layers`` 0 takes a quarter of
        the decoder (at least one layer); one segment; the quality-gate
        signals the plain greedy path gives (average log-prob of the
        emitted tokens, no-speech probability at SOT)."""
        from .inference.speculative import speculative_greedy_generate
        mel = self.mel_filters.compute_30s_device(
            audio, n_frames=2 * self.config.n_audio_ctx, device=self.device)
        ld = options.draft_layers or max(1, self.config.n_text_layer // 4)
        P = prompt.shape[1]
        spec = speculative_greedy_generate(
            self.params, self.encode(mel), prompt, bias, self.specials.eot,
            self.config, max_len=self._max_tokens(options), prompt_len=P,
            draft_tokens=options.draft_tokens, draft_layers=ld,
            compute_dtype=self._compute_dtype, no_speech=self._no_speech_id)
        toks = spec.tokens[0, : int(spec.lengths[0])].tolist()
        gen = toks[P:]
        text = self.tokenizer.decode_with_options(gen, skip_special=True)
        segments = ([Segment(0.0, len(audio) / SAMPLE_RATE, text, gen)]
                    if text.strip() else [])
        return BatchTranscriptionResult([TranscriptionResult(
            text=text.strip(), language=lang, segments=segments, tokens=toks,
            avg_logprob=float(spec.sum_logprob[0]) / max(len(gen), 1),
            no_speech_prob=float(spec.no_speech_prob[0]))],
            time.time() - t0)

    def transcribe_nbest(self, audio: np.ndarray,
                         options: Optional[TranscribeOptions] = None,
                         n: Optional[int] = None) -> List[TranscriptionResult]:
        """N-best hypotheses from beam search, best first (reference:
        src/inference/beam.rs:300 decode_nbest). ``n`` defaults to the
        beam size; the results follow the normalized-score order."""
        options = options or TranscribeOptions(strategy="beam")
        n = min(n or options.beam_size, options.beam_size)
        audio = np.asarray(audio, np.float32)
        lang = self._language(audio, options.language)
        prompt_list = self.get_initial_tokens(lang, options.task,
                                              options.timestamps)
        P = len(prompt_list)
        res = beam_generate(
            self.params, self._encode_clips([audio]),
            torch.tensor([prompt_list], dtype=torch.int64,
                         device=self.device),
            self._suppress_bias(options.timestamps), self.specials.eot,
            self.config, beam_size=options.beam_size,
            patience=options.patience, max_len=self._max_tokens(options),
            prompt_len=P, compute_dtype=self._compute_dtype,
            return_nbest=True, no_speech=self._no_speech_id,
            qd=self._qd_for(options.beam_size), qf_mode=self._qf_mode)
        toks = res.tokens[0].cpu().numpy()       # [K, max_len]
        lens = res.lengths[0].cpu().numpy()      # [K]
        scores = res.sum_logprob[0].cpu().numpy()
        ns = float(res.no_speech_prob[0])
        out = []
        for k in range(min(n, toks.shape[0])):
            seq = toks[k, : lens[k]].tolist()
            gen = seq[P:]
            text = self.tokenizer.decode_with_options(gen, skip_special=True)
            out.append(TranscriptionResult(
                text=text.strip(), language=lang, segments=[], tokens=seq,
                avg_logprob=float(scores[k]) / max(len(gen), 1),
                no_speech_prob=ns))
        return out

    @staticmethod
    def parse_hotwords(items) -> List:
        """["phrase", "phrase:3.5", ("phrase", 4.0)] -> [(phrase, boost)]."""
        out = []
        for it in items or ():
            if isinstance(it, (tuple, list)):
                out.append((str(it[0]), float(it[1])))
            else:
                text, sep, boost = str(it).rpartition(":")
                if sep and _is_float(boost):
                    out.append((text, float(boost)))
                else:
                    out.append((str(it), 5.0))
        return out

    def _transcribe_hotwords(self, audios, options: TranscribeOptions,
                             lang: str, prompt_list: List[int],
                             bias: torch.Tensor, t0: float
                             ) -> BatchTranscriptionResult:
        """Host-stepped greedy decode with trie prefix boosts (reference:
        src/vocabulary/mod.rs:86 VocabularyCustomizer::apply, trie.rs:324
        apply_prefix_boost), the JAX engine's design: the boosts depend on
        the generated prefix, so the plain step (``decoder.decode_step``)
        runs one token at a time on the engine's device and each step's
        logits come to the host for the trie."""
        from .model.decoder import decode_step
        from .vocabulary import HotwordBooster

        booster = HotwordBooster(self.tokenizer)
        for phrase, boost in self.parse_hotwords(options.hotwords):
            booster.add_hotword(phrase, boost)

        enc = self._encode_clips(audios)
        B = enc.shape[0]
        max_tokens = self._max_tokens(options)
        cache = init_cache(self.params, enc, self.config, max_tokens,
                           compute_dtype=self._compute_dtype)
        prompt = torch.tensor([prompt_list] * B, dtype=torch.int64,
                              device=self.device)
        logits, cache = prefill(self.params, prompt, enc, cache, self.config,
                                compute_dtype=self._compute_dtype)
        bias_np = bias.cpu().numpy()
        eot = self.specials.eot
        P = len(prompt_list)
        seqs = [list(prompt_list) for _ in range(B)]
        done = [False] * B
        pos = P
        logits_np = logits.float().cpu().numpy()
        while pos < max_tokens and not all(done):
            nxt = []
            for i in range(B):
                row = booster.apply(logits_np[i] + bias_np, seqs[i][P:])
                tok = int(np.argmax(row)) if not done[i] else eot
                nxt.append(tok)
                if not done[i]:
                    seqs[i].append(tok)
                    done[i] = tok == eot
            if all(done) or pos + 1 >= max_tokens:
                break
            logits, cache = decode_step(
                self.params, torch.tensor(nxt, device=self.device), pos,
                cache, self.config, compute_dtype=self._compute_dtype)
            logits_np = logits.float().cpu().numpy()
            pos += 1

        results = []
        for i in range(B):
            gen = seqs[i][P:]
            text = self.tokenizer.decode_with_options(gen, skip_special=True)
            segments = ([Segment(0.0, len(audios[i]) / SAMPLE_RATE, text,
                                 gen)] if text.strip() else [])
            results.append(TranscriptionResult(
                text=text.strip(), language=lang, segments=segments,
                tokens=seqs[i], temperature=options.temperature))
        return BatchTranscriptionResult(results, time.time() - t0)

    def _attach_word_timestamps(self, results, audios,
                                method: str = "dtw") -> None:
        """Word-level timestamps by cross-attention alignment (reference:
        src/timestamps/alignment.rs): a teacher-forced traced forward over
        each result's tokens (``model/traced``), its cross-attention
        weights aligned per token (``method`` "dtw", the default, or the
        reference's per-token "peak"), tokens grouped into words, the
        boundaries snapped to nearby energy minima."""
        from .alignment import (AlignmentConfig, WordTimestampExtractor,
                                refine_boundaries_by_silence)
        from .model.traced import decoder_forward_traced
        extractor = WordTimestampExtractor(
            self.tokenizer, AlignmentConfig(method=method))
        for result, audio in zip(results, audios):
            if not result.tokens:
                continue
            enc = self.encode(self.compute_mel(audio))
            toks = torch.tensor([result.tokens], dtype=torch.int64,
                                device=self.device)
            _, _, weights = decoder_forward_traced(self.params, toks, enc,
                                                   self.config)
            n_frames = min(int(np.ceil(len(audio) / SAMPLE_RATE / 0.02)),
                           enc.shape[1])
            words = extractor.extract(weights.float().cpu().numpy(),
                                      result.tokens, n_frames)
            result.words = refine_boundaries_by_silence(
                words, np.asarray(audio, np.float32))

    # -- streaming / VAD --------------------------------------------------------
    def create_streaming_session(self,
                                 options: Optional[TranscribeOptions] = None,
                                 input_sample_rate: int = 44_100,
                                 config=None):
        """Real-time session (reference: src/lib.rs:1555):
        ``inference.streaming.StreamingSession``."""
        from .inference.streaming import StreamingSession
        return StreamingSession(self, options, input_sample_rate, config)

    def transcribe_partial(self, audio: np.ndarray, is_final: bool = False,
                           options: Optional[TranscribeOptions] = None
                           ) -> TranscriptionResult:
        """Transcribe a growing prefix (reference: src/lib.rs:1482)."""
        return self.transcribe(audio, options)

    # Prefix lengths round DOWN to a multiple of this. The JAX engine
    # chose 8 to reuse compiled shapes; it decides which tokens are forced,
    # so it is kept for equal results.
    PREFIX_BUCKET = 8

    def transcribe_prefixed(self, audio: np.ndarray,
                            prefix_tokens: Sequence[int],
                            options: Optional[TranscribeOptions] = None
                            ) -> TranscriptionResult:
        """Greedy transcription continuing a forced text prefix: the
        streaming-reuse path (reference machinery: StreamingKVCache::
        warm_up, src/model/decoder.rs:739). New audio changes every
        encoder position, so the previous partial's decoder K/V cannot be
        reused; its tokens are forced as a decode prefix instead, their
        self-attention rows rebuilt against the new encoder output in one
        prefill, and only the new suffix decodes step by step. Greedy
        continuation of a prefix the full decode itself produces gives the
        full decode's tokens (but for rounding at a near tie).

        The prefix is cut down to a multiple of ``PREFIX_BUCKET``; with no
        room left to decode at the budget, this is ``transcribe``.
        """
        from .pipeline import fused_transcribe_step, pad_audio_batch
        options = options or TranscribeOptions()
        lang = options.language or "en"
        initial = self.get_initial_tokens(lang, options.task,
                                          options.timestamps)
        prefix = [int(t) for t in prefix_tokens]
        keep = (len(prefix) // self.PREFIX_BUCKET) * self.PREFIX_BUCKET
        prompt_list = initial + prefix[:keep]
        max_tokens = self._max_tokens(options)
        if len(prompt_list) + 1 >= max_tokens:
            return self.transcribe(audio, options)

        n_samples = 2 * self.config.n_audio_ctx * 160
        batch = torch.from_numpy(pad_audio_batch([audio], n_samples)).to(
            self.device)
        res = fused_transcribe_step(
            self.params, batch, *self.mel_filters.constants(self.device),
            torch.tensor([prompt_list], dtype=torch.int64,
                         device=self.device),
            self._suppress_bias(options.timestamps), self.specials.eot,
            self.config, max_len=max_tokens, prompt_len=len(prompt_list),
            compute_dtype=self._compute_dtype, no_speech=self._no_speech_id,
            qd=self._qdecode, qf_mode=self._qf_mode,
            use_flash=self._use_flash)
        toks = res.tokens[0, : int(res.lengths[0])].tolist()
        gen = toks[len(initial):]            # prefix + new suffix
        text = self.tokenizer.decode_with_options(gen, skip_special=True)
        segments = ([Segment(0.0, len(audio) / SAMPLE_RATE, text.strip(),
                             gen)] if text.strip() else [])
        return TranscriptionResult(text=text.strip(), language=lang,
                                   segments=segments, tokens=toks)

    def transcribe_with_vad(self, audio: np.ndarray,
                            options: Optional[TranscribeOptions] = None
                            ) -> TranscriptionResult:
        """VAD-segmented transcription: only the speech spans, decoded in
        one ``transcribe_batch`` (reference: src/lib.rs:1237)."""
        from .vad import VoiceActivityDetector
        options = options or TranscribeOptions()
        audio = np.asarray(audio, dtype=np.float32)
        segments = VoiceActivityDetector().detect(audio)
        clips = [audio[s:e] for s, e in segments if e - s >= 400]
        if not clips:
            return TranscriptionResult("", options.language or "en", [], [])
        batch = self.transcribe_batch(clips, options)
        texts, segs, toks = [], [], []
        for (s, e), r in zip(segments, batch.results):
            if r.text:
                texts.append(r.text)
                segs.append(Segment(s / SAMPLE_RATE, e / SAMPLE_RATE,
                                    r.text, r.tokens))
                toks.extend(r.tokens)
        return TranscriptionResult(" ".join(texts),
                                   batch.results[0].language, segs, toks)

    def transcribe_long(self, audio: np.ndarray,
                        options: Optional[TranscribeOptions] = None,
                        overlap_seconds: float = 1.0,
                        fallback: bool = False) -> TranscriptionResult:
        """Audio of any length: windows of one encoder context (30 s for
        the standard models) overlapping by ``overlap_seconds`` (at most a
        quarter window), every window in one ``transcribe_batch`` (or
        ``transcribe_batch_with_fallback``), segment times offset by each
        window's start, texts stitched with the overlap's repeated words
        dropped (``inference.streaming.dedup_overlap_words``). Audio of
        one window is ``transcribe`` (``transcribe_with_fallback``)."""
        from .audio.batch import split_into_chunks
        from .inference.streaming import dedup_overlap_words
        options = options or TranscribeOptions()
        audio = np.asarray(audio, dtype=np.float32)
        window = 2 * self.config.n_audio_ctx * 160
        if len(audio) <= window:
            return (self.transcribe_with_fallback(audio, options) if fallback
                    else self.transcribe(audio, options))
        overlap = min(int(overlap_seconds * SAMPLE_RATE), window // 4)
        chunks = split_into_chunks(audio, chunk_samples=window,
                                   overlap_samples=overlap)
        batch = (self.transcribe_batch_with_fallback(chunks, options)
                 if fallback else self.transcribe_batch(chunks, options))
        step = (window - overlap) / SAMPLE_RATE
        texts, segs, toks = [], [], []
        for i, r in enumerate(batch.results):
            if not r.text:
                continue
            text = (dedup_overlap_words(texts[-1], r.text) if texts
                    else r.text)
            if not text:
                continue
            texts.append(text)
            toks.extend(r.tokens)
            offset = i * step
            for s in r.segments:
                segs.append(Segment(s.start + offset, s.end + offset,
                                    s.text, s.tokens))
        return TranscriptionResult(" ".join(texts),
                                   batch.results[0].language, segs, toks)

    # -- file helpers ----------------------------------------------------------
    def transcribe_file(self, path: str,
                        options: Optional[TranscribeOptions] = None
                        ) -> TranscriptionResult:
        """Transcribe a WAV file of any length (``transcribe_long``),
        resampled to 16 kHz first."""
        with open(path, "rb") as f:
            samples, sr = parse_wav(f.read())
        if sr != SAMPLE_RATE:
            samples = SincResampler(sr, SAMPLE_RATE).resample(samples)
        return self.transcribe_long(samples, options)
