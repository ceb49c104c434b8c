"""Transcription orchestration and user API.

Counterpart of ``faster_whisper_tpu/transcribe.py``:

- ``WhisperModel.transcribe``, the sequential path: the seek loop over
  30 s windows, language detection, prompts, the temperature-fallback
  ladder and the split of decoded tokens into timestamped segments, with
  the reference's decode policy reproduced as the JAX package reproduces
  it.  Log-mel runs on the host; each window is sliced on the device.
  While a window decodes, the next window is encoded ahead on a side
  stream (``FWT_SPEC_ENCODE``, on by default).
- ``BatchedInferencePipeline.transcribe``: the audio crosses to the device
  once (on the int16 grid; in slices under the VAD with
  ``FWT_PIPELINED_VAD=1``), the Silero VAD cuts it into speech chunks of
  at most 30 s, their log-mel runs on the device, and batches of chunks
  are encoded and beam-decoded together.
- ``vad_filter`` on both, ``restore_speech_timestamps``, and
  ``decode_audio`` for a path or file object (WAV and FLAC).
- ``word_timestamps`` on both: a teacher-forced alignment pass over each
  window's or batch's text (``models/engine.py::WhisperEngine.align``),
  the DTW on the host, the word splitting of ``tokenizer.py``, and the
  reference's word heuristics, with the hallucination-silence skipping of
  the sequential path.

Each encode runs kernel K3 on the card; each decode step K1 and K4 (K2 and
K4's int8 form on the int8 compute types, with W8A8 int8 weights).

``WhisperModel(model_size_or_path)`` loads a CTranslate2 (``model.bin``)
or HF safetensors directory, or the same files held in memory
(``files=``), with its ``tokenizer.json`` (``bpe.py``) and
``preprocessor_config.json``; a size name or repo id resolves in the local
Hugging Face cache only (``utils.py::download_model``): the port
downloads nothing.

``compute_type="int4"`` puts the decoder's weights and the logits head
at 4-bit range (``ops/quant.py::quantize_params_int4``, per output channel
or in groups of ``int4_group_size`` input rows) and the cross cache at
4-bit range; the encoder and the self cache stay at int8 range.

``BatchedInferencePipeline(model, scheduler=ContinuousBatcher(model))``
sends each request's chunks to a process-wide batcher
(``scheduler.py``), where the chunks of concurrent requests share device
batches.

``device_index=[...]`` with ``tensor_parallel=N`` builds a ("data",
"model") mesh (``WhisperModel._setup_mesh``): one replica per row, each
column/row-sharded over its row's N devices (``models/engine.py``).
"""

import contextlib
import itertools
import json
import logging
import os
import zlib

from collections import deque
from dataclasses import asdict, dataclass
from inspect import signature
from math import ceil
from typing import BinaryIO, Iterable, List, Optional, Tuple, Union
from warnings import warn

import numpy as np
import torch
import torch.nn.functional as F

from faster_whisper_tpu_torch.audio import decode_audio, pad_or_trim
from faster_whisper_tpu_torch.feature_extractor import FeatureExtractor
from faster_whisper_tpu_torch.generation.generate import after_first_launch
from faster_whisper_tpu_torch.ops.mel import assemble_segments, extract_window, upload_audio
from faster_whisper_tpu_torch.tokenizer import _LANGUAGE_CODES, Tokenizer
from faster_whisper_tpu_torch.utils import (
    download_model,
    format_timestamp,
    get_end,
    get_logger,
    phase_timer,
    resolve_device,
    side_stream,
    span,
)
from faster_whisper_tpu_torch.vad import (
    SpeechTimestampsMap,
    VadOptions,
    collect_chunks,
    get_speech_timestamps,
    speech_timestamps_from_probs,
    upload_with_vad,
)


@dataclass
class Word:
    start: float
    end: float
    word: str
    probability: float

    def _asdict(self):
        warn(
            "Word._asdict() method is deprecated, use dataclasses.asdict(Word) instead",
            DeprecationWarning,
            2,
        )
        return asdict(self)


@dataclass
class Segment:
    id: int
    seek: int
    start: float
    end: float
    text: str
    tokens: List[int]
    avg_logprob: float
    compression_ratio: float
    no_speech_prob: float
    words: Optional[List[Word]]
    temperature: Optional[float]

    def _asdict(self):
        warn(
            "Segment._asdict() method is deprecated, use dataclasses.asdict(Segment)"
            " instead",
            DeprecationWarning,
            2,
        )
        return asdict(self)


@dataclass
class TranscriptionOptions:
    beam_size: int
    best_of: int
    patience: float
    length_penalty: float
    repetition_penalty: float
    no_repeat_ngram_size: int
    log_prob_threshold: Optional[float]
    no_speech_threshold: Optional[float]
    compression_ratio_threshold: Optional[float]
    condition_on_previous_text: bool
    prompt_reset_on_temperature: float
    temperatures: List[float]
    initial_prompt: Optional[Union[str, Iterable[int]]]
    prefix: Optional[str]
    suppress_blank: bool
    suppress_tokens: Optional[List[int]]
    without_timestamps: bool
    max_initial_timestamp: float
    word_timestamps: bool
    prepend_punctuations: str
    append_punctuations: str
    multilingual: bool
    max_new_tokens: Optional[int]
    clip_timestamps: Union[str, List[float]]
    hallucination_silence_threshold: Optional[float]
    hotwords: Optional[str]


@dataclass
class TranscriptionInfo:
    language: str
    language_probability: float
    duration: float
    duration_after_vad: float
    all_language_probs: Optional[List[Tuple[str, float]]]
    transcription_options: TranscriptionOptions
    vad_options: Optional[VadOptions]


_PUNCTUATION = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"

# compute_type -> activation dtype (bf16 where GPUs' CT2 uses fp16); the
# int8 types add W8A8 int8 weights and int8 KV caches, int4 4-bit-range
# decoder weights and cross cache (ops/quant.py)
_COMPUTE_TYPES = {
    "default": torch.bfloat16,
    "auto": torch.bfloat16,
    "float16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "int8": torch.bfloat16,
    "int8_float16": torch.bfloat16,
    "int8_bfloat16": torch.bfloat16,
    "int8_float32": torch.float32,
    "int4": torch.bfloat16,
}


def _check_compute_type(compute_type: str) -> None:
    if compute_type not in _COMPUTE_TYPES:
        raise ValueError(f"unsupported compute_type: {compute_type}")


def _fallback_tokenizer(multilingual: bool):
    """The vocabulary of a model directory without ``tokenizer.json``:
    ``tokenizer.json`` of ``openai/whisper-tiny`` (``.en`` for an
    English-only model), as the reference reads it, from the local Hugging
    Face cache only (``download_model``).  Raises ``FileNotFoundError``
    naming the directories searched when the cache lacks it."""
    from faster_whisper_tpu_torch.bpe import BPETokenizer

    repo = "openai/whisper-tiny" + ("" if multilingual else ".en")
    snapshot = download_model(repo)
    path = os.path.join(snapshot, "tokenizer.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"the model directory has no tokenizer.json and the cached {repo} "
            f"snapshot {snapshot} has none either; faster_whisper_tpu_torch "
            "downloads nothing"
        )
    return BPETokenizer.from_file(path)


def _resolve_devices(device, device_index, tensor_parallel: int) -> List[torch.device]:
    """The model's devices, the parameters' first: the indices of
    ``device_index`` (an int or a list) that name visible devices, as the
    JAX package's rule drops the others; fewer than two of them are the
    one device of the first visible index (else of the first as given).
    Raises the JAX package's ValueErrors of ``tensor_parallel`` that need
    no config; ``WhisperModel._setup_mesh`` raises the head-count one."""
    from faster_whisper_tpu_torch.parallel.mesh import device_count

    idxs = list(device_index) if isinstance(device_index, (list, tuple)) else [device_index]
    if tensor_parallel > 1 and len(idxs) < tensor_parallel:
        raise ValueError(
            f"tensor_parallel={tensor_parallel} needs at least that "
            f"many devices in device_index (got {len(idxs)})"
        )
    first = _model_device(device, idxs[0])
    n = device_count(first.type)
    use = [i for i in idxs if 0 <= i < n]
    if tensor_parallel > 1 and len(use) < tensor_parallel:
        raise ValueError(
            f"tensor_parallel={tensor_parallel} needs at least that "
            f"many visible devices (device_index resolved to "
            f"{len(use)} of {n} available)"
        )
    if len(use) < 2:
        return [_model_device(device, use[0]) if use else first]
    if tensor_parallel > 1 and len(use) % tensor_parallel:
        raise ValueError(
            f"tensor_parallel={tensor_parallel} must divide the "
            f"device count {len(use)}"
        )
    return [first if first.type == "cpu" else torch.device("cuda", i) for i in use]


def _model_device(device, device_index: int) -> torch.device:
    """``"auto"``, ``"cuda"`` and ``"cuda:N"`` are the card (``device_index``
    picks it for the first two), ``"cpu"`` the host; without a card the
    card raises, with no fallback to the host."""
    if device in ("auto", "cuda"):
        device = f"cuda:{device_index}"
    if str(device).split(":")[0] not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {device!r} (the card, 'cuda', or 'cpu')")
    return resolve_device(device)


class _SideEncode:
    """A window encoded ahead of the window that will read it.

    On the card the encode runs on the speculative-encode stream
    (``utils.side_stream``) of every card of the model's group (``devices``,
    the window's first; one card without a model axis): each first waits
    for an event recorded on the caller's stream of its card after the
    window was made, and the window is recorded to the lead's side stream so
    that its memory outlives the encode; an event recorded after the
    encode on each side stream marks its part done.  ``result()`` makes
    each card's current stream wait for its event and records the states
    to the lead's.  On the CPU there is one stream and the encode runs in
    line."""

    __slots__ = ("output", "done")

    def __init__(self, encode, window: torch.Tensor, devices=None):
        dev = window.device
        self.done = []
        if dev.type != "cuda":
            self.output = encode(window)
            return
        devices = list(dict.fromkeys(devices or [dev]))
        sides = []
        for d in devices:
            side = side_stream(d, "speculative encode")
            made = torch.cuda.Event()
            made.record(torch.cuda.current_stream(d))
            side.wait_event(made)
            sides.append(side)
        window.record_stream(sides[0])
        with contextlib.ExitStack() as stack:
            for side in sides:
                stack.enter_context(torch.cuda.stream(side))
            self.output = encode(window)
            for side in sides:
                done = torch.cuda.Event()
                done.record(side)
                self.done.append((side.device, done))

    def result(self) -> torch.Tensor:
        for d, done in self.done:
            torch.cuda.current_stream(d).wait_event(done)
        if self.done:
            self.output.record_stream(torch.cuda.current_stream(self.output.device))
        return self.output


class WhisperModel:
    def __init__(
        self,
        model_size_or_path: str,
        device: str = "auto",
        device_index: Union[int, List[int]] = 0,
        compute_type: str = "default",
        cpu_threads: int = 0,
        num_workers: int = 1,
        download_root: Optional[str] = None,
        local_files_only: bool = False,
        files: Optional[dict] = None,
        revision: Optional[str] = None,
        use_auth_token: Optional[Union[str, bool]] = None,
        tensor_parallel: int = 1,
        int4_group_size: Optional[int] = None,
        **model_kwargs,
    ):
        """Load a Whisper model.

        ``model_size_or_path`` is a CTranslate2-converted directory
        (``model.bin``), an HF-format directory (``*.safetensors``), or a
        size name (tiny..large-v3, turbo, distil-*) or Hub repo id found in
        the local Hugging Face cache (``download_model``; nothing is
        downloaded).  ``files`` holds the directory's files in memory (name
        -> bytes or file-like) instead.  ``device`` is the card
        (``"auto"``, ``"cuda"``, ``"cuda:N"``, with ``device_index``) or
        ``"cpu"``; without a card the card raises.  A list of device indices
        builds a data mesh, one replica per device (``_setup_mesh``).  ``compute_type``: default/float16/bfloat16 ->
        bf16, float32, the int8 types (W8A8 weights, int8 KV caches) and
        int4 (4-bit-range decoder weights and cross cache, with one scale
        per group of ``int4_group_size`` input rows when it is given).
        Without ``tokenizer.json`` the vocabulary of ``openai/whisper-tiny``
        (``.en`` for an English-only model) is read from the local Hugging
        Face cache.  ``cpu_threads`` and ``num_workers`` are accepted and
        ignored."""
        from faster_whisper_tpu_torch.bpe import BPETokenizer
        from faster_whisper_tpu_torch.models.load import load_model, read_blob

        self.logger = get_logger()
        _check_compute_type(compute_type)
        devices = _resolve_devices(device, device_index, tensor_parallel)
        dev = devices[0]
        if cpu_threads:
            self.logger.warning(
                "cpu_threads=%d is ignored: the model runs on its device and "
                "PyTorch manages host threading.", cpu_threads,
            )
        if num_workers != 1:
            self.logger.warning(
                "num_workers=%d is ignored: use BatchedInferencePipeline for "
                "parallel throughput.", num_workers,
            )

        tokenizer_bytes, preprocessor_bytes = None, None
        if files:
            files = dict(files)
            model_path = model_size_or_path
            tokenizer_bytes = files.pop("tokenizer.json", None)
            preprocessor_bytes = files.pop("preprocessor_config.json", None)
        elif os.path.isdir(model_size_or_path):
            model_path = model_size_or_path
        else:
            model_path = download_model(
                model_size_or_path,
                local_files_only=local_files_only,
                cache_dir=download_root,
                revision=revision,
                use_auth_token=use_auth_token,
            )

        params, config = load_model(
            model_path, dtype=_COMPUTE_TYPES[compute_type], files=files, device=dev
        )

        tokenizer_file = os.path.join(model_path, "tokenizer.json")
        if tokenizer_bytes:
            hf_tokenizer = BPETokenizer.from_buffer(read_blob(tokenizer_bytes))
        elif os.path.isfile(tokenizer_file):
            hf_tokenizer = BPETokenizer.from_file(tokenizer_file)
        else:
            hf_tokenizer = _fallback_tokenizer(config.is_multilingual)

        self._setup(
            params, config, hf_tokenizer,
            self._get_feature_kwargs(model_path, config, preprocessor_bytes),
            compute_type, dev, int4_group_size,
        )
        self._setup_mesh(devices, tensor_parallel)

    @classmethod
    def from_parts(
        cls,
        params,
        config,
        hf_tokenizer,
        feature_extractor_kwargs: Optional[dict] = None,
        compute_type: str = "default",
        device_index: Union[int, List[int]] = 0,
        tensor_parallel: int = 1,
        int4_group_size: Optional[int] = None,
        device="cuda",
    ) -> "WhisperModel":
        """Build a WhisperModel from in-memory pieces: a float parameter
        tree (``models/load.py``), its config and a base tokenizer.  The
        parameters are moved to ``device`` (default the card, the one of
        ``device_index``, or with a list of indices one replica per device,
        ``_setup_mesh``; without a card this raises) and cast to the compute
        type's dtype; the card's kernels take bfloat16 and float32.  The
        int8 compute types then quantize the cast tree
        (``ops/quant.py::quantize_params``) and decode over int8 KV caches;
        int4 quantizes it with ``quantize_params_int4(group_size=
        int4_group_size)``."""
        _check_compute_type(compute_type)
        devices = _resolve_devices(device, device_index, tensor_parallel)
        self = cls.__new__(cls)
        self.logger = get_logger()
        self._setup(
            params, config, hf_tokenizer, feature_extractor_kwargs, compute_type, devices[0],
            int4_group_size,
        )
        self._setup_mesh(devices, tensor_parallel)
        return self

    def _setup_mesh(self, devices: List[torch.device], tensor_parallel: int = 1):
        """More than one device (``_resolve_devices``): the reference's
        ``device_index=[0, 1, ...]`` loads one replica per GPU.  As the JAX
        package's mesh, the devices form a ("data", "model") mesh of
        ``len(devices) // tensor_parallel`` x ``tensor_parallel``
        (``parallel/mesh.py``, ``self.mesh``; None on one device).  The
        engine holds one replica of the parameters per row and splits each
        batch whose rows the data size divides over them; with
        ``tensor_parallel > 1`` each replica is column/row-sharded over its
        row's devices in the Megatron layouts, one host thread driving the
        group (``models/engine.py``).  A device may be listed twice:
        ``[0, 0]`` puts two replicas, or two shards, on ``cuda:0``.
        ``tensor_parallel`` must divide the head counts (the JAX package's
        ValueError)."""
        from faster_whisper_tpu_torch.parallel.mesh import make_mesh

        self.mesh = None
        if tensor_parallel > 1:
            cfg = self.model.config
            if cfg.n_text_head % tensor_parallel or cfg.n_audio_head % tensor_parallel:
                raise ValueError(
                    f"tensor_parallel={tensor_parallel} must divide the "
                    f"attention head counts "
                    f"({cfg.n_audio_head}/{cfg.n_text_head})"
                )
        if len(devices) < 2:
            return
        self.mesh = make_mesh(
            n_devices=len(devices), data=len(devices) // tensor_parallel, model=tensor_parallel,
            devices=devices,
        )
        self.model.set_mesh(self.mesh)

    def _setup(
        self, params, config, hf_tokenizer, feature_extractor_kwargs, compute_type, dev,
        int4_group_size=None,
    ):
        from faster_whisper_tpu_torch.models.engine import WhisperEngine
        from faster_whisper_tpu_torch.ops.quant import quantize_params, quantize_params_int4

        dtype = _COMPUTE_TYPES[compute_type]

        def move(tree):
            if isinstance(tree, dict):
                return {k: move(v) for k, v in tree.items()}
            return tree.to(device=dev, dtype=dtype)

        self.hf_tokenizer = hf_tokenizer
        int4 = compute_type == "int4"
        kv_int8 = compute_type.startswith("int8") or int4
        params = move(params)
        if int4:
            params = quantize_params_int4(params, group_size=int4_group_size)
        elif kv_int8:
            params = quantize_params(params)
        self.model = WhisperEngine(params, config, hf_tokenizer, kv_int8=kv_int8, int4=int4)
        self.feat_kwargs = dict(feature_extractor_kwargs or {})
        self.feat_kwargs.setdefault("feature_size", config.n_mels)
        self.feature_extractor = FeatureExtractor(**self.feat_kwargs)
        self.feature_extractor.device = dev  # the whole-file log-mel's device
        self.input_stride = 2
        self.frames_per_second = (
            self.feature_extractor.sampling_rate // self.feature_extractor.hop_length
        )
        self.tokens_per_second = self.feature_extractor.sampling_rate // (
            self.feature_extractor.hop_length * self.input_stride
        )
        self.time_precision = 0.02
        self.max_length = 448

    def _get_feature_kwargs(self, model_path, config, preprocessor_bytes=None) -> dict:
        """The FeatureExtractor arguments of ``preprocessor_config.json``
        (from ``files=`` or the directory).  ``feature_size`` defaults to
        the model's mel count, with the file or without one."""
        from faster_whisper_tpu_torch.models.load import read_blob

        kwargs = {}
        config_path = os.path.join(model_path, "preprocessor_config.json")
        try:
            if preprocessor_bytes is not None:
                kwargs = json.loads(read_blob(preprocessor_bytes))
            elif os.path.isfile(config_path):
                with open(config_path, "r", encoding="utf-8") as f:
                    kwargs = json.load(f)
        except json.JSONDecodeError as e:
            self.logger.warning("Could not load preprocessor config: %s", e)
            kwargs = {}
        valid_keys = signature(FeatureExtractor.__init__).parameters.keys()
        kwargs = {k: v for k, v in kwargs.items() if k in valid_keys and k != "self"}
        kwargs.setdefault("feature_size", config.n_mels)
        return kwargs

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def supported_languages(self) -> List[str]:
        return list(_LANGUAGE_CODES) if self.model.is_multilingual else ["en"]

    # ------------------------------------------------------------------
    # Sequential transcription
    # ------------------------------------------------------------------

    def transcribe(
        self,
        audio: Union[str, BinaryIO, np.ndarray],
        language: Optional[str] = None,
        task: str = "transcribe",
        log_progress: bool = False,
        beam_size: int = 5,
        best_of: int = 5,
        patience: float = 1,
        length_penalty: float = 1,
        repetition_penalty: float = 1,
        no_repeat_ngram_size: int = 0,
        temperature: Union[float, List[float], Tuple[float, ...]] = [
            0.0, 0.2, 0.4, 0.6, 0.8, 1.0,
        ],
        compression_ratio_threshold: Optional[float] = 2.4,
        log_prob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = True,
        prompt_reset_on_temperature: float = 0.5,
        initial_prompt: Optional[Union[str, Iterable[int]]] = None,
        prefix: Optional[str] = None,
        suppress_blank: bool = True,
        suppress_tokens: Optional[List[int]] = [-1],
        without_timestamps: bool = False,
        max_initial_timestamp: float = 1.0,
        word_timestamps: bool = False,
        prepend_punctuations: str = "\"'“¿([{-",
        append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
        multilingual: bool = False,
        vad_filter: bool = False,
        vad_parameters: Optional[Union[dict, VadOptions]] = None,
        max_new_tokens: Optional[int] = None,
        chunk_length: Optional[int] = None,
        clip_timestamps: Union[str, List[float]] = "0",
        hallucination_silence_threshold: Optional[float] = None,
        hotwords: Optional[str] = None,
        language_detection_threshold: Optional[float] = 0.5,
        language_detection_segments: int = 1,
    ) -> Tuple[Iterable[Segment], TranscriptionInfo]:
        """Transcribe a file (WAV or FLAC), a file object, or a float32
        mono waveform at 16 kHz.

        Same argument semantics as the JAX package's (and the reference's)
        ``WhisperModel.transcribe``; returns (lazy generator over Segment,
        TranscriptionInfo).  ``log_progress`` logs each window at INFO.
        With ``vad_filter`` the Silero VAD runs on the model's device."""
        sampling_rate = self.feature_extractor.sampling_rate

        if multilingual and not self.model.is_multilingual:
            self.logger.warning(
                "The current model is English-only but the multilingual parameter is"
                " set to True; setting to False instead."
            )
            multilingual = False

        if not isinstance(audio, np.ndarray):
            audio = decode_audio(audio, sampling_rate=sampling_rate)

        duration = audio.shape[0] / sampling_rate
        duration_after_vad = duration
        self.logger.info("Processing audio with duration %s", format_timestamp(duration))

        if vad_filter and clip_timestamps == "0":
            if vad_parameters is None:
                vad_parameters = VadOptions()
            elif isinstance(vad_parameters, dict):
                vad_parameters = VadOptions(**vad_parameters)
            speech_chunks = get_speech_timestamps(audio, vad_parameters, device=self.device)
            audio_chunks, _chunks_metadata = collect_chunks(audio, speech_chunks)
            audio = np.concatenate(audio_chunks, axis=0)
            duration_after_vad = audio.shape[0] / sampling_rate

            self.logger.info(
                "VAD filter removed %s of audio",
                format_timestamp(duration - duration_after_vad),
            )
            if self.logger.isEnabledFor(logging.DEBUG):
                self.logger.debug(
                    "VAD filter kept the following audio segments: %s",
                    ", ".join(
                        "[%s -> %s]"
                        % (
                            format_timestamp(chunk["start"] / sampling_rate),
                            format_timestamp(chunk["end"] / sampling_rate),
                        )
                        for chunk in speech_chunks
                    ),
                )
        else:
            speech_chunks = None

        features = self.feature_extractor(audio, chunk_length=chunk_length, return_device=True)

        all_language_probs = None
        if language is None:
            if not self.model.is_multilingual:
                language = "en"
                language_probability = 1
            else:
                start_timestamp = (
                    float(clip_timestamps.split(",")[0])
                    if isinstance(clip_timestamps, str)
                    else clip_timestamps[0]
                )
                content_frames = features.shape[-1] - 1
                seek = (
                    int(start_timestamp * self.frames_per_second)
                    if start_timestamp * self.frames_per_second < content_frames
                    else 0
                )
                (
                    language,
                    language_probability,
                    all_language_probs,
                ) = self.detect_language(
                    features=features[..., seek:],
                    language_detection_segments=language_detection_segments,
                    language_detection_threshold=language_detection_threshold,
                )
                self.logger.info(
                    "Detected language '%s' with probability %.2f",
                    language,
                    language_probability,
                )
        else:
            if not self.model.is_multilingual and language != "en":
                self.logger.warning(
                    "The current model is English-only but the language parameter is"
                    " set to '%s'; using 'en' instead." % language
                )
                language = "en"
            language_probability = 1

        tokenizer = Tokenizer(
            self.hf_tokenizer, self.model.is_multilingual, task=task, language=language
        )

        options = TranscriptionOptions(
            beam_size=beam_size,
            best_of=best_of,
            patience=patience,
            length_penalty=length_penalty,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size,
            log_prob_threshold=log_prob_threshold,
            no_speech_threshold=no_speech_threshold,
            compression_ratio_threshold=compression_ratio_threshold,
            condition_on_previous_text=condition_on_previous_text,
            prompt_reset_on_temperature=prompt_reset_on_temperature,
            temperatures=(
                temperature if isinstance(temperature, (list, tuple)) else [temperature]
            ),
            initial_prompt=initial_prompt,
            prefix=prefix,
            suppress_blank=suppress_blank,
            suppress_tokens=(
                get_suppressed_tokens(tokenizer, suppress_tokens)
                if suppress_tokens
                else suppress_tokens
            ),
            without_timestamps=without_timestamps,
            max_initial_timestamp=max_initial_timestamp,
            word_timestamps=word_timestamps,
            prepend_punctuations=prepend_punctuations,
            append_punctuations=append_punctuations,
            multilingual=multilingual,
            max_new_tokens=max_new_tokens,
            clip_timestamps=clip_timestamps,
            hallucination_silence_threshold=hallucination_silence_threshold,
            hotwords=hotwords,
        )

        encoder_output = None
        segments = self.generate_segments(
            features, tokenizer, options, log_progress, encoder_output
        )

        if speech_chunks:
            segments = restore_speech_timestamps(segments, speech_chunks, sampling_rate)

        info = TranscriptionInfo(
            language=language,
            language_probability=language_probability,
            duration=duration,
            duration_after_vad=duration_after_vad,
            transcription_options=options,
            vad_options=vad_parameters,
            all_language_probs=all_language_probs,
        )
        return segments, info

    def _split_segments_by_timestamps(
        self,
        tokenizer: Tokenizer,
        tokens: List[int],
        time_offset: float,
        segment_size: int,
        segment_duration: float,
        seek: int,
    ):
        current_segments = []
        tsb = tokenizer.timestamp_begin
        single_timestamp_ending = len(tokens) >= 2 and tokens[-2] < tsb <= tokens[-1]

        # indices where two timestamps are adjacent (segment boundaries)
        consecutive = [
            i for i in range(1, len(tokens)) if tokens[i] >= tsb and tokens[i - 1] >= tsb
        ]

        if consecutive:
            slices = list(consecutive)
            if single_timestamp_ending:
                slices.append(len(tokens))

            last_slice = 0
            for current_slice in slices:
                sliced = tokens[last_slice:current_slice]
                start_pos = sliced[0] - tsb
                end_pos = sliced[-1] - tsb
                current_segments.append(
                    dict(
                        seek=seek,
                        start=time_offset + start_pos * self.time_precision,
                        end=time_offset + end_pos * self.time_precision,
                        tokens=sliced,
                    )
                )
                last_slice = current_slice

            if single_timestamp_ending:
                # no speech after the last timestamp: advance a full window
                seek += segment_size
            else:
                # drop the unfinished tail, seek to the last timestamp
                last_pos = tokens[last_slice - 1] - tsb
                seek += last_pos * self.input_stride
        else:
            duration = segment_duration
            timestamps = [t for t in tokens if t >= tsb]
            if timestamps and timestamps[-1] != tsb:
                duration = (timestamps[-1] - tsb) * self.time_precision

            current_segments.append(
                dict(seek=seek, start=time_offset, end=time_offset + duration, tokens=tokens)
            )
            seek += segment_size

        return current_segments, seek, single_timestamp_ending

    def generate_segments(
        self,
        features: Union[np.ndarray, torch.Tensor],
        tokenizer: Tokenizer,
        options: TranscriptionOptions,
        log_progress,
        encoder_output=None,
    ) -> Iterable[Segment]:
        """The sequential seek loop: one encode and one fallback ladder per
        30 s window, yielding segments as they are decoded.  With word
        timestamps each window is aligned after its decode, and the seek
        follows the last word's end.  A caller's ``encoder_output`` serves
        the first window when it starts at frame 0.

        Speculative next-window encode: while a window decodes, the window
        that follows a full-window advance (``seek + segment_size``, what
        no-speech skips and single-timestamp endings give) is encoded
        ahead (``generate_with_fallback(after_dispatch=)``).  On the card
        that encode runs on a side stream beside the decode; the next
        window takes it only if its seek is the one predicted, so a miss
        costs device time and changes no output.  Off with
        ``word_timestamps`` or ``multilingual`` (other device work follows
        each decode there) and under ``FWT_SPEC_ENCODE=0``."""
        content_frames = features.shape[-1] - 1
        content_duration = float(content_frames * self.feature_extractor.time_per_frame)
        nb_max_frames = self.feature_extractor.nb_max_frames

        if isinstance(options.clip_timestamps, str):
            options.clip_timestamps = [
                float(ts)
                for ts in (options.clip_timestamps.split(",") if options.clip_timestamps else [])
            ]
        seek_points: List[int] = [
            round(ts * self.frames_per_second) for ts in options.clip_timestamps
        ]
        if len(seek_points) == 0:
            seek_points.append(0)
        if len(seek_points) % 2 == 1:
            seek_points.append(content_frames)
        seek_clips: List[Tuple[int, int]] = list(zip(seek_points[::2], seek_points[1::2]))

        idx = 0
        clip_idx = 0
        seek = seek_clips[clip_idx][0]
        all_tokens = []
        prompt_reset_since = 0

        if options.initial_prompt is not None:
            if isinstance(options.initial_prompt, str):
                all_tokens.extend(tokenizer.encode(" " + options.initial_prompt.strip()))
            else:
                all_tokens.extend(options.initial_prompt)

        # Features are padded on the device (host ones go there once);
        # every window is a slice there.
        features_padded = F.pad(torch.as_tensor(features, device=self.device), (0, nb_max_frames))
        last_speech_timestamp = 0.0

        speculate = (
            not options.word_timestamps
            and not options.multilingual
            and os.environ.get("FWT_SPEC_ENCODE", "1") != "0"
        )
        spec_seek, spec_output = None, None

        while clip_idx < len(seek_clips):
            seek_clip_start, seek_clip_end = seek_clips[clip_idx]
            if seek_clip_end > content_frames:
                seek_clip_end = content_frames
            if seek < seek_clip_start:
                seek = seek_clip_start
            if seek >= seek_clip_end:
                clip_idx += 1
                if clip_idx < len(seek_clips):
                    seek = seek_clips[clip_idx][0]
                continue

            time_offset = seek * self.feature_extractor.time_per_frame
            window_end_time = float((seek + nb_max_frames) * self.feature_extractor.time_per_frame)
            segment_size = min(nb_max_frames, content_frames - seek, seek_clip_end - seek)
            segment_duration = segment_size * self.feature_extractor.time_per_frame
            segment = extract_window(features_padded, seek, segment_size, nb_max_frames)

            if log_progress or self.logger.isEnabledFor(logging.DEBUG):
                self.logger.log(
                    logging.INFO if log_progress else logging.DEBUG,
                    "Processing segment at %s", format_timestamp(time_offset),
                )

            previous_tokens = all_tokens[prompt_reset_since:]

            if seek > 0 or encoder_output is None:
                if spec_seek == seek and spec_output is not None:
                    encoder_output = spec_output.result()  # speculation hit
                else:
                    encoder_output = self.encode(segment)
            spec_seek, spec_output = None, None

            if options.multilingual:
                results = self.model.detect_language(encoder_output)
                language_token, language_probability = results[0][0]
                language = language_token[2:-2]
                tokenizer.language = tokenizer.tokenizer.token_to_id(language_token)
                tokenizer.language_code = language

            prompt = self.get_prompt(
                tokenizer,
                previous_tokens,
                without_timestamps=options.without_timestamps,
                prefix=options.prefix if seek == 0 else None,
                hotwords=options.hotwords,
            )

            def _speculative_encode(
                seek=seek, segment_size=segment_size, seek_clip_end=seek_clip_end,
            ):
                pred = seek + segment_size
                if pred >= seek_clip_end or pred >= content_frames:
                    return
                pred_size = min(nb_max_frames, content_frames - pred, seek_clip_end - pred)
                pred_window = extract_window(features_padded, pred, pred_size, nb_max_frames)
                nonlocal spec_seek, spec_output
                spec_output = _SideEncode(self.encode, pred_window, self.model.group_devices())
                spec_seek = pred

            (
                result,
                avg_logprob,
                temperature,
                compression_ratio,
            ) = self.generate_with_fallback(
                encoder_output, prompt, tokenizer, options,
                after_dispatch=_speculative_encode if speculate else None,
            )

            if options.no_speech_threshold is not None:
                should_skip = result.no_speech_prob > options.no_speech_threshold
                if (
                    options.log_prob_threshold is not None
                    and avg_logprob > options.log_prob_threshold
                ):
                    # confident text despite high no-speech probability
                    should_skip = False

                if should_skip:
                    self.logger.debug(
                        "No speech threshold is met (%f > %f)",
                        result.no_speech_prob,
                        options.no_speech_threshold,
                    )
                    seek += segment_size
                    continue

            tokens = result.sequences_ids[0]
            previous_seek = seek

            current_segments, seek, single_timestamp_ending = self._split_segments_by_timestamps(
                tokenizer=tokenizer,
                tokens=tokens,
                time_offset=time_offset,
                segment_size=segment_size,
                segment_duration=segment_duration,
                seek=seek,
            )

            if options.word_timestamps:
                self.add_word_timestamps(
                    [current_segments],
                    tokenizer,
                    encoder_output,
                    segment_size,
                    options.prepend_punctuations,
                    options.append_punctuations,
                    last_speech_timestamp=last_speech_timestamp,
                )
                if not single_timestamp_ending:
                    last_word_end = get_end(current_segments)
                    if last_word_end is not None and last_word_end > time_offset:
                        seek = round(last_word_end * self.frames_per_second)

                if options.hallucination_silence_threshold is not None:
                    threshold = options.hallucination_silence_threshold
                    # a window that opens with an anomalous segment after a
                    # long gap is decoded again from that segment's start
                    first_segment = _next_words_segment(current_segments)
                    if first_segment is not None and _is_segment_anomaly(first_segment):
                        gap = first_segment["start"] - time_offset
                        if gap > threshold:
                            seek = previous_seek + round(gap * self.frames_per_second)
                            continue

                    # an anomalous segment with silence on both sides ends
                    # the window there
                    hal_last_end = last_speech_timestamp
                    for si in range(len(current_segments)):
                        segment_d = current_segments[si]
                        if not segment_d["words"]:
                            continue
                        if _is_segment_anomaly(segment_d):
                            next_segment = _next_words_segment(current_segments[si + 1 :])
                            if next_segment is not None:
                                hal_next_start = next_segment["words"][0]["start"]
                            else:
                                hal_next_start = time_offset + segment_duration
                            silence_before = (
                                segment_d["start"] - hal_last_end > threshold
                                or segment_d["start"] < threshold
                                or segment_d["start"] - time_offset < 2.0
                            )
                            silence_after = (
                                hal_next_start - segment_d["end"] > threshold
                                or _is_segment_anomaly(next_segment)
                                or window_end_time - segment_d["end"] < 2.0
                            )
                            if silence_before and silence_after:
                                seek = round(
                                    max(time_offset + 1, segment_d["start"]) * self.frames_per_second
                                )
                                if content_duration - segment_d["end"] < threshold:
                                    seek = content_frames
                                current_segments[si:] = []
                                break
                        hal_last_end = segment_d["end"]

                last_word_end = get_end(current_segments)
                if last_word_end is not None:
                    last_speech_timestamp = last_word_end

            for segment_d in current_segments:
                tokens = segment_d["tokens"]
                text = tokenizer.decode(tokens)

                if segment_d["start"] == segment_d["end"] or not text.strip():
                    continue

                all_tokens.extend(tokens)
                idx += 1

                yield Segment(
                    id=idx,
                    seek=previous_seek,
                    start=segment_d["start"],
                    end=segment_d["end"],
                    text=text,
                    tokens=tokens,
                    temperature=temperature,
                    avg_logprob=avg_logprob,
                    compression_ratio=compression_ratio,
                    no_speech_prob=result.no_speech_prob,
                    words=(
                        [Word(**word) for word in segment_d["words"]]
                        if options.word_timestamps
                        else None
                    ),
                )

            if (
                not options.condition_on_previous_text
                or temperature > options.prompt_reset_on_temperature
            ):
                if options.condition_on_previous_text:
                    self.logger.debug(
                        "Reset prompt. prompt_reset_on_temperature threshold is met"
                        " %f > %f",
                        temperature,
                        options.prompt_reset_on_temperature,
                    )
                prompt_reset_since = len(all_tokens)

    def encode(self, features) -> torch.Tensor:
        """Mel window(s) -> encoder states on the model's device."""
        return self.model.encode(features)

    def generate_with_fallback(
        self,
        encoder_output,
        prompt: List[int],
        tokenizer: Tokenizer,
        options: TranscriptionOptions,
        after_dispatch=None,
    ):
        """The temperature-fallback ladder: decode at each temperature in
        turn until the result passes the compression-ratio and log-prob
        tests.  Once a rung has failed and every remaining rung samples,
        the remaining rungs run as one batched call (a row per rung, each
        with its own temperature and generator), which picks the same
        result as running them in turn.

        ``after_dispatch`` (optional, called at most once) runs right after
        the first decode call is launched: inside its loop, once the
        prefill is queued and before the host first waits for the device
        (``generation/generate.py::after_first_launch``), whether that call
        is a serial rung or the batched tail.  The seek loop queues the
        speculative next-window encode there."""
        decode_result = None
        all_results = []
        below_cr_threshold_results = []

        max_initial_timestamp_index = int(
            round(options.max_initial_timestamp / self.time_precision)
        )
        if options.max_new_tokens is not None:
            max_length = len(prompt) + options.max_new_tokens
        else:
            max_length = self.max_length

        if max_length > self.max_length:
            raise ValueError(
                f"The length of the prompt is {len(prompt)}, and the `max_new_tokens` "
                f"{max_length - len(prompt)}. Thus, the combined length of the prompt "
                f"and `max_new_tokens` is: {max_length}. This exceeds the "
                f"`max_length` of the Whisper model: {self.max_length}. "
                "You should either reduce the length of your prompt, or "
                "reduce the value of `max_new_tokens`, "
                f"so that their combined length is less that {self.max_length}."
            )

        base_kwargs = dict(
            length_penalty=options.length_penalty,
            repetition_penalty=options.repetition_penalty,
            no_repeat_ngram_size=options.no_repeat_ngram_size,
            max_length=max_length,
            suppress_blank=options.suppress_blank,
            suppress_tokens=options.suppress_tokens,
            max_initial_timestamp_index=max_initial_timestamp_index,
        )

        def decode(*args, **kwargs):
            nonlocal after_dispatch
            hook, after_dispatch = after_dispatch, None
            if hook is None:
                return self.model.generate(*args, **kwargs)
            with after_first_launch(hook):
                return self.model.generate(*args, **kwargs)

        def rung_results():
            """Yield (result, temperature) in ladder order, lazily."""
            temps = list(options.temperatures)
            for i, temperature in enumerate(temps):
                tail = temps[i:]
                if len(tail) > 1 and all(t > 0 for t in tail) and encoder_output.shape[0] == 1:
                    n = len(tail)
                    results = decode(
                        encoder_output.expand((n,) + tuple(encoder_output.shape[1:])),
                        [prompt] * n,
                        **base_kwargs,
                        beam_size=1,
                        num_hypotheses=options.best_of,
                        sampling_topk=0,
                        sampling_temperature=list(tail),
                    )
                    yield from zip(results, tail)
                    return
                if temperature > 0:
                    kwargs = {
                        "beam_size": 1,
                        "num_hypotheses": options.best_of,
                        "sampling_topk": 0,
                        "sampling_temperature": temperature,
                    }
                else:
                    kwargs = {"beam_size": options.beam_size, "patience": options.patience}
                yield decode(encoder_output, [prompt], **base_kwargs, **kwargs)[0], temperature

        temperature = options.temperatures[-1]
        for result, temperature in rung_results():
            tokens = result.sequences_ids[0]

            # recover the length-normalized average log probability
            seq_len = len(tokens)
            cum_logprob = result.scores[0] * (seq_len ** options.length_penalty)
            avg_logprob = cum_logprob / (seq_len + 1)

            text = tokenizer.decode(tokens).strip()
            compression_ratio = get_compression_ratio(text)

            decode_result = (result, avg_logprob, temperature, compression_ratio)
            all_results.append(decode_result)

            needs_fallback = False

            if options.compression_ratio_threshold is not None:
                if compression_ratio > options.compression_ratio_threshold:
                    needs_fallback = True  # too repetitive
                    self.logger.debug(
                        "Compression ratio threshold is not met with temperature %.1f"
                        " (%f > %f)",
                        temperature,
                        compression_ratio,
                        options.compression_ratio_threshold,
                    )
                else:
                    below_cr_threshold_results.append(decode_result)

            if (
                options.log_prob_threshold is not None
                and avg_logprob < options.log_prob_threshold
            ):
                needs_fallback = True  # average log probability too low
                self.logger.debug(
                    "Log probability threshold is not met with temperature %.1f"
                    " (%f < %f)",
                    temperature,
                    avg_logprob,
                    options.log_prob_threshold,
                )

            if (
                options.no_speech_threshold is not None
                and result.no_speech_prob > options.no_speech_threshold
                and options.log_prob_threshold is not None
                and avg_logprob < options.log_prob_threshold
            ):
                needs_fallback = False  # silence: no point falling back

            if not needs_fallback:
                break
        else:
            # every temperature failed: pick the best average log probability
            decode_result = max(below_cr_threshold_results or all_results, key=lambda x: x[1])
            # report the final temperature for prompt_reset_on_temperature
            decode_result = (decode_result[0], decode_result[1], temperature, decode_result[3])

        return decode_result

    def get_prompt(
        self,
        tokenizer: Tokenizer,
        previous_tokens: List[int],
        without_timestamps: bool = False,
        prefix: Optional[str] = None,
        hotwords: Optional[str] = None,
    ) -> List[int]:
        prompt = []

        if previous_tokens or (hotwords and not prefix):
            prompt.append(tokenizer.sot_prev)
            if hotwords and not prefix:
                hotwords_tokens = tokenizer.encode(" " + hotwords.strip())
                if len(hotwords_tokens) >= self.max_length // 2:
                    hotwords_tokens = hotwords_tokens[: self.max_length // 2 - 1]
                prompt.extend(hotwords_tokens)
            if previous_tokens:
                prompt.extend(previous_tokens[-(self.max_length // 2 - 1) :])

        prompt.extend(tokenizer.sot_sequence)

        if without_timestamps:
            prompt.append(tokenizer.no_timestamps)

        if prefix:
            prefix_tokens = tokenizer.encode(" " + prefix.strip())
            if len(prefix_tokens) >= self.max_length // 2:
                prefix_tokens = prefix_tokens[: self.max_length // 2 - 1]
            if not without_timestamps:
                prompt.append(tokenizer.timestamp_begin)
            prompt.extend(prefix_tokens)

        return prompt

    # ------------------------------------------------------------------
    # Word timestamps
    # ------------------------------------------------------------------

    def add_word_timestamps(
        self,
        segments: List[List[dict]],
        tokenizer: Tokenizer,
        encoder_output,
        num_frames,
        prepend_punctuations: str,
        append_punctuations: str,
        last_speech_timestamp: float,
    ) -> Optional[float]:
        """Give each segment dict of each window (one list per row of
        ``encoder_output``) its ``words``; returns the last speech time."""
        state = self.add_word_timestamps_dispatch(segments, tokenizer, encoder_output, num_frames)
        if state is None:
            return None
        return self.add_word_timestamps_collect(
            state, segments, prepend_punctuations, append_punctuations, last_speech_timestamp
        )

    def add_word_timestamps_dispatch(
        self,
        segments: List[List[dict]],
        tokenizer: Tokenizer,
        encoder_output,
        num_frames,
    ):
        """Queue the alignment of every window's text tokens on the device
        and return the state that ``add_word_timestamps_collect`` takes:
        the batched pipeline queues its next batch in between."""
        if len(segments) == 0:
            return None

        text_tokens = []
        text_tokens_per_segment = []
        for segment in segments:
            segment_tokens = [
                [token for token in subsegment["tokens"] if token < tokenizer.eot]
                for subsegment in segment
            ]
            text_tokens.append(list(itertools.chain.from_iterable(segment_tokens)))
            text_tokens_per_segment.append(segment_tokens)

        pending = (
            self.model.align_dispatch(
                encoder_output, tokenizer.sot_sequence, text_tokens, num_frames,
                median_filter_width=7,
            )
            if len(text_tokens)
            else None
        )
        return (pending, tokenizer, text_tokens, text_tokens_per_segment)

    def add_word_timestamps_collect(
        self,
        state,
        segments: List[List[dict]],
        prepend_punctuations: str,
        append_punctuations: str,
        last_speech_timestamp: float,
    ) -> float:
        """Wait for the alignment, split it into words, and apply the
        reference's heuristics: overlong words truncated at sentence
        marks, punctuation merged into its neighbours, the words handed
        to each segment until they cover its tokens, and the boundary
        words of each segment held to its times."""
        pending, tokenizer, text_tokens, text_tokens_per_segment = state
        alignments = (
            self._alignment_words(tokenizer, self.model.align_collect(pending), text_tokens)
            if pending is not None
            else []
        )
        median_max_durations = []
        for alignment in alignments:
            word_durations = np.array([word["end"] - word["start"] for word in alignment])
            word_durations = word_durations[word_durations.nonzero()]
            median_duration = np.median(word_durations) if len(word_durations) > 0 else 0.0
            median_duration = min(0.7, float(median_duration))
            max_duration = median_duration * 2

            # truncate overlong words at sentence boundaries
            if len(word_durations) > 0:
                sentence_end_marks = ".。!！?？"
                for i in range(1, len(alignment)):
                    if alignment[i]["end"] - alignment[i]["start"] > max_duration:
                        if alignment[i]["word"] in sentence_end_marks:
                            alignment[i]["end"] = alignment[i]["start"] + max_duration
                        elif alignment[i - 1]["word"] in sentence_end_marks:
                            alignment[i]["start"] = alignment[i]["end"] - max_duration

            merge_punctuations(alignment, prepend_punctuations, append_punctuations)
            median_max_durations.append((median_duration, max_duration))

        for segment_idx, segment in enumerate(segments):
            word_index = 0
            time_offset = segment[0]["seek"] / self.frames_per_second
            median_duration, max_duration = median_max_durations[segment_idx]
            for subsegment_idx, subsegment in enumerate(segment):
                saved_tokens = 0
                words = []

                while word_index < len(alignments[segment_idx]) and saved_tokens < len(
                    text_tokens_per_segment[segment_idx][subsegment_idx]
                ):
                    timing = alignments[segment_idx][word_index]

                    if timing["word"]:
                        words.append(
                            dict(
                                word=timing["word"],
                                start=round(time_offset + timing["start"], 2),
                                end=round(time_offset + timing["end"], 2),
                                probability=timing["probability"],
                            )
                        )

                    saved_tokens += len(timing["tokens"])
                    word_index += 1

                if len(words) > 0:
                    # the first and second word after a pause must not be overlong
                    if words[0]["end"] - last_speech_timestamp > median_duration * 4 and (
                        words[0]["end"] - words[0]["start"] > max_duration
                        or (len(words) > 1 and words[1]["end"] - words[0]["start"] > max_duration * 2)
                    ):
                        if len(words) > 1 and words[1]["end"] - words[1]["start"] > max_duration:
                            boundary = max(words[1]["end"] / 2, words[1]["end"] - max_duration)
                            words[0]["end"] = words[1]["start"] = boundary
                        words[0]["start"] = max(0, words[0]["end"] - max_duration)

                    # prefer the segment-level start/end when words are overlong
                    if (
                        subsegment["start"] < words[0]["end"]
                        and subsegment["start"] - 0.5 > words[0]["start"]
                    ):
                        words[0]["start"] = max(
                            0, min(words[0]["end"] - median_duration, subsegment["start"])
                        )
                    else:
                        subsegment["start"] = words[0]["start"]

                    if (
                        subsegment["end"] > words[-1]["start"]
                        and subsegment["end"] + 0.5 < words[-1]["end"]
                    ):
                        words[-1]["end"] = max(words[-1]["start"] + median_duration, subsegment["end"])
                    else:
                        subsegment["end"] = words[-1]["end"]

                    last_speech_timestamp = subsegment["end"]
                segments[segment_idx][subsegment_idx]["words"] = words
        return last_speech_timestamp

    def find_alignment(
        self,
        tokenizer: Tokenizer,
        text_tokens: List[List[int]],
        encoder_output,
        num_frames,
        median_filter_width: int = 7,
    ) -> List[List[dict]]:
        """Word dicts (word, tokens, start, end, probability) of each row's
        text tokens, times relative to the window."""
        if len(text_tokens) == 0:
            return []
        results = self.model.align(
            encoder_output, tokenizer.sot_sequence, text_tokens, num_frames,
            median_filter_width=median_filter_width,
        )
        return self._alignment_words(tokenizer, results, text_tokens)

    def _alignment_words(self, tokenizer: Tokenizer, results, text_tokens: List[List[int]]) -> List[List[dict]]:
        """Alignment results -> per-row word dicts: each word starts at the
        time of its first token's jump in the DTW path and ends at the
        next word's; its probability is the mean of its tokens'."""
        return_list = []
        for result, text_token in zip(results, text_tokens):
            text_token_probs = result.text_token_probs
            alignments = result.alignments
            text_indices = np.array([pair[0] for pair in alignments])
            time_indices = np.array([pair[1] for pair in alignments])

            words, word_tokens = tokenizer.split_to_word_tokens(text_token + [tokenizer.eot])
            if len(word_tokens) <= 1:
                # eot only: nothing to align
                return_list.append([])
                continue
            word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))
            if len(word_boundaries) <= 1:
                return_list.append([])
                continue

            jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
            jump_times = time_indices[jumps] / self.tokens_per_second
            start_times = jump_times[word_boundaries[:-1]]
            end_times = jump_times[word_boundaries[1:]]
            word_probabilities = [
                np.mean(text_token_probs[i:j])
                for i, j in zip(word_boundaries[:-1], word_boundaries[1:])
            ]

            return_list.append(
                [
                    dict(word=word, tokens=tokens, start=start, end=end, probability=probability)
                    for word, tokens, start, end, probability in zip(
                        words, word_tokens, start_times, end_times, word_probabilities
                    )
                ]
            )
        return return_list

    def detect_language(
        self,
        audio: Optional[np.ndarray] = None,
        features: Optional[np.ndarray] = None,
        vad_filter: bool = False,
        vad_parameters: Optional[Union[dict, VadOptions]] = None,
        language_detection_segments: int = 1,
        language_detection_threshold: float = 0.5,
    ) -> Tuple[str, float, List[Tuple[str, float]]]:
        """Detect the language from audio or precomputed features; with
        ``vad_filter`` from the audio's speech only.

        Returns (language, probability, all_language_probs)."""
        if audio is None and features is None:
            raise ValueError("Either `audio` or `features` must be provided.")

        if audio is not None:
            if vad_filter:
                if isinstance(vad_parameters, dict):
                    vad_parameters = VadOptions(**vad_parameters)
                speech_chunks = get_speech_timestamps(audio, vad_parameters, device=self.device)
                audio_chunks, _ = collect_chunks(audio, speech_chunks)
                audio = np.concatenate(audio_chunks, axis=0)

            audio = audio[: language_detection_segments * self.feature_extractor.n_samples]
            features = self.feature_extractor(audio)

        features = features[
            ..., : language_detection_segments * self.feature_extractor.nb_max_frames
        ]

        detected_language_info = {}
        all_language_probs = None
        language = None
        language_probability = 0.0
        for i in range(0, features.shape[-1], self.feature_extractor.nb_max_frames):
            encoder_output = self.encode(
                pad_or_trim(features[..., i : i + self.feature_extractor.nb_max_frames])
            )
            results = self.model.detect_language(encoder_output)[0]
            all_language_probs = [(token[2:-2], prob) for (token, prob) in results]
            language, language_probability = all_language_probs[0]
            if language_probability > language_detection_threshold:
                break
            detected_language_info.setdefault(language, []).append(language_probability)
        else:
            # majority vote across segments
            language = max(
                detected_language_info,
                key=lambda lang: len(detected_language_info[lang]),
            )
            language_probability = max(detected_language_info[language])

        return language, language_probability, all_language_probs


# ---------------------------------------------------------------------------
# Batched (VAD-chunked) pipeline (reference: transcribe.py:111-617)
# ---------------------------------------------------------------------------


class BatchedInferencePipeline:
    def __init__(self, model: WhisperModel, scheduler=None):
        """Batches the chunks of one request through ``model``.
        ``scheduler`` (a ``scheduler.ContinuousBatcher``) routes them
        through a process-wide batcher instead, so that CONCURRENT requests
        share device batches; None keeps the in-request batching."""
        self.model: WhisperModel = model
        self.scheduler = scheduler
        self.last_speech_timestamp = 0.0
        self._batch_bucket = None

    def forward(self, features, tokenizer, chunks_metadata, options):
        encoder_output, pending = self._dispatch_segment_batch(features, tokenizer, options)
        return self._forward_collect(encoder_output, pending, tokenizer, chunks_metadata, options)

    def _forward_collect(
        self, encoder_output, pending, tokenizer, chunks_metadata, options, dispatch_hook=None
    ):
        """Split each chunk's tokens into segments, and with word timestamps
        align them.  The pow2 bucket's dummy rows have no metadata: the zip
        drops their outputs, and their encoder rows are sliced off.
        ``dispatch_hook`` queues the next batch: after the alignment's
        dispatch, before its collect."""
        outputs = self._collect_segment_batch(pending, options)

        with span("fwt.pipeline.segments"):
            segmented_outputs = []
            segment_sizes = []
            for chunk_metadata, output in zip(chunks_metadata, outputs):
                duration = chunk_metadata["duration"]
                segment_size = int(ceil(duration) * self.model.frames_per_second)
                segment_sizes.append(segment_size)
                subsegments, _seek, _single_timestamp_ending = self.model._split_segments_by_timestamps(
                    tokenizer=tokenizer,
                    tokens=output["tokens"],
                    time_offset=chunk_metadata["offset"],
                    segment_size=segment_size,
                    segment_duration=duration,
                    seek=0,
                )
                segmented_outputs.append(
                    [
                        dict(
                            text=tokenizer.decode(subsegment["tokens"]),
                            avg_logprob=output["avg_logprob"],
                            no_speech_prob=output["no_speech_prob"],
                            tokens=subsegment["tokens"],
                            start=subsegment["start"],
                            end=subsegment["end"],
                            compression_ratio=get_compression_ratio(
                                tokenizer.decode(subsegment["tokens"])
                            ),
                            seek=int(chunk_metadata["offset"] * self.model.frames_per_second),
                        )
                        for subsegment in subsegments
                    ]
                )

        if options.word_timestamps:
            state = self.model.add_word_timestamps_dispatch(
                segmented_outputs, tokenizer, encoder_output[: len(segment_sizes)], segment_sizes
            )
            if dispatch_hook is not None:
                dispatch_hook()
            if state is not None:
                self.last_speech_timestamp = self.model.add_word_timestamps_collect(
                    state,
                    segmented_outputs,
                    options.prepend_punctuations,
                    options.append_punctuations,
                    self.last_speech_timestamp,
                )
        elif dispatch_hook is not None:
            dispatch_hook()

        return segmented_outputs

    def generate_segment_batched(
        self,
        features: torch.Tensor,
        tokenizer: Tokenizer,
        options: TranscriptionOptions,
    ):
        self._batch_bucket = None  # direct calls: no bucket to share
        encoder_output, pending = self._dispatch_segment_batch(features, tokenizer, options)
        return encoder_output, self._collect_segment_batch(pending, options)

    def _dispatch_segment_batch(
        self,
        features: torch.Tensor,
        tokenizer: Tokenizer,
        options: TranscriptionOptions,
    ):
        """Encode a batch of chunk features and run its beam decode."""
        batch_size = features.shape[0]
        # A trailing partial batch is padded up to the full batches' bucket,
        # and otherwise the batch axis to the next power of two, with dummy
        # rows that repeat the last chunk; their outputs are dropped at
        # unpack.  A stale tail bucket from an earlier generator run must
        # not stop a larger direct forward() call from taking its pow2.
        pad_to = self._batch_bucket
        if pad_to is None or batch_size > pad_to:
            pad_to = 1
            while pad_to < batch_size:
                pad_to *= 2
        features = torch.as_tensor(features, device=self.model.device)
        if 0 < batch_size < pad_to:
            reps = features[-1:].expand((pad_to - batch_size,) + tuple(features.shape[1:]))
            features = torch.cat([features, reps], dim=0)
            batch_size = pad_to

        prompt = self.model.get_prompt(
            tokenizer,
            previous_tokens=(
                tokenizer.encode(options.initial_prompt)
                if options.initial_prompt is not None
                else []
            ),
            without_timestamps=options.without_timestamps,
            hotwords=options.hotwords,
        )

        if options.max_new_tokens is not None:
            max_length = len(prompt) + options.max_new_tokens
        else:
            max_length = self.model.max_length

        if max_length > self.model.max_length:
            raise ValueError(
                f"The length of the prompt is {len(prompt)}, and the `max_new_tokens` "
                f"{max_length - len(prompt)}. Thus, the combined length of the prompt "
                f"and `max_new_tokens` is: {max_length}. This exceeds the "
                f"`max_length` of the Whisper model: {self.model.max_length}. "
                "You should either reduce the length of your prompt, or "
                "reduce the value of `max_new_tokens`, "
                f"so that their combined length is less that {self.model.max_length}."
            )

        with phase_timer("encode dispatch"):
            encoder_output = self.model.encode(features)
        prompts = [prompt.copy() for _ in range(batch_size)]

        if options.multilingual:
            language_tokens = [
                tokenizer.tokenizer.token_to_id(segment_langs[0][0])
                for segment_langs in self.model.model.detect_language(encoder_output)
            ]
            language_token_index = prompt.index(tokenizer.language)
            for i, language_token in enumerate(language_tokens):
                prompts[i][language_token_index] = language_token

        with phase_timer("decode dispatch"):
            pending = self.model.model.generate_dispatch(
                encoder_output,
                prompts,
                beam_size=options.beam_size,
                patience=options.patience,
                length_penalty=options.length_penalty,
                max_length=max_length,
                suppress_blank=options.suppress_blank,
                suppress_tokens=options.suppress_tokens,
                sampling_temperature=options.temperatures[0],
                repetition_penalty=options.repetition_penalty,
                no_repeat_ngram_size=options.no_repeat_ngram_size,
            )
        return encoder_output, pending

    def _collect_segment_batch(self, pending, options: TranscriptionOptions):
        """Fetch the decoded sequences and unpack them."""
        with phase_timer("decode collect"):
            results = self.model.model.generate_collect(pending)
        output = []
        for result in results:
            seq_len = len(result.sequences_ids[0])
            cum_logprob = result.scores[0] * (seq_len ** options.length_penalty)
            output.append(
                dict(
                    avg_logprob=cum_logprob / (seq_len + 1),
                    no_speech_prob=result.no_speech_prob,
                    tokens=result.sequences_ids[0],
                )
            )
        return output

    def transcribe(
        self,
        audio: Union[str, BinaryIO, np.ndarray],
        language: Optional[str] = None,
        task: str = "transcribe",
        log_progress: bool = False,
        beam_size: int = 5,
        best_of: int = 5,
        patience: float = 1,
        length_penalty: float = 1,
        repetition_penalty: float = 1,
        no_repeat_ngram_size: int = 0,
        temperature: Union[float, List[float], Tuple[float, ...]] = [
            0.0, 0.2, 0.4, 0.6, 0.8, 1.0,
        ],
        compression_ratio_threshold: Optional[float] = 2.4,
        log_prob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = True,
        prompt_reset_on_temperature: float = 0.5,
        initial_prompt: Optional[Union[str, Iterable[int]]] = None,
        prefix: Optional[str] = None,
        suppress_blank: bool = True,
        suppress_tokens: Optional[List[int]] = [-1],
        without_timestamps: bool = True,
        max_initial_timestamp: float = 1.0,
        word_timestamps: bool = False,
        prepend_punctuations: str = "\"'“¿([{-",
        append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
        multilingual: bool = False,
        vad_filter: bool = True,
        vad_parameters: Optional[Union[dict, VadOptions]] = None,
        max_new_tokens: Optional[int] = None,
        chunk_length: Optional[int] = None,
        clip_timestamps: Optional[List[dict]] = None,
        hallucination_silence_threshold: Optional[float] = None,
        batch_size: int = 8,
        hotwords: Optional[str] = None,
        language_detection_threshold: Optional[float] = 0.5,
        language_detection_segments: int = 1,
    ) -> Tuple[Iterable[Segment], TranscriptionInfo]:
        """Batched transcription over VAD (or user-provided) chunks.

        Same argument semantics as the JAX package's (and the reference's)
        BatchedInferencePipeline (reference: transcribe.py:254-375); the
        forced overrides (one temperature, no conditioning,
        max_initial_timestamp=0) match :518-553.  ``clip_timestamps`` is a
        list of {"start", "end"} dicts in seconds.  ``log_progress`` logs
        each batch at INFO."""
        model = self.model
        sampling_rate = model.feature_extractor.sampling_rate

        if multilingual and not model.model.is_multilingual:
            model.logger.warning(
                "The current model is English-only but the multilingual parameter is"
                " set to True; setting to False instead."
            )
            multilingual = False

        if not isinstance(audio, np.ndarray):
            audio = decode_audio(audio, sampling_rate=sampling_rate)
        duration = audio.shape[0] / sampling_rate

        model.logger.info("Processing audio with duration %s", format_timestamp(duration))

        chunk_length = chunk_length or model.feature_extractor.chunk_length

        # One host->device transfer on the int16 grid feeds both the VAD and
        # the speech concat that the features are computed from.  Opt-in
        # (FWT_PIPELINED_VAD=1): the transfer in slices on a copy stream,
        # the VAD forward on each slice as it lands (vad.upload_with_vad).
        # FWT_SHARED_UPLOAD=0: the VAD reads the host audio and the
        # features a float32 speech concat uploaded on its own.
        audio_dev = vad_probs = None
        if len(audio) and os.environ.get("FWT_SHARED_UPLOAD", "1") != "0":
            if (
                not clip_timestamps
                and vad_filter
                and os.environ.get("FWT_PIPELINED_VAD", "0") == "1"
            ):
                with span("fwt.vad", phase="pcm upload + vad dispatch (pipelined)"):
                    audio_dev, vad_probs = upload_with_vad(audio, device=model.device)
            else:
                with phase_timer("pcm upload"):
                    audio_dev = upload_audio(audio, model.device)

        if not clip_timestamps:
            if vad_filter:
                if vad_parameters is None:
                    vad_parameters = VadOptions(
                        max_speech_duration_s=chunk_length,
                        min_silence_duration_ms=160,
                    )
                elif isinstance(vad_parameters, dict):
                    if "max_speech_duration_s" in vad_parameters.keys():
                        vad_parameters.pop("max_speech_duration_s")
                    vad_parameters = VadOptions(
                        **vad_parameters, max_speech_duration_s=chunk_length
                    )
                with phase_timer("vad (compile+forward+state machine)"):
                    if vad_probs is None:
                        clip_timestamps = get_speech_timestamps(
                            audio if audio_dev is None else audio_dev, vad_parameters,
                            device=model.device,
                        )
                    else:
                        with span("fwt.vad"):
                            clip_timestamps = speech_timestamps_from_probs(
                                vad_probs, len(audio), vad_parameters, sampling_rate
                            )
            elif duration < chunk_length:
                clip_timestamps = [{"start": 0, "end": audio.shape[0]}]
            else:
                raise RuntimeError(
                    "No clip timestamps found. "
                    "Set 'vad_filter' to True or provide 'clip_timestamps'."
                )

            clip_timestamps_provided = False
            with span("fwt.pipeline.chunks"):
                audio_chunks, chunks_metadata = collect_chunks(
                    audio, clip_timestamps, max_duration=chunk_length
                )
        else:
            clip_timestamps_provided = True
            clip_timestamps = [
                {k: int(v * sampling_rate) for k, v in segment.items()}
                for segment in clip_timestamps
            ]

            with span("fwt.pipeline.chunks"):
                audio_chunks, chunks_metadata = [], []
                for i, clip in enumerate(clip_timestamps):
                    audio_chunks.append(audio[clip["start"] : clip["end"]])
                    clip_duration = (clip["end"] - clip["start"]) / sampling_rate
                    if clip_duration > 30:
                        model.logger.warning(
                            "Segment %d is longer than 30 seconds, "
                            "only the first 30 seconds will be transcribed",
                            i,
                        )
                    chunks_metadata.append(
                        {
                            "offset": clip["start"] / sampling_rate,
                            "duration": clip_duration,
                            "segments": [clip],
                        }
                    )

        duration_after_vad = (
            sum((segment["end"] - segment["start"]) for segment in clip_timestamps)
            / sampling_rate
        )

        model.logger.info(
            "VAD filter removed %s of audio",
            format_timestamp(duration - duration_after_vad),
        )

        # Per-chunk features on the device, from the speech concat rebuilt
        # there (the chunks are consecutive in it).
        chunk_lengths = [len(c) for c in audio_chunks]
        if duration_after_vad:
            if audio_dev is not None:
                n_total = len(audio)  # numpy slicing clamps; match it
                with span("fwt.pipeline.chunks", phase="assemble speech concat"):
                    base_audio = assemble_segments(
                        audio_dev,
                        [(min(c["start"], n_total), min(c["end"], n_total)) for c in clip_timestamps],
                    )
            else:
                base_audio = torch.from_numpy(
                    np.concatenate(audio_chunks).astype(np.float32, copy=False)
                ).to(model.device)
            chunk_starts = np.concatenate([[0], np.cumsum(chunk_lengths)[:-1]])
            with phase_timer("chunked mel features"):
                features = model.feature_extractor.chunk_features(
                    base_audio, chunk_starts, chunk_lengths
                )  # (N, n_mels, 3000), already window-padded
        else:
            features = []

        all_language_probs = None
        if language is None:
            if not model.model.is_multilingual:
                language = "en"
                language_probability = 1
            else:
                # The reference concatenates the *unpadded* per-chunk
                # features plus a dummy column (transcribe.py:481-490).
                # detect_language keeps language_detection_segments windows,
                # so only the chunks that cover them leave the device.
                hop = model.feature_extractor.hop_length
                nb_max = model.feature_extractor.nb_max_frames
                unpadded_lens = [max((cl + 160) // hop - 1, 0) for cl in chunk_lengths]
                n_take, frames_taken = 0, 0
                while n_take < len(unpadded_lens) and frames_taken < (
                    language_detection_segments * nb_max
                ):
                    frames_taken += unpadded_lens[n_take]
                    n_take += 1
                feats_np = features[:n_take].cpu().numpy() if n_take else None
                unpadded = (
                    [feats_np[i][:, : unpadded_lens[i]] for i in range(n_take)]
                    if feats_np is not None
                    else []
                )
                (
                    language,
                    language_probability,
                    all_language_probs,
                ) = model.detect_language(
                    features=np.concatenate(
                        unpadded + [np.full((model.model.n_mels, 1), -1.5, dtype="float32")],
                        axis=1,
                    ),  # dummy column so empty audio still has features
                    language_detection_segments=language_detection_segments,
                    language_detection_threshold=language_detection_threshold,
                )
                model.logger.info(
                    "Detected language '%s' with probability %.2f",
                    language,
                    language_probability,
                )
        else:
            if not model.model.is_multilingual and language != "en":
                model.logger.warning(
                    "The current model is English-only but the language parameter is"
                    " set to '%s'; using 'en' instead." % language
                )
                language = "en"
            language_probability = 1

        tokenizer = Tokenizer(
            model.hf_tokenizer, model.model.is_multilingual, task=task, language=language
        )

        options = TranscriptionOptions(
            beam_size=beam_size,
            best_of=best_of,
            patience=patience,
            length_penalty=length_penalty,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size,
            log_prob_threshold=log_prob_threshold,
            no_speech_threshold=no_speech_threshold,
            compression_ratio_threshold=compression_ratio_threshold,
            temperatures=(
                temperature[:1] if isinstance(temperature, (list, tuple)) else [temperature]
            ),
            initial_prompt=initial_prompt,
            prefix=prefix,
            suppress_blank=suppress_blank,
            suppress_tokens=(
                get_suppressed_tokens(tokenizer, suppress_tokens)
                if suppress_tokens
                else suppress_tokens
            ),
            prepend_punctuations=prepend_punctuations,
            append_punctuations=append_punctuations,
            max_new_tokens=max_new_tokens,
            hotwords=hotwords,
            word_timestamps=word_timestamps,
            hallucination_silence_threshold=None,
            condition_on_previous_text=False,
            clip_timestamps=clip_timestamps,
            prompt_reset_on_temperature=0.5,
            multilingual=multilingual,
            without_timestamps=without_timestamps,
            max_initial_timestamp=0.0,
        )

        info = TranscriptionInfo(
            language=language,
            language_probability=language_probability,
            duration=duration,
            duration_after_vad=duration_after_vad,
            transcription_options=options,
            vad_options=vad_parameters,
            all_language_probs=all_language_probs,
        )

        if self.scheduler is not None and not multilingual:
            # cross-request continuous batching (multilingual stays on the
            # in-request path: its prompts are patched from this batch's
            # own encoder output)
            segments = self._scheduled_segments_generator(
                features, tokenizer, chunks_metadata, options, log_progress
            )
        else:
            segments = self._batched_segments_generator(
                features, tokenizer, chunks_metadata, batch_size, options, log_progress
            )
        if not clip_timestamps_provided:
            segments = restore_speech_timestamps(segments, clip_timestamps, sampling_rate)

        return segments, info

    def _batched_segments_generator(
        self, features, tokenizer, chunks_metadata, batch_size, options, log_progress
    ):
        seg_idx = 0
        starts = list(range(0, len(features), batch_size))
        # A trailing partial batch of at least half a batch is padded to the
        # full batches' size; a smaller one takes its own pow2 bucket.
        tail = len(features) % batch_size
        self._batch_bucket = (
            batch_size if len(features) > batch_size and tail >= batch_size // 2 else None
        )

        # The JAX package's order: the next batch is dispatched before this
        # one is collected and again from inside the collect (after the
        # alignment's dispatch, with word timestamps), with at most two in
        # flight.  Each keeps its encoder states for the alignment.
        in_flight = deque()  # (start, encoder_output, pending)
        next_idx = 0

        def dispatch_next():
            nonlocal next_idx
            if len(in_flight) < 2 and next_idx < len(starts):
                start = starts[next_idx]
                next_idx += 1
                encoder_output, pending = self._dispatch_segment_batch(
                    features[start : start + batch_size], tokenizer, options
                )
                in_flight.append((start, encoder_output, pending))

        dispatch_next()

        for bi in range(len(starts)):
            i, encoder_output, pending = in_flight.popleft()
            dispatch_next()
            results = self._forward_collect(
                encoder_output, pending, tokenizer, chunks_metadata[i : i + batch_size], options,
                dispatch_hook=dispatch_next,
            )
            if log_progress:
                self.model.logger.info(
                    "Processed batch %d of %d (chunks %d-%d of %d)",
                    bi + 1, len(starts), i + 1, min(i + batch_size, len(features)), len(features),
                )

            with span("fwt.pipeline.segments"):
                batch_segments = []
                for result in results:
                    for segment in result:
                        seg_idx += 1
                        batch_segments.append(
                            Segment(
                                seek=segment["seek"],
                                id=seg_idx,
                                text=segment["text"],
                                start=round(segment["start"], 3),
                                end=round(segment["end"], 3),
                                words=(
                                    [Word(**word) for word in segment["words"]]
                                    if options.word_timestamps
                                    else None
                                ),
                                tokens=segment["tokens"],
                                avg_logprob=segment["avg_logprob"],
                                no_speech_prob=segment["no_speech_prob"],
                                compression_ratio=segment["compression_ratio"],
                                temperature=options.temperatures[0],
                            )
                        )
            yield from batch_segments

        self.last_speech_timestamp = 0.0

    def _scheduled_segments_generator(
        self, features, tokenizer, chunks_metadata, options, log_progress
    ):
        """Chunk generator over the process-wide ContinuousBatcher: this
        request's chunks are submitted once and may run in device batches
        SHARED with other concurrent requests; results are consumed in
        chunk order so generator and timestamp semantics are unchanged.
        The word-timestamp alignment runs per chunk on this request's
        thread, between the batcher's batches."""
        from faster_whisper_tpu_torch.scheduler import GenKey

        # Count feature rows, not metadata entries: when the VAD removes
        # ALL speech, collect_chunks still emits one empty chunk with
        # metadata but `features` is [].  Zero rows -> zero entries -> the
        # generator yields nothing.  Any other length mismatch is a fault
        # that the zip below would silently truncate.
        n_chunks = len(features)
        assert n_chunks in (0, len(chunks_metadata)), (n_chunks, len(chunks_metadata))
        prompt = self.model.get_prompt(
            tokenizer,
            previous_tokens=(
                tokenizer.encode(options.initial_prompt)
                if options.initial_prompt is not None
                else []
            ),
            without_timestamps=options.without_timestamps,
            hotwords=options.hotwords,
        )
        if options.max_new_tokens is not None:
            max_length = len(prompt) + options.max_new_tokens
        else:
            max_length = self.model.max_length
        if max_length > self.model.max_length:
            raise ValueError(
                f"The combined length of the prompt ({len(prompt)}) and "
                f"`max_new_tokens` exceeds the model's `max_length` "
                f"({self.model.max_length})."
            )

        temperature = options.temperatures[0]
        key = GenKey(
            beam_size=options.beam_size,
            patience=options.patience,
            length_penalty=options.length_penalty,
            repetition_penalty=options.repetition_penalty,
            no_repeat_ngram_size=options.no_repeat_ngram_size,
            max_length=max_length,
            suppress_blank=options.suppress_blank,
            suppress_tokens=tuple(options.suppress_tokens or ()),
            # the temperature itself is per row (scheduler.GenKey); only the
            # sampling/beam split partitions batches
            sampling=options.beam_size == 1 and temperature > 0,
            with_timestamps=self.model.model.meta.no_timestamps not in prompt,
        )
        entries = (
            self.scheduler.submit(features, [prompt] * n_chunks, key, temperature=temperature)
            if n_chunks
            else []
        )

        seg_idx = 0
        for ci, (entry, chunk_metadata) in enumerate(zip(entries, chunks_metadata)):
            entry.event.wait()
            if entry.error is not None:
                raise entry.error
            result = entry.result
            seq_len = len(result.sequences_ids[0])
            cum_logprob = result.scores[0] * (seq_len ** options.length_penalty)
            output = dict(
                avg_logprob=cum_logprob / (seq_len + 1),
                no_speech_prob=result.no_speech_prob,
                tokens=result.sequences_ids[0],
            )

            duration = chunk_metadata["duration"]
            segment_size = int(ceil(duration) * self.model.frames_per_second)
            subsegments, _seek, _single_timestamp_ending = self.model._split_segments_by_timestamps(
                tokenizer=tokenizer,
                tokens=output["tokens"],
                time_offset=chunk_metadata["offset"],
                segment_size=segment_size,
                segment_duration=duration,
                seek=0,
            )
            segmented = [
                dict(
                    text=tokenizer.decode(subsegment["tokens"]),
                    avg_logprob=output["avg_logprob"],
                    no_speech_prob=output["no_speech_prob"],
                    tokens=subsegment["tokens"],
                    start=subsegment["start"],
                    end=subsegment["end"],
                    compression_ratio=get_compression_ratio(
                        tokenizer.decode(subsegment["tokens"])
                    ),
                    seek=int(chunk_metadata["offset"] * self.model.frames_per_second),
                )
                for subsegment in subsegments
            ]
            if options.word_timestamps:
                self.last_speech_timestamp = self.model.add_word_timestamps(
                    [segmented],
                    tokenizer,
                    entry.enc[entry.enc_row : entry.enc_row + 1],
                    [segment_size],
                    options.prepend_punctuations,
                    options.append_punctuations,
                    self.last_speech_timestamp,
                )
            if log_progress:
                self.model.logger.info("Processed chunk %d of %d", ci + 1, n_chunks)

            for segment in segmented:
                seg_idx += 1
                yield Segment(
                    seek=segment["seek"],
                    id=seg_idx,
                    text=segment["text"],
                    start=round(segment["start"], 3),
                    end=round(segment["end"], 3),
                    words=(
                        [Word(**word) for word in segment["words"]]
                        if options.word_timestamps
                        else None
                    ),
                    tokens=segment["tokens"],
                    avg_logprob=segment["avg_logprob"],
                    no_speech_prob=segment["no_speech_prob"],
                    compression_ratio=segment["compression_ratio"],
                    temperature=options.temperatures[0],
                )

        self.last_speech_timestamp = 0.0


def restore_speech_timestamps(
    segments: Iterable[Segment],
    speech_chunks: List[dict],
    sampling_rate: int,
) -> Iterable[Segment]:
    """Map VAD-compressed segment and word times back to the original
    clock.  A word's start and end map through the chunk of its midpoint,
    and a segment with words then spans its first and last word."""
    ts_map = SpeechTimestampsMap(speech_chunks, sampling_rate)

    for segment in segments:
        if segment.words:
            words = []
            for word in segment.words:
                middle = (word.start + word.end) / 2
                chunk_index = ts_map.get_chunk_index(middle)
                word.start = ts_map.get_original_time(word.start, chunk_index)
                word.end = ts_map.get_original_time(word.end, chunk_index)
                words.append(word)

            segment.start = words[0].start
            segment.end = words[-1].end
            segment.words = words
        else:
            segment.start = ts_map.get_original_time(segment.start)
            segment.end = ts_map.get_original_time(segment.end, is_end=True)

        yield segment


def get_compression_ratio(text: str) -> float:
    text_bytes = text.encode("utf-8")
    return len(text_bytes) / len(zlib.compress(text_bytes))


def get_suppressed_tokens(
    tokenizer: Tokenizer,
    suppress_tokens: Tuple[int],
) -> Optional[List[int]]:
    if -1 in suppress_tokens:
        suppress_tokens = [t for t in suppress_tokens if t >= 0]
        suppress_tokens.extend(tokenizer.non_speech_tokens)
    elif suppress_tokens is None or len(suppress_tokens) == 0:
        suppress_tokens = []
    else:
        if not isinstance(suppress_tokens, list):
            raise TypeError("suppress_tokens must be a list")
        suppress_tokens = list(suppress_tokens)

    suppress_tokens.extend(
        [
            tokenizer.transcribe,
            tokenizer.translate,
            tokenizer.sot,
            tokenizer.sot_prev,
            tokenizer.sot_lm,
            tokenizer.no_speech,
        ]
    )

    return tuple(sorted(set(suppress_tokens)))


def merge_punctuations(alignment: List[dict], prepended: str, appended: str) -> None:
    """Merge punctuation-only entries into their neighbours, in place."""
    # prepend: walk right to left, gluing opening punctuation forward
    i = len(alignment) - 2
    j = len(alignment) - 1
    while i >= 0:
        previous = alignment[i]
        following = alignment[j]
        if previous["word"].startswith(" ") and previous["word"].strip() in prepended:
            following["word"] = previous["word"] + following["word"]
            following["tokens"] = previous["tokens"] + following["tokens"]
            previous["word"] = ""
            previous["tokens"] = []
        else:
            j = i
        i -= 1

    # append: walk left to right, gluing closing punctuation backward
    i = 0
    j = 1
    while j < len(alignment):
        previous = alignment[i]
        following = alignment[j]
        if not previous["word"].endswith(" ") and following["word"] in appended:
            previous["word"] = previous["word"] + following["word"]
            previous["tokens"] = previous["tokens"] + following["tokens"]
            following["word"] = ""
            following["tokens"] = []
        else:
            i = j
        j += 1


def _word_anomaly_score(word: dict) -> float:
    """Anomalous words are very long, very short, or improbable."""
    probability = word.get("probability", 0.0)
    duration = word["end"] - word["start"]
    score = 0.0
    if probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15
    if duration > 2.0:
        score += duration - 2.0
    return score


def _is_segment_anomaly(segment: Optional[dict]) -> bool:
    if segment is None or not segment["words"]:
        return False
    words = [w for w in segment["words"] if w["word"] not in _PUNCTUATION]
    words = words[:8]
    score = sum(_word_anomaly_score(w) for w in words)
    return score >= 3 or score + 0.01 >= len(words)


def _next_words_segment(segments: List[dict]) -> Optional[dict]:
    return next((s for s in segments if s["words"]), None)
