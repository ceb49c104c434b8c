"""The real-weights acceptance gate, as one command.

Counterpart of ``faster_whisper_tpu/validate.py``, with the same checks,
flags, table and summary line.  The reference's acceptance gate is golden
transcripts on real audio with real weights (reference:
tests/test_transcribe.py:14-59 jfk with word timings, :100-115 prefix,
:118-139 VAD, :142-157 stereo, :160-214 multilingual, :217-234 hotwords)
plus LibriSpeech WER (reference: benchmark/wer_benchmark.py, published
WER 13.527 at README.md:37).  With a weights directory, run:

    python -m faster_whisper_tpu_torch.validate --model tiny \\
        [--weights-dir PATH] [--librispeech DIR] [--data-dir DIR]

Every check mirrors one reference test; the command prints a PASS/FAIL
table to stderr and a JSON summary as its last line, and exits non-zero
on any failure.  ``--mock`` runs the same harness over a random-weight
micro model (``testing.build_test_model``; text equality checks become
structural invariants), so the gate itself stays tested without weights.

The model runs on the card, as the port's entry points do.  The default
``--data-dir`` is the repository's ``docker/`` directory, which holds
``jfk.flac``; the checks whose files are not there skip.
"""

import argparse
import json
import os
import sys

GOLDEN_JFK = (
    " And so my fellow Americans, ask not what your country can do for you, "
    "ask what you can do for your country."
)
GOLDEN_JFK_BATCHED = (
    " And so my fellow Americans ask not what your country can do for you, "
    "ask what you can do for your country."
)
GOLDEN_STEREO_LEFT = (
    "He began a confused complaint against the wizard, "
    "who had vanished behind the curtain on the left."
)
GOLDEN_STEREO_RIGHT = "The horizon seems extremely distant."

# The repository's docker/ directory, beside the package: it holds jfk.flac.
DEFAULT_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docker"
)


# The --mock gate's sampling seed: see ``mock_model``.
MOCK_RNG_SEED = 0


def mock_model():
    """The ``--mock`` gate's model: the random-weight micro model of
    ``testing.build_test_model``, whose temperature fallback samples from
    ``MOCK_RNG_SEED`` instead of fresh entropy, so that two runs give equal
    segments.  (The JAX package's gate draws fresh entropy; on random
    weights a sampled rung can then fail a structural check in one run of
    many.)"""
    from faster_whisper_tpu_torch import testing

    model = testing.build_test_model()
    if model is not None:  # a stand-in that builds no model
        model.model.rng_seed = MOCK_RNG_SEED
    return model


class Gate:
    def __init__(self):
        self.results = []

    def run(self, name, fn):
        try:
            detail = fn()
            self.results.append((name, "PASS", detail or ""))
        except SkipCheck as e:
            self.results.append((name, "SKIP", str(e)))
        except Exception as e:  # noqa: BLE001 — the gate reports, not raises
            self.results.append((name, "FAIL", f"{type(e).__name__}: {e}"))

    @property
    def failed(self):
        return [r for r in self.results if r[1] == "FAIL"]


class SkipCheck(Exception):
    pass


def _structural_segments(segments, want_words=False):
    """Mock-mode invariants: the path must run end to end and what it emits
    must be well formed (ordered timestamps, sane word spans).  Random
    weights may give no segments (no-speech skips) or segments without
    words, so presence and text equality stay real-weights checks.

    Start times must not go backwards across segments only without word
    timestamps: with them, the seek moves back to the last aligned word's
    end after a window's segments, so a window decoded again may start a
    segment before the previous window's last ones."""
    segments = list(segments)
    last_start = 0.0
    for s in segments:
        assert s.end >= s.start >= 0, (s.start, s.end)
        if not want_words:
            assert s.start >= last_start - 1e-6, (s.start, last_start)
            last_start = s.start
        if want_words and s.words:
            for w in s.words:
                assert w.end >= w.start >= 0
    return f"{len(segments)} segments"


def check_jfk_sequential(model, jfk_path, mock):
    segments, info = model.transcribe(jfk_path, word_timestamps=True)
    if mock:
        return _structural_segments(segments, want_words=True)
    assert info.language == "en", info.language
    assert info.language_probability > 0.9
    segments = list(segments)
    assert len(segments) == 1, len(segments)
    seg = segments[0]
    assert seg.text == GOLDEN_JFK, repr(seg.text)
    assert seg.text == "".join(w.word for w in seg.words)
    assert seg.start == seg.words[0].start
    assert seg.end == seg.words[-1].end
    return "golden text + word spans"


def check_jfk_batched(model, jfk_path, mock):
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline

    pipeline = BatchedInferencePipeline(model)
    segments, info = pipeline.transcribe(jfk_path, word_timestamps=True, vad_filter=False)
    if mock:
        return _structural_segments(segments, want_words=True)
    assert info.language == "en"
    assert info.language_probability > 0.7
    segments = list(segments)
    assert len(segments) == 1, len(segments)
    assert segments[0].text == GOLDEN_JFK_BATCHED, repr(segments[0].text)
    return "golden text"


def check_jfk_prefix(model, jfk_path, mock):
    segments, _ = model.transcribe(jfk_path, prefix="And so my fellow Americans")
    if mock:
        return _structural_segments(segments)
    segments = list(segments)
    assert len(segments) == 1
    assert segments[0].text == GOLDEN_JFK, repr(segments[0].text)
    assert segments[0].start == 0
    assert 10 < segments[0].end <= 11
    return "prefix respected"


def check_jfk_vad(model, jfk_path, mock):
    segments, info = model.transcribe(
        jfk_path,
        vad_filter=True,
        vad_parameters=dict(min_silence_duration_ms=500, speech_pad_ms=200),
    )
    segments = list(segments)
    assert info.vad_options.min_silence_duration_ms == 500
    assert info.vad_options.speech_pad_ms == 200
    if mock:
        assert segments
        return f"{len(segments)} segments"
    assert len(segments) == 1
    assert segments[0].text == GOLDEN_JFK_BATCHED, repr(segments[0].text)
    assert 0 < segments[0].start < 1
    assert 10 < segments[0].end < 11
    return "golden text under VAD"


def check_stereo(model, data_dir, mock):
    from faster_whisper_tpu_torch.audio import decode_audio

    path = os.path.join(data_dir, "stereo_diarization.wav")
    if not os.path.exists(path):
        raise SkipCheck("stereo_diarization.wav not available")
    left, right = decode_audio(path, split_stereo=True)
    seg_l, _ = model.transcribe(left)
    seg_r, _ = model.transcribe(right)
    if mock:
        _structural_segments(seg_l)
        _structural_segments(seg_r)
        return "both channels decode"
    tl = "".join(s.text for s in seg_l).strip()
    tr = "".join(s.text for s in seg_r).strip()
    assert tl == GOLDEN_STEREO_LEFT, repr(tl)
    assert tr == GOLDEN_STEREO_RIGHT, repr(tr)
    return "golden per-channel text"


def check_hotwords(model, data_dir, mock):
    from faster_whisper_tpu_torch.audio import decode_audio
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline

    path = os.path.join(data_dir, "hotwords.mp3")
    if not os.path.exists(path):
        raise SkipCheck("hotwords.mp3 not available")
    audio = decode_audio(path)
    segments, info = model.transcribe(audio, hotwords="ComfyUI")
    segments = list(segments)
    assert info.transcription_options.hotwords == "ComfyUI"
    if not mock:
        assert "ComfyUI" in segments[0].text
    segments, info = BatchedInferencePipeline(model).transcribe(audio, hotwords="ComfyUI")
    segments = list(segments)
    assert info.transcription_options.hotwords == "ComfyUI"
    if not mock:
        assert "ComfyUI" in segments[0].text
        return "hotword surfaced both paths"
    return "hotwords plumbed both paths"


def check_multilingual(model, data_dir, mock):
    from faster_whisper_tpu_torch.audio import decode_audio

    path = os.path.join(data_dir, "multilingual.mp3")
    if not os.path.exists(path):
        raise SkipCheck("multilingual.mp3 not available")
    audio = decode_audio(path)
    segments, _ = model.transcribe(
        audio,
        multilingual=True,
        without_timestamps=True,
        condition_on_previous_text=False,
    )
    segments = list(segments)
    if mock:
        return f"{len(segments)} segments, per-segment language re-detect ran"
    assert segments[0].text.startswith(" Permission is hereby granted")
    assert "Software" in segments[1].text
    return "EN->DE per-segment switch"


def check_wer(model, librispeech_dir, threshold):
    """LibriSpeech greedy WER (reference: benchmark/wer_benchmark.py), with
    the repository's ``benchmarks/normalizer.py`` and ``benchmarks/wer.py``."""
    if not librispeech_dir or not os.path.isdir(librispeech_dir):
        raise SkipCheck("no --librispeech directory")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "benchmarks"))
    from normalizer import EnglishTextNormalizer  # benchmarks/normalizer.py
    from wer import wer as word_error_rate  # benchmarks/wer.py

    norm = EnglishTextNormalizer()
    refs, hyps = [], []
    n = 0
    for root, _, files in os.walk(librispeech_dir):
        trans = [f for f in files if f.endswith(".trans.txt")]
        for tf in trans:
            with open(os.path.join(root, tf)) as fh:
                for line in fh:
                    utt, text = line.strip().split(" ", 1)
                    flac = os.path.join(root, utt + ".flac")
                    if not os.path.exists(flac):
                        continue
                    segments, _ = model.transcribe(flac, language="en")
                    hyp = "".join(s.text for s in segments)
                    refs.append(norm(text))
                    hyps.append(norm(hyp))
                    n += 1
    if n == 0:
        raise SkipCheck("no utterances found")
    score = word_error_rate(refs, hyps) * 100
    assert score <= threshold, f"WER {score:.3f} > {threshold}"
    return f"WER {score:.3f} over {n} utts"


def check_ct2_int8_dir(model, jfk_path, mock):
    """A downloaded int8 CT2 checkpoint (model.bin with weight +
    weight_scale linears) must work first try through the public path
    with an int8 compute type (reference: transcribe.py:689-698; the hub's
    faster-whisper conversions ship exactly this layout).  In --mock mode
    the directory is written in memory from random weights of the mock
    model's config, loaded on the mock model's device (``"int8"`` on the
    card, ``"int8_float32"`` on the host); with real weights pass
    --weights-dir at an int8 conversion instead."""
    if not mock:
        raise SkipCheck("run the real int8 conversion via --weights-dir + --compute-type int8")
    import torch

    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.ops.quant import QuantizedLinear
    from faster_whisper_tpu_torch.testing import serialize_ct2_int8, tokenizer_json
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg = model.model.config
    params = random_params(cfg, dtype=torch.float32, device="cpu")
    blob = serialize_ct2_int8(params, cfg)
    dev = model.device
    m8 = WhisperModel(
        "mock-int8-ct2",
        device=dev.type,
        device_index=dev.index or 0,
        compute_type="int8" if dev.type == "cuda" else "int8_float32",
        files={
            "model.bin": blob,
            "config.json": json.dumps(
                {"attention_heads": cfg.n_text_head, "alignment_heads": [[1, 0], [1, 1]]}
            ).encode(),
            "tokenizer.json": tokenizer_json().encode(),
        },
    )
    assert isinstance(
        m8.model.params["decoder"]["layers"]["mlp"]["w1"], QuantizedLinear
    ), "int8 dir did not produce a quantized engine"
    segments, _ = m8.transcribe(jfk_path, language="en", beam_size=2, max_new_tokens=8)
    return _structural_segments(list(segments))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="faster_whisper_tpu_torch.validate")
    p.add_argument("--model", default="tiny")
    p.add_argument("--weights-dir", default=None,
                   help="local model dir (skips the hub download)")
    p.add_argument("--compute-type", default="default")
    p.add_argument("--data-dir", default=DEFAULT_DATA_DIR)
    p.add_argument("--librispeech", default=None,
                   help="LibriSpeech split dir for the WER gate")
    p.add_argument("--wer-threshold", type=float, default=15.0)
    p.add_argument("--mock", action="store_true",
                   help="random weights: exercises the gate harness itself")
    p.add_argument("--checks", default=None,
                   help="comma list to run a subset (names as printed); "
                   "default: all")
    args = p.parse_args(argv)

    if args.mock:
        model = mock_model()
    else:
        from faster_whisper_tpu_torch.transcribe import WhisperModel

        model = WhisperModel(args.weights_dir or args.model, compute_type=args.compute_type)

    jfk = os.path.join(args.data_dir, "jfk.flac")
    if not os.path.exists(jfk):
        print(f"fatal: {jfk} not found", file=sys.stderr)
        return 2

    checks = [
        ("jfk sequential + words", lambda: check_jfk_sequential(model, jfk, args.mock)),
        ("jfk batched", lambda: check_jfk_batched(model, jfk, args.mock)),
        ("jfk prefix", lambda: check_jfk_prefix(model, jfk, args.mock)),
        ("jfk vad", lambda: check_jfk_vad(model, jfk, args.mock)),
        ("stereo diarization", lambda: check_stereo(model, args.data_dir, args.mock)),
        ("hotwords", lambda: check_hotwords(model, args.data_dir, args.mock)),
        ("multilingual", lambda: check_multilingual(model, args.data_dir, args.mock)),
        ("ct2 int8 dir round-trip", lambda: check_ct2_int8_dir(model, jfk, args.mock)),
        ("librispeech wer", lambda: check_wer(model, args.librispeech, args.wer_threshold)),
    ]
    if args.checks:
        wanted = {c.strip() for c in args.checks.split(",")}
        known = {n for n, _ in checks}
        unknown = sorted(wanted - known)
        if unknown:
            p.error(f"unknown --checks {unknown}; valid names: {sorted(known)}")
        checks = [(n, f) for n, f in checks if n in wanted]

    gate = Gate()
    for name, fn in checks:
        gate.run(name, fn)

    width = max(len(n) for n, _, _ in gate.results)
    for name, status, detail in gate.results:
        print(f"{name:<{width}}  {status:<4}  {detail}", file=sys.stderr)
    summary = {
        "mode": "mock" if args.mock else "real",
        "model": args.model,
        "pass": sum(1 for r in gate.results if r[1] == "PASS"),
        "fail": len(gate.failed),
        "skip": sum(1 for r in gate.results if r[1] == "SKIP"),
    }
    print(json.dumps(summary))
    return 1 if gate.failed else 0


if __name__ == "__main__":
    sys.exit(main())
