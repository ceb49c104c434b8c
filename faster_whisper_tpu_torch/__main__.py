"""Command-line transcription: ``python -m faster_whisper_tpu_torch audio.flac``.

Counterpart of ``faster_whisper_tpu/__main__.py``, with the same flags and
outputs: transcribe one or more files with the batched pipeline (or the
sequential path with ``--no-vad`` or ``--batch-size 0``) and emit
txt/srt/vtt/json/tsv.  ``--model`` is a model directory or a name found in
the local Hugging Face cache, as for ``WhisperModel``: nothing is
downloaded.  The model runs on the card.
"""

import argparse
import json
import os
import sys


def _fmt_ts(seconds: float, sep: str = ",") -> str:
    from faster_whisper_tpu_torch.utils import format_timestamp

    return format_timestamp(
        seconds, always_include_hours=True, decimal_marker=sep
    )


def _emit(segments, fmt, out):
    if fmt == "txt":
        for seg in segments:
            out.write(seg.text.strip() + "\n")
    elif fmt == "srt":
        for i, seg in enumerate(segments, 1):
            out.write(
                f"{i}\n{_fmt_ts(seg.start)} --> {_fmt_ts(seg.end)}\n"
                f"{seg.text.strip()}\n\n"
            )
    elif fmt == "vtt":
        out.write("WEBVTT\n\n")
        for seg in segments:
            out.write(
                f"{_fmt_ts(seg.start, '.')} --> {_fmt_ts(seg.end, '.')}\n"
                f"{seg.text.strip()}\n\n"
            )
    elif fmt == "tsv":
        out.write("start\tend\ttext\n")
        for seg in segments:
            out.write(
                f"{int(seg.start * 1000)}\t{int(seg.end * 1000)}\t"
                f"{seg.text.strip()}\n"
            )
    elif fmt == "json":
        json.dump(
            {
                "segments": [
                    {
                        "id": s.id,
                        "start": s.start,
                        "end": s.end,
                        "text": s.text,
                        "avg_logprob": s.avg_logprob,
                        "no_speech_prob": s.no_speech_prob,
                        "compression_ratio": s.compression_ratio,
                        "words": (
                            [
                                {
                                    "start": w.start,
                                    "end": w.end,
                                    "word": w.word,
                                    "probability": w.probability,
                                }
                                for w in s.words
                            ]
                            if s.words
                            else None
                        ),
                    }
                    for s in segments
                ]
            },
            out,
            ensure_ascii=False,
            indent=2,
        )
        out.write("\n")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="faster_whisper_tpu_torch",
        description="Whisper transcription on PyTorch and CUDA",
    )
    ap.add_argument("audio", nargs="+", help="audio file(s)")
    ap.add_argument("--model", default="large-v3")
    ap.add_argument("--compute-type", default="default")
    ap.add_argument("--language", default=None)
    ap.add_argument("--task", default="transcribe",
                    choices=["transcribe", "translate"])
    ap.add_argument("--beam-size", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="0 = sequential (windowed) mode")
    ap.add_argument("--word-timestamps", action="store_true")
    ap.add_argument("--no-vad", action="store_true")
    ap.add_argument("--temperature", default=None,
                    help="comma-separated fallback ladder, e.g. '0' or "
                    "'0,0.2,0.4' (default: the reference's 0..1.0 ladder)")
    ap.add_argument("--initial-prompt", default=None)
    ap.add_argument("--hotwords", default=None)
    ap.add_argument("--output-format", default="txt",
                    choices=["txt", "srt", "vtt", "json", "tsv"])
    ap.add_argument("--output-dir", default=None,
                    help="write <stem>.<fmt> files here instead of stdout")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from faster_whisper_tpu_torch import BatchedInferencePipeline, WhisperModel

    model = WhisperModel(args.model, compute_type=args.compute_type)
    pipeline = BatchedInferencePipeline(model) if args.batch_size else None

    kw = dict(
        language=args.language,
        task=args.task,
        beam_size=args.beam_size,
        word_timestamps=args.word_timestamps,
        initial_prompt=args.initial_prompt,
        hotwords=args.hotwords,
    )
    if args.temperature is not None:
        kw["temperature"] = [float(t) for t in args.temperature.split(",")]
    for path in args.audio:
        # --no-vad has no chunking policy for the batched pipeline (it
        # requires VAD chunks or explicit clips, like the reference), so
        # it routes through the sequential windowed path
        if pipeline is not None and not args.no_vad:
            segments, info = pipeline.transcribe(
                path, batch_size=args.batch_size, vad_filter=True, **kw
            )
        else:
            segments, info = model.transcribe(
                path, vad_filter=not args.no_vad, **kw
            )
        segments = list(segments)
        if args.verbose:
            print(
                f"# {path}: language={info.language} "
                f"(p={info.language_probability:.2f}), "
                f"duration={info.duration:.1f}s",
                file=sys.stderr,
            )
        if args.output_dir:
            stem = os.path.splitext(os.path.basename(path))[0]
            dest = os.path.join(
                args.output_dir, f"{stem}.{args.output_format}"
            )
            os.makedirs(args.output_dir, exist_ok=True)
            with open(dest, "w", encoding="utf-8") as f:
                _emit(segments, args.output_format, f)
            print(dest)
        else:
            _emit(segments, args.output_format, sys.stdout)


if __name__ == "__main__":
    main()
