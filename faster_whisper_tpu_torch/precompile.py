"""Ahead-of-time warm-up: the startup warm for serving (``warm_parallel``)
and the offline warm CLI (``main``).

Counterpart of ``faster_whisper_tpu/precompile.py``.  On the card a
server's first request would otherwise pay for what runs once per process:
building the CUDA kernels from ``csrc/`` with ``nvcc`` (and the host
libraries with ``g++``), creating the CUDA context and the cuBLAS,
cuBLASLt and cuDNN handles, and growing the caching allocator to the
serving shapes.  ``warm_parallel`` pays for all of it before the port
opens, by running the serving path's pieces once on zero-filled inputs at
the production shapes: one encode and beam decode per batch bucket and
decode budget, one VAD forward, one chunked log-mel and, with
``word_timestamps``, one alignment pass.

Usage of the CLI, with the JAX package's flags, phases and report:

    python -m faster_whisper_tpu_torch.precompile --model large-v3 \
        --compute-type int8 --batch-size 8 --beam-size 5 \
        --max-new-tokens 128 [--word-timestamps] [--sequential] \
        [--language en] [--random-weights]

It builds the configured model (random weights of the same architecture
with ``--random-weights``, or ``test-micro`` for the micro config) and
pushes speech-shaped audio through the batched pipeline and, with
``--sequential``, the seek loop and every fallback rung's decode form.
The JAX package fills XLA's persistent compilation cache; eager PyTorch
compiles nothing per shape, and what persists here is the kernel build
directory (``ops/_build.py::BUILD_DIR``): the report's
``persistent_cache_dir`` is that directory, ``cache_entries_before`` and
``_after`` count its built libraries, and ``new_programs_cached`` is
their difference.
"""

import argparse
import functools
import json
import os
import sys
import time

# docker/jfk.flac, beside the package: the speech of ``synthetic_speech``.
_SPEECH_FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docker", "jfk.flac"
)
_fixture_cache = {}


def _count_cache_entries(cache_dir) -> int:
    """The built libraries in the kernel build directory."""
    if not cache_dir or not os.path.isdir(cache_dir):
        return 0
    return sum(1 for f in os.listdir(cache_dir) if f.startswith("lib") and f.endswith(".so"))


def synthetic_speech(seconds: float, sr: int = 16000, seed: int = 0):
    """Speech-shaped audio that the Silero VAD accepts: random fragments
    of ``docker/jfk.flac`` spliced with silence gaps, so the VAD cuts
    real chunks and the batched pipeline runs its production batch
    shapes (Silero scores tone constructions as silence).  Falls back to
    harmonic bursts when the file is absent."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    base = None
    if os.path.exists(_SPEECH_FIXTURE):
        base = _fixture_cache.get(sr)
        if base is None:
            from faster_whisper_tpu_torch.audio import decode_audio

            base = np.asarray(decode_audio(_SPEECH_FIXTURE, sampling_rate=sr), np.float32)
            _fixture_cache[sr] = base
    if base is None or len(base) < sr:
        return _harmonic_bursts(seconds, sr, seed)

    out = np.zeros(n, np.float32)
    t = 0
    while t < n:
        frag = int(rng.uniform(1.0, 4.0) * sr)
        start = int(rng.uniform(0, max(1, len(base) - frag)))
        gap = int(rng.uniform(0.3, 1.2) * sr)
        end = min(t + frag, n)
        out[t:end] = base[start : start + (end - t)]
        t = end + gap
    return out


def _harmonic_bursts(seconds: float, sr: int = 16000, seed: int = 0):
    """Harmonic bursts with pauses (the fixture-free fallback; a trained
    VAD does not take them for speech)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    out = np.zeros(n, np.float32)
    t = 0
    while t < n:
        burst = int(rng.uniform(1.0, 6.0) * sr)  # 1-6 s of "speech"
        gap = int(rng.uniform(0.3, 1.2) * sr)  # short silence
        end = min(t + burst, n)
        seg_t = np.arange(end - t) / sr
        f0 = rng.uniform(90, 220)
        sig = np.zeros(end - t, np.float32)
        for h in (1, 2, 3):
            sig += (0.3 / h) * np.sin(2 * np.pi * f0 * h * seg_t + rng.uniform(0, 6.28)).astype(
                np.float32
            )
        # syllable-rate amplitude modulation + noise floor
        sig *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2, 5) * seg_t).astype(np.float32)
        sig += 0.02 * rng.standard_normal(end - t).astype(np.float32)
        out[t:end] = sig
        t = end + gap
    return out


def warm_parallel(
    model,
    *,
    durations_s=(65.0, 780.0),
    batch_size: int = 8,
    beam_size: int = 5,
    max_new_tokens=128,  # int, None (= the model's full context), or a
    # sequence of those: servers that accept requests WITHOUT
    # max_new_tokens warm None too (the default request's decode length)
    language: str = "en",
    word_timestamps: bool = False,
    without_timestamps: bool = True,  # the batched pipeline's default
    log=None,
):
    """Warm the batched serving path before a server opens its port.

    First the native libraries the model's device runs are built (one
    compiler per source, all started together: the parallel part) and
    loaded.  Then, one after another: one tiny blocking computation (the
    CUDA context and a cuBLAS handle), one VAD forward over the longest
    duration, one chunked log-mel of that duration's 30 s chunks, and per
    batch bucket (the powers of two up to ``batch_size``, which the
    pipeline pads to) one encode and one beam decode per decode budget with
    the production arguments, plus the alignment pass with
    ``word_timestamps``, on every replica of a mesh (with a model axis,
    every group of shards).  The JAX package runs those pieces on concurrent
    threads so that their XLA compiles overlap; here nothing compiles, and
    host-driven decodes on concurrent threads only contend for the host
    and the one stream (four bucket decodes on four threads took 37.0 s
    on an H100, ``PERF.md``).

    Returns the list of ``(name, repr(exception))`` of the pieces that
    failed; a failure is logged and does not stop the others.  Every piece
    is stamped through ``log`` as it finishes."""
    import time as _time

    import numpy as np
    import torch

    from faster_whisper_tpu_torch.models.engine import ShardedStates
    from faster_whisper_tpu_torch.ops import _build
    from faster_whisper_tpu_torch.tokenizer import Tokenizer
    from faster_whisper_tpu_torch.transcribe import get_suppressed_tokens
    from faster_whisper_tpu_torch.vad import get_speech_timestamps, upload_with_vad

    eng = model.model
    fe = model.feature_extractor
    dev = model.device
    say = log or (lambda msg: None)
    t0 = _time.perf_counter()
    failures = []

    def timed(name, fn):
        t1 = _time.perf_counter()
        try:
            fn()
        except Exception as exc:  # noqa: BLE001 — warm must not kill serving
            failures.append((name, repr(exc)))
            say(f"# warm {name} FAILED: {exc!r}")
            return
        t2 = _time.perf_counter()
        say(f"# warm {name}: {t2 - t1:.1f}s (at +{t2 - t0:.1f}s)")

    def build():
        # the CUDA kernels only for a model on the card; on the host the
        # wrappers run their plain versions.  Built before any launch: a
        # first launch would build its one source alone
        sources = [
            src for src in _build.SIGNATURES
            if src not in _build.LINK_FLAGS
            and (dev.type == "cuda" or not src.endswith(".cu"))
        ]
        _build.build(sources)
        for src in sources:
            _build.load(src)

    def establish():
        a = torch.ones((64, 64), device=dev)
        float((a @ a).sum())

    n_longest = int(max(durations_s) * fe.sampling_rate)

    def vad_warm():
        get_speech_timestamps(torch.zeros(n_longest, device=dev))
        # the pipelined sliced upload is opt-in; warm it only where the
        # deployment opted in
        if os.environ.get("FWT_PIPELINED_VAD", "0") == "1":
            upload_with_vad(np.zeros(n_longest, np.float32), device=dev)

    def mel_warm():
        win = fe.n_samples
        starts = list(range(0, n_longest, win))
        lengths = [min(win, n_longest - s) for s in starts]
        fe.chunk_features(torch.zeros(n_longest, device=dev), starts, lengths)

    # The pipeline pads the batch axis to powers of two
    # (transcribe.py::_dispatch_segment_batch, scheduler.py::_dispatch), so
    # {1, 2, 4, ..., batch_size} are the batch sizes serving runs.
    b_set = {batch_size}
    b = 1
    while b < batch_size:
        b_set.add(b)
        b *= 2

    budgets = (
        tuple(max_new_tokens)
        if isinstance(max_new_tokens, (tuple, list, set))
        else (max_new_tokens,)
    )

    def decode_warm(b):
        # encode + the production beam decode (and the alignment pass with
        # word_timestamps) with the arguments the pipeline passes
        tokenizer = Tokenizer(
            model.hf_tokenizer,
            eng.is_multilingual,
            task="transcribe",
            language=language,
        )
        suppress = get_suppressed_tokens(tokenizer, [-1])
        prompt = model.get_prompt(
            tokenizer, previous_tokens=[],
            without_timestamps=without_timestamps,
        )
        mel = torch.zeros((b, eng.n_mels, fe.nb_max_frames), device=dev)
        # every bucket on every replica of a mesh (with a model axis, every
        # group of shards); one device encodes as the pipeline does
        for r in range(len(eng.replicas)):
            xa = (eng.encode(mel) if len(eng.replicas) == 1
                  else ShardedStates([eng._encode_on(r, mel)], [r]))
            for budget in budgets:
                max_len = min(
                    len(prompt) + (budget or model.max_length), model.max_length
                )
                eng.generate(
                    xa,
                    [list(prompt)] * b,
                    beam_size=beam_size,
                    patience=1,
                    length_penalty=1,
                    repetition_penalty=1,
                    no_repeat_ngram_size=0,
                    max_length=max_len,
                    suppress_blank=True,
                    suppress_tokens=suppress,
                    max_initial_timestamp_index=50,
                    sampling_temperature=0.0,
                )
            if word_timestamps:
                eng.align(
                    xa,
                    list(tokenizer.sot_sequence),
                    [[tokenizer.timestamp_begin]] * b,
                    [fe.nb_max_frames] * b,
                    median_filter_width=7,
                )

    timed("build native libraries", build)
    timed("establish (first blocking computation)", establish)
    timed("vad", vad_warm)
    timed("mel", mel_warm)
    for b in sorted(b_set):
        timed(f"encode+beam B={b}", functools.partial(decode_warm, b))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    say(f"# warm_parallel total: {_time.perf_counter() - t0:.1f}s")
    return failures


def build_model(args, device="cuda"):
    """The model of the CLI's arguments on ``device`` (the card by
    default): with ``--random-weights``, random bfloat16 weights from seed
    0 of ``--model``'s config (``test-micro``: the micro config) and the
    synthetic vocabulary of its size, at ``--compute-type``; else
    ``WhisperModel(--model)``."""
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    if args.random_weights:
        import torch

        from faster_whisper_tpu_torch.models.config import CONFIGS, tiny_test_config
        from faster_whisper_tpu_torch.models.load import random_params
        from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer

        if args.model == "test-micro":  # hermetic CPU tests
            config = tiny_test_config()
            tok = build_synthetic_tokenizer()
        else:
            config = CONFIGS[args.model]
            tok = build_synthetic_tokenizer(base_vocab=config.n_vocab - 1609)
        params = random_params(config, seed=0, dtype=torch.bfloat16, device=device)
        return WhisperModel.from_parts(
            params, config, tok, {"feature_size": config.n_mels},
            compute_type=args.compute_type, device=device,
        )
    return WhisperModel(args.model, device=device, compute_type=args.compute_type)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="faster_whisper_tpu_torch.precompile", description=__doc__.split("\n")[0]
    )
    p.add_argument("--model", default="large-v3")
    p.add_argument("--compute-type", default="int8")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--beam-size", type=int, default=5)
    p.add_argument("--best-of", type=int, default=5)
    p.add_argument(
        "--max-new-tokens", type=int, default=None,
        help="decode-budget bucket to compile (None = the model's full "
        "448 context)",
    )
    p.add_argument(
        "--language", default=None,
        help="pin the language (skips compiling language detection)",
    )
    p.add_argument(
        "--word-timestamps", action="store_true",
        help="also compile the alignment (DTW) forward pass",
    )
    p.add_argument(
        "--sequential", action="store_true",
        help="also compile the sequential seek-loop path: the long-prompt "
        "(conditioned) prefill bucket and the temperature-fallback "
        "sampling rungs",
    )
    p.add_argument(
        "--temperatures", default="0.0,0.2,0.4,0.6,0.8,1.0",
        help="fallback ladder to compile for --sequential",
    )
    p.add_argument("--random-weights", action="store_true")
    args = p.parse_args(argv)

    from faster_whisper_tpu_torch.ops import _build
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline

    cache_dir = str(_build.BUILD_DIR)
    n0 = _count_cache_entries(cache_dir)
    phases = []

    def phase(name, fn):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        phases.append((name, dt))
        print(f"# {name}: {dt:.1f}s", file=sys.stderr)

    t_start = time.perf_counter()
    model = build_model(args)
    phases.append(("load", time.perf_counter() - t_start))

    # Enough audio for two full batches and a trailing partial batch, so
    # the padded trailing batch runs too.
    audio = synthetic_speech((2 * args.batch_size + 3) * 18.0)
    pipeline = BatchedInferencePipeline(model)

    def run_batched(word_ts=False):
        segments, _ = pipeline.transcribe(
            audio,
            language=args.language,
            beam_size=args.beam_size,
            batch_size=args.batch_size,
            max_new_tokens=args.max_new_tokens,
            temperature=[0.0],
            word_timestamps=word_ts,
        )
        for _ in segments:
            pass

    phase("batched pipeline (beam)", run_batched)
    if args.word_timestamps:
        phase("alignment pass", lambda: run_batched(word_ts=True))

    if args.sequential:
        temps = [float(t) for t in args.temperatures.split(",") if t]

        def run_sequential():
            segments, _ = model.transcribe(
                audio[: 16000 * 95],
                language=args.language,
                beam_size=args.beam_size,
                best_of=args.best_of,
                max_new_tokens=args.max_new_tokens,
                temperature=temps,
                condition_on_previous_text=True,
            )
            for _ in segments:
                pass

        phase("sequential path (beam + conditioned prompts)", run_sequential)

        # Every decode form of the fallback ladder with the arguments
        # generate_with_fallback passes, at the three prompt lengths of
        # get_prompt (the first window, a short and the full 223-token
        # conditioning): the beam rung, a B=1 sampling rung and the
        # batched sampling tail (one row per remaining rung).
        def run_rungs():
            import numpy as np

            from faster_whisper_tpu_torch.tokenizer import Tokenizer
            from faster_whisper_tpu_torch.transcribe import get_suppressed_tokens

            eng = model.model
            tokenizer = Tokenizer(
                model.hf_tokenizer,
                eng.is_multilingual,
                task="transcribe",
                language=args.language or "en",
            )
            suppress = get_suppressed_tokens(tokenizer, [-1])
            feat = np.asarray(model.feature_extractor(audio[: 16000 * 30]))
            xa = eng.encode(np.ascontiguousarray(feat[:, :3000])[None])
            filler = tokenizer.encode("the ") or [0]
            prompts = [
                model.get_prompt(tokenizer, previous_tokens=prev)
                for prev in (
                    [],  # the first window
                    (filler * 90)[:90],  # short conditioning
                    (filler * 223)[:223],  # the full tail
                )
            ]
            sample_tail = [t for t in temps if t > 0]
            for prompt in prompts:
                max_len = min(
                    len(prompt) + (args.max_new_tokens or model.max_length),
                    model.max_length,
                )
                common = dict(
                    length_penalty=1.0,
                    repetition_penalty=1.0,
                    no_repeat_ngram_size=0,
                    max_length=max_len,
                    suppress_blank=True,
                    suppress_tokens=suppress,
                    max_initial_timestamp_index=50,
                )
                if any(t <= 0 for t in temps):
                    eng.generate(xa, [prompt], beam_size=args.beam_size, patience=1.0, **common)
                sample_kwargs = dict(
                    beam_size=1, num_hypotheses=args.best_of, sampling_topk=0, **common,
                )
                if sample_tail:
                    eng.generate(
                        xa, [prompt], sampling_temperature=sample_tail[0], **sample_kwargs,
                    )
                if len(sample_tail) > 1:
                    n = len(sample_tail)
                    eng.generate(
                        xa.expand((n,) + tuple(xa.shape[1:])), [prompt] * n,
                        sampling_temperature=sample_tail, **sample_kwargs,
                    )

        phase("fallback rungs (all temps x prompt buckets)", run_rungs)

    n1 = _count_cache_entries(cache_dir)
    total = time.perf_counter() - t_start
    report = {
        "model": args.model,
        "compute_type": args.compute_type,
        "batch_size": args.batch_size,
        "beam_size": args.beam_size,
        "max_new_tokens": args.max_new_tokens,
        "persistent_cache_dir": cache_dir,
        "cache_entries_before": n0,
        "cache_entries_after": n1,
        "new_programs_cached": n1 - n0,
        "phases": {name: round(dt, 1) for name, dt in phases},
        "total_seconds": round(total, 1),
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
