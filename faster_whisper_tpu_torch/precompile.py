"""Startup warm for serving: ``warm_parallel``.

Counterpart of the warm part of ``faster_whisper_tpu/precompile.py``.  On
the card a server's first request would otherwise pay for what runs once
per process: building the CUDA kernels from ``csrc/`` with ``nvcc`` (and
the host libraries with ``g++``), creating the CUDA context and the cuBLAS,
cuBLASLt and cuDNN handles, and growing the caching allocator to the
serving shapes.  ``warm_parallel`` pays for all of it before the port
opens, by running the serving path's pieces once on zero-filled inputs at
the production shapes: one encode and beam decode per batch bucket and
decode budget, one VAD forward, one chunked log-mel and, with
``word_timestamps``, one alignment pass.

The JAX package's XLA shape buckets and its persistent-cache counting have
no counterpart here: eager PyTorch compiles nothing per shape.  The offline
cache-filling CLI (``precompile.main``) is not ported.
"""

import functools


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
    ``word_timestamps``.  The JAX package runs those pieces on concurrent
    threads so that their XLA compiles overlap; here nothing compiles, and
    host-driven decodes on concurrent threads only contend for the host
    and the one stream (four bucket decodes on four threads took 37.0 s
    on an H100, ``PERF.md``).

    Returns the list of ``(name, repr(exception))`` of the pieces that
    failed; a failure is logged and does not stop the others.  Every piece
    is stamped through ``log`` as it finishes."""
    import time as _time

    import torch

    from faster_whisper_tpu_torch.ops import _build
    from faster_whisper_tpu_torch.tokenizer import Tokenizer
    from faster_whisper_tpu_torch.transcribe import get_suppressed_tokens
    from faster_whisper_tpu_torch.vad import get_speech_timestamps

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
        xa = eng.encode(mel)
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
