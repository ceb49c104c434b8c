#!/usr/bin/env python3
"""Smoke run of faster_whisper_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line with its seconds:

1. device: requires a CUDA card, prints its name and power limit, turns
   TF32 off for float32 matmuls and convolutions;
2. build: compiles every CUDA kernel of the main path from ``csrc/`` with
   nvcc and the host libraries (FLAC, DTW, the VAD's state machine) with
   g++, one process per source, all started together, and prints the
   ``-Xptxas -v`` register and shared-memory lines; the libav media
   decoder is left out (it needs FFmpeg's headers, which this machine may
   lack, and no phase decodes a compressed container);
3. kernels: holds each kernel form against its plain PyTorch version on
   the card, at the main path's shapes, in bfloat16 and in float32: K1 and
   K2 (beam self-attention over a raw and an int8 cache, with the write
   position on and beside the column chunks' boundaries, and two layers in
   one CUDA graph, which reuse its ticket counters), K3 (encoder flash
   attention, at ragged and full lengths), K4 over a raw and an int8 cache
   (decode cross-attention; two calls back to back and two layers in one
   CUDA graph), the int8 form also over codes at 4-bit range (qmax 7, the
   int4 cross cache);
4. times: each kernel form, its plain version and, where one exists, the
   one PyTorch call that computes the same function, on the card (CUDA
   events around the replay of a CUDA graph of 20 calls, L2 warm), each
   kernel again with L2 cold (a 256 MB buffer written before each call,
   each call under its own events), beside the least time the card could
   take (its bound), and each kernel's time per call when the host issues
   the calls one by one, as the decode loop does;
5. VAD: ``docker/jfk.flac`` decoded by the port's ``decode_audio`` and
   tiled to 5 minutes; the Silero VAD's probabilities and speech
   timestamps on the card against the same weights on the CPU, and its
   seconds on each; the native state machine (``hysteresis_native``) on
   the card's probabilities against its plain Python loop, both timed;
6. chunked mel: the device log-mel of the VAD's speech chunks on the card
   against the host ``FeatureExtractor`` on the same chunks;
7. main path: ``WhisperModel.transcribe`` at large-v3-turbo width (random
   weights from a seed, the synthetic 51866-token vocabulary), at bf16 on
   three requests (a-c), at ``compute_type="int8"`` on two (d, e), at
   ``"float32"`` on one (f) and at ``"int8_float32"`` on one (g); and
   ``BatchedInferencePipeline.transcribe`` (VAD on, beam 5, batch 8, 128
   new tokens per chunk) over the tiled audio, request h at bf16, i at
   ``"int8"``, n at ``"int4"`` and o at ``"int4"`` with
   ``int4_group_size=128`` (n's and o's launch counts equal to i's).
   Each run has its launch counts set to 0 before and read
   after: per decode step (over all rows and beams) four launches of K1
   and K4 in the run's activation type over a raw cache, or of K2 and
   K4's int8 form over an int8 cache, per encode (of a window, or of a
   batch of chunks) 32 of K3 in the run's activation type, and no launch
   of any other form;
8. small model: a small model on the card, at bf16, int8, float32,
   int8_float32 and int4 (per channel and in groups), against the same
   model on the CPU (at int4 its quantized decoder codes and scales must be
   equal on both); then at float32
   through the pipeline, on ``clip_timestamps`` and with the defaults on
   ``docker/jfk.flac`` given as a path, whose tokens on the card must
   equal those on the CPU;
9. checkpoints: the large-v3-turbo weights of phase 7 written as a
   CTranslate2 directory with a float16 ``model.bin`` and as one with an
   int8 ``model.bin`` (int8 linear weights with per-row scales, the rest
   float16), each with ``config.json``, ``preprocessor_config.json`` and a
   full-width ``tokenizer.json`` with BPE merges, under ``build/``;
   request j, ``WhisperModel(directory)`` with its defaults (the card,
   bf16) on 20 s at beam 5, whose loaded weights must equal the
   float16-rounded weights bit for bit and whose segments must equal
   ``from_parts`` on them; request k, ``WhisperModel(directory,
   compute_type="int8")`` through the pipeline as in request i; each with
   the launch counts of phase 7.  A small model written as an HF
   safetensors directory, on the card against the CPU (equal tokens).
   ``docker/jfk.flac`` through the native FLAC decoder, bit for bit the
   numpy decoder's samples.  Load, write and decode times and file sizes
   are printed beside the card's name and power limit; the directories
   are deleted at the end;
10. word timestamps, with the large-v3-turbo weights of phase 7 and the
    fallback alignment heads (the 40 heads of decoder layers 2-3): request
    l, ``WhisperModel.transcribe`` at bf16 on 20 s of the tiled speech,
    ``language="en"``, beam 5, ``word_timestamps=True``,
    ``hallucination_silence_threshold=2.0``; request m, request i with
    ``word_timestamps=True``, whose segment tokens and texts and launch
    counts must equal request i's.  Each alignment pass is timed with CUDA
    events and must launch no kernel of K1-K4 and run no encode; every
    DTW matrix goes through the numpy DTW too, whose path must equal the
    native one's; the words are held to ``check_words``.  Then the small
    float32 model with words on the card against the CPU, sequential and
    through the pipeline: equal words and times, probabilities within
    WORD_PROB_TOL;
11. serving, over the int8 model of request i: ``warm_parallel``
    (durations 30 and 300 s, batch 8, beam 5, 128 new tokens) with no
    failures; ``server.make_server`` on 127.0.0.1 with its
    ``ContinuousBatcher``, ``/healthz``; ``docker/jfk.flac`` tiled to 60 s
    as a WAV upload, sent as 4 multipart requests (en, beam 5, batch 8,
    128 new tokens) together with one SSE (``stream=true``) and one
    sequential (``batch_size=0``) request: every reply 200 with
    well-formed segments, fewer batches than chunks, and ``/metrics``
    reporting the batcher's two counters and 6 ok requests; then the 4
    batched requests again, alone, whose launch counts (set to 0 just
    before, read just after: only the batcher's thread launches) follow
    phase 7's rule, with each request's latency, audio seconds per wall
    second, the batcher thread's idle time and peak memory, against the
    same 4 one after another through the pipeline without the scheduler
    (a scheduled chunk's tokens must equal the unscheduled one's where
    their batch buckets are equal; elsewhere the count of differing
    tokens and the first differing step are printed); at float32 with
    cuDNN's TF32 at PyTorch's default, an encode on one thread while
    another sits in ``exact_float32`` must equal the encode alone, and a
    sequential and a batched request served together must equal each
    served alone, launching on one stream; last the CLI, ``python -m
    faster_whisper_tpu_torch`` on the 60 s WAV with the int8 CT2
    directory of request k, must exit 0 and print well-formed SRT;
12. speculation, the pipelined VAD, the gate, the warm CLI and memory:
    one speculative encode on the side stream against the in-line encode
    at bf16 and int8 (``torch.equal``; K3 x 32 and no K1, K2 or K4
    launched on the side stream), then requests p (150 s of the
    synthetic audio, en, without timestamps, beam 5, 128 new tokens,
    temperature 0, bf16), q (p at int8) and a, each with
    ``FWT_SPEC_ENCODE=0`` and then ``=1`` (``SpeculationProbe``: the
    sampling rungs' seeds follow the call order in both), whose segments
    must be equal, every hit's states equal to the in-line encode of its
    window and every speculative encode free of K1, K2 and K4 launches;
    speculative encodes, hits, misses, K3 launches, wall seconds, ms per
    step, and the side encode's device ms against the decode steps that
    ran beside it are printed.  ``upload_with_vad`` over the tiled 5
    minutes against ``upload_audio`` and the whole-buffer forward, timed in
    turns (PCM equal, probabilities within VAD_PROB_TOL, speech
    timestamps equal), and request h under ``FWT_PIPELINED_VAD=1``, whose
    segments must be h's.  ``validate.main(["--mock"])`` (the micro model
    at widths 128, float32) must exit 0 with no failure;
    ``precompile.main`` at large-v3-turbo width, int8, must exit 0 with
    phase 7's launch counts; ``memory_report(batch_size=8, beam_size=5,
    max_new_tokens=128)`` on request i's int8 model is printed beside i's
    measured peak.

Then it prints one JSON line with every kernel's numbers, the card's name
and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Any failure raises and exits nonzero before that line.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (dense, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 495e12
F32_FLOPS = 67e12

BF16_REL_TOL = 2e-2  # of the output scale: one bf16 rounding of P and of the output
# Of the output scale, for the float32 forms: the same function in float32,
# sums over up to 1500 terms taken in another order, exp2f/expf within 2 ulp.
F32_REL_TOL = 2e-5
# A small float32 model on the card against the CPU: float32 matmuls and
# convolutions on both (TF32 off), summed in other orders through every layer.
F32_MODEL_TOL = 1e-5
# Silero VAD probabilities, card against CPU: float32 on both (TF32 off),
# an LSTM carried over ~9,400 windows with its sums in other orders.
VAD_PROB_TOL = 1e-4
# Chunked log-mel on the card against the host FeatureExtractor: the JAX
# package's tolerance for the same comparison (tests/test_chunked_mel.py),
# float32 DFT sums over 400 samples in another order, through log10.
MEL_ATOL, MEL_RTOL = 3e-4, 1e-3
# Word probabilities of a small float32 model, card against CPU: means of
# a few float32 softmax probabilities over the text vocabulary, summed in
# other orders (the CPU tests hold the port to the JAX package so, too).
WORD_PROB_TOL = 1e-5
# The micro vocabulary's specials (ids 257..1864), suppressed where a small
# random model must decode text for its words to be aligned.
SMALL_SPECIALS = [-1] + list(range(257, 1865))
# How far past a chunk's speech its last word may end: the DTW runs over
# ceil(duration) seconds of encoder frames (< 1 s more), and the reference
# stretches a last word to at least the median word duration (<= 0.7 s).
WINDOW_STRETCH_S = 1.7
JFK_FLAC = "docker/jfk.flac"
FLUSH_BYTES = 256 * 2**20  # written before each L2-cold call: 5x the 50 MB L2

K1_REPLACES = "faster_whisper_tpu/ops/beam_attention.py:248"
K2_REPLACES = "faster_whisper_tpu/ops/beam_attention.py:91"
K3_REPLACES = "faster_whisper_tpu/ops/attention.py:123"
K4A_REPLACES = "faster_whisper_tpu/ops/beam_attention.py:715"
K4B_REPLACES = "faster_whisper_tpu/ops/beam_attention.py:535"  # and K4c, :605

# Words that the written tokenizer.json merges into one token each.
MERGED_WORDS = (
    " the and of to a in is you that it he was for on are as with his they I at be this"
    " have from or one had by word but not what all were we when your can said there use"
    " an each which she do how their if will up other about out many then them these so"
    " some her would make like him into time has look two more write go see number no way"
    " could people my than first water been call who its now find long down day did get"
    " come made may part country ask fellow Americans And So"
).split(" ")[1:]
MERGED_WORDS = tuple(" " + w for w in MERGED_WORDS)
# (layer, head) pairs written into the CT2 config.json and read back.
ALIGNMENT_HEADS = ((2, 4), (2, 11), (3, 3), (3, 6), (3, 11), (3, 14))


def phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def require_card():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")


def build_kernels():
    """Phase 2: every kernel from source; returns {source: ptxas lines}."""
    from faster_whisper_tpu_torch.ops import _build

    logs = _build.build()
    return {
        src: [ln.strip() for ln in log.splitlines() if "ptxas info" in ln] or [log.strip()]
        for src, log in logs.items()
    }


# ---------------------------------------------------------------------------
# K1: beam self-attention with in-place append
# ---------------------------------------------------------------------------


def tolerance(dtype):
    return F32_REL_TOL if dtype == torch.float32 else BF16_REL_TOL


def dtype_name(dtype):
    return "f32" if dtype == torch.float32 else "bf16"


def k1_inputs(B, pos, K=5, H=20, D=64, L=4, ctx=448, seed=0, divergent=False,
              dtype=torch.bfloat16):
    """K1's inputs in ``dtype``.  ``anc`` draws each query beam's slot per
    column at random, so that beams share rows; with ``divergent`` every
    column is a permutation of the K slots instead, so that no two beams
    share a row (the case in which each query reads K*pos distinct cache
    rows)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    if divergent:
        keys = torch.rand((B, ctx, K), generator=g, device="cuda")
        anc = keys.argsort(dim=-1).transpose(1, 2).to(torch.int32).contiguous()
    else:
        anc = torch.randint(0, K, (B, K, ctx), generator=g, device="cuda", dtype=torch.int32)
    anc[:, :, pos] = torch.arange(K, device="cuda", dtype=torch.int32)  # own slot at pos
    return dict(
        layer=L - 1,
        pos_row=torch.full((B,), pos, device="cuda", dtype=torch.int32),
        q=randn(B, H, K, D), k_new=randn(B, H, K, D), v_new=randn(B, H, K, D),
        self_k=randn(L, B, H, K, ctx, D), self_v=randn(L, B, H, K, ctx, D), anc=anc,
    )


def _clone(cache):
    from faster_whisper_tpu_torch.ops.quant import QuantKV

    if isinstance(cache, QuantKV):
        return QuantKV(cache.q.clone(), cache.s.clone())
    return cache.clone()


def _k1_call(fn, x, caches=None, layer=None):
    sk, sv = caches if caches is not None else (_clone(x["self_k"]), _clone(x["self_v"]))
    layer = x["layer"] if layer is None else layer
    return fn(layer, x["pos_row"], x["q"], x["k_new"], x["v_new"], sk, sv, x["anc"])


def beam_positions(B, quant, dtype, K=5, H=20, D=64, ctx=448):
    """(B, pos) for the K1/K2 checks: the first two columns (most chunks
    empty), the last, and the columns on and beside the first chunk
    boundary of the kernel's plan at this shape."""
    from faster_whisper_tpu_torch.ops.beam_attention import _split_plan

    row_bytes = D * (1 if quant else torch.finfo(dtype).bits // 8)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    chunk, _ = _split_plan(B, H, K, ctx, row_bytes, n_sm)
    return [(B, pos) for pos in sorted({0, 1, chunk - 1, chunk, chunk + 1, ctx - 1})]


def check_beam_attention(batches=(1, 8), dtype=torch.bfloat16):
    """K1 in ``dtype`` against its plain version at ``beam_positions``: the
    attention output within the dtype's tolerance, and the caches: the
    target column of every slot holds the new K/V, every other element is
    untouched.  Returns the max abs error."""
    from faster_whisper_tpu_torch.ops.beam_attention import (
        beam_attend_append,
        beam_attend_append_ref,
    )

    shapes = [bp for B in batches for bp in beam_positions(B, False, dtype)]
    worst = 0.0
    for (B, pos), divergent in ((shape, d) for shape in shapes for d in (False, True)):
        x = k1_inputs(B, pos, seed=B * 1000 + pos, divergent=divergent, dtype=dtype)
        ref, rk, rv = _k1_call(beam_attend_append_ref, x)
        out, ok, ov = _k1_call(beam_attend_append, x)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tolerance(dtype) * ref.float().abs().max().item()
        print(f"K1 {dtype_name(dtype)} B={B} K=5 ctx=448 pos={pos} "
              f"{'divergent' if divergent else 'shared'} ancestry: "
              f"max|err| {err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version at B={B}, pos={pos}, divergent={divergent}")
        if not (torch.equal(ok, rk) and torch.equal(ov, rv)):
            raise AssertionError(f"K1 caches differ from the plain version at B={B}, pos={pos}")
        layer = x["layer"]
        if not torch.equal(ok[layer, :, :, :, pos], x["k_new"]) or not torch.equal(
            ov[layer, :, :, :, pos], x["v_new"]
        ):
            raise AssertionError("K1 did not write the target column")
        keep = torch.ones(ok.shape, dtype=torch.bool, device="cuda")
        keep[layer, :, :, :, pos] = False
        if not (torch.equal(ok[keep], x["self_k"][keep]) and torch.equal(ov[keep], x["self_v"][keep])):
            raise AssertionError("K1 wrote outside the target column")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# K2: beam self-attention over the int8 cache
# ---------------------------------------------------------------------------


def k2_inputs(B, pos, seed=0, divergent=False, **kw):
    """K1's inputs with the caches quantized as the int8 decode stores
    them: int8 codes and bf16 scales (L, B, H, K, ctx)."""
    from faster_whisper_tpu_torch.ops.quant import QuantKV, quantize_kv

    x = k1_inputs(B, pos, seed=seed, divergent=divergent, **kw)
    for name in ("self_k", "self_v"):
        qk = quantize_kv(x[name])
        x[name] = QuantKV(qk.q, qk.s.to(torch.bfloat16))
    return x


def check_beam_attention_int8(batches=(1, 8), dtype=torch.bfloat16):
    """K2 with ``dtype`` activations against its plain version at
    ``beam_positions``: the attention output within the dtype's tolerance;
    the codes written at the target column equal to the plain version's
    (up to one unit where a value lies on a rounding boundary, counted),
    the scales bit-equal, and nothing outside the target column moved.
    Returns (max abs error, count of codes that differ)."""
    from faster_whisper_tpu_torch.ops.beam_attention import (
        beam_attend_append,
        beam_attend_append_ref,
    )

    shapes = [bp for B in batches for bp in beam_positions(B, True, dtype)]
    worst, n_diff = 0.0, 0
    for (B, pos), divergent in ((shape, d) for shape in shapes for d in (False, True)):
        x = k2_inputs(B, pos, seed=B * 1000 + pos + 7, divergent=divergent, dtype=dtype)
        ref, rk, rv = _k1_call(beam_attend_append_ref, x)
        out, ok, ov = _k1_call(beam_attend_append, x)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tolerance(dtype) * ref.float().abs().max().item()
        code_diff = max(
            (a.q.int() - b.q.int()).abs().max().item() for a, b in ((ok, rk), (ov, rv))
        )
        n = sum(int((a.q != b.q).sum()) for a, b in ((ok, rk), (ov, rv)))
        print(f"K2 {dtype_name(dtype)} B={B} K=5 ctx=448 pos={pos} "
              f"{'divergent' if divergent else 'shared'} ancestry: "
              f"max|err| {err:.3e} (tolerance {tol:.3e}), {n} codes differ (max {code_diff})")
        if not err <= tol:
            raise AssertionError(f"K2 disagrees with its plain version at B={B}, pos={pos}, divergent={divergent}")
        if code_diff > 1:
            raise AssertionError(f"K2 codes differ by {code_diff} from the plain version's at B={B}, pos={pos}")
        if not (torch.equal(ok.s, rk.s) and torch.equal(ov.s, rv.s)):
            raise AssertionError(f"K2 scales differ from the plain version's at B={B}, pos={pos}")
        layer = x["layer"]
        for new, old in ((ok, x["self_k"]), (ov, x["self_v"])):
            keep = torch.ones(new.q.shape, dtype=torch.bool, device="cuda")
            keep[layer, :, :, :, pos] = False
            if not torch.equal(new.q[keep], old.q[keep]) or not torch.equal(
                new.s[keep[..., 0]], old.s[keep[..., 0]]
            ):
                raise AssertionError("K2 wrote outside the target column")
        worst, n_diff = max(worst, err), n_diff + n
    return worst, n_diff


K1_FORMS = {  # form -> (int8 cache, activation dtype)
    "K1": (False, torch.bfloat16),
    "K1 f32": (False, torch.float32),
    "K2": (True, torch.bfloat16),
    "K2 f32": (True, torch.float32),
}


def check_beam_attention_graph(form, B=1, pos=40):
    """Two layers of K1/K2 (``form``) captured in one CUDA graph and
    replayed twice: every replay's outputs agree with the plain version's,
    so the ticket counters were reset after each launch."""
    from faster_whisper_tpu_torch.ops.beam_attention import (
        beam_attend_append,
        beam_attend_append_ref,
    )

    quant, dtype = K1_FORMS[form]
    x = (k2_inputs if quant else k1_inputs)(B, pos, seed=77, divergent=True, dtype=dtype)
    layers = (x["layer"], x["layer"] - 1)
    refs = [_k1_call(beam_attend_append_ref, x, layer=i)[0] for i in layers]
    caches = (_clone(x["self_k"]), _clone(x["self_v"]))  # the appends rewrite one column
    for i in layers:  # warm-up outside the capture
        _k1_call(beam_attend_append, x, caches, layer=i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [_k1_call(beam_attend_append, x, caches, layer=i)[0] for i in layers]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for o, r in zip(outs, refs):
            err = (o.float() - r.float()).abs().max().item()
            if not err <= tolerance(dtype) * r.float().abs().max().item():
                raise AssertionError(f"{form} in a CUDA graph of two layers disagrees: {err:.3e}")
    print(f"{form}: two layers in one CUDA graph, replayed twice, agree")


# ---------------------------------------------------------------------------
# K4: decode cross-attention, bf16 and int8 forms
# ---------------------------------------------------------------------------


def k4_inputs(B, quant, K=5, H=20, D=64, L=4, T=1500, seed=0, dtype=torch.bfloat16, qmax=127):
    """A layer index, queries (B, H, K, D) in ``dtype`` and the stacked
    (L, B, H, T, D) cross caches: raw in ``dtype``, or int8 codes within
    ``qmax`` (7: the int4 cross cache) with bf16 scales (L, B, H, 1, T) as
    the int8 and int4 decodes store them."""
    from faster_whisper_tpu_torch.ops.quant import QuantKV, quantize_kv

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, ck, cv = randn(B, H, K, D), randn(L, B, H, T, D), randn(L, B, H, T, D)
    if quant:
        ck, cv = (
            QuantKV(c.q, c.s.to(torch.bfloat16)[:, :, :, None].contiguous())
            for c in (quantize_kv(ck, qmax=qmax), quantize_kv(cv, qmax=qmax))
        )
    return L - 1, q, ck, cv


K4_FORMS = {  # form -> (int8 cache, activation dtype, qmax of the codes)
    "bf16": (False, torch.bfloat16, 127),
    "int8": (True, torch.bfloat16, 127),
    "f32": (False, torch.float32, 127),
    "int8 f32": (True, torch.float32, 127),
    # the int8 form over the int4 cross cache: codes in [-7, 7]
    "int8 qmax7": (True, torch.bfloat16, 7),
    "int8 qmax7 f32": (True, torch.float32, 7),
}


def check_cross_attention(batches=(1, 8), forms=tuple(K4_FORMS), Ts=(1500,), Ks=(5,), L=4):
    """K4, each form, against its plain version; the second of two calls
    back to back must equal the first (the ticket counters were reset), and
    two layers captured in one CUDA graph and replayed twice must agree
    with their plain versions.  Returns {form: max abs error}."""
    from faster_whisper_tpu_torch.ops.cross_attention import cross_attend, cross_attend_ref

    worst = {}
    for form in forms:
        quant, dtype, qmax = K4_FORMS[form]
        for B in batches:
            for T in Ts:
                for K in Ks:
                    seed = B + 10 * quant + T + K + 1000 * (qmax != 127)
                    layer, q, ck, cv = k4_inputs(B, quant, K=K, L=L, T=T, seed=seed, dtype=dtype,
                                                 qmax=qmax)
                    ref = cross_attend_ref(layer, q, ck, cv)
                    out = cross_attend(layer, q, ck, cv)
                    again = cross_attend(layer, q, ck, cv)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    tol = tolerance(dtype) * ref.float().abs().max().item()
                    print(f"K4 {form} B={B} K={K} T={T}: max|err| {err:.3e} (tolerance {tol:.3e})")
                    if not err <= tol:
                        raise AssertionError(f"K4 ({form}) disagrees with its plain version at B={B}, K={K}, T={T}")
                    if not torch.equal(out, again):
                        raise AssertionError(f"K4 ({form}): a second call differs from the first at B={B}, K={K}, T={T}")
                    worst[form] = max(worst.get(form, 0.0), err)
        # Two layers in one graph, replayed twice.
        layer, q, ck, cv = k4_inputs(batches[0], quant, L=L, T=Ts[0], seed=99, dtype=dtype, qmax=qmax)
        refs = [cross_attend_ref(i, q, ck, cv) for i in (layer, layer - 1)]
        for i in (layer, layer - 1):  # warm-up outside the capture
            cross_attend(i, q, ck, cv)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [cross_attend(i, q, ck, cv) for i in (layer, layer - 1)]
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            for o, r in zip(outs, refs):
                err = (o.float() - r.float()).abs().max().item()
                if not err <= tolerance(dtype) * r.float().abs().max().item():
                    raise AssertionError(f"K4 ({form}) in a CUDA graph of two layers disagrees: {err:.3e}")
        print(f"K4 {form}: two layers in one CUDA graph, replayed twice, agree")
    return worst


# ---------------------------------------------------------------------------
# K3: encoder flash attention
# ---------------------------------------------------------------------------


def k3_inputs(B, S=1500, H=20, D=64, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return [
        torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
        for _ in range(3)
    ]


K3_SHAPES = dict(batches=(1, 8), Ss=(1, 63, 128, 1500, 1501))


def check_flash_attention(batches=(1, 8), Ss=(1500,), dtype=torch.bfloat16):
    """K3 in ``dtype`` against its plain version (``mha``); returns the max
    abs error."""
    from faster_whisper_tpu_torch.ops.attention import mha, mha_flash

    worst = 0.0
    for B in batches:
        for S in Ss:
            q, k, v = k3_inputs(B, S, seed=B + S, dtype=dtype)
            ref = mha(q, k, v)
            out = mha_flash(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = tolerance(dtype) * ref.float().abs().max().item()
            print(f"K3 {dtype_name(dtype)} ({B},{S},20,64): max|err| {err:.3e} (tolerance {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"K3 ({dtype_name(dtype)}) disagrees with its plain version at B={B}, S={S}")
            worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Times
# ---------------------------------------------------------------------------


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call of ``fn``: after a warm-up, ``iters``
    back-to-back calls are captured in a CUDA graph and one replay of it is
    timed with CUDA events, so that the host's cost per call (Python
    checks, the ctypes call) does not pace the card.  L2 stays warm between
    calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters=20, warmup=3):
    """Mean time of one call of ``fn`` issued from the host, back to back
    (CUDA events): what the host-driven decode loop pays for it today, the
    host's cost per call included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, iters=10):
    """Mean device time of one call of ``fn`` with L2 cold: before each
    call a 256 MB buffer is written (five times the 50 MB L2), and each
    call is timed alone with CUDA events.  A sleep queued ahead of the
    write keeps the card busy while the host issues the call, so that the
    host's cost per call stays off the clock."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000)
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _timed(kernel, plain, library=None):
    """The kernel warm, cold and per host call; the plain version and the
    library call (where one exists) warm."""
    return dict(
        ms=time_ms(kernel), cold_ms=cold_ms(kernel), call_ms=call_ms(kernel),
        plain_ms=time_ms(plain, iters=5),
        library_ms=None if library is None else time_ms(library),
        library_cold_ms=None if library is None else cold_ms(library),
    )


def time_beam_attention(B=1, pos=447, K=5, H=20, D=64, quant=False, dtype=torch.bfloat16):
    """K1, or K2 with ``quant``, with ``dtype`` activations, on a divergent
    ancestry."""
    from faster_whisper_tpu_torch.ops.beam_attention import (
        _split_plan,
        beam_attend_append,
        beam_attend_append_ref,
    )

    x = (k2_inputs if quant else k1_inputs)(B, pos, divergent=True, dtype=dtype)
    caches = (x["self_k"], x["self_v"])  # rewritten in place with the same column
    t = _timed(lambda: _k1_call(beam_attend_append, x, caches),
               lambda: _k1_call(beam_attend_append_ref, x, caches))
    n = pos + 1
    # Cache rows the step must read: the distinct (slot, column) pairs of
    # the columns before pos (column pos comes from k_new/v_new).
    seen = x["anc"][:, :, :pos].sort(dim=1).values
    rows = B * pos + int((seen[:, 1:] != seen[:, :-1]).sum()) if pos else 0
    act = torch.finfo(dtype).bits // 8
    row_bytes = D + 2 if quant else act * D  # int8 codes and a bf16 scale, or raw
    nbytes = (
        rows * H * row_bytes * 2  # the visible K and V rows
        + B * K * n * 4  # ancestry
        + 4 * B * H * K * D * act  # q, k_new, v_new and the output
        + 2 * B * H * K * row_bytes  # the two written columns
    )
    flops = 4 * B * H * K * n * D  # QK and PV, f32 FMA
    t["bound_ms"], t["bound_by"] = bound(nbytes, flops, F32_FLOPS)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    chunk, n_chunks = _split_plan(B, H, K, 448, D if quant else act * D, n_sm)
    t["shape"] = (f"B={B} H={H} K={K} ctx=448 pos={pos} D={D} {dtype_name(dtype)}"
                  f"{' int8 cache' if quant else ''}, divergent beams ({rows} distinct cache rows)"
                  f", {n_chunks} chunks of {chunk}: {n_chunks * B * H} blocks")
    return t


def time_cross_attention(quant, B=1, K=5, H=20, D=64, T=1500, dtype=torch.bfloat16):
    from faster_whisper_tpu_torch.ops.cross_attention import (
        _split_plan,
        cross_attend,
        cross_attend_ref,
    )

    layer, q, ck, cv = k4_inputs(B, quant, K=K, H=H, D=D, T=T, dtype=dtype)
    library = None
    if not quant:  # the same function in one PyTorch call (raw cache only)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(q, ck[layer], cv[layer])  # noqa: E731
    t = _timed(lambda: cross_attend(layer, q, ck, cv), lambda: cross_attend_ref(layer, q, ck, cv),
               library)
    act = torch.finfo(dtype).bits // 8
    cache_bytes = 2 * B * H * T * (D + 2) if quant else 2 * B * H * T * D * act
    nbytes = cache_bytes + 2 * B * H * K * D * act  # K/V (and scales), q and output
    flops = 4 * B * H * K * T * D  # QK and PV, f32 FMA
    t["bound_ms"], t["bound_by"] = bound(nbytes, flops, F32_FLOPS)
    chunk, n_chunks = _split_plan(B, H, T, torch.cuda.get_device_properties(0).multi_processor_count)
    t["shape"] = (f"B={B} H={H} K={K} T={T} D={D} {dtype_name(dtype)}{' int8 cache' if quant else ''}"
                  f", {n_chunks} chunks of {chunk}: {n_chunks * B * H} blocks")
    return t


def time_flash_attention(B=1, S=1500, H=20, D=64, dtype=torch.bfloat16):
    from faster_whisper_tpu_torch.ops.attention import mha, mha_flash

    q, k, v = k3_inputs(B, S, H, D, dtype=dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    t = _timed(lambda: mha_flash(q, k, v), lambda: mha(q, k, v),
               lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))
    act = torch.finfo(dtype).bits // 8
    nbytes = 4 * B * S * H * D * act
    flops = 4 * B * H * S * S * D
    if dtype == torch.float32:
        # The float32 kernel takes three TF32 tensor-core products per
        # product (3xTF32): its least time is 3x the operations over the
        # TF32 peak.  The same work on the f32 FMA units, beside it.
        t["bound_ms"], t["bound_by"] = bound(nbytes, 3 * flops, TF32_TENSOR_FLOPS)
        t["fma_bound_ms"] = bound(nbytes, flops, F32_FLOPS)[0]
    else:
        t["bound_ms"], t["bound_by"] = bound(nbytes, flops, BF16_TENSOR_FLOPS)
    t["shape"] = f"({B},{S},{H},{D}) {dtype_name(dtype)}"
    return t


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    """A gated tone sweep over noise, 16 kHz float32, from a seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    gate = np.sin(2 * np.pi * 0.3 * t) > -0.2
    tone = np.sin(2 * np.pi * (180 + 40 * np.sin(2 * np.pi * 0.1 * t)) * t)
    return (0.3 * tone * gate + 0.03 * rng.standard_normal(t.size)).astype(np.float32)


def _counted():
    from faster_whisper_tpu_torch.generation.generate import _gen_decoder_step
    from faster_whisper_tpu_torch.models.model import encode
    from faster_whisper_tpu_torch.ops.attention import mha_flash
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append
    from faster_whisper_tpu_torch.ops.cross_attention import cross_attend

    # name -> (function, attribute); every name but steps and encodes is a
    # kernel form's launch count
    return dict(
        k1=(beam_attend_append, "launches"), k1_f32=(beam_attend_append, "launches_f32"),
        k2=(beam_attend_append, "launches_int8"), k2_f32=(beam_attend_append, "launches_int8_f32"),
        k3=(mha_flash, "launches"), k3_f32=(mha_flash, "launches_f32"),
        k4_bf16=(cross_attend, "launches"), k4_f32=(cross_attend, "launches_f32"),
        k4_int8=(cross_attend, "launches_int8"), k4_int8_f32=(cross_attend, "launches_int8_f32"),
        steps=(_gen_decoder_step, "calls"), encodes=(encode, "calls"),
    )


def reset_counts():
    for f, attr in _counted().values():
        setattr(f, attr, 0)


def read_counts():
    return {name: getattr(f, attr) for name, (f, attr) in _counted().items()}


def run_requests(model, requests, n_vocab):
    """Each request through ``transcribe``, checked; returns the launch
    counts of the run, set to 0 just before it."""
    reset_counts()
    for name, audio, kwargs in requests:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        segments, info = model.transcribe(audio, **kwargs)
        segments = list(segments)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_segments(segments, info, len(audio) / 16000, n_vocab)
        n_tokens = sum(len(s.tokens) for s in segments)
        print(f"request {name}: {len(segments)} segments, {n_tokens} tokens, "
              f"language {info.language}, {seconds:.3f} s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, counts so far {read_counts()}")
    return read_counts()


def check_counts(counts, per_step, per_encode, cfg):
    """Every kernel form in ``per_step`` launched n_text_layer times per
    decode step, ``per_encode`` n_audio_layer times per encode, every other
    form never."""
    if counts["steps"] == 0 or counts["encodes"] == 0:
        raise AssertionError(f"the run decoded or encoded nothing: {counts}")
    for name, n in counts.items():
        if name in ("steps", "encodes"):
            continue
        if name in per_step:
            want, what = cfg.n_text_layer * counts["steps"], f"{cfg.n_text_layer} x {counts['steps']} decode steps"
        elif name == per_encode:
            want, what = cfg.n_audio_layer * counts["encodes"], f"{cfg.n_audio_layer} x {counts['encodes']} encodes"
        else:
            want, what = 0, "0: another compute type's form"
        if n != want:
            raise AssertionError(f"{name} launches {n} != {what}")


def run_main_path(speech):
    """Requests a-c at bf16, d-e at int8, f at float32 and g at
    int8_float32, on the same random weights, and the batched requests h
    (bf16), i (int8), n (int4) and o (int4, groups of 128 input rows) over
    ``speech``; returns the counts of the runs, and for phase 10 the
    weights, config and vocabulary with request i's segments and
    seconds."""
    from faster_whisper_tpu_torch.models.config import CONFIGS
    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg = CONFIGS["large-v3-turbo"]
    tok = build_synthetic_tokenizer(base_vocab=50257)
    t0 = time.perf_counter()
    params = random_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    model = WhisperModel.from_parts(params, cfg, tok)
    torch.cuda.synchronize()
    print(f"large-v3-turbo random weights on the card: {time.perf_counter() - t0:.3f} s, "
          f"vocab {cfg.n_vocab}")
    long_clip, short_clip = synth_audio(45.0, seed=1), synth_audio(20.0, seed=2)
    ladder = dict(language=None, beam_size=5)
    greedy = dict(beam_size=1, temperature=0.0)
    bf16 = run_requests(model, [
        ("a: 45 s, language detection, beam 5, temperature ladder, timestamps", long_clip, ladder),
        ("b: 45 s, en, beam 5, without timestamps",
         long_clip, dict(language="en", beam_size=5, without_timestamps=True)),
        ("c: 20 s, beam 1, temperature 0", short_clip, greedy),
    ], cfg.n_vocab)
    print(f"main path counts, bf16 (a-c): {bf16}")
    check_counts(bf16, per_step=("k1", "k4_bf16"), per_encode="k3", cfg=cfg)
    runs = {"bf16": bf16}
    runs["h"], h_segments, _ = run_batched(model, "h: bf16", speech, cfg)
    check_counts(runs["h"], per_step=("k1", "k4_bf16"), per_encode="k3", cfg=cfg)

    later = dict(params=params, cfg=cfg, tok=tok, h_segments=h_segments)
    for key, compute_type, requests, per_step, per_encode, batched in (
        ("int8", "int8", [
            ("d: int8, 45 s, language detection, beam 5, temperature ladder, timestamps",
             long_clip, ladder),
            ("e: int8, 20 s, beam 1, temperature 0", short_clip, greedy),
        ], ("k2", "k4_int8"), "k3", "i"),
        ("f32", "float32", [("f: float32, 20 s, beam 1, temperature 0", short_clip, greedy)],
         ("k1_f32", "k4_f32"), "k3_f32", None),
        ("int8_f32", "int8_float32",
         [("g: int8_float32, 20 s, beam 1, temperature 0", short_clip, greedy)],
         ("k2_f32", "k4_int8_f32"), "k3_f32", None),
    ):
        del model
        t0 = time.perf_counter()
        model = WhisperModel.from_parts(params, cfg, tok, compute_type=compute_type)
        torch.cuda.synchronize()
        print(f"large-v3-turbo at compute_type={compute_type!r} on the card: "
              f"{time.perf_counter() - t0:.3f} s")
        counts = run_requests(model, requests, cfg.n_vocab)
        print(f"main path counts, {compute_type} ({', '.join(r[0][0] for r in requests)}): {counts}")
        check_counts(counts, per_step=per_step, per_encode=per_encode, cfg=cfg)
        runs[key] = counts
        if batched:
            runs[batched], later["i_segments"], later["i_seconds"] = run_batched(
                model, f"{batched}: {compute_type}", speech, cfg
            )
            later["i_peak"] = torch.cuda.max_memory_allocated()
            check_counts(runs[batched], per_step=per_step, per_encode=per_encode, cfg=cfg)

    for key, group in (("n", None), ("o", 128)):
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = WhisperModel.from_parts(params, cfg, tok, compute_type="int4", int4_group_size=group)
        torch.cuda.synchronize()
        w2 = model.model.params["decoder"]["layers"]["mlp"]["w2"]
        print(f"large-v3-turbo at compute_type='int4', int4_group_size={group} on the card: "
              f"{time.perf_counter() - t0:.3f} s; decoder mlp.w2 codes {tuple(w2.q.shape)} in "
              f"[{int(w2.q.min())}, {int(w2.q.max())}], scales {tuple(w2.s.shape)}")
        runs[key] = run_batched(model, f"{key}: int4, int4_group_size={group}", speech, cfg)[0]
        check_counts(runs[key], per_step=("k2", "k4_int8"), per_encode="k3", cfg=cfg)
        print(f"request {key} against request i: equal launch counts: {runs[key] == runs['i']}")
        if runs[key] != runs["i"]:
            raise AssertionError(f"request {key}'s launch counts {runs[key]} differ from i's {runs['i']}")
    del model
    torch.cuda.empty_cache()
    return runs, later


def run_batched(model, name, audio, cfg, **kwargs):
    """One ``BatchedInferencePipeline.transcribe`` with the VAD on, beam 5,
    batch 8 (and ``kwargs``), checked; returns the launch counts of the
    run, set to 0 just before it, its segments and its seconds.  The
    chunks of each batch, its seconds (encode and decode) and the rows it
    was encoded with (its pow2 bucket) are read off the pipeline's
    dispatch and the model's encode."""
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline

    pipeline = BatchedInferencePipeline(model)
    chunks, rows, batch_seconds = [], [], []
    dispatch, encode = pipeline._dispatch_segment_batch, model.encode

    def counted_dispatch(features, *args):
        chunks.append(int(features.shape[0]))
        out, sec = _synced_seconds(lambda: dispatch(features, *args))
        batch_seconds.append(sec)
        return out

    def counted_encode(features):
        rows.append(int(features.shape[0]))
        return encode(features)

    pipeline._dispatch_segment_batch, model.encode = counted_dispatch, counted_encode
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        segments, info = pipeline.transcribe(
            audio, language="en", beam_size=5, batch_size=8, max_new_tokens=128, **kwargs
        )
        segments = list(segments)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
    finally:
        # the wrappers' closures would tie the pipeline and the model into
        # cycles that keep the model's weights alive into the next request
        del model.encode, pipeline._dispatch_segment_batch
    duration = len(audio) / 16000
    check_segments(segments, info, duration, cfg.n_vocab)
    if sum(chunks) < 1 or len(rows) != len(chunks) or counts["encodes"] != len(rows):
        raise AssertionError(f"batched run {name}: chunks {chunks}, encodes {rows}, {counts}")
    n_tokens = sum(len(s.tokens) for s in segments)
    print(f"request {name}, BatchedInferencePipeline, VAD on, beam 5, batch 8, "
          f"{duration:.1f} s of audio ({info.duration_after_vad:.1f} s of speech): "
          f"{sum(chunks)} chunks in {len(chunks)} batches of {chunks} chunks, encoded at "
          f"{rows} rows (pow2 buckets), {counts['steps']} decode steps "
          f"({sum(batch_seconds) * 1e3 / max(counts['steps'], 1):.2f} ms per step over the batches' "
          f"seconds), {len(segments)} segments, "
          f"{n_tokens} tokens, {seconds:.3f} s ({', '.join(f'{b:.3f}' for b in batch_seconds)} s "
          f"encoding and decoding the batches, {seconds - sum(batch_seconds):.3f} s the rest: "
          f"upload, VAD, log-mel, segments), {duration / seconds:.2f} audio s per wall s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {card_line()}; "
          f"counts {counts}")
    return counts, segments, seconds


def check_segments(segments, info, duration, n_vocab):
    last_end = 0.0
    for s in segments:
        if not (np.isfinite(s.avg_logprob) and np.isfinite(s.compression_ratio)):
            raise AssertionError(f"non-finite segment numbers: {s}")
        if not (0.0 <= s.no_speech_prob <= 1.0 and 0.0 <= s.start <= s.end):
            raise AssertionError(f"malformed segment: {s}")
        if not all(0 <= t < n_vocab for t in s.tokens):
            raise AssertionError(f"token out of the vocabulary: {s.tokens}")
        if s.start < last_end - 1e-6 and s.seek == segments[0].seek:
            raise AssertionError("segment times go backwards within a window")
        last_end = s.end
    if not info.duration == duration:
        raise AssertionError(f"duration {info.duration} != {duration}")


def small_model_parts():
    """A small float32 model on the CPU (random weights from seed 5, the
    synthetic vocabulary): (config, weights, tokenizer)."""
    from faster_whisper_tpu_torch.models.config import WhisperConfig
    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer, synthetic_vocab_size

    cfg = WhisperConfig(
        name="smoke-small", n_mels=128, n_audio_state=128, n_audio_head=2,
        n_audio_layer=2, n_vocab=synthetic_vocab_size(), n_text_state=128,
        n_text_head=2, n_text_layer=2, multilingual=True,
    )
    return cfg, random_params(cfg, seed=5, dtype=torch.float32, device="cpu"), build_synthetic_tokenizer()


def check_small_model_against_cpu():
    """The card's path against the same weights on the CPU (plain versions)
    on a small input: at bf16 and at float32 against float32 on the CPU, at
    int8 and at int8_float32 against int8_float32 on the CPU (the card's
    int8 product), at int4 (per channel, and in groups of 64 input rows)
    against int4 on the CPU: encoder states, and the language
    probabilities of the first decoder step, within the tolerance of the
    card's type times their largest value.  At int4 the quantized decoder
    (codes and scales of every matmul and the logits head) must be equal
    on the card and on the CPU; the codes that differ, by one unit or
    more, are counted and printed."""
    from faster_whisper_tpu_torch.ops.quant import QuantizedLinear
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg, cpu, tok = small_model_parts()
    audio = synth_audio(12.0, seed=3)
    # int8 activation quantization turns float32 noise into whole code
    # steps, so the int8 types are held to the bf16 tolerances.
    for card_type, cpu_type, enc_rel, prob_rel, group in (
        ("bfloat16", "float32", 3 * BF16_REL_TOL, BF16_REL_TOL, None),
        ("int8", "int8_float32", 3 * BF16_REL_TOL, BF16_REL_TOL, None),
        ("float32", "float32", F32_MODEL_TOL, F32_MODEL_TOL, None),
        ("int8_float32", "int8_float32", 3 * BF16_REL_TOL, BF16_REL_TOL, None),
        ("int4", "int4", 3 * BF16_REL_TOL, BF16_REL_TOL, None),
        ("int4", "int4", 3 * BF16_REL_TOL, BF16_REL_TOL, 64),
    ):
        m_cpu = WhisperModel.from_parts(cpu, cfg, tok, compute_type=cpu_type, device="cpu",
                                        int4_group_size=group)
        m_gpu = WhisperModel.from_parts(cpu, cfg, tok, compute_type=card_type, device="cuda",
                                        int4_group_size=group)
        if card_type == "int4":
            card_type = f"int4, int4_group_size={group}"
            dec_cpu, dec_gpu = m_cpu.model.params["decoder"], m_gpu.model.params["decoder"]
            pairs = [(dec_cpu["logits_w"], dec_gpu["logits_w"])] + [
                (dec_cpu["layers"][sec][name], dec_gpu["layers"][sec][name])
                for sec in ("self_attn", "cross_attn", "mlp") for name in dec_cpu["layers"][sec]
                if isinstance(dec_cpu["layers"][sec][name], QuantizedLinear)
            ]
            n_codes = sum(a.q.numel() for a, _ in pairs)
            n_diff = sum(int((a.q != b.q.cpu()).sum()) for a, b in pairs)
            n_one = sum(int(((a.q.int() - b.q.cpu().int()).abs() == 1).sum()) for a, b in pairs)
            same_s = all(torch.equal(a.s, b.s.cpu()) for a, b in pairs)
            amax = max(int(b.q.abs().max()) for _, b in pairs)
            print(f"small model {card_type}: {len(pairs)} quantized decoder matrices, {n_codes} codes "
                  f"(max |code| {amax}); codes that differ between card and CPU: {n_diff} "
                  f"({n_one} by one unit); scales equal: {same_s}")
            if n_diff or not same_s or amax > 7:
                raise AssertionError(f"the int4 decoder quantized on the card ({card_type}) differs "
                                     "from the CPU's")
        feats = m_cpu.feature_extractor(audio)[:, :3000]
        feats = np.pad(feats, ((0, 0), (0, 3000 - feats.shape[1])))
        x_cpu = m_cpu.encode(feats)
        x_gpu = m_gpu.encode(feats)
        err = (x_gpu.float().cpu() - x_cpu).abs().max().item()
        tol = enc_rel * x_cpu.abs().max().item()
        print(f"small model encoder, card {card_type} vs CPU {cpu_type}: max|err| {err:.3e} "
              f"(tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"encoder on the card ({card_type}) disagrees with the CPU reference")
        p_cpu = dict(m_cpu.model.detect_language(x_cpu)[0])
        p_gpu = m_gpu.model.detect_language(x_gpu)[0]
        d = max(abs(p_cpu[k] - p) for k, p in p_gpu)
        top = max(p_cpu.values())
        tol = prob_rel * top
        print(f"small model language probabilities, card {card_type} vs CPU {cpu_type}: max|diff| "
              f"{d:.3e} (tolerance {tol:.3e}; CPU probabilities span "
              f"{min(p_cpu.values()):.3e}..{top:.3e})")
        if not d <= tol:
            raise AssertionError(
                f"language probabilities on the card ({card_type}) disagree with the CPU reference"
            )


def jfk_path():
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), JFK_FLAC)


def tiled_speech(seconds=300.0):
    """``docker/jfk.flac`` (11 s of speech, 44.1 kHz stereo 24-bit) through
    the port's ``decode_audio`` (FLAC, mixed to mono, resampled to 16 kHz),
    and the same tiled to ``seconds``."""
    from faster_whisper_tpu_torch.audio import decode_audio

    t0 = time.perf_counter()
    base = decode_audio(jfk_path())
    n = int(seconds * 16000)
    audio = np.tile(base, -(-n // len(base)))[:n]
    print(f"{JFK_FLAC}: {len(base) / 16000:.3f} s decoded on the host in "
          f"{time.perf_counter() - t0:.3f} s, tiled to {len(audio) / 16000:.1f} s")
    return base, audio


def _synced_seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_vad(audio, card):
    """The Silero VAD on the card against the same weights on the CPU:
    probabilities within VAD_PROB_TOL, speech timestamps equal, for the
    default options and for the batched pipeline's.  Each card run's state
    machine (``hysteresis_native``) is held equal to its plain Python loop
    on the same probabilities and arguments, both timed.  Returns the
    pipeline's speech timestamps."""
    from faster_whisper_tpu_torch import vad
    from faster_whisper_tpu_torch.ops.mel import upload_audio
    from faster_whisper_tpu_torch.vad import VadOptions, get_speech_timestamps, get_vad_model

    padded = np.pad(audio, (0, (len(audio) // 512 + 1) * 512 - len(audio)))
    probs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        model = get_vad_model(dev)
        model(padded)  # first call: weights and cuDNN plans
        p, secs[dev] = _synced_seconds(lambda: model(padded).cpu().numpy())
        probs[dev] = p
    err = float(np.abs(probs["cuda"] - probs["cpu"]).max())
    print(f"VAD forward over {len(padded) // 512} windows ({len(audio) / 16000:.1f} s): card "
          f"{secs['cuda']:.4f} s, CPU {secs['cpu']:.4f} s (host -> device copy and probabilities "
          f"back included); max|card - CPU| {err:.3e} (tolerance {VAD_PROB_TOL:.0e}) on {card}")
    if not err <= VAD_PROB_TOL:
        raise AssertionError("VAD probabilities on the card disagree with the CPU")

    for label, opts in (
        ("default", VadOptions()),
        ("pipeline", VadOptions(max_speech_duration_s=30, min_silence_duration_ms=160)),
    ):
        native, calls = vad.hysteresis_native, []

        def recorded(probs, *args):
            calls.append((probs, args))
            return native(probs, *args)

        vad.hysteresis_native = recorded
        try:
            on_card, sec_card = _synced_seconds(
                lambda: get_speech_timestamps(upload_audio(audio, "cuda"), opts)
            )
        finally:
            vad.hysteresis_native = native
        on_cpu = get_speech_timestamps(audio, opts, device="cpu")
        print(f"VAD speech timestamps, {label} options: {len(on_card)} chunks on the card in "
              f"{sec_card:.4f} s (upload, forward, state machine), {len(on_cpu)} on the CPU")
        if on_card != on_cpu:
            raise AssertionError(f"VAD speech timestamps ({label}) differ between card and CPU")
        if len(calls) != 1:
            raise AssertionError(f"the VAD ran its native state machine {len(calls)} times, not once")
        (probs_card, args), = calls
        out_native, sec_native = _synced_seconds(lambda: native(probs_card, *args))
        out_py, sec_py = _synced_seconds(lambda: vad._hysteresis_py(probs_card, *args))
        print(f"VAD state machine, {label} options, over the card's {len(probs_card)} window "
              f"probabilities: native {sec_native * 1e3:.3f} ms, Python loop {sec_py * 1e3:.3f} ms "
              f"on the host of {card}; {len(out_native)} speech segments, equal: {out_native == out_py}")
        if out_native != out_py:
            raise AssertionError(f"the native VAD state machine differs from the Python loop ({label})")
    return on_card


def check_chunked_mel(audio, speech, card):
    """The batched pipeline's device log-mel of the speech chunks on the
    card against the host FeatureExtractor on the same int16-grid chunks,
    within MEL_ATOL + MEL_RTOL * |host|."""
    from faster_whisper_tpu_torch.audio import pad_or_trim
    from faster_whisper_tpu_torch.feature_extractor import FeatureExtractor
    from faster_whisper_tpu_torch.ops.mel import assemble_segments, upload_audio
    from faster_whisper_tpu_torch.vad import collect_chunks

    fe = FeatureExtractor(feature_size=128)
    grid = (np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16) / 32768.0).astype(np.float32)
    chunks, _ = collect_chunks(grid, speech, max_duration=30)
    lengths = [len(c) for c in chunks]
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    concat = assemble_segments(upload_audio(audio, "cuda"), [(c["start"], c["end"]) for c in speech])
    fe.chunk_features(concat, starts, lengths)  # first call
    feats, sec = _synced_seconds(lambda: fe.chunk_features(concat, starts, lengths))
    worst, err = -np.inf, 0.0
    for i, c in enumerate(chunks):
        want = pad_or_trim(fe(c)[..., :-1], fe.nb_max_frames)
        got = feats[i].cpu().numpy()
        diff = np.abs(got - want)
        err = max(err, float(diff.max()))
        worst = max(worst, float((diff - (MEL_ATOL + MEL_RTOL * np.abs(want))).max()))
    print(f"chunked mel: {len(chunks)} chunks {tuple(feats.shape)} on the card in {sec:.4f} s; "
          f"max|card - host| {err:.3e} (tolerance {MEL_ATOL:.0e} + {MEL_RTOL:.0e} x |host|) on {card}")
    if not worst <= 0:
        raise AssertionError("chunked log-mel on the card disagrees with the host FeatureExtractor")


def check_small_pipeline_against_cpu(jfk, word_timestamps=False):
    """A small float32 model through ``BatchedInferencePipeline`` on the
    card and on the CPU: on ``clip_timestamps`` (three clips at batch 2: a
    full batch and a tail padded with a dummy row), and with the defaults
    (VAD on, language detection, beam 5, batch 8) on ``docker/jfk.flac``,
    which the card's run decodes from the path and the CPU's gets decoded.
    Equal tokens and times.  With ``word_timestamps`` (phase 10) the
    specials of the synthetic vocabulary are suppressed, so that the
    chunks decode text, and the words must be equal too
    (``check_words_equal``)."""
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline, WhisperModel

    cfg, cpu, tok = small_model_parts()
    models = {
        dev: WhisperModel.from_parts(cpu, cfg, tok, compute_type="float32", device=dev)
        for dev in ("cuda", "cpu")
    }
    clips = [{"start": 0.0, "end": 5.0}, {"start": 5.5, "end": 9.0}, {"start": 9.0, "end": 12.0}]
    words = dict(word_timestamps=True, suppress_tokens=SMALL_SPECIALS) if word_timestamps else {}
    for label, inputs, kwargs in (
        ("3 clips at batch 2", {"cuda": synth_audio(12.0, seed=3), "cpu": synth_audio(12.0, seed=3)},
         dict(clip_timestamps=clips, language="en", batch_size=2)),
        (f"{JFK_FLAC} with the defaults", {"cuda": jfk_path(), "cpu": jfk}, {}),
    ):
        out, segs = {}, {}
        for dev, model in models.items():
            segments, info = BatchedInferencePipeline(model).transcribe(
                inputs[dev], max_new_tokens=32, **kwargs, **words
            )
            segs[dev] = list(segments)
            out[dev] = [(s.start, s.end, s.tokens) for s in segs[dev]]
        n_tokens = sum(len(t) for _, _, t in out["cpu"])
        print(f"small float32 model through BatchedInferencePipeline, {label}"
              f"{', word timestamps' if word_timestamps else ''}: "
              f"{len(out['cuda'])} segments on the card, {len(out['cpu'])} on the CPU, "
              f"{n_tokens} tokens; equal: {out['cuda'] == out['cpu']}")
        if out["cuda"] != out["cpu"]:
            raise AssertionError(f"the batched pipeline's segments on the card differ from the "
                                 f"CPU's ({label})")
        if word_timestamps:
            check_words_equal(segs["cuda"], segs["cpu"], f"the pipeline, {label}")


# ---------------------------------------------------------------------------
# Phase 9: checkpoints
# ---------------------------------------------------------------------------


def _dir_bytes(path):
    import os

    return {f: os.path.getsize(os.path.join(path, f)) for f in sorted(os.listdir(path))}


def _segment_keys(segments):
    return [(s.seek, s.start, s.end, s.text, tuple(s.tokens)) for s in segments]


def check_native_flac(card):
    """``docker/jfk.flac`` through the native decoder and the numpy one:
    the same float32 samples, bit for bit; both times printed."""
    from faster_whisper_tpu_torch.flac import decode_flac, decode_flac_native

    with open(jfk_path(), "rb") as f:
        data = f.read()
    native, sec_native = _synced_seconds(lambda: decode_flac_native(data))
    plain, sec_plain = _synced_seconds(lambda: decode_flac(data))
    same = native[1] == plain[1] and native[0].shape == plain[0].shape and np.array_equal(
        native[0].view(np.uint32), plain[0].view(np.uint32)
    )
    print(f"{JFK_FLAC} ({len(data)} bytes, {native[0].shape[0]} samples x {native[0].shape[1]} "
          f"channels at {native[1]} Hz): native decoder {sec_native:.4f} s, numpy decoder "
          f"{sec_plain:.4f} s on the host of {card}; bit-equal samples: {same}")
    if not same:
        raise AssertionError("the native FLAC decoder's samples differ from the numpy decoder's")


def check_small_hf_against_cpu(root, card):
    """A small float32 model written as an HF safetensors directory by the
    port's writer, loaded by ``WhisperModel(directory)`` on the card and on
    the CPU: the alignment heads read back, and equal tokens and times of
    ``transcribe`` at beam 5."""
    import dataclasses
    import os

    from faster_whisper_tpu_torch.models.config import WhisperConfig
    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.testing import tokenizer_json, word_merges, write_hf_dir
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    base_vocab = 1024
    cfg = WhisperConfig(
        name="smoke-small-hf", n_mels=128, n_audio_state=128, n_audio_head=2,
        n_audio_layer=2, n_vocab=base_vocab + 1609, n_text_state=128, n_text_head=2,
        n_text_layer=2, alignment_heads=((1, 0), (1, 1)),
    )
    hf_dir = os.path.join(root, "small-hf")
    write_hf_dir(hf_dir, random_params(cfg, seed=7, dtype=torch.float32, device="cpu"), cfg,
                 tokenizer_json(base_vocab, word_merges(MERGED_WORDS)))
    out = {}
    for dev in ("cuda", "cpu"):
        model = WhisperModel(hf_dir, device=dev, compute_type="float32")
        if dataclasses.replace(model.model.config, name=cfg.name) != cfg:
            raise AssertionError(f"HF config read back as {model.model.config}")
        segments, _ = model.transcribe(synth_audio(12.0, seed=3), language="en", beam_size=5,
                                       temperature=0.0, max_new_tokens=32)
        out[dev] = [(s.start, s.end, s.tokens) for s in segments]
    n_tokens = sum(len(t) for _, _, t in out["cpu"])
    print(f"small float32 model from an HF safetensors directory ({_dir_bytes(hf_dir)} bytes), "
          f"transcribe at beam 5: {len(out['cuda'])} segments on the card, {len(out['cpu'])} "
          f"on the CPU, {n_tokens} tokens; equal: {out['cuda'] == out['cpu']} on {card}")
    if out["cuda"] != out["cpu"]:
        raise AssertionError("the HF directory's model on the card differs from the CPU's")


def run_checkpoints(speech, card, root):
    """Phase 9: write the large-v3-turbo CT2 directories under ``root``
    (which the caller deletes), then requests j (float16 model.bin,
    defaults) and k (int8 model.bin, int8, through the pipeline), the small
    HF directory and the native FLAC decode.  Returns the launch counts of
    j and k, each set to 0 just before its run, and the int8 directory."""
    import dataclasses
    import os

    from faster_whisper_tpu_torch.bpe import BPETokenizer
    from faster_whisper_tpu_torch.models.config import CONFIGS
    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.testing import tokenizer_json, word_merges, write_ct2_dir
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg = dataclasses.replace(CONFIGS["large-v3-turbo"], alignment_heads=ALIGNMENT_HEADS)
    tok_text = tokenizer_json(50257, word_merges(MERGED_WORDS))
    params = random_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    dirs = {"float16": os.path.join(root, "ct2-float16"), "int8": os.path.join(root, "ct2-int8")}
    for weights, d in (("float16", dirs["float16"]), ("int8_float16", dirs["int8"])):
        sec = _synced_seconds(lambda: write_ct2_dir(d, params, cfg, tok_text, weights=weights))[1]
        print(f"CT2 directory, {weights} model.bin: {_dir_bytes(d)} bytes, written in {sec:.3f} s "
              f"on the host of {card}")
    # what a float16 model.bin holds, at the default compute type
    rounded = {}

    def round_f16(tree, out):
        for k, v in tree.items():
            if isinstance(v, dict):
                round_f16(v, out.setdefault(k, {}))
            else:
                out[k] = v.to(torch.float16).to(torch.bfloat16)

    round_f16(params, rounded)
    del params

    model, sec = _synced_seconds(lambda: WhisperModel(dirs["float16"]))
    cfg_read = model.model.config
    print(f"request j: WhisperModel(CT2 float16 directory) loaded in {sec:.3f} s on {card}: "
          f"{cfg_read.n_audio_layer}/{cfg_read.n_text_layer} layers, vocab {cfg_read.n_vocab}, "
          f"tokenizer vocab {model.hf_tokenizer.get_vocab_size()}, alignment heads "
          f"{cfg_read.alignment_heads}")
    if dataclasses.replace(cfg_read, name=cfg.name) != cfg:
        raise AssertionError(f"CT2 config read back as {cfg_read}")

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from leaves(v, prefix + k + "/") if isinstance(v, dict) else [(prefix + k, v)]

    loaded = dict(leaves(model.model.params))
    diff = [k for k, v in leaves(rounded) if not torch.equal(loaded.pop(k), v)]
    if diff or loaded:
        raise AssertionError(f"loaded weights differ from the float16-rounded ones: {diff}, {list(loaded)}")
    clip = synth_audio(20.0, seed=2)
    def request_j():
        segments, info = model.transcribe(clip, beam_size=5)
        return list(segments), info

    reset_counts()
    (segments, info), sec = _synced_seconds(request_j)
    counts = {"j": read_counts()}
    check_segments(segments, info, len(clip) / 16000, cfg.n_vocab)
    got = _segment_keys(segments)
    print(f"request j: CT2 float16 model.bin, defaults, 20 s, beam 5: {len(got)} segments, "
          f"{sum(len(k[4]) for k in got)} tokens, {sec:.3f} s on {card}")
    print(f"main path counts, j: {counts['j']}")
    check_counts(counts["j"], per_step=("k1", "k4_bf16"), per_encode="k3", cfg=cfg)
    del model
    ref = WhisperModel.from_parts(rounded, cfg_read, BPETokenizer.from_str(tok_text))
    want = _segment_keys(ref.transcribe(clip, beam_size=5)[0])
    del ref, rounded
    print(f"request j against from_parts on the float16-rounded weights: equal segments and "
          f"tokens: {got == want}")
    if got != want:
        raise AssertionError("the loaded CT2 model's segments differ from from_parts on the same weights")

    model, sec = _synced_seconds(lambda: WhisperModel(dirs["int8"], compute_type="int8"))
    print(f"request k: WhisperModel(CT2 int8 directory, compute_type='int8') loaded in "
          f"{sec:.3f} s on {card}")
    counts["k"] = run_batched(model, "k: CT2 int8 model.bin, int8", speech, cfg)[0]
    check_counts(counts["k"], per_step=("k2", "k4_int8"), per_encode="k3", cfg=cfg)
    del model
    torch.cuda.empty_cache()

    check_small_hf_against_cpu(root, card)
    check_native_flac(card)
    return counts, dirs["int8"]


# ---------------------------------------------------------------------------
# Phase 10: word timestamps
# ---------------------------------------------------------------------------


class AlignmentProbe:
    """Records the word alignment while a request runs: each alignment
    pass's device seconds (CUDA events around it) and the launch counts
    just before and just after it, which must be equal (the pass launches
    no kernel of K1-K4 and runs no encode); each window's text tokens and
    its word dicts (with their tokens); and each DTW cost matrix,
    its path and the native DTW's host milliseconds."""

    def __init__(self, model):
        from faster_whisper_tpu_torch.models import engine

        self.engine, self.model = engine, model
        self.events, self.costs, self.native_ms, self.windows = [], [], [], []

    def __enter__(self):
        engine, model = self.engine, self.model
        self._pass, self._dtw = engine._align_forward_post, engine.dtw_path
        alignment_words = model._alignment_words

        def timed_pass(*args, **kwargs):
            before = read_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._pass(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            if read_counts() != before:
                raise AssertionError(f"the alignment pass launched a kernel or an encode: {before} "
                                     f"-> {read_counts()}")
            return out

        def timed_dtw(cost):
            t0 = time.perf_counter()
            path = self._dtw(cost)
            self.native_ms.append((time.perf_counter() - t0) * 1e3)
            self.costs.append((cost.copy(), path))
            return path

        def recorded_words(tokenizer, results, text_tokens):
            out = alignment_words(tokenizer, results, text_tokens)
            self.windows.extend(zip([list(t) for t in text_tokens], out))
            return out

        engine._align_forward_post, engine.dtw_path = timed_pass, timed_dtw
        model._alignment_words = recorded_words
        return self

    def __exit__(self, *exc):
        self.engine._align_forward_post, self.engine.dtw_path = self._pass, self._dtw
        del self.model._alignment_words

    def pass_seconds(self):
        torch.cuda.synchronize()
        return [start.elapsed_time(end) / 1e3 for start, end in self.events]

    def check_dtw(self, name, card):
        """The numpy DTW on every recorded matrix: the native path index
        for index; prints both times per matrix."""
        from faster_whisper_tpu_torch.dtw import _dtw_path_numpy

        numpy_ms = []
        for cost, (text_idx, time_idx) in self.costs:
            t0 = time.perf_counter()
            want_text, want_time = _dtw_path_numpy(cost)
            numpy_ms.append((time.perf_counter() - t0) * 1e3)
            if not (np.array_equal(text_idx, want_text) and np.array_equal(time_idx, want_time)):
                raise AssertionError(f"request {name}: the native DTW's path differs from the numpy "
                                     f"DTW's on a {cost.shape} matrix")
        shapes = sorted({c.shape for c, _ in self.costs})
        print(f"request {name}: native DTW equals the numpy DTW index for index on all "
              f"{len(self.costs)} matrices (shapes {shapes[0]}..{shapes[-1]}); per matrix native "
              f"{np.mean(self.native_ms):.3f} ms, numpy {np.mean(numpy_ms):.3f} ms (mean; max "
              f"{max(self.native_ms):.3f} and {max(numpy_ms):.3f}) on the host of {card}")


def check_words(name, segments, probe, eot, span=None):
    """The words of a request, held to what the reference's word policy
    guarantees (the CPU tests hold the port's words equal to the JAX
    package's, ``tests/test_torch_word_timestamps.py``):

    - every aligned window with text gets words, and each window's words'
      tokens, concatenated, are its text tokens (punctuation merges move
      tokens between neighbours, no more).  Which segment of the window
      holds them follows the reference: each segment takes words until
      they cover its token count, and a word that runs on past a segment's
      last token is that segment's alone, so a later segment's share may
      be used up.  Such segments with text and no words are counted;
    - every segment has a word list; each word has text, finite times with
      0 <= start <= end and a probability in [0, 1]; within a segment each
      word starts where the previous one ended or later;
    - a segment spans its words: with ``span`` (the VAD restored the
      times) its start and end are its first and last word's; without, the
      reference keeps the segment's own start inside its first word and its
      end inside its last where the words run past them by over 0.5 s;
    - with ``span`` = (first speech start, last speech end) in seconds,
      every word lies inside it, the end up to WINDOW_STRETCH_S later.

    Across segments the reference's boundary heuristics may start a
    segment's first word before the previous segment's; such inversions
    are counted."""
    n_words, wordless, inversions, previous_first = 0, 0, 0, None
    for s in segments:
        if s.words is None:
            raise AssertionError(f"request {name}: segment {s.id} has no word list")
        wordless += any(t < eot for t in s.tokens) and not s.words
        for a in s.words:
            if not (a.word and np.isfinite(a.start) and np.isfinite(a.end) and 0.0 <= a.start <= a.end
                    and 0.0 <= a.probability <= 1.0):
                raise AssertionError(f"request {name}: malformed word {a} in segment {s.id}")
        for a, b in zip(s.words, s.words[1:]):
            if b.start < a.end:
                raise AssertionError(f"request {name}: words out of order in segment {s.id}: {a}, {b}")
        if not s.words:
            continue
        first, last = s.words[0], s.words[-1]
        if span is not None:
            if (s.start, s.end) != (first.start, last.end):
                raise AssertionError(f"request {name}: segment {s.id} ({s.start}, {s.end}) does not "
                                     f"span its words ({first.start}, {last.end})")
            if not (span[0] <= first.start and last.end <= span[1] + WINDOW_STRETCH_S):
                raise AssertionError(f"request {name}: words of segment {s.id} outside the speech "
                                     f"{span}: ({first.start}, {last.end})")
        elif not (first.start <= s.start <= first.end and last.start <= s.end <= last.end):
            raise AssertionError(f"request {name}: segment {s.id} ({s.start}, {s.end}) outside its "
                                 f"first and last words {first}, {last}")
        inversions += previous_first is not None and first.start < previous_first
        previous_first = first.start
        n_words += len(s.words)
    for tokens, words in probe.windows:
        if tokens and not any(w["word"] for w in words):
            raise AssertionError(f"request {name}: an aligned window with text has no words")
        if [t for w in words for t in w["tokens"]] != tokens:
            raise AssertionError(f"request {name}: the words' tokens are not the window's text tokens")
    if n_words == 0:
        raise AssertionError(f"request {name}: no words")
    print(f"request {name}: {n_words} words in {len(segments)} segments, {len(probe.windows)} windows "
          f"aligned; {wordless} segments with text and no words (the reference's assignment), "
          f"{inversions} segments whose first word starts before the previous segment's")
    return n_words


def check_words_equal(card, cpu, label):
    """The same words on the card and on the CPU: text, start and end
    equal, probabilities within WORD_PROB_TOL."""
    got = [[(w.word, w.start, w.end) for w in s.words] for s in card]
    want = [[(w.word, w.start, w.end) for w in s.words] for s in cpu]
    diff = max((abs(a.probability - b.probability) for s, r in zip(card, cpu)
                for a, b in zip(s.words, r.words)), default=0.0)
    n = sum(len(w) for w in want)
    print(f"small float32 model, {label}: {n} words; words and times equal on the card and the CPU: "
          f"{got == want}; max|probability diff| {diff:.3e} (tolerance {WORD_PROB_TOL:.0e})")
    if got != want or n == 0 or not diff <= WORD_PROB_TOL:
        raise AssertionError(f"the words of {label} on the card differ from the CPU's")


def check_small_words_against_cpu():
    """The small float32 model of phase 8 through ``WhisperModel.transcribe``
    with word timestamps on the card and on the CPU (beam 5, temperature
    0, the hallucination-silence skipping on): equal segments and words."""
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg, cpu, tok = small_model_parts()
    audio = synth_audio(20.0, seed=3)
    out = {}
    for dev in ("cuda", "cpu"):
        model = WhisperModel.from_parts(cpu, cfg, tok, compute_type="float32", device=dev)
        segments, _ = model.transcribe(
            audio, language="en", beam_size=5, temperature=0.0, max_new_tokens=32,
            word_timestamps=True, hallucination_silence_threshold=1.0, suppress_tokens=SMALL_SPECIALS,
        )
        out[dev] = list(segments)
    keys = {dev: [(s.seek, s.start, s.end, s.tokens) for s in segs] for dev, segs in out.items()}
    if keys["cuda"] != keys["cpu"]:
        raise AssertionError("the small model's segments with word timestamps differ on the card")
    check_words_equal(out["cuda"], out["cpu"], "WhisperModel.transcribe with word timestamps")


def run_word_timestamps(later, jfk, speech, speech_chunks, i_counts, card):
    """Phase 10: request l (``WhisperModel.transcribe`` at bf16 with word
    timestamps and the hallucination-silence skipping on 20 s of the tiled
    speech) and request m (request i with word timestamps), each checked
    by ``check_words`` with its counts set to 0 just before and read just
    after; then the small float32 model with words on the card against the
    CPU.  Returns the counts of l and m."""
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg, tok = later["cfg"], later["tok"]
    eot = tok.token_to_id("<|endoftext|>")
    model = WhisperModel.from_parts(later["params"], cfg, tok)
    heads = model.model._alignment_heads()
    print(f"alignment heads of large-v3-turbo without alignment_heads in its config: the fallback, "
          f"{len(heads)} heads of decoder layers {sorted({h[0] for h in heads})}")
    clip = speech[: 20 * 16000]
    counts = {}
    with AlignmentProbe(model) as probe:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        segments, info = model.transcribe(clip, language="en", beam_size=5, word_timestamps=True,
                                          hallucination_silence_threshold=2.0)
        segments = list(segments)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts["l"] = read_counts()
    check_segments(segments, info, len(clip) / 16000, cfg.n_vocab)
    check_words("l", segments, probe, eot)
    passes = probe.pass_seconds()
    print(f"request l: bf16, 20 s of {JFK_FLAC} tiled, en, beam 5, word timestamps, "
          f"hallucination_silence_threshold=2.0: {len(segments)} segments, "
          f"{sum(len(s.tokens) for s in segments)} tokens, {seconds:.3f} s, {counts['l']['steps']} "
          f"decode steps, {len(passes)} windows aligned, alignment pass {np.mean(passes):.4f} s per "
          f"window (device, max {max(passes):.4f}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    probe.check_dtw("l", card)
    print(f"main path counts, l: {counts['l']}")
    check_counts(counts["l"], per_step=("k1", "k4_bf16"), per_encode="k3", cfg=cfg)
    del model

    model = WhisperModel.from_parts(later["params"], cfg, tok, compute_type="int8")
    with AlignmentProbe(model) as probe:
        counts["m"], segments, seconds = run_batched(
            model, "m: int8, word timestamps", speech, cfg, word_timestamps=True
        )
    span = (speech_chunks[0]["start"] / 16000, speech_chunks[-1]["end"] / 16000)
    check_words("m", segments, probe, eot, span=span)
    passes = probe.pass_seconds()
    print(f"request m: {len(passes)} batches aligned, alignment pass {np.mean(passes):.4f} s per "
          f"batch (device; {', '.join(f'{p:.4f}' for p in passes)}); {seconds:.3f} s against request "
          f"i's {later['i_seconds']:.3f} s without words on {card}")
    probe.check_dtw("m", card)
    want = [(s.seek, s.text, s.tokens) for s in later["i_segments"]]
    got = [(s.seek, s.text, s.tokens) for s in segments]
    print(f"request m against request i: equal segment tokens and texts: {got == want}; equal "
          f"launch counts: {counts['m'] == i_counts}")
    if got != want:
        raise AssertionError("request m's segment tokens or texts differ from request i's")
    if counts["m"] != i_counts:
        raise AssertionError(f"request m's launch counts {counts['m']} differ from i's {i_counts}")
    del model
    torch.cuda.empty_cache()

    check_small_words_against_cpu()
    check_small_pipeline_against_cpu(jfk, word_timestamps=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 11: serving
# ---------------------------------------------------------------------------


def wav_bytes(audio: np.ndarray) -> bytes:
    """16 kHz float32 samples as a mono 16-bit WAV file."""
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def post_multipart(url, payload, fields, timeout=600):
    """POST ``payload`` as the ``file`` part with ``fields`` to the
    transcription route; returns (status, body, seconds)."""
    import urllib.request

    boundary = "fwtsmoke"
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="file"; filename="a.wav"\r\n'
                 f"Content-Type: audio/wav\r\n\r\n".encode() + payload + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    req = urllib.request.Request(
        url + "/v1/audio/transcriptions", data=b"".join(parts),
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read(), time.perf_counter() - t0


def parse_sse(raw: bytes):
    events = []
    for block in raw.decode().split("\n\n"):
        block = block.strip()
        if block:
            if not block.startswith("data: "):
                raise AssertionError(f"malformed SSE block: {block[:200]!r}")
            data = block[len("data: "):]
            events.append(data if data == "[DONE]" else json.loads(data))
    return events


def served_segments(name, status, body, stream, duration, n_vocab):
    """The segments of one served response, held to ``check_segments``: a
    verbose_json body, or with ``stream`` the SSE events (one
    transcript.segment each, then transcript.text.done and [DONE])."""
    from types import SimpleNamespace

    if status != 200:
        raise AssertionError(f"request {name}: HTTP {status}")
    if stream:
        events = parse_sse(body)
        if events[-1] != "[DONE]" or events[-2]["type"] != "transcript.text.done":
            raise AssertionError(f"request {name}: the SSE stream ends with {events[-2:]}")
        if any(e["type"] != "transcript.segment" for e in events[:-2]):
            raise AssertionError(f"request {name}: unexpected SSE events {events[:-2]}")
        out, segs = events[-2], [e["segment"] for e in events[:-2]]
    else:
        out = json.loads(body)
        segs = out["segments"]
    if out["text"] != "".join(s["text"] for s in segs).strip():
        raise AssertionError(f"request {name}: text is not the segments' texts")
    segments = [SimpleNamespace(**{k: s[k] for k in (
        "id", "seek", "start", "end", "text", "tokens", "avg_logprob", "compression_ratio",
        "no_speech_prob")}) for s in segs]
    check_segments(segments, SimpleNamespace(duration=out["duration"]), duration, n_vocab)
    if not segments:
        raise AssertionError(f"request {name}: no segments")
    return segments


def scrape_metrics(url):
    import urllib.request

    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        if r.status != 200:
            raise AssertionError(f"/metrics: HTTP {r.status}")
        text = r.read().decode()
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in text.splitlines() if line.strip() and not line.startswith("#")}


class DispatchLog:
    """Wraps a ContinuousBatcher's ``_dispatch`` and ``_collect``: each
    batch's start and end on the batcher's thread, its chunks and bucket,
    the CUDA stream it launched on, and each entry's row and tokens."""

    def __init__(self, batcher):
        self.batcher, self.batches, self.entries = batcher, [], []
        dispatch, collect = batcher._dispatch, batcher._collect

        def timed_dispatch(batch):
            t0 = time.perf_counter()
            out = dispatch(batch)
            torch.cuda.synchronize()
            self.batches.append(dict(start=t0, end=time.perf_counter(), chunks=len(batch),
                                     bucket=int(out[1].shape[0]),
                                     stream=torch.cuda.current_stream().cuda_stream))
            return out

        def recorded_collect(in_flight):
            collect(in_flight)
            bucket = int(in_flight[1].shape[0])
            self.entries += [(e.row, bucket, list(e.result.sequences_ids[0])) for e in in_flight[0]]

        batcher._dispatch, batcher._collect = timed_dispatch, recorded_collect

    def close(self):
        del self.batcher._dispatch, self.batcher._collect

    def idle(self, t_begin, t_end):
        """Seconds between t_begin and t_end in which the batcher's thread
        ran no dispatch: before the first, between batches, after the last."""
        busy = sum(min(b["end"], t_end) - max(b["start"], t_begin) for b in self.batches
                   if b["end"] > t_begin and b["start"] < t_end)
        return (t_end - t_begin) - busy


def concurrently(jobs):
    """Run the callables of ``jobs`` ({name: fn}) on their own threads,
    started together; returns {name: result} or raises the first error."""
    import concurrent.futures
    import threading

    barrier = threading.Barrier(len(jobs))

    def start(fn):
        barrier.wait()
        return fn()

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(start, fn) for name, fn in jobs.items()}
        return {name: f.result(timeout=900) for name, f in futs.items()}


def token_diff(a, b):
    """(tokens that differ, first step that differs) of two sequences."""
    n = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    return n, (first if n else None)


def check_srt(text, duration):
    """Well-formed SRT: numbered blocks from 1, each with a
    ``HH:MM:SS,mmm --> HH:MM:SS,mmm`` line inside the audio and a text."""
    import re

    blocks = [b for b in text.strip().split("\n\n") if b.strip()]
    if not blocks:
        raise AssertionError("the CLI printed no SRT block")

    def secs(ts):
        h, m, s = ts.split(":")
        return int(h) * 3600 + int(m) * 60 + float(s.replace(",", "."))

    for i, block in enumerate(blocks, 1):
        lines = block.split("\n")
        m = re.fullmatch(r"(\d\d:\d\d:\d\d,\d\d\d) --> (\d\d:\d\d:\d\d,\d\d\d)", lines[1]) if len(lines) > 2 else None
        if lines[0] != str(i) or m is None:
            raise AssertionError(f"malformed SRT block {i}: {block!r}")
        start, end = secs(m.group(1)), secs(m.group(2))
        if not 0 <= start <= end <= duration + WINDOW_STRETCH_S:
            raise AssertionError(f"SRT block {i} spans {start}..{end} s of {duration} s")
    return len(blocks)


def check_float32_threads(later, speech, card):
    """The two thread hazards of serving at float32, with cuDNN's TF32 at
    PyTorch's default (on): a float32 encode on one thread while another
    sits in ``exact_float32`` must equal the encode run alone (the size of
    the hazard, TF32 on against off, is printed); and a sequential and a
    batched request served together (two threads launching K1, K3 and K4's
    float32 forms) must equal each run alone, both launching on one
    stream."""
    import threading

    from faster_whisper_tpu_torch.server import TranscriptionService
    from faster_whisper_tpu_torch.transcribe import WhisperModel
    from faster_whisper_tpu_torch.utils import exact_float32

    cfg, tok = later["cfg"], later["tok"]
    model = WhisperModel.from_parts(later["params"], cfg, tok, compute_type="float32")
    fe = model.feature_extractor
    feats = torch.as_tensor(fe(speech[: 30 * 16000])[:, :3000], device=model.device)[None]
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    try:
        x_alone = model.encode(feats)
        with exact_float32():
            x_exact = model.encode(feats)
        seen = {}

        def encode_on_a_thread():
            seen["x"] = model.encode(feats)
            torch.cuda.synchronize()
            seen["t"] = time.perf_counter()

        with exact_float32():
            t_block = time.perf_counter()
            worker = threading.Thread(target=encode_on_a_thread)
            worker.start()
            time.sleep(0.5)
            t_left = time.perf_counter()
        worker.join(120)
        hazard = (x_alone - x_exact).abs().max().item()
        equal = torch.equal(seen["x"], x_alone)
        print(f"float32 encode, TF32 convolutions on (PyTorch's default) against off (inside "
              f"exact_float32): max|diff| {hazard:.3e} of max|x| {x_alone.abs().max().item():.3e}; "
              f"the encode on a thread while another held exact_float32 for "
              f"{t_left - t_block:.3f} s: equal to the encode alone: {equal}, it ended "
              f"{seen['t'] - t_left:.3f} s after the block on {card}")
        if not equal:
            raise AssertionError("a float32 encode ran under another thread's exact_float32 flags")

        clip = speech[: 20 * 16000]
        payload = wav_bytes(clip)
        seq_opts = dict(language="en", beam_size=1, temperature=0.0, max_new_tokens=64)
        bat_opts = dict(language="en", beam_size=5, batch_size=8, max_new_tokens=64)
        service = TranscriptionService(model)
        streams = set()
        dispatch = model.model.generate_dispatch

        def recorded_dispatch(*args, **kwargs):
            streams.add((threading.current_thread().name.split("-")[0],
                         torch.cuda.current_stream().cuda_stream))
            return dispatch(*args, **kwargs)

        model.model.generate_dispatch = recorded_dispatch
        try:
            def keys(opts):
                segments, _ = service.transcribe_bytes(payload, dict(opts, batch_size=opts.get("batch_size", 0)))
                return [(s.seek, s.tokens, s.start, s.end) for s in segments]

            alone = {"sequential": keys(seq_opts), "batched": keys(bat_opts)}
            together = concurrently({"sequential": lambda: keys(seq_opts),
                                     "batched": lambda: keys(bat_opts)})
        finally:
            del model.model.generate_dispatch
            service.close()
        same = {k: together[k] == alone[k] for k in alone}
        print(f"float32 server, a sequential (beam 1) and a batched (beam 5) request of 20 s together "
              f"against each alone: equal segments and tokens {same}; threads and CUDA streams that "
              f"launched decodes: {sorted(streams)}")
        if not all(same.values()):
            raise AssertionError(f"float32 requests served together differ from each alone: {same}")
        if len({s for _, s in streams}) != 1:
            raise AssertionError(f"the serving threads launched on more than one stream: {streams}")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    del model
    torch.cuda.empty_cache()


def run_serving(later, jfk, ct2_int8, card):
    """Phase 11: the warm, the HTTP server with its ContinuousBatcher over
    the int8 model of request i, a concurrent mix of requests, the same
    four batched requests again with their launch counts (one launching
    thread: the batcher's) against the unscheduled pipeline in series, the
    float32 thread hazards, and the CLI on ``ct2_int8``.  Returns the
    counts of the counted round."""
    import io
    import tempfile
    import threading
    import urllib.request

    from faster_whisper_tpu_torch.audio import decode_audio
    from faster_whisper_tpu_torch.precompile import warm_parallel
    from faster_whisper_tpu_torch.server import make_server
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline, WhisperModel

    cfg, tok = later["cfg"], later["tok"]
    audio = np.tile(jfk, -(-60 * 16000 // len(jfk)))[: 60 * 16000]
    duration = len(audio) / 16000
    payload = wav_bytes(audio)
    audio = decode_audio(io.BytesIO(payload))  # what the server transcribes
    model = WhisperModel.from_parts(later["params"], cfg, tok, compute_type="int8")

    torch.cuda.reset_peak_memory_stats()
    failures, sec = _synced_seconds(lambda: warm_parallel(
        model, durations_s=(30.0, 300.0), batch_size=8, beam_size=5, max_new_tokens=(128,),
        language="en", log=print,
    ))
    print(f"serving warm_parallel(durations_s=(30, 300), batch_size=8, beam_size=5, "
          f"max_new_tokens=(128,)): {sec:.3f} s (kernels already built by phase 2), failures "
          f"{failures}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    if failures:
        raise AssertionError(f"warm_parallel failed: {failures}")

    server = make_server(model, model_name="large-v3-turbo int8")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_port}"
    batcher = server.service.batcher
    log = DispatchLog(batcher)
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = (r.status, json.load(r))
        print(f"server on {url}: /healthz {health}")
        if health[0] != 200:
            raise AssertionError(f"/healthz answered {health}")

        fields = dict(language="en", beam_size="5", batch_size="8", max_new_tokens="128",
                      response_format="verbose_json")
        batched = {f"batched {i}": (lambda: post_multipart(url, payload, fields)) for i in range(4)}
        mix = dict(batched)
        mix["sse"] = lambda: post_multipart(url, payload, dict(fields, stream="true"))
        mix["sequential"] = lambda: post_multipart(url, payload, dict(fields, batch_size="0"))
        t0 = time.perf_counter()
        replies = concurrently(mix)
        wall = time.perf_counter() - t0
        for name, (status, body, seconds) in replies.items():
            segments = served_segments(name, status, body, name == "sse", duration, cfg.n_vocab)
            print(f"serving mix, request {name}: HTTP {status}, {len(segments)} segments, "
                  f"{sum(len(s.tokens) for s in segments)} tokens, latency {seconds:.3f} s")
        print(f"serving mix: 4 batched + 1 SSE + 1 sequential requests of {duration:.0f} s together, "
              f"{wall:.3f} s wall; the batcher: {batcher.chunks_processed} chunks in "
              f"{batcher.batches_dispatched} batches of {[b['chunks'] for b in log.batches]} chunks "
              f"(buckets {[b['bucket'] for b in log.batches]}) on {card}")
        if not batcher.batches_dispatched < batcher.chunks_processed:
            raise AssertionError(f"the chunks did not coalesce: {batcher.batches_dispatched} batches for "
                                 f"{batcher.chunks_processed} chunks")
        metrics = scrape_metrics(url)
        want = {"fwt_batcher_batches_dispatched_total": batcher.batches_dispatched,
                "fwt_batcher_chunks_processed_total": batcher.chunks_processed,
                'fwt_requests_total{status="ok"}': 6, "fwt_requests_in_flight": 0}
        got = {k: metrics.get(k) for k in want}
        print(f"/metrics: {got}")
        if got != want:
            raise AssertionError(f"/metrics reports {got}, expected {want}")

        # the counted round: only the batcher's thread launches kernels
        log.batches.clear()
        log.entries.clear()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        b0, c0 = batcher.batches_dispatched, batcher.chunks_processed
        t0 = time.perf_counter()
        replies = concurrently(batched)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        for name, (status, body, seconds) in replies.items():
            served_segments(name, status, body, False, duration, cfg.n_vocab)
        latencies = ", ".join(f"{r[2]:.3f}" for r in replies.values())
        idle = log.idle(t0, t0 + wall)
        gaps = [b["start"] - a["end"] for a, b in zip(log.batches, log.batches[1:])]
        print(f"serving, 4 concurrent batched requests of {duration:.0f} s: latencies {latencies} s, "
              f"{wall:.3f} s wall, {4 * duration / wall:.2f} audio s per wall s; "
              f"{batcher.chunks_processed - c0} chunks in {batcher.batches_dispatched - b0} batches of "
              f"{[b['chunks'] for b in log.batches]} chunks (buckets {[b['bucket'] for b in log.batches]}), "
              f"batch seconds {[round(b['end'] - b['start'], 3) for b in log.batches]}; the batcher's "
              f"thread idle {idle:.3f} s of the {wall:.3f} s ({idle / wall:.1%}; before the first batch "
              f"{log.batches[0]['start'] - t0:.3f} s, between batches {[round(g, 3) for g in gaps]} s); "
              f"peak memory {peak:.2f} GiB on {card}; counts {counts}")
        print(f"main path counts, serving: {counts}")
        check_counts(counts, per_step=("k2", "k4_int8"), per_encode="k3", cfg=cfg)
        scheduled = list(log.entries)
    finally:
        log.close()
        server.shutdown()
        server.service.close()

    # the same four requests one after another through the unscheduled pipeline
    pipeline = BatchedInferencePipeline(model)
    rows, collect = [], model.model.generate_collect

    def recorded_collect(pending):
        results = collect(pending)
        rows.append((len(results), [list(r.sequences_ids[0]) for r in results]))
        return results

    model.model.generate_collect = recorded_collect
    try:
        t0 = time.perf_counter()
        for _ in range(4):
            segments, _ = pipeline.transcribe(audio, language="en", beam_size=5, batch_size=8,
                                              max_new_tokens=128)
            list(segments)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del model.model.generate_collect
    n_chunks = max(r for r, _, _ in scheduled) + 1
    per_run = rows[: len(rows) // 4]
    unscheduled = {}  # row -> (bucket, tokens)
    for bucket, toks in per_run:
        for t in toks[: n_chunks - len(unscheduled)]:
            unscheduled[len(unscheduled)] = (bucket, t)
    print(f"the same 4 requests one after another through BatchedInferencePipeline without the "
          f"scheduler: {wall:.3f} s, {4 * duration / wall:.2f} audio s per wall s on {card}")
    same_bucket = [(row, toks == unscheduled[row][1]) for row, bucket, toks in scheduled
                   if bucket == unscheduled[row][0]]
    other = [(row, bucket, unscheduled[row][0], *token_diff(toks, unscheduled[row][1]))
             for row, bucket, toks in scheduled if bucket != unscheduled[row][0]]
    print(f"scheduled chunks against the unscheduled pipeline's: {len(same_bucket)} in the same bucket, "
          f"equal tokens {sum(eq for _, eq in same_bucket)}; {len(other)} in another bucket, "
          f"(row, scheduled bucket, unscheduled bucket, tokens that differ, first step that differs): "
          f"{other}")
    if not all(eq for _, eq in same_bucket):
        raise AssertionError("a scheduled chunk's tokens differ from the unscheduled pipeline's in the "
                             "same batch bucket")
    del model, pipeline
    torch.cuda.empty_cache()

    check_float32_threads(later, audio, card)

    with tempfile.TemporaryDirectory(dir=os.path.dirname(ct2_int8)) as tmp:
        path = os.path.join(tmp, "jfk60.wav")
        with open(path, "wb") as f:
            f.write(payload)
        cmd = [sys.executable, "-m", "faster_whisper_tpu_torch", path, "--model", ct2_int8,
               "--compute-type", "int8", "--language", "en", "--output-format", "srt"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
    n_blocks = check_srt(proc.stdout, duration)
    print(f"CLI: python -m faster_whisper_tpu_torch <{duration:.0f} s WAV> --model <CT2 int8 "
          f"directory> --compute-type int8 --language en --output-format srt: exit 0, {n_blocks} SRT "
          f"blocks, {sec:.3f} s (a new process: CUDA context, load, VAD, batched decode) on {card}; "
          f"first block {proc.stdout.strip().splitlines()[:3]}")
    return counts


# ---------------------------------------------------------------------------
# Phase 12: the speculative encode, the pipelined VAD, the gate, the warm
# CLI and memory_report
# ---------------------------------------------------------------------------

# Kernel forms that must never launch on the speculative encode's side
# stream: K1, K2 and K4 share per-device buffers (ops/cross_attention.py).
DECODE_FORMS = ("k1", "k1_f32", "k2", "k2_f32", "k4_bf16", "k4_f32", "k4_int8", "k4_int8_f32")


def check_side_encode(model, window, n_layer, k3="k3"):
    """One speculative encode of ``window`` on the side stream
    (``transcribe._SideEncode``) against the in-line encode of the same
    window on the default stream: ``torch.equal``, and the side stream
    launched K3 ``n_layer`` times and no K1, K2 or K4 (the launch counters
    read around it).  Returns the side stream's priority and the default
    stream's."""
    from faster_whisper_tpu_torch import transcribe
    from faster_whisper_tpu_torch.utils import side_stream

    before = read_counts()
    side = transcribe._SideEncode(model.encode, window)
    after = read_counts()
    got = side.result()
    want = model.encode(window)
    torch.cuda.synchronize()
    delta = {k: after[k] - before[k] for k in after}
    if any(delta[k] for k in DECODE_FORMS) or delta[k3] != n_layer or delta["encodes"] != 1:
        raise AssertionError(f"the side-stream encode launched {delta}")
    if not torch.equal(got, want):
        raise AssertionError(f"the side-stream encode differs from the in-line one: max|diff| "
                             f"{(got.float() - want.float()).abs().max().item():.3e}")
    stream = side_stream(window.device, "speculative encode")
    return getattr(stream, "priority", "n/a"), getattr(torch.cuda.current_stream(), "priority", "n/a")


def _priority_range():
    """CUDA's (least, greatest) stream priority, as PyTorch reports it."""
    fn = getattr(torch.cuda.Stream, "priority_range", None)
    try:
        return fn() if fn is not None else "n/a"
    except TypeError:  # printed only: an instance method in this PyTorch
        return "n/a"


class SpeculationProbe:
    """Within the block: every speculative encode (``transcribe.
    _SideEncode``) is logged with the launch counters read around it, its
    window and output kept; every encode is timed with CUDA events on the
    stream it launched on (the side stream for a speculative one); every
    decode step records an event on the default stream after its launches;
    and the sampling rungs' seeds follow the call order (the port draws
    fresh entropy per call otherwise), so that runs with speculation off
    and on sample the same.  ``report()`` reads it all after the run."""

    def __init__(self, model):
        self.model = model
        self.made, self.encodes, self.steps = [], [], []

    def __enter__(self):
        from faster_whisper_tpu_torch import transcribe
        from faster_whisper_tpu_torch.generation import generate

        probe, model = self, self.model
        base = self._base = transcribe._SideEncode

        class Probe(base):
            def __init__(self, encode, window):
                before = read_counts()
                super().__init__(encode, window)
                after = read_counts()
                self.entry = dict(window=window, output=self.output, hit=False,
                                  delta={k: after[k] - before[k]
                                         for k in DECODE_FORMS + ("k3", "k3_f32", "encodes")})
                probe.made.append(self.entry)

            def result(self):
                self.entry.update(hit=True, until=len(probe.steps))
                return super().result()

        encode = model.encode

        def timed_encode(features):
            stream = torch.cuda.current_stream()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = encode(features)
            end.record(stream)
            probe.encodes.append((stream.cuda_stream != torch.cuda.default_stream().cuda_stream,
                                  start, end))
            return out

        step, seeds = generate._gen_decoder_step, generate._row_seeds
        counter = iter(range(10**9))

        def stepped(*args):
            out = step(*args)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            probe.steps.append(ev)
            return out

        stepped.calls = 0
        self._saved = (step, seeds)
        transcribe._SideEncode = Probe
        model.encode = timed_encode
        generate._gen_decoder_step = stepped
        generate._row_seeds = lambda rng_seed, b: seeds(
            next(counter) if rng_seed is None else rng_seed, b
        )
        return self

    def __exit__(self, *exc):
        from faster_whisper_tpu_torch import transcribe
        from faster_whisper_tpu_torch.generation import generate

        transcribe._SideEncode = self._base
        del self.model.encode
        # the step function counts its calls on its module's name, which
        # named the wrapper meanwhile
        stepped = generate._gen_decoder_step
        generate._gen_decoder_step, generate._row_seeds = self._saved
        generate._gen_decoder_step.calls += stepped.calls
        return False

    def report(self, n_layer, k3="k3"):
        """Checks every speculative encode's launches (``k3``: its K3
        form) and every hit's states against the in-line encode of its
        window; returns the numbers of the run: speculative encodes, hits,
        misses, the side and in-line encodes' device ms, and the device ms
        between consecutive decode steps' events for the steps whose span
        overlaps a speculative encode against the others."""
        torch.cuda.synchronize()
        for e in self.made:
            d = e["delta"]
            if any(d[k] for k in DECODE_FORMS) or d[k3] != n_layer or d["encodes"] != 1:
                raise AssertionError(f"a speculative encode launched {d} on the side stream")
        side = [s.elapsed_time(t) for on_side, s, t in self.encodes if on_side]
        inline = [s.elapsed_time(t) for on_side, s, t in self.encodes if not on_side]
        side_spans = [(s, t) for on_side, s, t in self.encodes if on_side]
        beside, other = [], []
        for a, b in zip(self.steps, self.steps[1:]):
            overlaps = any(a.elapsed_time(t) > 0 and s.elapsed_time(b) > 0 for s, t in side_spans)
            (beside if overlaps else other).append(a.elapsed_time(b))
        saved = read_counts()
        equal = []
        for e in self.made:
            if e["hit"]:
                equal.append(torch.equal(e["output"], self.model.model.encode(e["window"])))
        torch.cuda.synchronize()
        for name, (f, attr) in _counted().items():
            setattr(f, attr, saved[name])  # the check's encodes do not count
        if not all(equal):
            raise AssertionError(f"a speculation hit's encoder states differ from the in-line encode "
                                 f"of its window ({equal})")
        hits = sum(e["hit"] for e in self.made)
        return dict(made=len(self.made), hits=hits, misses=len(self.made) - hits,
                    side_ms=side, inline_ms=inline, beside=beside, other=other, equal=len(equal))


def _steps_ms(xs):
    return f"median {np.median(xs):.3f}, max {max(xs):.3f}, sum {sum(xs):.3f}" if xs else "n/a"


def _ms(xs):
    return f"{np.median(xs):.3f}" if xs else "n/a"


def check_small_speculation():
    """The small model on the card at bf16, int8 and float32: one
    speculative encode against the in-line one (``check_side_encode``),
    then 100 s of the synthetic audio, en, without timestamps, beam 2, 16
    new tokens, the vocabulary's specials suppressed (random weights emit
    timestamp tokens even without timestamps, and the seek then follows
    the last one: a miss), with FWT_SPEC_ENCODE=0 and =1
    (``SpeculationProbe``): equal segments, and at least one hit whose
    states equal the in-line encode of its window."""
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg, cpu, tok = small_model_parts()
    audio = synth_audio(100.0, seed=4)
    g = torch.Generator(device="cuda").manual_seed(0)
    window = torch.randn((1, cfg.n_mels, 3000), generator=g, device="cuda")
    for compute_type, k3 in (("bfloat16", "k3"), ("int8", "k3"), ("float32", "k3_f32")):
        model = WhisperModel.from_parts(cpu, cfg, tok, compute_type=compute_type, device="cuda")
        check_side_encode(model, window, cfg.n_audio_layer, k3=k3)
        rows, hits = {}, {}
        for spec in ("0", "1"):
            os.environ["FWT_SPEC_ENCODE"] = spec
            try:
                with SpeculationProbe(model) as probe:
                    segments, _ = model.transcribe(audio, language="en", without_timestamps=True,
                                                   beam_size=2, max_new_tokens=16,
                                                   suppress_tokens=SMALL_SPECIALS)
                    rows[spec] = [(s.seek, s.start, s.end, s.tokens, s.avg_logprob) for s in segments]
            finally:
                os.environ.pop("FWT_SPEC_ENCODE")
            hits[spec] = probe.report(cfg.n_audio_layer, k3=k3)["hits"]
        print(f"small model at {compute_type}, speculation off and on: {len(rows['1'])} segments, "
              f"equal: {rows['0'] == rows['1']}; hits {hits}")
        if rows["0"] != rows["1"] or hits["0"] or not hits["1"]:
            raise AssertionError(f"small model speculation at {compute_type}: hits {hits}, equal "
                                 f"segments {rows['0'] == rows['1']}")


def run_speculation(later, card):
    """Phase 12a: requests p (150 s, en, without timestamps, beam 5, 128
    new tokens, temperature 0, bf16), q (p at int8) and a (45 s, the
    ladder with timestamps), each with FWT_SPEC_ENCODE=0 and then =1: equal
    segments in each pair, every hit's encoder states equal to the
    in-line encode of its window, no K1, K2 or K4 launched on the side
    stream; speculative encodes, hits, misses, K3 launches, wall seconds
    and ms per step of each run, and the side encode's device ms against
    the steps that ran beside it.  Returns the counts of the runs."""
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg, tok = later["cfg"], later["tok"]
    long_clip = synth_audio(150.0, seed=1)
    p_kwargs = dict(language="en", without_timestamps=True, beam_size=5, max_new_tokens=128,
                    temperature=0.0)
    runs = {}
    for compute_type in ("bfloat16", "int8"):
        model = WhisperModel.from_parts(later["params"], cfg, tok, compute_type=compute_type)
        per_step = ("k1", "k4_bf16") if compute_type == "bfloat16" else ("k2", "k4_int8")
        window = torch.zeros((1, cfg.n_mels, 3000), device="cuda")
        window[..., :1500] = 1.0
        prio = check_side_encode(model, window, cfg.n_audio_layer)
        print(f"side-stream encode at {compute_type}: equal to the in-line encode, K3 x "
              f"{cfg.n_audio_layer} and no K1, K2, K4 on the side stream; stream priorities: side "
              f"{prio[0]}, default {prio[1]} (CUDA's range (least, greatest): "
              f"{_priority_range()})")
        requests = [("p" if compute_type == "bfloat16" else "q", long_clip, p_kwargs)]
        if compute_type == "bfloat16":
            requests.append(("a", synth_audio(45.0, seed=1), dict(language=None, beam_size=5)))
        for name, audio, kwargs in requests:
            rows = {}
            for spec in ("0", "1"):
                os.environ["FWT_SPEC_ENCODE"] = spec
                reset_counts()  # before the probe, which wraps the step counter's function
                with SpeculationProbe(model) as probe:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    segments, info = model.transcribe(audio, **kwargs)
                    segments = list(segments)
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                counts = read_counts()
                rep = probe.report(cfg.n_audio_layer)
                check_segments(segments, info, len(audio) / 16000, cfg.n_vocab)
                check_counts(counts, per_step=per_step, per_encode="k3", cfg=cfg)
                runs[f"{name} spec {spec}"] = counts
                rows[spec] = [(s.seek, s.start, s.end, s.text, s.tokens, s.avg_logprob, s.temperature,
                               s.no_speech_prob) for s in segments]
                print(f"request {name} ({compute_type}, {len(audio) / 16000:.0f} s, {kwargs}), "
                      f"FWT_SPEC_ENCODE={spec}: {len(segments)} segments, {seconds:.3f} s wall, "
                      f"{counts['steps']} decode steps, {seconds * 1e3 / max(counts['steps'], 1):.2f} ms "
                      f"per step (wall), {counts['encodes']} encodes, K3 launches {counts['k3']}; "
                      f"speculative encodes {rep['made']}, hits {rep['hits']} (states equal to the "
                      f"in-line encode: {rep['equal']} of {rep['hits']}), misses {rep['misses']}; encode "
                      f"device ms, median: side stream {_ms(rep['side_ms'])} ({len(rep['side_ms'])}), in "
                      f"line {_ms(rep['inline_ms'])} ({len(rep['inline_ms'])}); device ms between decode "
                      f"step events: the {len(rep['beside'])} spans overlapping a speculative encode "
                      f"{_steps_ms(rep['beside'])}, the other {len(rep['other'])} "
                      f"{_steps_ms(rep['other'])} on {card}")
            os.environ.pop("FWT_SPEC_ENCODE")
            print(f"request {name}: segments with speculation off and on equal: {rows['0'] == rows['1']}")
            if rows["0"] != rows["1"]:
                raise AssertionError(f"request {name}'s segments differ with speculation on")
        del model
        torch.cuda.empty_cache()
    return runs


def check_pipelined_vad(speech, card):
    """Phase 12b: ``upload_with_vad`` over ``speech`` against
    ``upload_audio`` and the whole-buffer forward on the card, in turns
    (serial, pipelined, pipelined, serial) after one warm call of each:
    the PCM ``torch.equal``, the probabilities' max |diff|, the speech
    timestamps of the pipeline's options equal.  Returns the max |diff|."""
    import torch.nn.functional as F

    from faster_whisper_tpu_torch.models.silero import VAD_SLICE_SAMPLES
    from faster_whisper_tpu_torch.ops.mel import upload_audio
    from faster_whisper_tpu_torch.vad import (
        VadOptions,
        get_vad_model,
        speech_timestamps_from_probs,
        upload_with_vad,
    )

    n = len(speech)
    expected = n // 512 + 1
    model = get_vad_model("cuda")

    def serial():
        audio_dev = upload_audio(speech, "cuda")
        return audio_dev, model(F.pad(audio_dev, (0, expected * 512 - n))).cpu().numpy()

    def pipelined():
        return upload_with_vad(speech, device="cuda")

    serial(), pipelined()
    secs = {"serial": [], "pipelined": []}
    out = {}
    for name in ("serial", "pipelined", "pipelined", "serial"):
        out[name], sec = _synced_seconds(serial if name == "serial" else pipelined)
        secs[name].append(sec)
    (a_serial, p_serial), (a_pipe, p_pipe) = out["serial"], out["pipelined"]
    err = float(np.abs(p_pipe[:expected] - p_serial).max())
    opts = VadOptions(max_speech_duration_s=30, min_silence_duration_ms=160)
    ts_serial = speech_timestamps_from_probs(p_serial, n, opts)
    ts_pipe = speech_timestamps_from_probs(p_pipe, n, opts)
    print(f"pipelined VAD over {n / 16000:.0f} s ({-(-n // VAD_SLICE_SAMPLES)} slices of "
          f"{VAD_SLICE_SAMPLES} samples): upload_with_vad {', '.join(f'{s:.4f}' for s in secs['pipelined'])} s, "
          f"upload_audio + whole-buffer forward {', '.join(f'{s:.4f}' for s in secs['serial'])} s "
          f"(both with the probabilities back on the host); PCM equal: {torch.equal(a_pipe, a_serial)}; "
          f"probabilities max|diff| {err:.3e} ({int((p_pipe[:expected] != p_serial).sum())} of {expected} "
          f"windows differ); speech timestamps equal: {ts_pipe == ts_serial} ({len(ts_pipe)} chunks) "
          f"on {card}")
    if not torch.equal(a_pipe, a_serial):
        raise AssertionError("upload_with_vad's PCM differs from upload_audio's")
    if ts_pipe != ts_serial:
        raise AssertionError("the pipelined VAD's speech timestamps differ from the whole-buffer VAD's")
    if not err <= VAD_PROB_TOL:
        raise AssertionError(f"the pipelined VAD's probabilities differ by {err:.3e}")
    return err


def run_pipelined_request(later, speech, card):
    """Phase 12b, request h again under FWT_PIPELINED_VAD=1: its segments
    must be h's.  Returns its counts."""
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg = later["cfg"]
    model = WhisperModel.from_parts(later["params"], cfg, later["tok"])
    os.environ["FWT_PIPELINED_VAD"] = "1"
    try:
        counts, segments, seconds = run_batched(model, "h (FWT_PIPELINED_VAD=1): bf16", speech, cfg)
    finally:
        os.environ.pop("FWT_PIPELINED_VAD")
    check_counts(counts, per_step=("k1", "k4_bf16"), per_encode="k3", cfg=cfg)
    want = [(s.start, s.end, s.tokens) for s in later["h_segments"]]
    got = [(s.start, s.end, s.tokens) for s in segments]
    print(f"request h under FWT_PIPELINED_VAD=1 against request h: equal segments: {got == want} on {card}")
    if got != want:
        raise AssertionError("request h's segments differ under FWT_PIPELINED_VAD=1")
    del model
    torch.cuda.empty_cache()
    return counts


def _captured(main, argv):
    """``main(argv)``, its exit code and its standard output (its last line
    is a JSON object, printed here behind a label rather than bare)."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue().strip().splitlines(), time.perf_counter() - t0


def run_tools(later, card):
    """Phase 12c-e: the acceptance gate in mock mode, the offline warm CLI
    at large-v3-turbo width, int8, and ``memory_report`` on request i's
    int8 model beside i's measured peak; each launches on the card.
    Returns the counts of the gate's and the warm CLI's runs."""
    from faster_whisper_tpu_torch import precompile, validate
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    runs = {}
    reset_counts()
    rc, lines, sec = _captured(validate.main, ["--mock"])
    counts = runs["validate"] = read_counts()
    summary = json.loads(lines[-1])
    print(f"validate --mock (micro model at widths 128, float32, on the card): exit {rc}, {sec:.3f} s, "
          f"summary {summary}; launches {counts} on {card}")
    if rc != 0 or summary["fail"] or summary["pass"] < 5:
        raise AssertionError(f"validate --mock failed: exit {rc}, {summary}")
    if not (counts["k3_f32"] and counts["k1_f32"] and counts["k2"] and counts["k4_int8"]):
        raise AssertionError(f"validate --mock did not run the kernels on the card: {counts}")

    argv = ["--random-weights", "--model", "large-v3-turbo", "--compute-type", "int8",
            "--max-new-tokens", "128", "--language", "en"]
    reset_counts()
    rc, lines, sec = _captured(precompile.main, argv)
    counts = runs["precompile"] = read_counts()
    report = json.loads(lines[-1])
    print(f"precompile {' '.join(argv)}: exit {rc}, {sec:.3f} s, report {report}; launches {counts} "
          f"on {card}")
    if rc != 0:
        raise AssertionError(f"precompile.main exited {rc}")
    check_counts(counts, per_step=("k2", "k4_int8"), per_encode="k3", cfg=later["cfg"])
    torch.cuda.empty_cache()

    model = WhisperModel.from_parts(later["params"], later["cfg"], later["tok"], compute_type="int8")
    rep, sec = _synced_seconds(lambda: model.model.memory_report(batch_size=8, beam_size=5,
                                                                 max_new_tokens=128))
    gib = 2.0**30

    def fmt(r):
        return ", ".join(f"{k} {v / gib:.3f} GiB" for k, v in r.items())

    print(f"memory_report(batch_size=8, beam_size=5, max_new_tokens=128) on request i's int8 model "
          f"({sec:.3f} s): weights {rep['weights_bytes'] / gib:.3f} GiB; encode: {fmt(rep['encode'])}; "
          f"decode: {fmt(rep['decode'])}; request i's measured peak {later['i_peak'] / gib:.3f} GiB "
          f"on {card}")
    for name in ("encode", "decode"):
        r = rep[name]
        if set(r) != {"argument_bytes", "output_bytes", "temp_bytes", "code_bytes", "peak_bytes"} or \
                not r["peak_bytes"] > r["argument_bytes"] > rep["weights_bytes"] > 0:
            raise AssertionError(f"memory_report's {name}: {r}")
    del model
    torch.cuda.empty_cache()
    return runs


def _fmt(x):
    return "n/a" if x is None else f"{x:.4f} ms"


def print_times(label, t, card):
    fma = f", f32 FMA bound {t['fma_bound_ms']:.4f} ms" if "fma_bound_ms" in t else ""
    print(f"{label} {t['shape']}: kernel {t['ms']:.4f} ms warm, {t['cold_ms']:.4f} ms L2 cold, "
          f"{t['call_ms']:.4f} ms per call from the host; plain {t['plain_ms']:.4f} ms; "
          f"library {_fmt(t['library_ms'])} warm, {_fmt(t['library_cold_ms'])} L2 cold; "
          f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}){fma} on {card}")


def main():
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    require_card()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, {sys.version.split()[0]}")
    phase("device", t0)

    t0 = time.perf_counter()
    for src, lines in build_kernels().items():
        for ln in lines:
            print(f"build {src}: {ln}")
    phase("build", t0)

    t0 = time.perf_counter()
    f32 = torch.float32
    errs = {
        "K1": check_beam_attention(),
        "K1 f32": check_beam_attention(dtype=f32),
        "K3": check_flash_attention(**K3_SHAPES),
        "K3 f32": check_flash_attention(**K3_SHAPES, dtype=f32),
    }
    errs["K2"], k2_codes = check_beam_attention_int8()
    errs["K2 f32"], k2_codes_f32 = check_beam_attention_int8(dtype=f32)
    for form in K1_FORMS:
        check_beam_attention_graph(form)
    for form, err in check_cross_attention().items():
        errs[f"K4 {form}"] = err
    print(f"K2 codes that differ from the plain version's by one unit: {k2_codes} (bf16), "
          f"{k2_codes_f32} (f32)")
    phase("kernels against plain versions", t0)

    t0 = time.perf_counter()
    times = {
        "K1": time_beam_attention(),
        "K1 f32": time_beam_attention(dtype=f32),
        "K2": time_beam_attention(quant=True),
        "K2 f32": time_beam_attention(quant=True, dtype=f32),
        "K3": time_flash_attention(),
        "K3 f32": time_flash_attention(dtype=f32),
        "K4 bf16": time_cross_attention(quant=False),
        "K4 int8": time_cross_attention(quant=True),
        "K4 f32": time_cross_attention(quant=False, dtype=f32),
        "K4 int8 f32": time_cross_attention(quant=True, dtype=f32),
    }
    for label, t in times.items():
        print_times(label, t, card)
    print_times("K3", time_flash_attention(B=8), card)
    print_times("K3 f32", time_flash_attention(B=8, dtype=f32), card)
    for quant in (False, True):
        print_times("K4", time_cross_attention(quant, B=8), card)
    for label, (quant, dtype) in K1_FORMS.items():
        print_times(label, time_beam_attention(B=8, quant=quant, dtype=dtype), card)
    print_times("K1", time_beam_attention(B=5, pos=223), card)
    phase("times", t0)

    t0 = time.perf_counter()
    jfk, speech = tiled_speech()
    pipeline_chunks = check_vad(speech, card)
    phase("VAD", t0)
    t0 = time.perf_counter()
    check_chunked_mel(speech, pipeline_chunks, card)
    phase("chunked mel", t0)

    t0 = time.perf_counter()
    runs, later = run_main_path(speech)
    phase("main path", t0)
    t0 = time.perf_counter()
    check_small_model_against_cpu()
    check_small_pipeline_against_cpu(jfk)
    phase("small model against the CPU", t0)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", f"checkpoints_{os.getpid()}")
    os.makedirs(root)
    try:
        t0 = time.perf_counter()
        counts, ct2_int8 = run_checkpoints(speech, card, root)
        runs.update(counts)
        phase("checkpoints", t0)
        t0 = time.perf_counter()
        runs.update(run_word_timestamps(later, jfk, speech, pipeline_chunks, runs["i"], card))
        phase("word timestamps", t0)
        t0 = time.perf_counter()
        runs["serving"] = run_serving(later, jfk, ct2_int8, card)
        phase("serving", t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    late = run_speculation(later, card)
    phase("speculative encode", t0)
    t0 = time.perf_counter()
    check_pipelined_vad(speech, card)
    late["h pipelined"] = run_pipelined_request(later, speech, card)
    phase("pipelined VAD", t0)
    t0 = time.perf_counter()
    late.update(run_tools(later, card))
    del later
    phase("gate, warm CLI, memory_report", t0)

    def late_sum(key):
        return sum(c[key] for c in late.values())

    def entry(name, label, source, replaces, launches):
        t = times[label]
        return dict(name=name, route="cuda", source=f"faster_whisper_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=errs[label],
                    **{k: t[k] for k in ("ms", "cold_ms", "call_ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")})

    bf16, int8, fp32, int8_f32, req_h, req_i, req_j, req_k, req_l, req_m, req_n, req_o, serve = (
        runs[k] for k in ("bf16", "int8", "f32", "int8_f32", "h", "i", "j", "k", "l", "m", "n", "o",
                          "serving")
    )
    # the K4 int8 form's error: over int8 codes and over the int4 cross cache's
    errs["K4 int8"] = max(errs["K4 int8"], errs["K4 int8 qmax7"])
    errs["K4 int8 f32"] = max(errs["K4 int8 f32"], errs["K4 int8 qmax7 f32"])
    # each kernel's launches over every path's counted run: phases 7 and
    # 9-11 and phase 12's (late_sum)
    kernels = [
        entry("beam_attend_append bf16 (K1)", "K1", "beam_attention.cu", K1_REPLACES,
              bf16["k1"] + req_h["k1"] + req_j["k1"] + req_l["k1"] + late_sum("k1")),
        entry("beam_attend_append f32 (K1)", "K1 f32", "beam_attention.cu", K1_REPLACES,
              fp32["k1_f32"] + late_sum("k1_f32")),
        entry("beam_attend_append int8 (K2)", "K2", "beam_attention.cu", K2_REPLACES,
              int8["k2"] + req_i["k2"] + req_k["k2"] + req_m["k2"] + req_n["k2"] + req_o["k2"]
              + serve["k2"] + late_sum("k2")),
        entry("beam_attend_append int8, f32 activations (K2)", "K2 f32", "beam_attention.cu",
              K2_REPLACES, int8_f32["k2_f32"] + late_sum("k2_f32")),
        entry("mha_flash bf16 (K3)", "K3", "flash_attention.cu", K3_REPLACES,
              bf16["k3"] + int8["k3"] + req_h["k3"] + req_i["k3"] + req_j["k3"] + req_k["k3"]
              + req_l["k3"] + req_m["k3"] + req_n["k3"] + req_o["k3"] + serve["k3"]
              + late_sum("k3")),
        entry("mha_flash f32 (K3)", "K3 f32", "flash_attention.cu", K3_REPLACES,
              fp32["k3_f32"] + int8_f32["k3_f32"] + late_sum("k3_f32")),
        entry("cross_attend bf16 (K4a)", "K4 bf16", "cross_attention.cu", K4A_REPLACES,
              bf16["k4_bf16"] + req_h["k4_bf16"] + req_j["k4_bf16"] + req_l["k4_bf16"]
              + late_sum("k4_bf16")),
        entry("cross_attend f32 (K4a)", "K4 f32", "cross_attention.cu", K4A_REPLACES,
              fp32["k4_f32"] + late_sum("k4_f32")),
        entry("cross_attend int8 (K4b, K4c)", "K4 int8", "cross_attention.cu", K4B_REPLACES,
              int8["k4_int8"] + req_i["k4_int8"] + req_k["k4_int8"] + req_m["k4_int8"]
              + req_n["k4_int8"] + req_o["k4_int8"] + serve["k4_int8"] + late_sum("k4_int8")),
        entry("cross_attend int8, f32 activations (K4b, K4c)", "K4 int8 f32", "cross_attention.cu",
              K4B_REPLACES, int8_f32["k4_int8_f32"] + late_sum("k4_int8_f32")),
    ]
    print(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
