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
   int4 cross cache); and the probe kernels of ``ops/probes.py`` at the
   probe scripts' shape (B=8, H=20, K=5, ctx=192, D=64, 32 layers): P1
   (attention only, s8) with every row at 120, 0 and 191 over the
   scripts' identity ancestry and a divergent one, P2b and P2h (int8 QK
   score sums), each with q's s8 codes equal to the plain version's (P1's
   weight codes too, but for a count one unit apart where the float32
   softmax sum's order moves a weight across a rounding boundary) and a
   second call equal to the first, P2b also bit for bit equal to its exact
   int64 reference (``scores_batched_exact``); then every form of K1/K2
   and K4 on one row of a batch of 8 with 20 heads: the row alone, inside
   its batch and as heads 10-19 (a ``tensor_parallel=2`` shard)
   bit-equal; then the LayerNorm kernel (LN, ``csrc/layer_norm.cu``) in
   bf16 and float32 at a decode step's and an encode's rows and at other
   widths against its plain version, and a row's bits alone and inside
   10, 16, 40 and 12000 rows, which must be equal; then the W8A8 kernel
   (``csrc/w8a8.cu``, ``int8_dense`` on the card) bit-equal to the
   composition it replaced (``_quantize_rows``, ``torch._int_mm``,
   ``_rescale``) at 1 to 12000 rows, every width of large-v3's products
   and its padded logits head, bf16 and float32 inputs and outputs, with
   and without a bias, a zero row and 4-bit-range codes, one launch per
   call (a decode launch up to 64 rows, ``int8_dense.decode_launches``)
   and one per ``int8_dense_many`` call of three weights up to 64 rows;
4. times: each kernel form, its plain version and, where one exists, the
   one PyTorch call that computes the same function, on the card (CUDA
   events around the replay of a CUDA graph of 20 calls, L2 warm), each
   kernel again with L2 cold (a 256 MB buffer written before each call,
   each call under its own events), beside the least time the card could
   take (its bound), and each kernel's time per call when the host issues
   the calls one by one, as the decode loop does; K2 at the probes' shape
   beside P1; K1/K2 and K4 with their plans' fixed chunks (32 and 80
   columns) against the chunks that the earlier plans chose from B x H
   and the SM count, at B=1 and B=8 with 20 heads and B=8 with 10, in
   turns, and a sweep of widths at B=8; LN at a decode step's 40 x 1280
   and an encode's 12000 x 1280 beside ``F.layer_norm``; the W8A8 kernel
   at a decode step's shapes (batch 8 x 5 beams: 1280 x 1280, mlp.w2,
   mlp.w1, the logits head, and q, k, v as one call) and an encode's
   mlp.w1 beside the composition it replaced; and an empty kernel timed
   the same ways, the launch floor;
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
   of any other form; LN 2 x 32 + 1 times per encode and 3 x 4 + 1 per
   decoder forward (decode step, prefill, alignment pass), per device of
   a model-axis group (``expected_layer_norms``); the W8A8 kernel in the
   int8 and int4 runs and in no other (request o, in groups: the
   encoder's 6 products a layer only); then (7b) request i's
   last two chunks, the pipeline's batch of 2, again inside a batch of 8,
   compared stage by stage (the log-mel, the conv stem, each encoder
   layer, the encoder's output, the cross K/V codes, the prefill's and
   each decode step's logits; the first stage that differs, or "none", is
   printed), each decode step op by op (its LayerNorms, projections, K2,
   K4, output projections, MLP, residual adds and logits; the first op
   that differs, or none, is printed, and may not be a LayerNorm), the
   decoder's LayerNorm on 1, 10, 16 and 40 rows alone against the same
   rows inside 40 and 12000 (0 rows may differ), and the two chunks
   decoded at batch 8 and at batch 2 from the same encoder states, whose
   tokens must be equal;
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
   ``from_parts`` on them, both sampling from ``rng_seed=0``; request
   k, ``WhisperModel(directory, compute_type="int8")`` through the
   pipeline as in request i; each with
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
    tokens and the first differing step are printed, and must be 0 when
    phase 7b found no stage from the conv stem on that differs between
    buckets, which at int8 every op of the decode step now meets: the
    products and their all-reduces are exact, the quantizers take a max,
    K2/K4 and the LayerNorm kernel split a row alike in any batch); at
    float32 with
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
    measured peak;
13. the probes, the one ctx table and the mesh: the probe entry point's
    sweeps (``ops.probes.run_sweeps``: the scripts' 32 layers x 64 steps
    of K2 against P1 and of P2b against P2h, ms per 32-layer step); then
    requests a (bf16) and q (int8), once each: phase 7's launch counts,
    every decode on one table of its ``ctx_cap`` (``WidthProbe``), ms per
    step and (q) ``memory_report``'s decode peak; then request h on
    ``device_index=[0, 0]`` (two replicas on the one card, each batch
    split over two host threads): phase 7's launch counts, each replica's
    batches, segments equal to one device's with each shard's rows
    batched together (the mesh's output is its shards' batch results),
    counted against h's (batches of 8, which the card's bf16 decode need
    not match), with the wall seconds beside h's; and
    ``device_index=[0, 1]`` on a one-card machine, which is one device;
14. tensor parallel: K1-K4's holds of phase 3 at a shard's heads (H=10
    for N=2, H=5 for N=4) and K1-K4 timed at H=10 beside H=20; at
    large-v3-turbo width ``tensor_parallel=2`` on ``device_index=[0, 0]``
    against one device: an encode's states and a decode step's logits
    (bf16, within TP_BF16_TOL) and a row-parallel int8 product
    (bit-equal); the small float32 model at N=2 on the card against N=2
    on the CPU (equal tokens and times); requests h (bf16) and i (int8)
    through the pipeline and a (20 s) under ``tensor_parallel=2``: per
    decode step 4 launches per shard of K1 (K2) and K4, per encode 32 per
    shard of K3, the all-reduces' count and host time a step (the span
    ``fwt.all_reduce``), and the segments that differ from one device's
    (printed; at bf16 the row-parallel partials round once more; at int8,
    request i, none may differ); with two cards h on ``[0, 1]`` (NCCL)
    must equal ``[0, 0]``'s, and with one a line says that NCCL was not
    run;
15. the sequential log-mel and the upload knobs: the whole-file log-mel
    on the card (``FeatureExtractor(return_device=True)``, 128 mels) and
    the host numpy path at 1 s, 479990, 480000 and 480150 samples, 45 s,
    150 s (request p's audio) and 600 s, each within LOG_MEL_TOL of a
    float64 DFT and of the other, each timed on both; requests a, p and q through ``WhisperModel.transcribe``, whose
    features reach the seek loop as a tensor on the card, with phase 7's
    launch counts; at int8 with the engine's ``rng_seed`` fixed, request
    i on its audio rounded to the int16 grid under ``FWT_SHARED_UPLOAD=0``
    and ``FWT_I16_TRANSFER=0``, each against the knob's default: 0
    segments may differ (on the raw audio only printed);
16. the beam-search step graph (``generation/generate.py::_StepGraph``)
    at the benchmark cells' shapes, large-v3 at int8 with batch 8 and
    large-v3-turbo at bf16 with batch 16, beam 5, 128 new tokens, random
    weights: the batched pipeline over tiled speech records its first
    full batch's decode (and captures the step); that decode again,
    replayed and eagerly (``EagerSteps``), must give the same tables,
    tokens, scores and no-speech probabilities bit for bit and the same
    counts, and the steps' host and device ms are printed both ways; at
    int8, one eager decode step's ``int8_dense.decode_launches /
    int8_dense.launches`` must be 193 / 193 (6 a layer and the head).

Then it prints one JSON line with every kernel's numbers, the card's name
and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Any failure raises and exits nonzero before that line.
"""

import contextlib
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
INT8_TENSOR_OPS = 1979e12
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
P1_REPLACES = "benchmarks/profile_call_anatomy.py:50"
P2B_REPLACES = "benchmarks/profile_mosaic_micro.py:41"
P2H_REPLACES = "benchmarks/profile_mosaic_micro.py:59"
# The port's LayerNorm kernel replaces no TPU kernel: the JAX package's
# layer_norm, which XLA compiles.
LN_REPLACES = "faster_whisper_tpu/models/model.py:39 (XLA, no TPU kernel)"
# The LayerNorm kernel's float32 form against its plain version, of the
# output scale: the same float32 arithmetic with its row sums in another
# order, rsqrt correctly rounded on one side.
LN_F32_REL_TOL = 1e-5
# The probes' float32 sums (P2), card against plain version: of the sum of
# the terms' magnitudes (sums of up to K * ctx * H float32 terms in another
# order; the integer dots are exact on both).
P2_SUM_TOL = 1e-5

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
    chunk, _ = _split_plan(K, ctx, row_bytes)
    return [(B, pos) for pos in sorted({0, 1, chunk - 1, chunk, chunk + 1, ctx - 1})]


def check_beam_attention(batches=(1, 8), dtype=torch.bfloat16, H=20):
    """K1 in ``dtype`` with ``H`` heads against its plain version at ``beam_positions``: the
    attention output within the dtype's tolerance, and the caches: the
    target column of every slot holds the new K/V, every other element is
    untouched.  Returns the max abs error."""
    from faster_whisper_tpu_torch.ops.beam_attention import (
        beam_attend_append,
        beam_attend_append_ref,
    )

    shapes = [bp for B in batches for bp in beam_positions(B, False, dtype, H=H)]
    worst = 0.0
    for (B, pos), divergent in ((shape, d) for shape in shapes for d in (False, True)):
        x = k1_inputs(B, pos, H=H, seed=B * 1000 + pos, divergent=divergent, dtype=dtype)
        ref, rk, rv = _k1_call(beam_attend_append_ref, x)
        out, ok, ov = _k1_call(beam_attend_append, x)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tolerance(dtype) * ref.float().abs().max().item()
        print(f"K1 {dtype_name(dtype)} B={B} H={H} K=5 ctx=448 pos={pos} "
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


def check_beam_attention_int8(batches=(1, 8), dtype=torch.bfloat16, H=20):
    """K2 with ``dtype`` activations and ``H`` heads against its plain version at
    ``beam_positions``: the attention output within the dtype's tolerance;
    the codes written at the target column equal to the plain version's
    (up to one unit where a value lies on a rounding boundary, counted),
    the scales bit-equal, and nothing outside the target column moved.
    Returns (max abs error, count of codes that differ)."""
    from faster_whisper_tpu_torch.ops.beam_attention import (
        beam_attend_append,
        beam_attend_append_ref,
    )

    shapes = [bp for B in batches for bp in beam_positions(B, True, dtype, H=H)]
    worst, n_diff = 0.0, 0
    for (B, pos), divergent in ((shape, d) for shape in shapes for d in (False, True)):
        x = k2_inputs(B, pos, H=H, seed=B * 1000 + pos + 7, divergent=divergent, dtype=dtype)
        ref, rk, rv = _k1_call(beam_attend_append_ref, x)
        out, ok, ov = _k1_call(beam_attend_append, x)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tolerance(dtype) * ref.float().abs().max().item()
        code_diff = max(
            (a.q.int() - b.q.int()).abs().max().item() for a, b in ((ok, rk), (ov, rv))
        )
        n = sum(int((a.q != b.q).sum()) for a, b in ((ok, rk), (ov, rv)))
        print(f"K2 {dtype_name(dtype)} B={B} H={H} K=5 ctx=448 pos={pos} "
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


def check_cross_attention(batches=(1, 8), forms=tuple(K4_FORMS), Ts=(1500,), Ks=(5,), L=4, H=20):
    """K4, each form, with ``H`` heads against its plain version; the second of two calls
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
                    layer, q, ck, cv = k4_inputs(B, quant, K=K, H=H, L=L, T=T, seed=seed, dtype=dtype,
                                                 qmax=qmax)
                    ref = cross_attend_ref(layer, q, ck, cv)
                    out = cross_attend(layer, q, ck, cv)
                    again = cross_attend(layer, q, ck, cv)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    tol = tolerance(dtype) * ref.float().abs().max().item()
                    print(f"K4 {form} B={B} H={H} K={K} T={T}: max|err| {err:.3e} (tolerance {tol:.3e})")
                    if not err <= tol:
                        raise AssertionError(f"K4 ({form}) disagrees with its plain version at B={B}, K={K}, T={T}")
                    if not torch.equal(out, again):
                        raise AssertionError(f"K4 ({form}): a second call differs from the first at B={B}, K={K}, T={T}")
                    worst[form] = max(worst.get(form, 0.0), err)
        # Two layers in one graph, replayed twice.
        layer, q, ck, cv = k4_inputs(batches[0], quant, H=H, L=L, T=Ts[0], seed=99, dtype=dtype, qmax=qmax)
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


def _part(cache, rows, heads):
    """Rows ``rows`` and heads ``heads`` of an (L, B, H, ...) cache, raw or
    ``QuantKV``, as a contiguous cache of its own."""
    from faster_whisper_tpu_torch.ops.quant import QuantKV

    if isinstance(cache, QuantKV):
        return QuantKV(cache.q[:, rows, heads].contiguous(), cache.s[:, rows, heads].contiguous())
    return cache[:, rows, heads].contiguous()


def check_batch_invariance(B=8, H=20, row=3):
    """Phase 3: K1/K2 (every form, write position 300: 10 of 14 chunks
    visible, divergent beams) and K4 (every form, T=1500) on one row of a
    batch of ``B`` with ``H`` heads: the row alone, the same row inside the
    batch and its heads H/2..H-1 as a shard of H/2 heads give bit-equal
    outputs (K1/K2: and bit-equal appended caches), since the kernels'
    column chunks depend on neither the batch nor the heads.  Returns the
    number of holds."""
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append
    from faster_whisper_tpu_torch.ops.cross_attention import cross_attend

    rows, half = slice(row, row + 1), slice(H // 2, H)
    views = {"alone": (rows, slice(None)), f"heads {H // 2}-{H - 1}": (rows, half)}
    n = 0
    for form, (quant, dtype) in K1_FORMS.items():
        x = (k2_inputs if quant else k1_inputs)(B, 300, H=H, seed=31, divergent=True, dtype=dtype)
        whole, wk, wv = _k1_call(beam_attend_append, x)
        for name, (r, h) in views.items():
            y = dict(x, q=x["q"][r, h].contiguous(), k_new=x["k_new"][r, h].contiguous(),
                     v_new=x["v_new"][r, h].contiguous(), self_k=_part(x["self_k"], r, h),
                     self_v=_part(x["self_v"], r, h), anc=x["anc"][r].contiguous(),
                     pos_row=x["pos_row"][r].contiguous())
            out, ok, ov = _k1_call(beam_attend_append, y)
            torch.cuda.synchronize()
            same = torch.equal(out, whole[r, h])
            caches = all(
                torch.equal(a.q, _part(b, r, h).q) and torch.equal(a.s, _part(b, r, h).s) if quant
                else torch.equal(a, _part(b, r, h))
                for a, b in ((ok, wk), (ov, wv))
            )
            print(f"{form} B={B} H={H} pos=300: row {row} {name} against the batch: output "
                  f"bit-equal {same}, appended caches bit-equal {caches}")
            if not (same and caches):
                raise AssertionError(f"{form}: row {row} {name} differs from the same row in its batch")
            n += 1
    for form, (quant, dtype, qmax) in K4_FORMS.items():
        layer, q, ck, cv = k4_inputs(B, quant, H=H, seed=32, dtype=dtype, qmax=qmax)
        whole = cross_attend(layer, q, ck, cv)
        for name, (r, h) in views.items():
            out = cross_attend(layer, q[r, h].contiguous(), _part(ck, r, h), _part(cv, r, h))
            torch.cuda.synchronize()
            same = torch.equal(out, whole[r, h])
            print(f"K4 {form} B={B} H={H} T=1500: row {row} {name} against the batch: output "
                  f"bit-equal {same}")
            if not same:
                raise AssertionError(f"K4 {form}: row {row} {name} differs from the same row in its batch")
            n += 1
    return n


# ---------------------------------------------------------------------------
# LN: the port's LayerNorm
# ---------------------------------------------------------------------------

# (rows, width): a decode step's rows at batch 1, 2 and 8 (B x 5 beams),
# an encode's at batch 8 (8 x 1500), and other widths of the configs (the
# micro config's 64, tiny's 384, medium's 1024).
LN_SHAPES = ((5, 1280), (10, 1280), (40, 1280), (12000, 1280), (1, 64), (300, 64), (40, 384),
             (7, 1024))


def ln_inputs(m, n, dtype, seed):
    """Rows (m, n) with an offset and a spread, a gain near 1 and a bias
    near 0, in ``dtype``, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = 3 * torch.randn((m, n), generator=g, device="cuda") + 0.5
    w = 1 + 0.1 * torch.randn(n, generator=g, device="cuda")
    b = 0.1 * torch.randn(n, generator=g, device="cuda")
    return x.to(dtype), w.to(dtype), b.to(dtype)


def ln_rows_differ(dtype, n=1280, seed=41):
    """The rows of a LayerNorm call on the card that differ in any bit
    from the same rows inside a larger call: {(m, within): rows} for the
    first m in (1, 10, 16, 40) rows alone against the same rows inside 10,
    16, 40 and 12000 (the first 10 rows each alone, too; and every other
    row of the first 40, a strided view)."""
    from faster_whisper_tpu_torch.models.model import layer_norm

    x, w, b = ln_inputs(12000, n, dtype, seed)
    inside = {m: layer_norm(x[:m].contiguous(), w, b) for m in (10, 16, 40, 12000)}
    res = {}
    for m in (1, 10, 16, 40):
        part = layer_norm(x[:m].contiguous(), w, b)
        for within, whole in inside.items():
            if within >= m:
                res[(m, within)] = int((part != whole[:m]).any(-1).sum())
    alone = torch.cat([layer_norm(x[r : r + 1], w, b) for r in range(10)])
    for within, whole in inside.items():
        res[("each of 10 alone", within)] = int((alone != whole[:10]).any(-1).sum())
    res[("rows 0, 2, .., 38 strided", 12000)] = int(
        (layer_norm(x[:40:2], w, b) != inside[12000][:40:2]).any(-1).sum())
    torch.cuda.synchronize()
    return res


def check_layer_norm():
    """Phase 3: the LayerNorm kernel against its plain version at
    LN_SHAPES in bf16 (within BF16_REL_TOL of the output scale) and
    float32 (LN_F32_REL_TOL), a second call equal to the first, a (B, 5,
    d) view equal to its rows; then a row's bits alone and inside 10, 16,
    40 and 12000 rows (``ln_rows_differ``), which must all be equal.
    Returns {"LN": max abs error over both dtypes, ...}."""
    from faster_whisper_tpu_torch.models.model import layer_norm
    from faster_whisper_tpu_torch.ops.layer_norm import layer_norm_plain

    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        rel = BF16_REL_TOL if dtype == torch.bfloat16 else LN_F32_REL_TOL
        for m, n in LN_SHAPES:
            x, w, b = ln_inputs(m, n, dtype, seed=m + n)
            ref = layer_norm_plain(x, w, b)
            out, again = layer_norm(x, w, b), layer_norm(x, w, b)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = rel * ref.float().abs().max().item()
            bits = int((out != ref).sum())
            same = torch.equal(out, again)
            view = torch.equal(layer_norm(x.view(m // 5, 5, n), w, b).view(m, n), out) if m % 5 == 0 else True
            print(f"LN {dtype_name(dtype)} ({m}, {n}): max|err| {err:.3e} (tolerance {tol:.3e}); "
                  f"{bits} of {out.numel()} values differ in any bit from the plain version's; a second "
                  f"call equal: {same}; as (B, 5, {n}): {view}")
            if not err <= tol or not same or not view:
                raise AssertionError(f"LN ({dtype_name(dtype)}) disagrees with its plain version at ({m}, {n})")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        differ = ln_rows_differ(dtype)
        print(f"LN {dtype_name(dtype)} width 1280: rows that differ between a call of m rows and the same "
              f"rows inside a larger call: " + ", ".join(f"{m} in {w}: {d}" for (m, w), d in differ.items()))
        if any(differ.values()):
            raise AssertionError(f"LN ({dtype_name(dtype)}): a row's bits follow the row count: {differ}")
    return {"LN": max(worst.values()), "LN bf16": worst[torch.bfloat16], "LN f32": worst[torch.float32]}


def time_layer_norm(m, n=1280, dtype=torch.bfloat16):
    """The LayerNorm kernel at (m, n), its plain version and
    ``F.layer_norm`` on the same rows; bound: the rows read and written
    once and g and b read once, beside ~8 float32 operations per element."""
    from faster_whisper_tpu_torch.models.model import layer_norm
    from faster_whisper_tpu_torch.ops.layer_norm import layer_norm_plain

    x, w, b = ln_inputs(m, n, dtype, seed=5)
    t = _timed(lambda: layer_norm(x, w, b), lambda: layer_norm_plain(x, w, b),
               lambda: torch.nn.functional.layer_norm(x, (n,), w, b, 1e-5))
    act = torch.finfo(dtype).bits // 8
    t["bound_ms"], t["bound_by"] = bound(2 * m * n * act + 2 * n * act, 8 * m * n, F32_FLOPS)
    t["shape"] = f"({m}, {n}) {dtype_name(dtype)}, one CTA of {-(-n // 8 // 32)} warps per row"
    return t


def time_empty():
    """An empty kernel (``csrc/layer_norm.cu::fwt_empty``, one CTA of 32
    threads) timed as phase 4 times the kernels: the launch floor of a
    graph of 20 calls, of a call alone after the L2 flush, and of a call
    issued from the host through the same ctypes path."""
    from faster_whisper_tpu_torch.ops import _build

    fn = _build.load("layer_norm.cu").fwt_empty
    dev = torch.device("cuda", torch.cuda.current_device())
    call = lambda: _build.check(_build.launch(dev, fn), "empty kernel")  # noqa: E731
    return dict(ms=time_ms(call), cold_ms=cold_ms(call), call_ms=call_ms(call))


# ---------------------------------------------------------------------------
# W8A8: the int8 product of int8_dense
# ---------------------------------------------------------------------------

W8A8_REPLACES = "faster_whisper_tpu/ops/quant.py::int8_dense (XLA, no TPU kernel)"
# Rows: the sequential path's beams (5), a batch of 8 x 5 beams (40), the
# edges of the plans (1, 17), an encode window (1500) and a batch of 8
# windows (12000).  (K, N): every width of large-v3's products, the logits
# head padded to 51872 columns, a row-parallel shard of a 128-wide model
# (64, 128) and a ragged contraction tile (1040, 136).
W8A8_ROWS = (1, 5, 17, 40, 1500, 12000)
W8A8_WIDTHS = ((1280, 1280), (1280, 5120), (5120, 1280), (5120, 5120), (1280, 51872), (5120, 51872),
               (64, 128), (1040, 136))
# (x's dtype, the output's, the bias's or None, qmax of the codes): the
# bf16 model's products, its logits head (float32 scores, no bias), the
# int8_float32 model's, and int4's per-channel decoder codes (qmax 7).
W8A8_VARIANTS = (
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, 127),
    (torch.bfloat16, torch.float32, None, 127),
    (torch.float32, torch.float32, torch.float32, 127),
    (torch.bfloat16, torch.bfloat16, None, 7),
)
# The main path's products, timed in phase 4 as (m, k, n, weights a call):
# a decode step's at batch 8 x 5 beams (attention, mlp.w2, mlp.w1, the
# logits head, q, k and v in one call) and an encode's mlp.w1.
W8A8_TIMED = ((40, 1280, 1280, 1), (40, 5120, 1280, 1), (40, 1280, 5120, 1), (40, 1280, 51872, 1),
              (40, 1280, 1280, 3), (12000, 1280, 5120, 1))


def w8a8_inputs(m, k, n, x_dtype=torch.bfloat16, bias_dtype=torch.bfloat16, qmax=127, seed=0):
    """x (m, k) in ``x_dtype`` with row m // 2 all zeros (its scale takes the
    1e-10 floor) where m > 1; a (k, n) weight quantized on the card at
    ``qmax`` (``card_layout``); a bias (n,) in ``bias_dtype`` or None."""
    from faster_whisper_tpu_torch.ops.quant import quantize_weight

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda").to(x_dtype)
    if m > 1:
        x[m // 2] = 0
    w = quantize_weight(0.02 * torch.randn((k, n), generator=g, device="cuda"), qmax=qmax)
    b = None if bias_dtype is None else torch.randn((n,), generator=g, device="cuda").to(bias_dtype)
    return x, w, b


def w8a8_composition(x, w, b, out_dtype):
    """The card's product before the kernel: ``_quantize_rows``,
    ``torch._int_mm`` (through ``_int_mm``, its rows padded, on the codes'
    (in, out)-contiguous copy) and ``_rescale``."""
    from faster_whisper_tpu_torch.ops.quant import QuantizedLinear, _int8_product, _quantize_rows, _rescale

    xf = x.float()
    xq, sx = _quantize_rows(xf, xf.abs().amax(dim=-1, keepdim=True))
    wn = QuantizedLinear(w.q.contiguous(), w.s)
    return _rescale(_int8_product(xq, wn), sx, wn, b, out_dtype)


def check_w8a8(rows=W8A8_ROWS, widths=W8A8_WIDTHS, variants=W8A8_VARIANTS):
    """The W8A8 kernel (``int8_dense`` on the card, ``csrc/w8a8.cu``)
    against the composition it replaced, ``torch.equal`` at every row
    count of ``rows``, width of ``widths`` and form of ``variants``, one
    launch counted per call (a decode launch up to 64 rows); and at each
    row count ``int8_dense_many`` on three weights (one quantization of x;
    one launch up to 64 rows, three above) against three calls; returns
    the number of products held."""
    from faster_whisper_tpu_torch.ops.quant import _plan, _slots, int8_dense, int8_dense_many

    slots = _slots(torch.device("cuda", torch.cuda.current_device()))
    n_held, plans = 0, set()
    for m in rows:
        for k, n in widths:
            for i, (x_dtype, out_dtype, bias_dtype, qmax) in enumerate(variants):
                x, w, b = w8a8_inputs(m, k, n, x_dtype, bias_dtype, qmax, seed=m + k + n + i)
                before = (int8_dense.launches, int8_dense.decode_launches)
                got = int8_dense(x, w, b, out_dtype=out_dtype)
                want = w8a8_composition(x, w, b, out_dtype)
                torch.cuda.synchronize()
                what = (f"W8A8 {m} x {k} @ {k} x {n}, x {dtype_name(x_dtype)}, out {dtype_name(out_dtype)}, "
                        f"bias {'none' if b is None else dtype_name(bias_dtype)}, qmax {qmax}")
                plan = _plan(m, k, (n,), slots)
                counted = (int8_dense.launches - before[0], int8_dense.decode_launches - before[1])
                if counted != (1, int(plan.decode)):
                    raise AssertionError(f"{what}: (launches, decode launches) {counted} counted, not "
                                         f"(1, {int(plan.decode)})")
                if got.dtype != out_dtype or not torch.equal(got, want):
                    differ = int((got != want).sum()) if got.shape == want.shape else -1
                    raise AssertionError(f"{what}: {differ} of {want.numel()} values differ from the composition")
                plans.add(tuple(plan))
                n_held += 1
                del x, w, b, got, want
        # one quantization of x for three weights (q, k, v), as the model's
        # int8_dense_many runs it, equal to three calls
        k, n = widths[0]
        x, w, b = w8a8_inputs(m, k, n, seed=m + 7)
        ws = [w, w8a8_inputs(1, k, n, seed=m + 8)[1], w8a8_inputs(1, k, n, seed=m + 9)[1]]
        before = int8_dense.launches
        many = int8_dense_many(x, ws, (b, None, b))
        launches = 1 if _plan(m, k, (n,) * 3, slots).decode else 3
        if int8_dense.launches != before + launches or not all(
                torch.equal(y, int8_dense(x, wi, bi)) for y, wi, bi in zip(many, ws, (b, None, b))):
            raise AssertionError(f"W8A8 {m} x {k}: one quantization for three weights differs from three calls "
                                 f"or took {int8_dense.launches - before} launches, not {launches}")
        n_held += 3
    torch.cuda.empty_cache()
    print(f"W8A8: {n_held} products bit-equal to the composition (_quantize_rows, torch._int_mm, _rescale) "
          f"over {len(plans)} plans (decode, bn, cluster, clusters): " + ", ".join(str(p) for p in sorted(plans)))
    return n_held


def time_w8a8(m, k, n, weights=1):
    """The W8A8 kernel on a bf16 x (m, k) and ``weights`` (k, n) weights in
    one ``int8_dense_many`` call (the self-attention's q, k and v: three),
    each with a bf16 bias (float32 scores and no bias for the logits
    head's n > 5120), the composition it replaced as both the plain version
    and the library call; bound: the weights' codes, x, the outputs and the
    scales moved once, beside 2 m k n int8 operations a weight."""
    from faster_whisper_tpu_torch.ops.quant import _plan, _slots, int8_dense_many

    head = n > 5120
    out_dtype = torch.float32 if head else torch.bfloat16
    x, w, b = w8a8_inputs(m, k, n, bias_dtype=None if head else torch.bfloat16, seed=7)
    ws, bs = [w] * weights, [b] * weights
    t = _timed(lambda: int8_dense_many(x, ws, bs, out_dtype=out_dtype),
               lambda: [w8a8_composition(x, w, b, out_dtype) for _ in ws],
               lambda: [w8a8_composition(x, w, b, out_dtype) for _ in ws])
    nbytes = weights * (k * n + m * n * (4 if head else 2) + 4 * n + (0 if head else 2 * n)) + 2 * m * k
    t["bound_ms"], t["bound_by"] = bound(nbytes, 2 * m * k * n * weights, INT8_TENSOR_OPS)
    plan = _plan(m, k, (n,) * weights, _slots(x.device))
    t["shape"] = (f"{m} x {k} @ {'%d x ' % weights if weights > 1 else ''}{k} x {n}, {dtype_name(out_dtype)} "
                  f"out, plan (decode, bn, cluster, clusters) {tuple(plan)}")
    return t


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


def check_flash_attention(batches=(1, 8), Ss=(1500,), dtype=torch.bfloat16, H=20):
    """K3 in ``dtype`` with ``H`` heads against its plain version (``mha``);
    returns the max abs error."""
    from faster_whisper_tpu_torch.ops.attention import mha, mha_flash

    worst = 0.0
    for B in batches:
        for S in Ss:
            q, k, v = k3_inputs(B, S, H=H, seed=B + S, dtype=dtype)
            ref = mha(q, k, v)
            out = mha_flash(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = tolerance(dtype) * ref.float().abs().max().item()
            print(f"K3 {dtype_name(dtype)} ({B},{S},{H},64): max|err| {err:.3e} (tolerance {tol:.3e})")
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

    x = (k2_inputs if quant else k1_inputs)(B, pos, H=H, divergent=True, dtype=dtype)
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
    chunk, n_chunks = _split_plan(K, 448, D if quant else act * D)
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
    chunk, n_chunks = _split_plan(T)
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


def old_k1_chunk(B, H, K, ctx, row_bytes, n_sm):
    """The column chunk that K1/K2's plan chose before it was fixed: aimed
    at two blocks per SM from B * H and the SM count (kept here only to
    time the fixed plan against it)."""
    want = -(-2 * n_sm // (B * H))  # chunks per (b, h)
    chunk = -(-ctx // want)
    chunk = -(-chunk // 8) * 8
    fit = max(8, 64 * 1024 // (2 * K * (row_bytes + 16)) // 8 * 8)
    return min(chunk, 64, fit)


def old_k4_chunk(B, H, T, n_sm):
    """K4's chunk before its plan was fixed: three blocks per SM from B * H."""
    want = -(-3 * n_sm // (B * H))  # chunks per (b, h)
    chunk = -(-T // want)
    return min(128, -(-chunk // 16) * 16)


PLAN_SHAPES = ((1, 20), (8, 20), (8, 10))  # (B, H): the main path's, and a tensor_parallel=2 shard's
K1_SWEEP = (16, 24, 32, 40, 48, 64)
K4_SWEEP = (48, 64, 80, 96, 112, 128)


def time_plans(card):
    """Phase 4: every form of K1/K2 (K=5, ctx=448, pos=447, divergent
    beams) and of K4 (K=5, T=1500) at each (B, H) of PLAN_SHAPES, with the
    fixed chunk of their plans against the chunk that the earlier plan
    chose from B * H and the SM count, timed warm in turns (earlier, fixed,
    fixed, earlier) through the launchers (``_launch``, uncounted); then
    at B=8, H=20 the bf16 and int8 forms over a sweep of chunk widths.
    Prints each pair and the fixed plan's time over the earlier one's.
    Returns {(form, B, H): (earlier ms, fixed ms)}."""
    from faster_whisper_tpu_torch.ops import beam_attention as ba
    from faster_whisper_tpu_torch.ops import cross_attention as ca

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}

    def turns(label, B, H, old, new, blocks, call):
        if old == new:
            t = time_ms(call(new))
            res[(label, B, H)] = (t, t)
            print(f"plan {label} B={B} H={H}: the earlier plan's chunk is the fixed one, {new} columns "
                  f"({blocks(new)} blocks), {t:.4f} ms warm on {card}")
            return
        ms = {old: [], new: []}
        for chunk in (old, new, new, old):
            ms[chunk].append(time_ms(call(chunk)))
        t_old, t_new = (sum(ms[c]) / 2 for c in (old, new))
        res[(label, B, H)] = (t_old, t_new)
        print(f"plan {label} B={B} H={H}: earlier plan {old} columns ({blocks(old)} blocks) "
              f"{'/'.join(f'{t:.4f}' for t in ms[old])} ms warm, fixed {new} columns ({blocks(new)} "
              f"blocks) {'/'.join(f'{t:.4f}' for t in ms[new])} ms: fixed / earlier {t_new / t_old:.3f}, "
              f"within 10%: {t_new <= 1.10 * t_old} on {card}")

    k1_calls = {}
    for label, (quant, dtype) in K1_FORMS.items():
        row_bytes = 64 * (1 if quant else torch.finfo(dtype).bits // 8)
        new, _ = ba._split_plan(5, 448, row_bytes)
        for B, H in PLAN_SHAPES:
            x = (k2_inputs if quant else k1_inputs)(B, 447, H=H, divergent=True, dtype=dtype)
            caches = (x["self_k"], x["self_v"])  # rewritten in place with the same column

            def call(chunk, x=x, caches=caches):
                return lambda: ba._launch(x["layer"], x["pos_row"], x["q"], x["k_new"], x["v_new"],
                                          *caches, x["anc"], chunk)

            k1_calls[(label, B, H)] = call
            turns(label, B, H, old_k1_chunk(B, H, 5, 448, row_bytes, n_sm), new,
                  lambda c, B=B, H=H: -(-448 // c) * B * H, call)
    k4_calls = {}
    for form in ("bf16", "int8", "f32", "int8 f32"):
        quant, dtype, _ = K4_FORMS[form]
        new, _ = ca._split_plan(1500)
        for B, H in PLAN_SHAPES:
            layer, q, ck, cv = k4_inputs(B, quant, H=H, dtype=dtype)

            def call(chunk, layer=layer, q=q, ck=ck, cv=cv):
                return lambda: ca._launch(layer, q, ck, cv, chunk)

            k4_calls[(f"K4 {form}", B, H)] = call
            turns(f"K4 {form}", B, H, old_k4_chunk(B, H, 1500, n_sm), new,
                  lambda c, B=B, H=H: -(-1500 // c) * B * H, call)
    for label, widths, calls in (("K1", K1_SWEEP, k1_calls), ("K2", K1_SWEEP, k1_calls),
                                 ("K4 bf16", K4_SWEEP, k4_calls), ("K4 int8", K4_SWEEP, k4_calls)):
        fit = 40 if label == "K1" else 128  # K1 bf16's rows of 128 bytes fit 40 columns at K=5
        times = [(w, time_ms(calls[(label, 8, 20)](w))) for w in widths if w <= fit]
        print(f"plan sweep {label} B=8 H=20: " + ", ".join(f"{w} columns {t:.4f} ms" for w, t in times)
              + f" warm on {card}")
    return res


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
    from faster_whisper_tpu_torch.models.engine import _teacher_forced
    from faster_whisper_tpu_torch.models.model import decoder_prefill, encode
    from faster_whisper_tpu_torch.ops.attention import mha_flash
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append
    from faster_whisper_tpu_torch.ops.cross_attention import cross_attend
    from faster_whisper_tpu_torch.ops.layer_norm import layer_norm
    from faster_whisper_tpu_torch.ops.probes import attend_only, scores_batched, scores_perhead
    from faster_whisper_tpu_torch.ops.quant import int8_dense

    # name -> (function, attribute); every name but those of FORWARDS is a
    # kernel's launch count (w8a8: one per product, its two launches)
    return dict(
        w8a8=(int8_dense, "launches"),
        p1=(attend_only, "launches"), p2b=(scores_batched, "launches"),
        p2h=(scores_perhead, "launches"), ln=(layer_norm, "launches"),
        k1=(beam_attend_append, "launches"), k1_f32=(beam_attend_append, "launches_f32"),
        k2=(beam_attend_append, "launches_int8"), k2_f32=(beam_attend_append, "launches_int8_f32"),
        k3=(mha_flash, "launches"), k3_f32=(mha_flash, "launches_f32"),
        k4_bf16=(cross_attend, "launches"), k4_f32=(cross_attend, "launches_f32"),
        k4_int8=(cross_attend, "launches_int8"), k4_int8_f32=(cross_attend, "launches_int8_f32"),
        steps=(_gen_decoder_step, "calls"), encodes=(encode, "calls"),
        prefills=(decoder_prefill, "calls"), aligns=(_teacher_forced, "calls"),
    )


# The counts of forward passes (decode steps, encodes, prefills, alignment
# passes) among ``_counted``'s.
FORWARDS = ("steps", "encodes", "prefills", "aligns")


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


def ln_layout(model):
    """(devices, logit shards) of a model's first replica: the distinct
    devices of its model-axis group, each of which runs a layer's
    LayerNorms once for its shards (``ShardGroup.replicated``), and the
    shards that run the final LayerNorm before the logits (every shard of
    a vocab-sharded int8 head, else the lead; ``models/model.py::
    _logits``)."""
    params = model.model.replicas[0][1]
    group = getattr(params, "group", None)
    if group is None:
        return 1, 1
    dec = params.trees[0]["decoder"]
    vocab, lw = dec["token_embed"].shape[0], dec.get("logits_w")
    width = vocab // group.size if lw is not None and lw.q.shape[-1] < vocab else vocab
    return len(set(group.devices)), vocab // width


def expected_layer_norms(counts, cfg, layout=(1, 1)):
    """The LayerNorm launches of a run: per encode 2 x n_audio_layer (once
    per distinct device of the group) and the final one; per decoder
    forward (decode step, prefill, alignment pass) 3 x n_text_layer per
    distinct device and the final one, on every logit shard for a step or
    a prefill."""
    devices, logit_shards = layout
    forwards = counts["steps"] + counts["prefills"] + counts["aligns"]
    return (counts["encodes"] * (2 * cfg.n_audio_layer * devices + 1)
            + forwards * 3 * cfg.n_text_layer * devices
            + (counts["steps"] + counts["prefills"]) * logit_shards + counts["aligns"])


def check_counts(counts, per_step, per_encode, cfg, shards=1, layout=(1, 1)):
    """Every kernel form in ``per_step`` launched n_text_layer times per
    decode step, ``per_encode`` n_audio_layer times per encode, on each of
    ``shards`` shards of a model-axis group, every other form never; the
    LayerNorm kernel as ``expected_layer_norms`` counts for the group's
    ``layout`` (``ln_layout``); the W8A8 kernel in every run whose decode
    runs K2 (the int8 and int4 compute types: their encoders' weights at
    least have per-channel scales), in no other."""
    if counts["steps"] == 0 or counts["encodes"] == 0:
        raise AssertionError(f"the run decoded or encoded nothing: {counts}")
    want = expected_layer_norms(counts, cfg, layout)
    if counts["ln"] != want or not want:
        raise AssertionError(f"layer_norm launches {counts['ln']} != {want} from the run's forwards "
                             f"{ {k: counts[k] for k in FORWARDS} } at {layout} (devices, logit shards)")
    int8 = any(form in per_step for form in ("k2", "k2_f32"))
    if (counts["w8a8"] > 0) != int8:
        raise AssertionError(f"W8A8 launches {counts['w8a8']} in a run {'with' if int8 else 'without'} "
                             f"int8 weights")
    for name, n in counts.items():
        if name in FORWARDS or name in ("ln", "w8a8"):
            continue
        if name in per_step:
            want = shards * cfg.n_text_layer * counts["steps"]
            what = f"{shards} x {cfg.n_text_layer} x {counts['steps']} decode steps"
        elif name == per_encode:
            want = shards * cfg.n_audio_layer * counts["encodes"]
            what = f"{shards} x {cfg.n_audio_layer} x {counts['encodes']} encodes"
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
        ("b: 20 s, en, beam 5, without timestamps",
         short_clip, dict(language="en", beam_size=5, without_timestamps=True)),
        ("c: 20 s, beam 1, temperature 0", short_clip, greedy),
    ], cfg.n_vocab)
    print(f"main path counts, bf16 (a-c): {bf16}")
    check_counts(bf16, per_step=("k1", "k4_bf16"), per_encode="k3", cfg=cfg)
    runs = {"bf16": bf16}
    runs["h"], h_segments, h_seconds = run_batched(model, "h: bf16", speech, cfg)
    check_counts(runs["h"], per_step=("k1", "k4_bf16"), per_encode="k3", cfg=cfg)

    later = dict(params=params, cfg=cfg, tok=tok, h_segments=h_segments, h_seconds=h_seconds)
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
        # in groups the decoder's products keep the composition: only the
        # encoder's 6 a layer reach the W8A8 kernel
        w8a8 = runs["i"]["w8a8"] if group is None else 6 * cfg.n_audio_layer * runs[key]["encodes"]
        same = {k: v for k, v in runs[key].items() if k != "w8a8"} == {
            k: v for k, v in runs["i"].items() if k != "w8a8"}
        print(f"request {key} against request i: equal launch counts: {same}; W8A8 {runs[key]['w8a8']} "
              f"(i's {runs['i']['w8a8']}, expected {w8a8})")
        if not same or runs[key]["w8a8"] != w8a8:
            raise AssertionError(f"request {key}'s launch counts {runs[key]} differ from i's {runs['i']}")
    del model
    torch.cuda.empty_cache()
    return runs, later


def _encoder_stages(params, cfg, mel):
    """The encoder of ``models/model.py::encode`` stage by stage: yields
    (name, states) after the conv stem, after each layer and after the
    final layer norm (the encoder's output)."""
    from faster_whisper_tpu_torch.models import model as M

    trees, group = M.shards(params)
    xs = group.replicated(lambda t, m: M._stem(t["encoder"], m), trees, group.broadcast(mel))
    yield "conv stem", xs[0]
    for i in range(cfg.n_audio_layer):
        xs = M._encoder_layer(group, xs, M._layers(trees, "encoder", i), cfg.n_audio_head // group.size)
        yield f"encoder layer {i}", xs[0]
    enc = trees[0]["encoder"]
    yield "encoder output", M.layer_norm(xs[0], enc["ln_post_g"], enc["ln_post_b"])


# The functions of a decode step (``generation/generate.py::
# _gen_decoder_step``) whose outputs DecodeProbe records, op by op: the
# LayerNorms, the projections, K1/K2, K4, the output projections, the
# MLP, the residual adds and the logits.
STEP_OPS = ("_norm", "_dense_many", "_dense", "beam_attend_append", "cross_attend", "_out", "_mlp",
            "_residual", "_logits")


class DecodeProbe:
    """Within the block: the rows ``rows`` of the prefill's logits, of the
    cross K/V codes and scales after quantization and of every decode
    step's logits, and of the output of every call of STEP_OPS within each
    step ((name, rows) in call order), recorded from
    ``generation/generate.py``; under ``EagerSteps``, so that every step
    runs the wrapped functions."""

    def __init__(self, rows):
        self.rows, self.stages = rows, {}

    def __enter__(self):
        from faster_whisper_tpu_torch.generation import generate as G

        self._saved = prefill, expand, step = G._prefill, G._expand_caches, G._gen_decoder_step
        self._ops = {name: getattr(G, name) for name in STEP_OPS}
        rows, stages = self.rows, self.stages
        steps = stages.setdefault("steps", [])
        ops = stages.setdefault("ops", [])
        inside = [False]  # within a decode step

        def spy_op(name, fn):
            def op(*args, **kwargs):
                out = fn(*args, **kwargs)
                first = out[0] if isinstance(out, (list, tuple)) else out  # a shard's, or K1/K2's attn
                if inside[0]:
                    ops[-1].append((name, first[rows].clone()))
                return out
            return op

        for name, fn in self._ops.items():
            setattr(G, name, spy_op(name, fn))

        def spy_prefill(*args, **kwargs):
            out = prefill(*args, **kwargs)
            stages["prefill logits"] = out[0][rows].clone()
            return out

        def spy_expand(*args, **kwargs):
            out = expand(*args, **kwargs)
            for name, c in (("cross K", out[2]), ("cross V", out[3])):
                stages[f"{name} codes and scales"] = (c.q[:, rows].clone(), c.s[:, rows].clone())
            return out

        def spy_step(*args, **kwargs):
            ops.append([])
            inside[0] = True
            try:
                out = step(*args, **kwargs)
            finally:
                inside[0] = False
            steps.append(out[0][rows].clone())
            return out

        spy_step.calls = 0  # the step counts its calls on whatever its module's name holds
        self._spy = spy_step
        G._prefill, G._expand_caches, G._gen_decoder_step = spy_prefill, spy_expand, spy_step
        return self

    def __exit__(self, *exc):
        from faster_whisper_tpu_torch.generation import generate as G

        G._prefill, G._expand_caches, G._gen_decoder_step = self._saved
        for name, fn in self._ops.items():
            setattr(G, name, fn)
        G._gen_decoder_step.calls += self._spy.calls
        return False


def first_differing_op(a, b):
    """The first op of two DecodeProbe records (``stages["ops"]``) whose
    outputs differ: (step, call index, name, layer, max|diff|), or None.
    The layer is counted from the step's LayerNorms (three per layer)."""
    for step, (xs, ys) in enumerate(zip(a, b)):
        norms = 0
        for i, ((name, x), (_, y)) in enumerate(zip(xs, ys)):
            if not torch.equal(x, y):
                return step, i, name, norms // 3, (x.float() - y.float()).abs().max().item()
            norms += name == "_norm"
    return None


def trace_batch_stages(later, speech, card):
    """Phase 7b: request i's int8 model through the pipeline (batches of 8
    and 2 chunks), the chunks and prompts recorded; then chunks 8 and 9,
    the pipeline's batch of 2, again in a batch of 8 (chunks 2-9), stage
    by stage against the batch of 2: the log-mel, the conv stem, each
    encoder layer, the encoder's output, the cross K/V codes and scales,
    the prefill's logits and each decode step's logits.  Prints the first
    stage at which they differ, or "none", and returns the first from the
    conv stem on (the log-mel is computed once per request, over all of its
    chunks, and no batch reaches it).  Each decode step op by op: the
    first op whose output differs (``first_differing_op``), which may not
    be a LayerNorm.  The decoder's LayerNorm kernel on rows alone against
    the same rows inside 10, 16, 40 and 12000, in bf16 and float32: 0 rows
    may differ.  Then the two chunks decoded at batch
    8 and at batch 2 from the same encoder states (the batch of 8's): their
    tokens must be equal."""
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline, WhisperModel

    cfg = later["cfg"]
    model = WhisperModel.from_parts(later["params"], cfg, later["tok"], compute_type="int8")
    eng, fe = model.model, model.feature_extractor
    params = eng.replicas[0][1]
    features, dispatch = fe.chunk_features, eng.generate_dispatch
    rec = {"dispatch": []}

    def spy_features(audio, starts, lengths):
        rec["mel"] = (audio, list(starts), list(lengths))
        rec["features"] = out = features(audio, starts, lengths)
        return out

    def spy_dispatch(encoder_output, prompts, **kwargs):
        rec["dispatch"].append((int(encoder_output.shape[0]), [list(p) for p in prompts], kwargs))
        return dispatch(encoder_output, prompts, **kwargs)

    fe.chunk_features, eng.generate_dispatch = spy_features, spy_dispatch
    try:
        list(BatchedInferencePipeline(model).transcribe(
            speech, language="en", beam_size=5, batch_size=8, max_new_tokens=128)[0])
    finally:
        del fe.chunk_features, eng.generate_dispatch
    sizes = [d[0] for d in rec["dispatch"]]
    if sizes != [8, 2]:
        raise AssertionError(f"request i's pipeline ran batches of {sizes}, the trace expects [8, 2]")
    audio, starts, lengths = rec["mel"]
    feats = rec["features"]
    big, small = slice(2, 10), slice(8, 10)  # chunks 8-9: rows 6-7 of the one, 0-1 of the other
    in_big, in_small = slice(6, 8), slice(0, 2)
    stages = []

    def compare(name, a, b):
        same = torch.equal(a, b)
        stages.append((name, same, 0.0 if same else (a.float() - b.float()).abs().max().item()))

    with torch.no_grad():
        m8 = features(audio, starts[big], lengths[big])
        m2 = features(audio, starts[small], lengths[small])
        compare("log-mel", m8[in_big], m2[in_small])
        kept = {name: x[in_small].clone() for name, x in _encoder_stages(params, cfg, feats[small].float())}
        for name, x in _encoder_stages(params, cfg, feats[big].float()):
            compare(name, x[in_big], kept[name])
            last = x
        enc8, enc2 = eng.encode(feats[big]), eng.encode(feats[small])
        if not torch.equal(last, enc8):
            raise AssertionError("the encoder traced stage by stage differs from the engine's encode")
        caught = {}
        for name, enc, rows, (_, prompts, kwargs) in (("small", enc2, in_small, rec["dispatch"][1]),
                                                       ("big", enc8, in_big, rec["dispatch"][0])):
            with EagerSteps(eng), DecodeProbe(rows) as probe:
                eng.generate_collect(eng.generate_dispatch(enc, prompts, **kwargs))
            caught[name] = probe.stages
        a, b = caught["big"], caught["small"]
        for name in ("cross K codes and scales", "cross V codes and scales"):
            stages.append((name, all(torch.equal(x, y) for x, y in zip(a[name], b[name])), None))
        compare("prefill logits", a["prefill logits"], b["prefill logits"])
        for i, (x, y) in enumerate(zip(a["steps"], b["steps"])):
            compare(f"decode step {i} logits", x, y)
        # the same encoder states at batch 8 and at batch 2
        _, prompts, kwargs = rec["dispatch"][0]
        at8 = eng.generate_collect(eng.generate_dispatch(enc8, prompts, **kwargs))[6:8]
        _, prompts, kwargs = rec["dispatch"][1]
        at2 = eng.generate_collect(eng.generate_dispatch(enc8[in_big].contiguous(), prompts, **kwargs))
    def first_differing(rest):
        first = next((s for s in rest if not s[1]), None)
        if first is None:
            return "none", ""
        return first[0], "" if first[2] is None else f" (max|diff| {first[2]:.3e})"

    where, diff = first_differing(stages)
    # The pipeline and the batcher compute a request's log-mel once over
    # all of its chunks, never per batch: what a batch bucket can change
    # starts at the conv stem.
    batched, batched_diff = first_differing(stages[1:])
    print(f"batch stages, request i's int8 model, chunks 8-9 in a batch of 8 (chunks 2-9) against "
          f"the pipeline's batch of 2: {sum(s[1] for s in stages)} of {len(stages)} stages bit-equal "
          f"({len(a['steps'])} and {len(b['steps'])} decode steps); the first stage that differs: "
          f"{where}{diff}; from the conv stem on (the stages a batch bucket reaches; the log-mel is "
          f"computed per request): {batched}{batched_diff} on {card}")
    # A decode step that differs, op by op: the first op whose output
    # differs between the two batches.
    step_differs = any(not same for name, same, _ in stages if name.startswith("decode step"))
    op = first_differing_op(a["ops"], b["ops"])
    if op is None:
        print(f"batch stages, decode steps op by op ({', '.join(STEP_OPS)}): every op's output bit-equal "
              f"between the batch of 8 and the batch of 2 on {card}")
    else:
        print(f"batch stages, decode steps op by op: the first op that differs is decode step {op[0]}'s "
              f"call {op[1]}, {op[2]} (layer {op[3]}), max|diff| {op[4]:.3e} on {card}")
    if op is not None and op[2] == "_norm":
        raise AssertionError(f"the LayerNorm kernel's rows differ between batch buckets: {op}")
    if step_differs and op is None:
        raise AssertionError("a decode step's logits differ but none of its ops' outputs does")
    # The decoder's LayerNorm on a step's rows (B x 5 beams): rows alone
    # against the same rows inside 10, 16, 40 and an encode's 12000.
    for dtype in (torch.bfloat16, torch.float32):
        differ = ln_rows_differ(dtype, n=cfg.n_text_state, seed=7)
        print(f"the decoder's layer_norm ({dtype_name(dtype)}, width {cfg.n_text_state}): rows that differ "
              f"between a call of m rows and the same rows inside a larger call: "
              + ", ".join(f"{m} in {w}: {d}" for (m, w), d in differ.items()) + f" on {card}")
        if any(differ.values()):
            raise AssertionError(f"the LayerNorm kernel's rows follow the row count: {differ}")
    toks8 = [list(r.sequences_ids[0]) for r in at8]
    toks2 = [list(r.sequences_ids[0]) for r in at2]
    print(f"int8 tokens of chunks 8-9 decoded at batch 8 and at batch 2 from the same encoder states: "
          f"equal {toks8 == toks2} ({[len(t) for t in toks8]} and {[len(t) for t in toks2]} tokens) on {card}")
    if toks8 != toks2:
        raise AssertionError("a chunk's int8 tokens differ at batch 8 and at batch 2 from the same "
                             "encoder states")
    del model
    torch.cuda.empty_cache()
    return batched


def run_batched(model, name, audio, cfg, stats=None, **kwargs):
    """One ``BatchedInferencePipeline.transcribe`` with the VAD on, beam 5,
    batch 8 (and ``kwargs``), checked; returns the launch counts of the
    run, set to 0 just before it, its segments and its seconds.  The
    chunks of each batch, its seconds (encode and decode) and the rows it
    was encoded with (its pow2 bucket) are read off the pipeline's
    dispatch and the model's encode; ``stats``, a dict, gets the batches'
    seconds."""
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
    if stats is not None:
        stats["batch_seconds"] = list(batch_seconds)
    check_segments(segments, info, duration, cfg.n_vocab)
    # on a mesh of n replicas a batch of rows that n divides encodes once per replica
    n = len(model.model.replicas)
    if sum(chunks) < 1 or len(rows) != len(chunks) or counts["encodes"] != sum(
        n if r % n == 0 else 1 for r in rows
    ):
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


def check_small_pipeline_against_cpu(jfk, word_timestamps=False, tensor_parallel=1):
    """A small float32 model through ``BatchedInferencePipeline`` on the
    card and on the CPU: on ``clip_timestamps`` (three clips at batch 2: a
    full batch and a tail padded with a dummy row), and with the defaults
    (VAD on, language detection, beam 5, batch 8) on ``docker/jfk.flac``,
    which the card's run decodes from the path and the CPU's gets decoded.
    Equal tokens and times.  With ``word_timestamps`` (phase 10) the
    specials of the synthetic vocabulary are suppressed, so that the
    chunks decode text, and the words must be equal too
    (``check_words_equal``).  With ``tensor_parallel=N`` both models are
    one group of N shards: on ``device_index=[0] * N`` on the card, and on N
    host devices."""
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline, WhisperModel

    cfg, cpu, tok = small_model_parts()
    mesh = lambda dev: (dict(device_index=[0] * tensor_parallel if dev == "cuda"  # noqa: E731
                             else list(range(tensor_parallel)), tensor_parallel=tensor_parallel)
                        if tensor_parallel > 1 else {})
    models = {
        dev: WhisperModel.from_parts(cpu, cfg, tok, compute_type="float32", device=dev, **mesh(dev))
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
              f"{', word timestamps' if word_timestamps else ''}"
              f"{f', tensor_parallel={tensor_parallel}' if tensor_parallel > 1 else ''}: "
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
    # j's rungs all fail on random weights and a sampled one is kept: both
    # models draw from one fixed seed, so that only their weights differ
    # (with fresh entropy one model's output changes from run to run:
    # tools/sampling_repeats.py)
    model.model.rng_seed = 0

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
    ref.model.rng_seed = 0
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
    just before and just after it, which must be equal but for the pass's
    own count, its 3 x n_text_layer + 1 LayerNorms and its int8 products
    (the pass launches no kernel of K1-K4 and runs no encode); each
    window's text tokens and
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
            after = read_counts()
            delta = {k: after[k] - before[k] for k in after}
            if any(delta[k] for k in after if k not in ("ln", "aligns", "w8a8")) or delta["aligns"] != 1:
                raise AssertionError(f"the alignment pass launched a kernel or an encode: {before} "
                                     f"-> {after}")
            want = 3 * model.model.config.n_text_layer * ln_layout(model)[0] + 1
            if delta["ln"] != want:
                raise AssertionError(f"the alignment pass launched layer_norm {delta['ln']} times, "
                                     f"not {want}")
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
    # the alignment passes add their own count, LayerNorms and W8A8
    # products, nothing else
    same = {k: v for k, v in counts["m"].items() if k not in ("ln", "aligns", "w8a8")} == {
        k: v for k, v in i_counts.items() if k not in ("ln", "aligns", "w8a8")}
    print(f"request m against request i: equal segment tokens and texts: {got == want}; equal "
          f"launch counts but the alignment passes' LayerNorms and products: {same}")
    if got != want:
        raise AssertionError("request m's segment tokens or texts differ from request i's")
    if not same:
        raise AssertionError(f"request m's launch counts {counts['m']} differ from i's {i_counts}")
    check_counts(counts["m"], per_step=("k2", "k4_int8"), per_encode="k3", cfg=cfg)
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
    n_other = sum(o[3] for o in other)
    print(f"scheduled chunks against the unscheduled pipeline's: {len(same_bucket)} in the same bucket, "
          f"equal tokens {sum(eq for _, eq in same_bucket)}; {len(other)} in another bucket, "
          f"{sum(o[3] == 0 for o in other)} of them with equal tokens, {n_other} int8 tokens differ "
          f"across buckets (row, scheduled bucket, unscheduled bucket, tokens that differ, first step "
          f"that differs): {other}; the first stage that differs between buckets (phase 7b): "
          f"{later['batch_stage']}")
    if not all(eq for _, eq in same_bucket):
        raise AssertionError("a scheduled chunk's tokens differ from the unscheduled pipeline's in the "
                             "same batch bucket")
    if later["batch_stage"] == "none" and n_other:
        raise AssertionError("a scheduled chunk's int8 tokens differ from the unscheduled pipeline's in "
                             "another batch bucket, though no stage of the pipeline differs between "
                             "buckets")
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
    if (any(delta[k] for k in DECODE_FORMS) or delta[k3] != n_layer or delta["encodes"] != 1
            or delta["ln"] != 2 * n_layer + 1):
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
    decode step records an event on the default stream after its launches
    (every step eager, ``EagerSteps``); and the sampling rungs' seeds follow the call order (the port draws
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
            def __init__(self, encode, window, devices=None):
                before = read_counts()
                super().__init__(encode, window, devices)
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

        def stepped(*args, **kwargs):
            out = step(*args, **kwargs)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            probe.steps.append(ev)
            return out

        stepped.calls = 0
        self._saved = (step, seeds)
        self._eager = EagerSteps(model.model).__enter__()
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
        self._eager.__exit__()
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
    if not (counts["k3_f32"] and counts["k1_f32"] and counts["k2"] and counts["k4_int8"]
            and counts["ln"]):
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


# ---------------------------------------------------------------------------
# Phase 13: the probes P1 and P2, the ctx ladder, the mesh's data axis
# ---------------------------------------------------------------------------


def probe_inputs(pos, divergent, seed=0):
    """The probe scripts' inputs at their shape (``ops/probes.py::
    PROBE_SHAPE``) on the card, every row at ``pos``; with ``divergent``
    each column's ancestry a permutation of the slots instead of the
    scripts' identity."""
    from faster_whisper_tpu_torch.ops.probes import PROBE_SHAPE, probe_inputs as make

    x = make(**PROBE_SHAPE, device="cuda", seed=seed, pos=pos)
    if divergent:
        b, k, ctx = x["anc"].shape
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        keys = torch.rand((b, ctx, k), generator=g, device="cuda")
        x["anc"] = keys.argsort(dim=-1).transpose(1, 2).to(torch.int32).contiguous()
    return x


def check_probes():
    """P1, P2b and P2h against their plain versions on the card at the
    probes' shape: P1 with every row at 120 (the scripts' position), 0
    and 191 (the last column), over the scripts' identity ancestry and a
    divergent one.  q's codes must be equal; P1's weight codes equal but
    where the float32 softmax sum, taken in another order, moves a weight
    across a rounding boundary (at most one unit, counted); P1's bf16
    output within the bf16 tolerance of phase 3; P2's float32 sums within
    P2_SUM_TOL of the sum of their terms' magnitudes, and P2b's bit for
    bit equal to ``scores_batched_exact``.  Returns the max abs
    errors and the count of weight codes one unit apart."""
    from faster_whisper_tpu_torch.ops import probes

    errs, moved = {"P1": 0.0, "P2b": 0.0, "P2h": 0.0}, 0
    layer = probes.PROBE_SHAPE["L"] - 1
    for pos, divergent in ((120, False), (120, True), (0, True), (191, False), (191, True)):
        x = probe_inputs(pos, divergent, seed=pos)
        args = (layer, x["pos"], x["q"], x["self_k"], x["self_v"], x["anc"])
        ref, rq, rp = probes.attend_only_plain(*args, codes=True)
        out, oq, op = probes.attend_only(*args, codes=True)
        out2 = probes.attend_only(*args)  # again: no state is left between calls
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_REL_TOL * ref.float().abs().max().item()
        diff = (op.int() - rp.int()).abs()
        n, worst = int((diff > 0).sum()), int(diff.max())
        print(f"P1 attend_only B=8 H=20 K=5 ctx=192 pos={pos} "
              f"{'divergent' if divergent else 'identity'} ancestry: max|err| {err:.3e} (tolerance "
              f"{tol:.3e}); q codes equal: {torch.equal(oq, rq)}; weight codes: {n} of {rp.numel()} "
              f"differ (max {worst}); a second call equal: {torch.equal(out, out2)}")
        if not err <= tol or not torch.equal(oq, rq) or worst > 1 or not torch.equal(out, out2):
            raise AssertionError(f"P1 disagrees with its plain version at pos={pos}, divergent={divergent}")
        errs["P1"], moved = max(errs["P1"], err), moved + n
    x = probe_inputs(120, False, seed=3)
    kq = x["self_k"].q
    for name, fn, plain, q, perhead in (
        ("P2b", probes.scores_batched, probes.scores_batched_plain, x["q"], False),
        ("P2h", probes.scores_perhead, probes.scores_perhead_plain, x["q_flat"], True),
    ):
        for layer in (0, probes.PROBE_SHAPE["L"] - 1):
            ref, rq = plain(layer, q, kq, codes=True)
            out, oq = fn(layer, q, kq, codes=True)
            out2 = fn(layer, q, kq)  # again: no state is left between calls
            torch.cuda.synchronize()
            mag = probes.score_magnitudes(layer, q, kq, perhead)
            err = (out - ref).abs()
            ok = bool((err <= P2_SUM_TOL * mag).all()) and torch.equal(out, out2)
            exact = "" if perhead else (
                f"; bit-equal to the exact int64 reference: "
                f"{torch.equal(out, probes.scores_batched_exact(layer, q, kq))}")
            print(f"{name} layer {layer} {tuple(q.shape)} -> {tuple(out.shape)}: max|err| "
                  f"{err.max().item():.3e}, max |err| / sum |terms| {(err / mag).max().item():.3e} "
                  f"(tolerance {P2_SUM_TOL:.0e}); q codes equal: {torch.equal(oq, rq)}; a second "
                  f"call equal: {torch.equal(out, out2)}{exact}")
            if not perhead and not torch.equal(out, probes.scores_batched_exact(layer, q, kq)):
                raise AssertionError(f"P2b differs from its exact int64 reference at layer {layer}")
            if not ok or not torch.equal(oq, rq):
                raise AssertionError(f"{name} disagrees with its plain version at layer {layer}")
            errs[name] = max(errs[name], err.max().item())
    return errs, moved


def time_probes():
    """P1, P2b and P2h at the probes' shape on the scripts' inputs (every
    row at 120, the identity ancestry), timed as phase 4 times the other
    kernels.  P1's bound counts the K and V rows that the visible columns
    need (codes and scales), the ancestry, q and the output; P2's the
    layer's K codes, q and the output; both beside their s8 products over
    the int8 tensor-core peak.  No one PyTorch call computes either.  K2
    (``beam_attend_append`` over the same int8 cache, appending at 120) is
    timed beside P1 as "K2 probe", with K2's bound."""
    from faster_whisper_tpu_torch.ops import probes
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append, beam_attend_append_ref

    dims = probes.PROBE_SHAPE
    B, H, K, ctx, D = dims["B"], dims["H"], dims["K"], dims["ctx"], dims["D"]
    pos = probes.PROBE_POS
    x = probe_inputs(pos, False)
    layer = dims["L"] - 1
    args = (layer, x["pos"], x["q"], x["self_k"], x["self_v"], x["anc"])
    times = {"P1": _timed(lambda: probes.attend_only(*args), lambda: probes.attend_only_plain(*args))}
    n = pos + 1
    seen = x["anc"][:, :, :n].sort(dim=1).values
    rows = B * n + int((seen[:, 1:] != seen[:, :-1]).sum())  # distinct (slot, column) per (b, h)
    nbytes = rows * H * (D + 2) * 2 + B * K * n * 4 + 2 * B * H * K * D * 2
    full = 2 * B * H * K * ctx * (D + 2) + B * K * ctx * 4 + 2 * B * H * K * D * 2
    times["P1"]["bound_ms"], times["P1"]["bound_by"] = bound(nbytes, 4 * B * H * K * n * D, INT8_TENSOR_OPS)
    times["P1"]["shape"] = (f"B={B} H={H} K={K} ctx={ctx} D={D} pos={pos} identity ancestry, "
                            f"{nbytes / 1e6:.1f} MB visible ({full / 1e6:.1f} MB the whole layer, "
                            f"{full / HBM_BYTES_PER_S * 1e3:.5f} ms)")
    k2_args = (layer, x["pos"], x["q"], x["k_new"], x["v_new"], x["self_k"], x["self_v"], x["anc"])
    times["K2 probe"] = t = _timed(lambda: beam_attend_append(*k2_args),
                                   lambda: beam_attend_append_ref(*k2_args))
    # K2's bytes, as time_beam_attention counts them: the visible rows
    # before pos, the ancestry, q, the new rows and the output, and the two
    # written columns
    before = x["anc"][:, :, :pos].sort(dim=1).values
    rows_k2 = B * pos + int((before[:, 1:] != before[:, :-1]).sum())
    k2_bytes = (rows_k2 * H * (D + 2) * 2 + B * K * n * 4 + 4 * B * H * K * D * 2
                + 2 * B * H * K * (D + 2))
    t["bound_ms"], t["bound_by"] = bound(k2_bytes, 4 * B * H * K * n * D, F32_FLOPS)
    t["shape"] = f"K2 at the probes' shape: B={B} H={H} K={K} ctx={ctx} D={D} pos={pos} identity ancestry"
    kq = x["self_k"].q
    p2_bytes = B * H * K * ctx * D + B * H * K * D * 2
    for name, fn, q, out_bytes in (
        ("P2b", probes.scores_batched, x["q"], B * H * K * 4),
        ("P2h", probes.scores_perhead, x["q_flat"], B * K * 4),
    ):
        plain = getattr(probes, fn.__name__ + "_plain")
        t = times[name] = _timed(lambda fn=fn, q=q: fn(layer, q, kq),
                                 lambda plain=plain, q=q: plain(layer, q, kq))
        t["bound_ms"], t["bound_by"] = bound(p2_bytes + out_bytes, 2 * B * H * K * K * ctx * D,
                                             INT8_TENSOR_OPS)
        t["shape"] = f"q {tuple(q.shape)}, kq layer of {tuple(kq.shape[1:])} int8"
    return times


def run_probe_sweeps(card):
    """The probe entry point's main path: ``ops.probes.run_sweeps`` at the
    scripts' shapes (32 layers x 64 steps, best of 3, then one step in a
    CUDA graph replayed), its launch counts set to 0 just before and read
    just after: P1, P2b and P2h and the "full" column's K2 each launched.
    Prints ms per 32-layer step.  Returns the counts."""
    from faster_whisper_tpu_torch.ops import probes

    reset_counts()
    res = probes.run_sweeps("cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    for name, (host, graph) in res.items():
        print(f"probe sweep {name}: {host:.4f} ms per 32-layer step issued from the host, "
              f"{graph:.4f} ms replayed from a CUDA graph (B=8 H=20 K=5 ctx=192, 64 steps) on {card}")
    print("probe sweep: 'full' is the port's K2 (append + attend, its products not on s8); the "
          f"TPU script's full column was an s8 kernel; launches {counts}")
    for a, b in (("attend-only", "full"), ("per-head dots", "batched H-dot")):
        print(f"probe sweep: {a} / {b} = {res[a][0] / res[b][0]:.3f} issued from the host, "
              f"{res[a][1] / res[b][1]:.3f} replayed from a CUDA graph")
    if not all(counts[k] for k in ("p1", "p2b", "p2h", "k2")):
        raise AssertionError(f"the probe sweeps did not launch every probe kernel: {counts}")
    return counts, res


class WidthProbe:
    """Within the block: each decode's ``ctx_cap`` (``beam_search``'s or
    ``sample``'s options) and the width of the tables it hands back, which
    are the ones it ran on, and the sampling rungs' seeds in call order (as
    ``SpeculationProbe``), so that two runs sample the same.  It wraps
    nothing inside the loop, so the beam searches still replay their
    graphs."""

    def __enter__(self):
        from faster_whisper_tpu_torch.generation import generate

        self.caps, self.widths = [], []
        self._saved = (generate.beam_search, generate.sample, generate._row_seeds)
        beam, sample, seeds = self._saved
        counter = iter(range(10**9))

        def traced(loop, axis):  # axis: the ctx axis of the loop's first table
            def run(params, config, gen_opts, *args, **kwargs):
                out = loop(params, config, gen_opts, *args, **kwargs)
                self.caps.append(min(gen_opts.ctx_cap, config.n_text_ctx))
                self.widths.append(out[0].shape[axis])
                return out
            return run

        generate.beam_search, generate.sample = traced(beam, 1), traced(sample, 2)
        generate._row_seeds = lambda rng_seed, b: seeds(
            next(counter) if rng_seed is None else rng_seed, b
        )
        return self

    def __exit__(self, *exc):
        from faster_whisper_tpu_torch.generation import generate

        generate.beam_search, generate.sample, generate._row_seeds = self._saved
        return False

    def summary(self):
        from collections import Counter

        return f"{len(self.widths)} decodes on tables of {sorted(Counter(self.widths).items())}"


def run_ladder(later, card):
    """Phase 13b: requests a (bf16, 45 s, language detection, beam 5, the
    temperature ladder, timestamps) and q (int8, 150 s, en, without
    timestamps, beam 5, 128 new tokens, temperature 0), once each
    (``WidthProbe``): launch counts by phase 7's rule, every decode on one
    table of its ``ctx_cap`` (the port runs no ctx ladder), ms per step
    (wall) and ``memory_report``'s decode peak of q's int8 model.  Returns
    the counts."""
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg, tok = later["cfg"], later["tok"]
    runs = {}
    gib = 2.0**30
    for compute_type, name, audio, kwargs in (
        ("bfloat16", "a", synth_audio(45.0, seed=1), dict(language=None, beam_size=5)),
        ("int8", "q", synth_audio(150.0, seed=1),
         dict(language="en", without_timestamps=True, beam_size=5, max_new_tokens=128, temperature=0.0)),
    ):
        model = WhisperModel.from_parts(later["params"], cfg, tok, compute_type=compute_type)
        per_step = ("k1", "k4_bf16") if compute_type == "bfloat16" else ("k2", "k4_int8")
        reset_counts()
        with WidthProbe() as tables:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            segments, info = model.transcribe(audio, **kwargs)
            segments = list(segments)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        counts = read_counts()
        check_segments(segments, info, len(audio) / 16000, cfg.n_vocab)
        check_counts(counts, per_step=per_step, per_encode="k3", cfg=cfg)
        peak = None if compute_type != "int8" else model.model.memory_report(
            batch_size=8, beam_size=5, max_new_tokens=128)["decode"]["peak_bytes"]
        runs[f"{name} one table"] = counts
        print(f"request {name} ({compute_type}, {len(audio) / 16000:.0f} s, {kwargs}): {len(segments)} "
              f"segments, {seconds:.3f} s wall, {counts['steps']} decode steps, "
              f"{seconds * 1e3 / max(counts['steps'], 1):.2f} ms per step (wall); {tables.summary()}; "
              f"memory_report(8, 5, 128) decode peak {'n/a' if peak is None else f'{peak / gib:.3f} GiB'}; "
              f"counts {counts} on {card}")
        if not tables.widths or tables.widths != tables.caps:
            raise AssertionError(f"request {name} decoded on tables of {tables.widths}, its ctx caps "
                                 f"{tables.caps}")
        del model
        torch.cuda.empty_cache()
    return runs


def run_mesh(later, speech, card):
    """Phase 13c: request h (bf16, the pipeline, batch 8, beam 5, 128 new
    tokens, 300 s) on ``device_index=[0, 0]``, two replicas on the one
    card, each batch split into two shards (8 rows into 4 + 4, 2 into 1 +
    1) over two host threads on the default stream: launch counts summed
    over the replicas by phase 7's rule and each replica's batches.  The
    mesh's output is each shard's batch result, as on a JAX data mesh: its
    segments must equal one device's with the same rows batched together,
    the chunks of shards of 4 at batch 4 and those of shards of 1 at batch
    1.  Its segments against h's (batches of 8 rows, which the card's bf16
    decode need not match) are counted, and its wall seconds set beside
    h's.  ``device_index=[0, 1]`` on a one-card machine is one device (the
    JAX rule).  Returns the counts."""
    from faster_whisper_tpu_torch.models.engine import ShardedStates
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline, WhisperModel

    cfg = later["cfg"]
    if torch.cuda.device_count() == 1:
        one = WhisperModel.from_parts(later["params"], cfg, later["tok"], device_index=[0, 1])
        print(f"device_index=[0, 1] on one card: mesh {one.mesh}, {len(one.model.replicas)} replica")
        if one.mesh is not None or len(one.model.replicas) != 1:
            raise AssertionError("device_index=[0, 1] on one card is not one device")
        del one
        torch.cuda.empty_cache()
    model = WhisperModel.from_parts(later["params"], cfg, later["tok"], device_index=[0, 0])
    if model.mesh.shape != {"data": 2, "model": 1}:
        raise AssertionError(f"device_index=[0, 0] made the mesh {model.mesh.shape}")
    shards = []  # per encoded batch: its shards' rows, or [rows] when it ran whole
    encode = model.model.encode

    def spied(feats):
        out = encode(feats)
        shards.append([int(t.shape[0]) for t in out.shards] if isinstance(out, ShardedStates)
                      else [int(out.shape[0])])
        return out

    model.model.encode = spied
    try:
        counts, segments, seconds = run_batched(model, "h on device_index=[0, 0]: bf16", speech, cfg)
    finally:
        del model.model.encode
    check_counts(counts, per_step=("k1", "k4_bf16"), per_encode="k3", cfg=cfg)
    batches = list(model.model.replica_batches)
    del model
    torch.cuda.empty_cache()
    if any(len(s) != 2 for s in shards) or min(batches) < 1:
        raise AssertionError(f"request h's batches were not each split over the two replicas: {shards}")

    def rows(segs):
        return [(s.seek, s.start, s.end, s.tokens) for s in segs]

    # One device with each shard's rows batched together: the chunk of the
    # mesh's n-th row, in row order, batched at its shard's size.
    sizes = [size for batch in shards for size in batch for _ in range(size)]
    seeks = sorted({s.seek for s in segments})
    if len(seeks) != len(sizes):
        raise AssertionError(f"{len(seeks)} chunks gave segments, {len(sizes)} were decoded")
    one = WhisperModel.from_parts(later["params"], cfg, later["tok"])
    want, times = [], {}
    for size in sorted(set(sizes), reverse=True):
        ref, times[size] = _synced_seconds(lambda: list(BatchedInferencePipeline(one).transcribe(
            speech, language="en", beam_size=5, batch_size=size, max_new_tokens=128)[0]))
        mine = {seek for seek, n in zip(seeks, sizes) if n == size}
        want += [r for r in rows(ref) if r[0] in mine]
    del one
    torch.cuda.empty_cache()
    want.sort(key=lambda r: seeks.index(r[0]))
    got = rows(segments)
    h = rows(later["h_segments"])
    differ = sum(a != b for a, b in zip(got, h)) + abs(len(got) - len(h))
    print(f"request h on device_index=[0, 0]: shards per batch {shards}, replica batches {batches}; "
          f"{seconds:.3f} s wall on two threads, h's {later['h_seconds']:.3f} s; one device at the "
          f"shards' batch sizes "
          f"{', '.join(f'{n}: {t:.3f} s' for n, t in times.items())}; segments equal to one device's "
          f"at the shards' batch sizes: {got == want} ({len(got)} segments); against h's (batches of "
          f"8 rows): {differ} of {len(h)} segments differ on {card}")
    if got != want:
        raise AssertionError("request h on the mesh differs from one device at the shards' batch sizes")
    return counts


# ---------------------------------------------------------------------------
# Phase 14: tensor parallel
# ---------------------------------------------------------------------------

# A large-v3-turbo layer under tensor_parallel=2 against one device, both
# bf16 on the card: the row-parallel products' partials are rounded to
# bf16 and summed (one more rounding than one product), through 32 encoder
# layers or a prefill and a decode step.  Of the largest value, as phase 8
# holds the card's bf16 encoder against the CPU.
TP_BF16_TOL = 3 * BF16_REL_TOL
TP_HEADS = (10, 5)  # large-v3-turbo's 20 heads over 2 and over 4 shards


def check_tp_kernels(card):
    """Phase 14a: phase 3's holds of K1, K2, K3 and K4 against their plain
    versions, at the heads of a shard: H=10 (N=2) and H=5 (N=4); K1, K2,
    K3 and K4 timed at B=8 and H=10 beside phase 3's H=20.  Returns
    {label: max abs error} in phase 3's labels."""
    f32 = torch.float32
    errs = {}

    def keep(label, err):
        errs[label] = max(errs.get(label, 0.0), err)

    for H in TP_HEADS:
        keep("K1", check_beam_attention(H=H))
        keep("K1 f32", check_beam_attention(dtype=f32, H=H))
        keep("K2", check_beam_attention_int8(H=H)[0])
        keep("K2 f32", check_beam_attention_int8(dtype=f32, H=H)[0])
        keep("K3", check_flash_attention(**K3_SHAPES, H=H))
        keep("K3 f32", check_flash_attention(**K3_SHAPES, dtype=f32, H=H))
        for form, err in check_cross_attention(H=H).items():
            keep(f"K4 {form}", err)
    for H in (20, 10):
        print_times(f"K1 H={H}", time_beam_attention(B=8, H=H), card)
        print_times(f"K2 H={H}", time_beam_attention(B=8, H=H, quant=True), card)
        print_times(f"K3 H={H}", time_flash_attention(B=8, H=H), card)
        for quant in (False, True):
            print_times(f"K4 H={H}", time_cross_attention(quant, B=8, H=H), card)
    return errs


def _one_step_logits(model, xa, tok0, before_step=None):
    """One prefill of 4 start tokens and one beam decode step (K=5, a table
    of 64) over the encoder states ``xa`` with the tokens ``tok0`` (B,):
    the step's logits (B, K, V) on the lead.  ``before_step()`` is called
    just before the step, if given."""
    from faster_whisper_tpu_torch.generation import generate as G
    from faster_whisper_tpu_torch.models import model as M

    eng = model.model
    params = eng.replicas[0][1]
    b, K, P, ctx = xa.shape[0], 5, 4, 64
    prompt = torch.full((b, P), eng.sot_id, dtype=torch.long, device="cuda")
    lens = torch.full((b,), P, dtype=torch.long, device="cuda")
    _, cache0 = M.decoder_prefill(params, eng.config, prompt, lens, xa, (lens - 1)[:, None], ctx=ctx)
    sk, sv, ck, cv = G._expand_caches(cache0, K, eng.kv_int8)
    tok = tok0[:, None].expand(b, K).contiguous()
    pos = torch.full((b, K), P, dtype=torch.long, device="cuda")
    anc = torch.arange(K, dtype=torch.int32, device="cuda")[None, :, None].expand(b, K, ctx).contiguous()
    if before_step is not None:
        before_step()
    logits, _, _ = G._gen_decoder_step(params, eng.config, tok, pos, pos[:, 0].int(), sk, sv, ck, cv, anc)
    return logits


def check_tp_layers(later, card):
    """Phase 14b: at large-v3-turbo width on ``device_index=[0, 0]``,
    ``tensor_parallel=2`` against one device: one encode's states (B=2)
    and one decode step's logits (the same encoder states and tokens) in
    bf16 within TP_BF16_TOL of the largest value, the step launching K1
    and K4 4 times per shard; at int8 one row-parallel ``int8_dense``
    (mlp.w2 of layer 0, 40 rows: B=8 x 5 beams) bit-equal to one device's,
    and the int8 encode's states compared.  Returns (one device's bf16
    model, the tensor-parallel bf16 model)."""
    from faster_whisper_tpu_torch.models import model as M
    from faster_whisper_tpu_torch.ops.quant import int8_dense, int8_dense_rows
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    params, cfg, tok = later["params"], later["cfg"], later["tok"]
    g = torch.Generator(device="cuda")
    g.manual_seed(14)
    mel = torch.randn((2, cfg.n_mels, 3000), generator=g, device="cuda")
    one = WhisperModel.from_parts(params, cfg, tok)
    tp = WhisperModel.from_parts(params, cfg, tok, device_index=[0, 0], tensor_parallel=2)
    x1, x2 = one.model.encode(mel), tp.model.encode(mel)
    err = (x2.float() - x1.float()).abs().max().item()
    tol = TP_BF16_TOL * x1.float().abs().max().item()
    print(f"tensor_parallel=2 on [0, 0], bf16 encode (2, 1500, 1280) against one device: max|err| "
          f"{err:.3e} (tolerance {tol:.3e}), bit-equal {torch.equal(x1, x2)}")
    if not err <= tol:
        raise AssertionError("the tensor-parallel bf16 encode disagrees with one device's")
    tok0 = torch.randint(0, 50257, (2,), generator=g, device="cuda")
    l1 = _one_step_logits(one, x1, tok0)
    reset_counts()
    l2 = _one_step_logits(tp, x1, tok0)
    counts = read_counts()
    err = (l2 - l1).abs().max().item()
    tol = TP_BF16_TOL * l1.abs().max().item()
    same_top = bool((l1.argmax(-1) == l2.argmax(-1)).all())
    print(f"tensor_parallel=2, bf16 prefill and one decode step's logits (2, 5, {cfg.n_vocab}) against one "
          f"device: max|err| {err:.3e} (tolerance {tol:.3e}), argmax equal {same_top}; K1 launches "
          f"{counts['k1']}, K4 {counts['k4_bf16']} (4 layers x 2 shards)")
    if not err <= tol:
        raise AssertionError("the tensor-parallel decode step's logits disagree with one device's")
    if counts["k1"] != 2 * cfg.n_text_layer or counts["k4_bf16"] != 2 * cfg.n_text_layer:
        raise AssertionError(f"the tensor-parallel decode step launched {counts}")

    one8 = WhisperModel.from_parts(params, cfg, tok, compute_type="int8")
    tp8 = WhisperModel.from_parts(params, cfg, tok, compute_type="int8", device_index=[0, 0],
                                  tensor_parallel=2)
    w = M._layer(one8.model.params["decoder"]["layers"], 0)["mlp"]
    parts = [M._layer(t["decoder"]["layers"], 0)["mlp"] for t in tp8.model.params.trees]
    x = torch.randn((40, 4 * cfg.n_text_state), generator=g, device="cuda").to(torch.bfloat16)
    half = x.shape[1] // 2
    want = int8_dense(x, w["w2"], w["b2"])
    got = int8_dense_rows([x[:, :half], x[:, half:]], [p["w2"] for p in parts], [p["b2"] for p in parts],
                          tp8.model.params.group)
    equal = all(torch.equal(y, want) for y in got)
    e1, e2 = one8.model.encode(mel), tp8.model.encode(mel)
    print(f"tensor_parallel=2, int8 row-parallel int8_dense (40 x 5120 @ 5120 x 1280, mlp.w2 of layer 0) "
          f"bit-equal to one device's: {equal}; int8 encode states bit-equal: {torch.equal(e1, e2)} "
          f"(max|diff| {(e1.float() - e2.float()).abs().max().item():.3e})")
    if not equal:
        raise AssertionError("the tensor-parallel int8 row-parallel product differs from one device's")
    del one8, tp8
    torch.cuda.empty_cache()
    return one, tp


def _reduce_report(group, totals, steps, batch_seconds, per_step):
    """The reductions' count and host time from the span ``fwt.all_reduce``
    (``faster_whisper_tpu_torch/tracing.py``) over a whole request (encode,
    prefill and decode), against the ``per_step`` reductions of a decode
    step: host time, the launch of each reduction (a local sum's adds, or
    NCCL's enqueue), not its device time."""
    count, seconds = totals.get("fwt.all_reduce", (0, 0.0))
    step_ms = sum(batch_seconds) * 1e3 / max(steps, 1)
    return (f"all-reduces ({group.transport}): {count} in {seconds * 1e3:.3f} ms of host time, "
            f"{count / max(steps, 1):.1f} a decode step ({per_step} in the step), "
            f"{seconds * 1e3 / max(steps, 1):.4f} ms a step of {step_ms:.3f} ms")


def run_tensor_parallel(later, speech, card):
    """Phase 14c: requests h (bf16) and i (int8) through the pipeline (VAD
    on, batch 8, beam 5, 128 new tokens, the tiled 5 minutes) and a (20 s,
    sequential, language detection, beam 5) under ``tensor_parallel=2`` on
    ``device_index=[0, 0]``: well-formed segments, per decode step 4
    launches per shard of K1 (K2) and K4, per encode 32 of K3; the
    transport, wall seconds, ms per step, the card's peak (both shards),
    the all-reduces' count and host time a step (the span
    ``fwt.all_reduce``), and the segments that differ from
    one device's request (printed; at int8, request i, none may differ:
    every product is exact, every all-reduce an integer sum, and K1/K2/K4
    split a row alike at 10 heads as at 20).  On two or more cards h on
    ``[0, 1]`` (NCCL) must give ``[0, 0]``'s segments.  Returns {request:
    launch counts}."""
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    params, cfg, tok = later["params"], later["cfg"], later["tok"]
    one, tp = check_tp_layers(later, card)
    runs = {}

    def rows(segs):
        return [(s.seek, s.start, s.end, s.tokens) for s in segs]

    def differ(a, b):
        return sum(x != y for x, y in zip(rows(a), rows(b))) + abs(len(a) - len(b))

    def batched(model, label, ref, forms, per_step):
        from faster_whisper_tpu_torch import tracing

        group, stats = model.model.params.group, {}
        tracing.reset()
        tracing.enable(True)
        try:
            counts, segments, seconds = run_batched(model, label, speech, cfg, stats=stats)
        finally:
            tracing.enable(False)
        check_counts(counts, per_step=forms[:2], per_encode=forms[2], cfg=cfg, shards=2,
                     layout=ln_layout(model))
        print(f"request {label}: transport {group.transport}; {seconds:.3f} s wall; "
              f"{_reduce_report(group, tracing.totals(), counts['steps'], stats['batch_seconds'], per_step)}; "
              f"{differ(segments, ref)} of {len(ref)} segments differ from one device's on {card}")
        return counts, segments

    runs["tp h"], h_segments = batched(tp, "h: bf16, tensor_parallel=2 on [0, 0]", later["h_segments"],
                                       ("k1", "k4_bf16", "k3"), 3 * cfg.n_text_layer)
    clip = synth_audio(20.0, seed=1)
    kwargs = dict(language=None, beam_size=5)
    seqs = {}
    for name, model in (("one device", one), ("tensor_parallel=2 on [0, 0]", tp)):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        segments, info = model.transcribe(clip, **kwargs)
        seqs[name] = list(segments)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        check_segments(seqs[name], info, 20.0, cfg.n_vocab)
        print(f"request a: 20 s, language detection, beam 5, temperature ladder, {name}: "
              f"{len(seqs[name])} segments, {seconds:.3f} s, {counts['steps']} steps "
              f"({seconds * 1e3 / max(counts['steps'], 1):.2f} ms per step, wall), peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")
    check_counts(counts, per_step=("k1", "k4_bf16"), per_encode="k3", cfg=cfg, shards=2,
                 layout=ln_layout(tp))
    runs["tp a"] = counts
    print(f"request a under tensor_parallel=2: {differ(seqs['tensor_parallel=2 on [0, 0]'], seqs['one device'])}"
          f" of {len(seqs['one device'])} segments differ from one device's")
    del one, tp
    torch.cuda.empty_cache()

    tp8 = WhisperModel.from_parts(params, cfg, tok, compute_type="int8", device_index=[0, 0],
                                  tensor_parallel=2)
    runs["tp i"], i_segments = batched(tp8, "i: int8, tensor_parallel=2 on [0, 0]", later["i_segments"],
                                       ("k2", "k4_int8", "k3"), 6 * cfg.n_text_layer)
    # at int8 every product is exact, every all-reduce an integer sum, and
    # K1/K2/K4 split a row alike at 10 heads as at 20: one device's segments
    n_differ = differ(i_segments, later["i_segments"])
    print(f"request i under tensor_parallel=2: {n_differ} of {len(later['i_segments'])} segments differ "
          f"from one device's")
    if n_differ:
        raise AssertionError("request i (int8) under tensor_parallel=2 differs from one device's")
    del tp8
    torch.cuda.empty_cache()

    if torch.cuda.device_count() < 2:
        print("NCCL transport not run: the machine has one card (tensor_parallel=2 on [0, 1] needs two)")
        return runs
    nccl = WhisperModel.from_parts(params, cfg, tok, device_index=[0, 1], tensor_parallel=2)
    counts, segments = batched(nccl, "h: bf16, tensor_parallel=2 on [0, 1]", h_segments,
                               ("k1", "k4_bf16", "k3"), 3 * cfg.n_text_layer)
    runs["tp h nccl"] = counts
    if rows(segments) != rows(h_segments):
        raise AssertionError("request h on [0, 1] (NCCL) differs from [0, 0] (the local sum)")
    return runs


def _fmt(x):
    return "n/a" if x is None else f"{x:.4f} ms"


def print_times(label, t, card):
    fma = f", f32 FMA bound {t['fma_bound_ms']:.4f} ms" if "fma_bound_ms" in t else ""
    print(f"{label} {t['shape']}: kernel {t['ms']:.4f} ms warm, {t['cold_ms']:.4f} ms L2 cold, "
          f"{t['call_ms']:.4f} ms per call from the host; plain {t['plain_ms']:.4f} ms; "
          f"library {_fmt(t['library_ms'])} warm, {_fmt(t['library_cold_ms'])} L2 cold; "
          f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}){fma} on {card}")


# ---------------------------------------------------------------------------
# Phase 15: the sequential path's log-mel on the card and the upload knobs
# ---------------------------------------------------------------------------

# Whole-file log-mel, the card's and the host's each against a float64 DFT
# of the same float32 frames and bases, and against each other: the CPU
# tests' tolerance against the JAX package (tests/test_torch_log_mel.py).
# A bin that a louder one leaks into is a sum of 400 terms that nearly
# cancel; the host sums them in float32 (~3e-5 to 7e-5 from the float64
# sum), the card in float64 (ops/mel.py::_log_spectrum).
LOG_MEL_TOL = 1e-4
P_SAMPLES = 150 * 16000  # request p's audio, synth_audio(150.0, seed=1)
# Phase 15's log-mel lengths in samples: 1 s, both sides of the end of the
# first 1500-frame bucket, 45 s, request p's 150 s and 600 s.
LOG_MEL_LENGTHS = (16000, 479990, 480000, 480150, 45 * 16000, P_SAMPLES, 600 * 16000)


def log_mel_float64(fe, audio):
    """The whole-file log-mel of ``audio`` with every sum in float64, on
    the card: the JAX package's buffer (zeros to k * 1500 + 1 frames, a
    reflect pad), the extractor's float32 DFT bases and filters widened,
    ``log10(clip(., 1e-10))``, the global max, the clamp and the scale."""
    n = len(audio)
    n_valid = (n + 160) // 160
    n_bucketed = max(1, -(-max(n_valid - 1, 1) // 1500)) * 1500 + 1
    mel_filters, cos_b, sin_b = (torch.from_numpy(a).to("cuda", torch.float64)
                                 for a in (fe.mel_filters, fe._cos_b, fe._sin_b))
    x = torch.nn.functional.pad(torch.from_numpy(audio).to("cuda", torch.float64), (0, n_bucketed * 160 - n))
    frames = torch.nn.functional.pad(x[None], (200, 360), mode="reflect")[0].unfold(0, 400, 160)[:n_valid]
    mel = ((frames @ cos_b) ** 2 + (frames @ sin_b) ** 2) @ mel_filters.T
    ref = torch.log10(torch.clamp(mel, min=1e-10))
    return ((torch.maximum(ref, ref.max() - 8.0) + 4.0) / 4.0).T.cpu().numpy()


def _with_env(name, value, fn):
    """``fn()`` with the variable ``name`` set to ``value`` (None: as it
    is), then restored."""
    if value is None:
        return fn()
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop(name)
        else:
            os.environ[name] = old


def check_device_log_mel(card, lengths=LOG_MEL_LENGTHS):
    """Phase 15 (i): ``FeatureExtractor(feature_size=128)(audio,
    return_device=True)``, whose device is the card by default, against
    the host numpy path at each length: a float32 tensor on the card of
    the host's shape; the card's and the host's each within LOG_MEL_TOL of
    ``log_mel_float64`` and of each other.  Each is timed: the host's wall
    seconds, and the card's synchronized, the second of two calls (warm);
    at 150 s that is request p's log-mel.  Returns {length: the largest of
    the three differences}."""
    from faster_whisper_tpu_torch.feature_extractor import FeatureExtractor

    fe = FeatureExtractor(feature_size=128)
    errs = {}
    for n in lengths:
        audio = synth_audio(150.0, seed=1) if n == P_SAMPLES else synth_audio(n / 16000 + 1, seed=5)[:n]
        t0 = time.perf_counter()
        host = fe(audio)
        host_s = time.perf_counter() - t0
        fe(audio, return_device=True)
        dev, dev_s = _synced_seconds(lambda: fe(audio, return_device=True))
        if not (dev.is_cuda and dev.dtype == torch.float32 and tuple(dev.shape) == host.shape):
            raise AssertionError(f"device log-mel of {n} samples: {dev.dtype} {tuple(dev.shape)} on "
                                 f"{dev.device}, host {host.shape}")
        dev = dev.cpu().numpy()
        ref = log_mel_float64(fe, audio)
        card_err, host_err = float(np.abs(dev - ref).max()), float(np.abs(host - ref).max())
        diff = float(np.abs(dev - host).max())
        errs[n] = max(card_err, host_err, diff)
        what = "request p's log-mel, " if n == P_SAMPLES else ""
        print(f"whole-file log-mel, {what}{n} samples ({n / 16000:.2f} s), 128 mels, {host.shape[1]} "
              f"frames: max|card - float64| {card_err:.3e}, max|host - float64| {host_err:.3e}, "
              f"max|card - host| {diff:.3e} (tolerance {LOG_MEL_TOL:.0e}); host {host_s:.4f} s wall, "
              f"card {dev_s:.4f} s (synchronized, warm) on {card}")
        if not errs[n] <= LOG_MEL_TOL:
            raise AssertionError(f"the log-mel of {n} samples: card {card_err:.3e} and host {host_err:.3e} "
                                 f"from the float64 DFT, {diff:.3e} from each other")
    return errs


def run_device_feature_requests(later, card):
    """Phase 15 (ii): requests a (45 s, language detection, beam 5, the
    ladder; bf16), p (150 s, en, without timestamps, beam 5, 128 new
    tokens, temperature 0; bf16) and q (p at int8) through
    ``WhisperModel.transcribe``, whose whole-file features reach
    ``generate_segments`` as a float32 tensor on the card: segments, decode
    steps and wall seconds, with phase 7's launch counts.  Returns the
    counts of the runs."""
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg, tok = later["cfg"], later["tok"]
    long_clip = synth_audio(150.0, seed=1)
    p_kwargs = dict(language="en", without_timestamps=True, beam_size=5, max_new_tokens=128,
                    temperature=0.0)
    runs = {}
    for compute_type, per_step, requests in (
        ("bfloat16", ("k1", "k4_bf16"), [("a", synth_audio(45.0, seed=1), dict(language=None, beam_size=5)),
                                         ("p", long_clip, p_kwargs)]),
        ("int8", ("k2", "k4_int8"), [("q", long_clip, p_kwargs)]),
    ):
        model = WhisperModel.from_parts(later["params"], cfg, tok, compute_type=compute_type)
        seen = []
        generate_segments = model.generate_segments

        def spy(features, *args, **kwargs):
            seen.append(features)
            return generate_segments(features, *args, **kwargs)

        model.generate_segments = spy
        try:
            for name, audio, kwargs in requests:
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                segments, info = model.transcribe(audio, **kwargs)
                segments = list(segments)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = read_counts()
                check_segments(segments, info, len(audio) / 16000, cfg.n_vocab)
                check_counts(counts, per_step=per_step, per_encode="k3", cfg=cfg)
                runs[f"{name} device features"] = counts
                f = seen[-1]
                frames = (len(audio) + 160) // 160
                if not (isinstance(f, torch.Tensor) and f.is_cuda and tuple(f.shape) == (cfg.n_mels, frames)):
                    raise AssertionError(f"request {name}'s features reached generate_segments as "
                                         f"{type(f).__name__} {tuple(f.shape)}, not a tensor on the card")
                print(f"request {name} ({compute_type}, {len(audio) / 16000:.0f} s, {kwargs}) on device "
                      f"features ({tuple(f.shape)} float32 on {f.device}): {len(segments)} segments, "
                      f"{sum(len(s.tokens) for s in segments)} tokens, {counts['steps']} decode steps, "
                      f"{counts['encodes']} encodes, {seconds:.3f} s wall, "
                      f"{seconds * 1e3 / max(counts['steps'], 1):.2f} ms per step (wall) on {card}")
        finally:
            del model.generate_segments
        del model
        torch.cuda.empty_cache()
    return runs


def run_knobs(later, speech, card):
    """Phase 15 (iii), at int8 with the engine's ``rng_seed`` fixed (int8
    is batch-invariant on the card, phase 7b): request i (the pipeline
    over ``speech``) under ``FWT_SHARED_UPLOAD=0`` and
    ``FWT_I16_TRANSFER=0`` on ``speech`` rounded to the int16 grid, each
    against the same run with the knob at its default: 0 segments may
    differ.  The two knobs on the raw resampled audio, which is off the
    grid, only print how many segments differ.  Returns the counts of the
    runs."""
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg = later["cfg"]
    model = WhisperModel.from_parts(later["params"], cfg, later["tok"], compute_type="int8")
    model.model.rng_seed = 0
    grid = (np.clip(np.round(speech * 32768.0), -32768, 32767).astype(np.int16) / 32768.0).astype(np.float32)
    runs = {}

    def differ(a, b):
        return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))

    def batched(label, audio, knob=None, value=None):
        counts, segments, _ = _with_env(
            knob, value, lambda: run_batched(model, f"i ({label}): int8", audio, cfg)
        )
        check_counts(counts, per_step=("k2", "k4_int8"), per_encode="k3", cfg=cfg)
        runs[f"i {label}"] = counts
        return [(s.start, s.end, s.tokens) for s in segments]

    failures = []
    base, grid_base = batched("defaults", speech), batched("int16 grid", grid)
    for knob in ("FWT_SHARED_UPLOAD", "FWT_I16_TRANSFER"):
        n = differ(batched(f"int16 grid, {knob}=0", grid, knob, "0"), grid_base)
        print(f"request i on int16-grid audio under {knob}=0: {n} of {len(grid_base)} segments differ "
              f"from the knob's default on {card}")
        if n:
            failures.append(knob)
        n = differ(batched(f"{knob}=0", speech, knob, "0"), base)
        print(f"request i on the raw resampled audio (off the int16 grid) under {knob}=0: {n} of "
              f"{len(base)} segments differ from the knob's default (printed only) on {card}")
    del model
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"segments on int16-grid audio moved under {failures}")
    return runs


# ---------------------------------------------------------------------------
# Phase 16: the beam-search step as a CUDA graph
# ---------------------------------------------------------------------------


# (size, compute type, batch): the benchmark cells' decodes
STEP_GRAPH_CELLS = (("large-v3", "int8", 8), ("large-v3-turbo", "bfloat16", 16))


class EagerSteps:
    """Within the block every beam-search step of ``engine`` runs eagerly:
    its decodes are handed no step graphs, as a module-level
    ``generate_dispatch`` is, and run on states of their own.  For a
    probe that wraps a function inside the step, which a replay skips."""

    def __init__(self, engine):
        self.engine = engine

    def __enter__(self):
        self._graphs, self.engine.step_graphs = self.engine.step_graphs, None
        return self

    def __exit__(self, *exc):
        self.engine.step_graphs = self._graphs
        return False


def device_ms(fn):
    """The device time of the operations ``fn()`` launches, in ms (the
    profiler's CUDA activity), or None where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
    return total / 1e3 if total > 0 else None


def graph_decode_pair(model, xa, prompts, kwargs):
    """One decode of the engine replayed from its step graph (which must
    exist) and the same decode with every step eager: each side's pending
    tables, results, counts, wall seconds and device ms of a second run."""
    eng = model.model
    sides = {}
    for name in ("graph", "eager"):
        reset_counts()
        with EagerSteps(eng) if name == "eager" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending = eng.generate_dispatch(xa, prompts, **kwargs)
            results = eng.generate_collect(pending)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        counts = read_counts()
        with EagerSteps(eng) if name == "eager" else contextlib.nullcontext():
            dev_ms = device_ms(lambda: eng.generate_collect(eng.generate_dispatch(xa, prompts, **kwargs)))
        sides[name] = dict(pending=pending, results=results, counts=counts, seconds=seconds, device_ms=dev_ms)
    graphs = [g for g in eng.step_graphs.graphs() if g.step is not None and g.state.cur_len.shape[0] == xa.shape[0]]
    if not graphs:
        raise AssertionError("the decode left no captured step graph of its batch")
    return sides


def graph_model(size, compute_type, decoder_layers=None):
    """A model of ``size``'s published widths on the card at
    ``compute_type``, random weights; with ``decoder_layers`` a shallower
    decoder and one encoder layer (the card tests: the step's shapes at a
    few layers)."""
    import dataclasses

    from faster_whisper_tpu_torch.models.config import CONFIGS
    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg = CONFIGS[size]
    if decoder_layers is not None:
        cfg = dataclasses.replace(cfg, n_audio_layer=1, n_text_layer=decoder_layers)
    params = random_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    return WhisperModel.from_parts(params, cfg, build_synthetic_tokenizer(base_vocab=50257),
                                   compute_type=compute_type)


def graph_decode_inputs(model, rows, seed=0, timestamps=False):
    """Encoder states (rows, 1500, d) drawn from ``seed`` in the model's
    activation dtype, the prompts <|startoftranscript|> <|en|>
    (<|notimestamps|>), and the cells' decode options: beam 5, 128 new
    tokens."""
    eng = model.model
    dtype = eng.params["decoder"]["token_embed"].dtype
    g = torch.Generator(device="cuda").manual_seed(seed)
    xa = torch.randn((rows, 1500, eng.config.n_text_state), generator=g, device="cuda").to(dtype)
    prompt = [eng.sot_id, dict(eng.language_tokens)["en"]] + ([] if timestamps else [eng.meta.no_timestamps])
    return xa, [prompt] * rows, dict(beam_size=5, max_length=len(prompt) + 128)


def check_decode_step_launches(model, xa, card):
    """One eager decode step of ``model`` (int8) over the encoder states
    ``xa`` (B, 1500, d), B x 5 beams: every W8A8 launch of the step is a
    decode launch, one per ``int8_dense_many`` call (6 a decoder layer and
    the logits head); prints ``int8_dense.decode_launches /
    int8_dense.launches``."""
    from faster_whisper_tpu_torch.ops.quant import int8_dense

    marks = []
    g = torch.Generator(device="cuda").manual_seed(24)
    tok0 = torch.randint(0, 256, (xa.shape[0],), generator=g, device="cuda")
    _one_step_logits(model, xa, tok0, before_step=lambda: marks.append((int8_dense.launches,
                                                                        int8_dense.decode_launches)))
    torch.cuda.synchronize()
    launches, decode = int8_dense.launches - marks[0][0], int8_dense.decode_launches - marks[0][1]
    want = 6 * model.model.config.n_text_layer + 1
    print(f"one int8 decode step, batch {xa.shape[0]} x 5 beams: int8_dense.decode_launches / "
          f"int8_dense.launches = {decode} / {launches} (expected {want} / {want}) on {card}")
    if not decode == launches == want:
        raise AssertionError(f"the decode step launched {launches} W8A8 products, {decode} of the decode plan, "
                             f"not {want} of {want}")


def run_step_graphs(card):
    """Phase 16 (``STEP_GRAPH_CELLS``): for each cell, random weights at
    the size's published widths, the batched pipeline over tiled speech
    (en, beam 5, 128 new tokens, the cell's batch), whose first full batch's
    decode arguments are recorded; that decode replayed and eager must give
    equal pending tables, tokens, scores and no-speech probabilities bit
    for bit, and equal counts; prints the steps, the host ms per step
    (wall) and the device ms per step both ways.  Returns the counts."""
    from faster_whisper_tpu_torch.models.config import CONFIGS
    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline, WhisperModel

    runs = {}
    tok = build_synthetic_tokenizer(base_vocab=50257)
    for size, compute_type, rows in STEP_GRAPH_CELLS:
        cfg = CONFIGS[size]
        _, speech = tiled_speech(35.0 * rows)
        params = random_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        model = WhisperModel.from_parts(params, cfg, tok, compute_type=compute_type)
        del params
        eng = model.model
        calls, dispatch = [], eng.generate_dispatch

        def spy(encoder_output, prompts, **kwargs):
            calls.append((encoder_output, [list(p) for p in prompts], kwargs))
            return dispatch(encoder_output, prompts, **kwargs)

        eng.generate_dispatch = spy
        try:
            list(BatchedInferencePipeline(model).transcribe(
                speech, language="en", beam_size=5, batch_size=rows, max_new_tokens=128)[0])
        finally:
            del eng.generate_dispatch
        full = [c for c in calls if c[0].shape[0] == rows]
        if not full:
            raise AssertionError(f"{size}: the pipeline ran batches of {[c[0].shape[0] for c in calls]}, "
                                 f"none of {rows}")
        xa, prompts, kwargs = full[0]
        sides = graph_decode_pair(model, xa, prompts, kwargs)
        g, e = sides["graph"], sides["eager"]
        tables = all(torch.equal(a, b) for a, b in zip(g["pending"].arrays, e["pending"].arrays))
        results = [(r.sequences_ids, r.scores, r.no_speech_prob) for r in g["results"]] == [
            (r.sequences_ids, r.scores, r.no_speech_prob) for r in e["results"]]
        steps = g["counts"]["steps"]

        def ms(side, key):
            v = side[key]
            return "not measured" if v is None else f"{v * (1e3 if key == 'seconds' else 1) / steps:.3f}"

        print(f"step graph, {size} {compute_type}, batch {rows}, beam 5, prompt {max(map(len, prompts))}: "
              f"{steps} steps; tables equal {tables}, results equal {results}, counts equal "
              f"{g['counts'] == e['counts']}; host ms per step (wall) graph {ms(g, 'seconds')}, eager "
              f"{ms(e, 'seconds')}; device ms per step graph {ms(g, 'device_ms')}, eager "
              f"{ms(e, 'device_ms')}; counts {g['counts']} on {card}")
        if not (tables and results and g["counts"] == e["counts"]):
            raise AssertionError(f"{size}: the replayed decode differs from the eager one (tables {tables}, "
                                 f"results {results}, counts {g['counts']} against {e['counts']})")
        per_step = ("k2", "k4_int8") if compute_type == "int8" else ("k1", "k4_bf16")
        bad = {k: g["counts"][k] for k in per_step if g["counts"][k] != cfg.n_text_layer * steps}
        if not steps or bad or g["counts"]["ln"] != expected_layer_norms(g["counts"], cfg):
            raise AssertionError(f"{size}: the replayed decode's counts {g['counts']} are not "
                                 f"{cfg.n_text_layer} a step of {per_step} and the decoder's LayerNorms")
        runs[f"step graph {size}"] = g["counts"]
        if compute_type == "int8":
            check_decode_step_launches(model, xa, card)
        del model, eng, xa, calls, full, sides, g, e
        torch.cuda.empty_cache()
    return runs


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
    probe_errs, p1_moved = check_probes()
    errs.update(probe_errs)
    print(f"P1 weight codes one unit from the plain version's: {p1_moved}")
    print(f"K1/K2/K4: {check_batch_invariance()} holds of a row alone and as a head slice against "
          f"its batch, all bit-equal")
    errs.update(check_layer_norm())
    check_w8a8()
    errs["W8A8"] = 0.0  # bit-equal to the composition, or check_w8a8 raised
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
    for label, t in time_probes().items():
        times[label] = t
        print_times(label, t, card)
    print(f"P1 against K2 at the probes' shape (B=8 H=20 K=5 ctx=192 pos=120): P1 {times['P1']['ms']:.4f} "
          f"ms warm, K2 {times['K2 probe']['ms']:.4f} ms (P1 / K2 = "
          f"{times['P1']['ms'] / times['K2 probe']['ms']:.3f}); P2h {times['P2h']['ms']:.4f} ms, P2b "
          f"{times['P2b']['ms']:.4f} ms (P2h / P2b = {times['P2h']['ms'] / times['P2b']['ms']:.3f}) on {card}")
    time_plans(card)
    for label, m, dtype in (("LN", 40, torch.bfloat16), ("LN encode", 12000, torch.bfloat16),
                            ("LN f32", 40, f32), ("LN f32 encode", 12000, f32)):
        times[label] = time_layer_norm(m, dtype=dtype)
        print_times(label, times[label], card)
    for m, k, n, weights in W8A8_TIMED:
        t = time_w8a8(m, k, n, weights)
        times.setdefault("W8A8", t)  # the table's: a decode step's attention product
        print_times("W8A8", t, card)
    floor = time_empty()
    print(f"launch floor: an empty kernel {floor['ms']:.4f} ms warm (a graph of 20 calls), "
          f"{floor['cold_ms']:.4f} ms L2 cold, {floor['call_ms']:.4f} ms per call from the host; "
          f"P2b {times['P2b']['ms']:.4f} ms warm, {times['P2b']['ms'] - floor['ms']:.4f} ms above the "
          f"floor, against its bound {times['P2b']['bound_ms']:.5f} ms; LN (40, 1280) "
          f"{times['LN']['ms']:.4f} ms on {card}")
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
    later["batch_stage"] = trace_batch_stages(later, speech, card)
    phase("batch stages", t0)
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
    phase("gate, warm CLI, memory_report", t0)
    t0 = time.perf_counter()
    probe_counts, _ = run_probe_sweeps(card)
    late["probes"] = probe_counts
    phase("probe sweeps", t0)
    t0 = time.perf_counter()
    late.update(run_ladder(later, card))
    phase("ctx ladder", t0)
    t0 = time.perf_counter()
    late["h mesh"] = run_mesh(later, speech, card)
    phase("mesh", t0)
    t0 = time.perf_counter()
    for label, err in check_tp_kernels(card).items():
        errs[label] = max(errs[label], err)
    check_small_pipeline_against_cpu(jfk, tensor_parallel=2)
    late.update(run_tensor_parallel(later, speech, card))
    phase("tensor parallel", t0)
    t0 = time.perf_counter()
    check_device_log_mel(card)
    late.update(run_device_feature_requests(later, card))
    late.update(run_knobs(later, speech, card))
    del later
    phase("sequential log-mel and upload knobs", t0)
    t0 = time.perf_counter()
    late.update(run_step_graphs(card))
    phase("step graphs", t0)

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
    # 9-11 and phases 12-15's (late_sum)
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
        entry("attend_only (P1)", "P1", "probes.cu", P1_REPLACES, late_sum("p1")),
        entry("scores_batched (P2b)", "P2b", "probes.cu", P2B_REPLACES, late_sum("p2b")),
        entry("scores_perhead (P2h)", "P2h", "probes.cu", P2H_REPLACES, late_sum("p2h")),
        entry("layer_norm bf16 and f32 (LN; times at a decode step's 40 x 1280 bf16)", "LN",
              "layer_norm.cu", LN_REPLACES,
              sum(c["ln"] for c in runs.values()) + late_sum("ln")),
        entry("int8_dense W8A8 (times at a decode step's 40 x 1280 @ 1280 x 1280)", "W8A8", "w8a8.cu",
              W8A8_REPLACES, sum(c["w8a8"] for c in runs.values()) + late_sum("w8a8")),
    ]
    print(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
