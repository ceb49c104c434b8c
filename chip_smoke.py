#!/usr/bin/env python3
"""Smoke run of faster_whisper_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line with its seconds:

1. device: requires a CUDA card, prints its name and power limit, turns
   TF32 off for float32 matmuls and convolutions;
2. build: compiles every CUDA kernel of the main path from ``csrc/`` with
   nvcc (one process per source, all started together) and prints the
   ``-Xptxas -v`` register and shared-memory lines;
3. kernels: holds each kernel against its plain PyTorch version on the
   card, at the main path's shapes, in bfloat16: K1 and K2 (beam
   self-attention over a bf16 and an int8 cache), K3 (encoder flash
   attention), K4 in its bf16 and int8 forms (decode cross-attention);
4. times: each kernel, its plain version and, where one exists, the one
   PyTorch call that computes the same function, on the card (CUDA events
   around the replay of a CUDA graph of 20 calls), beside the least time
   the card could take (its bound), and each kernel's time per call when
   the host issues the calls one by one, as the decode loop does;
5. main path: ``WhisperModel.transcribe`` at large-v3-turbo width (random
   weights from a seed, the synthetic 51866-token vocabulary), first at
   bf16 on three requests (a-c), then at ``compute_type="int8"`` on two
   (d, e), each with the launch counts set to 0 before and read after: K1
   and K4's bf16 form four times per bf16 decode step, K2 and K4's int8
   form four times per int8 decode step, K3 32 times per encode.  Then it
   holds a small model on the card, at bf16 and at int8, against the same
   model in float32 on the CPU.

Then it prints one JSON line with every kernel's numbers, the card's name
and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Any failure raises and exits nonzero before that line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (dense, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12

BF16_REL_TOL = 2e-2  # of the output scale: one bf16 rounding of P and of the output

K1_REPLACES = "faster_whisper_tpu/ops/beam_attention.py:248"
K2_REPLACES = "faster_whisper_tpu/ops/beam_attention.py:91"
K3_REPLACES = "faster_whisper_tpu/ops/attention.py:123"
K4A_REPLACES = "faster_whisper_tpu/ops/beam_attention.py:715"
K4B_REPLACES = "faster_whisper_tpu/ops/beam_attention.py:535"  # and K4c, :605


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


def k1_inputs(B, pos, K=5, H=20, D=64, L=4, ctx=448, seed=0, divergent=False):
    """K1's inputs.  ``anc`` draws each query beam's slot per column at
    random, so that beams share rows; with ``divergent`` every column is a
    permutation of the K slots instead, so that no two beams share a row
    (the case in which each query reads K*pos distinct cache rows)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

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


def _k1_call(fn, x, caches=None):
    sk, sv = caches if caches is not None else (_clone(x["self_k"]), _clone(x["self_v"]))
    return fn(x["layer"], x["pos_row"], x["q"], x["k_new"], x["v_new"], sk, sv, x["anc"])


def check_beam_attention(shapes=((1, 0), (1, 17), (1, 447), (8, 0), (8, 17), (8, 447))):
    """K1 against its plain version: the attention output within the bf16
    tolerance, and the caches: the target column of every slot holds the
    new K/V, every other element is untouched.  Returns the max abs error."""
    from faster_whisper_tpu_torch.ops.beam_attention import (
        beam_attend_append,
        beam_attend_append_ref,
    )

    worst = 0.0
    for (B, pos), divergent in ((shape, d) for shape in shapes for d in (False, True)):
        x = k1_inputs(B, pos, seed=B * 1000 + pos, divergent=divergent)
        ref, rk, rv = _k1_call(beam_attend_append_ref, x)
        out, ok, ov = _k1_call(beam_attend_append, x)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_REL_TOL * ref.float().abs().max().item()
        print(f"K1 B={B} K=5 ctx=448 pos={pos} {'divergent' if divergent else 'shared'} ancestry: "
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


def check_beam_attention_int8(shapes=((1, 0), (1, 17), (1, 447), (8, 0), (8, 17), (8, 447))):
    """K2 against its plain version: the attention output within the bf16
    tolerance; the codes written at the target column equal to the plain
    version's (up to one unit where a value lies on a rounding boundary,
    counted), the scales bit-equal, and nothing outside the target column
    moved.  Returns (max abs error, count of codes that differ)."""
    from faster_whisper_tpu_torch.ops.beam_attention import (
        beam_attend_append,
        beam_attend_append_ref,
    )

    worst, n_diff = 0.0, 0
    for (B, pos), divergent in ((shape, d) for shape in shapes for d in (False, True)):
        x = k2_inputs(B, pos, seed=B * 1000 + pos + 7, divergent=divergent)
        ref, rk, rv = _k1_call(beam_attend_append_ref, x)
        out, ok, ov = _k1_call(beam_attend_append, x)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_REL_TOL * ref.float().abs().max().item()
        code_diff = max(
            (a.q.int() - b.q.int()).abs().max().item() for a, b in ((ok, rk), (ov, rv))
        )
        n = sum(int((a.q != b.q).sum()) for a, b in ((ok, rk), (ov, rv)))
        print(f"K2 B={B} K=5 ctx=448 pos={pos} {'divergent' if divergent else 'shared'} ancestry: "
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


# ---------------------------------------------------------------------------
# K4: decode cross-attention, bf16 and int8 forms
# ---------------------------------------------------------------------------


def k4_inputs(B, quant, K=5, H=20, D=64, L=4, T=1500, seed=0):
    """A layer index, queries (B, H, K, D) and the stacked (L, B, H, T, D)
    cross caches: bf16, or int8 codes with bf16 scales (L, B, H, 1, T) as
    the int8 decode stores them."""
    from faster_whisper_tpu_torch.ops.quant import QuantKV, quantize_kv

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    q, ck, cv = randn(B, H, K, D), randn(L, B, H, T, D), randn(L, B, H, T, D)
    if quant:
        ck, cv = (
            QuantKV(c.q, c.s.to(torch.bfloat16)[:, :, :, None].contiguous())
            for c in (quantize_kv(ck), quantize_kv(cv))
        )
    return L - 1, q, ck, cv


def check_cross_attention(batches=(1, 8)):
    """K4, both forms, against its plain version; returns {form: max abs
    error}."""
    from faster_whisper_tpu_torch.ops.cross_attention import cross_attend, cross_attend_ref

    worst = {}
    for quant in (False, True):
        form = "int8" if quant else "bf16"
        for B in batches:
            args = k4_inputs(B, quant, seed=B + 10 * quant)
            ref = cross_attend_ref(*args)
            out = cross_attend(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = BF16_REL_TOL * ref.float().abs().max().item()
            print(f"K4 {form} B={B} K=5 T=1500: max|err| {err:.3e} (tolerance {tol:.3e})")
            if not err <= tol:
                raise AssertionError(f"K4 ({form}) disagrees with its plain version at B={B}")
            worst[form] = max(worst.get(form, 0.0), err)
    return worst


# ---------------------------------------------------------------------------
# K3: encoder flash attention
# ---------------------------------------------------------------------------


def k3_inputs(B, S=1500, H=20, D=64, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return [
        torch.randn((B, S, H, D), generator=g, device="cuda").to(torch.bfloat16)
        for _ in range(3)
    ]


def check_flash_attention(batches=(1, 8)):
    """K3 against its plain version (``mha``); returns the max abs error."""
    from faster_whisper_tpu_torch.ops.attention import mha, mha_flash

    worst = 0.0
    for B in batches:
        q, k, v = k3_inputs(B, seed=B)
        ref = mha(q, k, v)
        out = mha_flash(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = BF16_REL_TOL * ref.float().abs().max().item()
        print(f"K3 ({B},1500,20,64): max|err| {err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"K3 disagrees with its plain version at B={B}")
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


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_beam_attention(B=1, pos=447, K=5, H=20, D=64, quant=False):
    """K1, or K2 with ``quant``, on a divergent ancestry."""
    from faster_whisper_tpu_torch.ops.beam_attention import (
        beam_attend_append,
        beam_attend_append_ref,
    )

    x = (k2_inputs if quant else k1_inputs)(B, pos, divergent=True)
    caches = (x["self_k"], x["self_v"])  # rewritten in place with the same column
    ms = time_ms(lambda: _k1_call(beam_attend_append, x, caches))
    host_ms = call_ms(lambda: _k1_call(beam_attend_append, x, caches))
    plain_ms = time_ms(lambda: _k1_call(beam_attend_append_ref, x, caches), iters=5)
    n = pos + 1
    # Cache rows the step must read: the distinct (slot, column) pairs of
    # the columns before pos (column pos comes from k_new/v_new).
    seen = x["anc"][:, :, :pos].sort(dim=1).values
    rows = B * pos + int((seen[:, 1:] != seen[:, :-1]).sum()) if pos else 0
    row_bytes = D + 2 if quant else 2 * D  # int8 codes and a bf16 scale, or bf16
    nbytes = (
        rows * H * row_bytes * 2  # the visible K and V rows
        + B * K * n * 4  # ancestry
        + 4 * B * H * K * D * 2  # q, k_new, v_new and the output
        + 2 * B * H * K * row_bytes  # the two written columns
    )
    flops = 4 * B * H * K * n * D  # QK and PV, f32 FMA
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                call_ms=host_ms,
                shape=f"B={B} H={H} K={K} ctx=448 pos={pos} D={D}{' int8' if quant else ''}, "
                      f"divergent beams ({rows} distinct cache rows)")


def time_cross_attention(quant, B=1, K=5, H=20, D=64, T=1500):
    from faster_whisper_tpu_torch.ops.cross_attention import cross_attend, cross_attend_ref

    layer, q, ck, cv = k4_inputs(B, quant, K=K, H=H, D=D, T=T)
    ms = time_ms(lambda: cross_attend(layer, q, ck, cv))
    host_ms = call_ms(lambda: cross_attend(layer, q, ck, cv))
    plain_ms = time_ms(lambda: cross_attend_ref(layer, q, ck, cv), iters=5)
    library_ms = None
    if not quant:  # the same function in one PyTorch call (bf16 form only)
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, ck[layer], cv[layer])
        )
    cache_bytes = 2 * B * H * T * (D + 2) if quant else 2 * B * H * T * D * 2
    nbytes = cache_bytes + 2 * B * H * K * D * 2  # K/V (and scales), q and output
    flops = 4 * B * H * K * T * D  # QK and PV, f32 FMA
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                call_ms=host_ms, shape=f"B={B} H={H} K={K} T={T} D={D} {'int8' if quant else 'bf16'}")


def time_flash_attention(B=1, S=1500, H=20, D=64):
    from faster_whisper_tpu_torch.ops.attention import mha, mha_flash

    q, k, v = k3_inputs(B, S, H, D)
    ms = time_ms(lambda: mha_flash(q, k, v))
    host_ms = call_ms(lambda: mha_flash(q, k, v))
    plain_ms = time_ms(lambda: mha(q, k, v), iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    )
    nbytes = 4 * B * S * H * D * 2
    flops = 4 * B * H * S * S * D
    b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, call_ms=host_ms, shape=f"({B},{S},{H},{D})")


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

    # name -> (function, attribute)
    return dict(
        k1=(beam_attend_append, "launches"), k2=(beam_attend_append, "launches_int8"),
        k3=(mha_flash, "launches"), k4_bf16=(cross_attend, "launches"),
        k4_int8=(cross_attend, "launches_int8"), steps=(_gen_decoder_step, "calls"),
        encodes=(encode, "calls"),
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


def check_counts(counts, per_step, idle, cfg):
    """Every kernel in ``per_step`` launched n_text_layer times per decode
    step, K3 n_audio_layer times per encode, the kernels in ``idle`` never."""
    if counts["steps"] == 0 or counts["encodes"] == 0:
        raise AssertionError(f"the run decoded or encoded nothing: {counts}")
    for name in per_step:
        if counts[name] != cfg.n_text_layer * counts["steps"]:
            raise AssertionError(
                f"{name} launches {counts[name]} != {cfg.n_text_layer} x {counts['steps']} decode steps"
            )
    if counts["k3"] != cfg.n_audio_layer * counts["encodes"]:
        raise AssertionError(f"K3 launches {counts['k3']} != {cfg.n_audio_layer} x {counts['encodes']} encodes")
    for name in idle:
        if counts[name] != 0:
            raise AssertionError(f"{name} launched {counts[name]} times on the other compute type's path")


def run_main_path():
    """Requests a-c at bf16, then d-e at int8, on the same random weights;
    returns the counts of the two runs."""
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
    check_counts(bf16, per_step=("k1", "k4_bf16"), idle=("k2", "k4_int8"), cfg=cfg)
    del model

    t0 = time.perf_counter()
    model = WhisperModel.from_parts(params, cfg, tok, compute_type="int8")
    torch.cuda.synchronize()
    print(f"large-v3-turbo quantized to int8 on the card: {time.perf_counter() - t0:.3f} s")
    int8 = run_requests(model, [
        ("d: int8, 45 s, language detection, beam 5, temperature ladder, timestamps",
         long_clip, ladder),
        ("e: int8, 20 s, beam 1, temperature 0", short_clip, greedy),
    ], cfg.n_vocab)
    print(f"main path counts, int8 (d-e): {int8}")
    check_counts(int8, per_step=("k2", "k4_int8"), idle=("k1", "k4_bf16"), cfg=cfg)
    return bf16, int8


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


def check_small_model_against_cpu():
    """The card's path against the same weights in float32 on the CPU
    (plain versions) on a small input, at bf16 (K3 in the encoder) and at
    int8 (the card's int8 product, against ``int8_float32`` on the CPU):
    encoder states, and the language probabilities of the first decoder
    step, within the bf16 tolerance of their largest value."""
    from faster_whisper_tpu_torch.models.config import WhisperConfig
    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer, synthetic_vocab_size
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg = WhisperConfig(
        name="smoke-small", n_mels=128, n_audio_state=128, n_audio_head=2,
        n_audio_layer=2, n_vocab=synthetic_vocab_size(), n_text_state=128,
        n_text_head=2, n_text_layer=2, multilingual=True,
    )
    cpu = random_params(cfg, seed=5, dtype=torch.float32, device="cpu")
    tok = build_synthetic_tokenizer()
    audio = synth_audio(12.0, seed=3)
    for card_type, cpu_type in (("bfloat16", "float32"), ("int8", "int8_float32")):
        m_cpu = WhisperModel.from_parts(cpu, cfg, tok, compute_type=cpu_type, device="cpu")
        m_gpu = WhisperModel.from_parts(cpu, cfg, tok, compute_type=card_type, device="cuda")
        feats = m_cpu.feature_extractor(audio)[:, :3000]
        feats = np.pad(feats, ((0, 0), (0, 3000 - feats.shape[1])))
        x_cpu = m_cpu.encode(feats)
        x_gpu = m_gpu.encode(feats)
        err = (x_gpu.float().cpu() - x_cpu).abs().max().item()
        tol = 3 * BF16_REL_TOL * x_cpu.abs().max().item()
        print(f"small model encoder, card {card_type} vs CPU {cpu_type}: max|err| {err:.3e} "
              f"(tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"encoder on the card ({card_type}) disagrees with the CPU reference")
        p_cpu = dict(m_cpu.model.detect_language(x_cpu)[0])
        p_gpu = m_gpu.model.detect_language(x_gpu)[0]
        d = max(abs(p_cpu[k] - p) for k, p in p_gpu)
        top = max(p_cpu.values())
        tol = BF16_REL_TOL * top
        print(f"small model language probabilities, card {card_type} vs CPU {cpu_type}: max|diff| "
              f"{d:.3e} (tolerance {tol:.3e}; CPU probabilities span "
              f"{min(p_cpu.values()):.3e}..{top:.3e})")
        if not d <= tol:
            raise AssertionError(
                f"language probabilities on the card ({card_type}) disagree with the CPU reference"
            )


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
    k1_err = check_beam_attention()
    k2_err, k2_codes = check_beam_attention_int8()
    k3_err = check_flash_attention()
    k4_err = check_cross_attention()
    print(f"K2 codes that differ from the plain version's by one unit: {k2_codes}")
    phase("kernels against plain versions", t0)

    t0 = time.perf_counter()
    times = {
        "K1": time_beam_attention(),
        "K2": time_beam_attention(quant=True),
        "K3": time_flash_attention(),
        "K4 bf16": time_cross_attention(quant=False),
        "K4 int8": time_cross_attention(quant=True),
    }
    for label, t in times.items():
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"{label} {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {lib}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
              f"{t['call_ms']:.4f} ms per call from the host on {card}")
    k3_b8 = time_flash_attention(B=8)
    print(f"K3 {k3_b8['shape']}: kernel {k3_b8['ms']:.4f} ms, library {k3_b8['library_ms']:.4f} ms, "
          f"bound {k3_b8['bound_ms']:.4f} ms on {card}")
    k1_b5 = time_beam_attention(B=5, pos=223)
    print(f"K1 {k1_b5['shape']}: kernel {k1_b5['ms']:.4f} ms, bound {k1_b5['bound_ms']:.4f} ms on {card}")
    phase("times", t0)

    t0 = time.perf_counter()
    bf16, int8 = run_main_path()
    phase("main path", t0)
    t0 = time.perf_counter()
    check_small_model_against_cpu()
    phase("small model against the CPU", t0)

    def entry(name, label, source, replaces, launches, err):
        t = times[label]
        return dict(name=name, route="cuda", source=f"faster_whisper_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=launches, max_abs_err=err,
                    **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})

    kernels = [
        entry("beam_attend_append bf16 (K1)", "K1", "beam_attention.cu", K1_REPLACES,
              bf16["k1"], k1_err),
        entry("beam_attend_append int8 (K2)", "K2", "beam_attention.cu", K2_REPLACES,
              int8["k2"], k2_err),
        entry("mha_flash (K3)", "K3", "flash_attention.cu", K3_REPLACES,
              bf16["k3"] + int8["k3"], k3_err),
        entry("cross_attend bf16 (K4a)", "K4 bf16", "cross_attention.cu", K4A_REPLACES,
              bf16["k4_bf16"], k4_err["bf16"]),
        entry("cross_attend int8 (K4b, K4c)", "K4 int8", "cross_attention.cu", K4B_REPLACES,
              int8["k4_int8"], k4_err["int8"]),
    ]
    print(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
