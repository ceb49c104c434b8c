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
   card, at the main path's shapes, in bfloat16;
4. times: each kernel, its plain version and, where one exists, the one
   PyTorch call that computes the same function, with CUDA events, beside
   the least time the card could take (its bound);
5. main path: ``WhisperModel.transcribe`` at large-v3-turbo width (random
   weights from a seed, the synthetic 51866-token vocabulary) on three
   requests, checks that the kernels carried it (K1 four times per decode
   step, K3 32 times per encode), and holds a small model on the card
   against the same model in float32 on the CPU.

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
K3_REPLACES = "faster_whisper_tpu/ops/attention.py:123"


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


def _k1_call(fn, x, caches=None):
    sk, sv = caches if caches is not None else (x["self_k"].clone(), x["self_v"].clone())
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
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after a warm-up; L2 stays warm between calls)."""
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


def time_beam_attention(B=1, pos=447, K=5, H=20, D=64):
    from faster_whisper_tpu_torch.ops.beam_attention import (
        beam_attend_append,
        beam_attend_append_ref,
    )

    x = k1_inputs(B, pos, divergent=True)
    caches = (x["self_k"], x["self_v"])  # rewritten in place with the same column
    ms = time_ms(lambda: _k1_call(beam_attend_append, x, caches))
    plain_ms = time_ms(lambda: _k1_call(beam_attend_append_ref, x, caches), iters=5)
    n = pos + 1
    # Cache rows the step must read: the distinct (slot, column) pairs of
    # the columns before pos (column pos comes from k_new/v_new).
    seen = x["anc"][:, :, :pos].sort(dim=1).values
    rows = B * pos + int((seen[:, 1:] != seen[:, :-1]).sum()) if pos else 0
    nbytes = (
        rows * H * D * 2 * 2  # the visible K and V rows
        + B * K * n * 4  # ancestry
        + 3 * B * H * K * D * 2  # q, k_new, v_new
        + 3 * B * H * K * D * 2  # output and the two written columns
    )
    flops = 4 * B * H * K * n * D  # QK and PV, f32 FMA
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=f"B={B} H={H} K={K} ctx=448 pos={pos} D={D}, divergent beams "
                      f"({rows} distinct cache rows)")


def time_flash_attention(B=1, S=1500, H=20, D=64):
    from faster_whisper_tpu_torch.ops.attention import mha, mha_flash

    q, k, v = k3_inputs(B, S, H, D)
    ms = time_ms(lambda: mha_flash(q, k, v))
    plain_ms = time_ms(lambda: mha(q, k, v), iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    )
    nbytes = 4 * B * S * H * D * 2
    flops = 4 * B * H * S * S * D
    b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, shape=f"({B},{S},{H},{D})")


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


def reset_counts():
    from faster_whisper_tpu_torch.generation.generate import _gen_decoder_step
    from faster_whisper_tpu_torch.models.model import encode
    from faster_whisper_tpu_torch.ops.attention import mha_flash
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append

    for f in (beam_attend_append, mha_flash):
        f.launches = 0
    for f in (_gen_decoder_step, encode):
        f.calls = 0


def read_counts():
    from faster_whisper_tpu_torch.generation.generate import _gen_decoder_step
    from faster_whisper_tpu_torch.models.model import encode
    from faster_whisper_tpu_torch.ops.attention import mha_flash
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append

    return dict(
        k1=beam_attend_append.launches, k3=mha_flash.launches,
        steps=_gen_decoder_step.calls, encodes=encode.calls,
    )


def run_main_path():
    from faster_whisper_tpu_torch.models.config import CONFIGS
    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg = CONFIGS["large-v3-turbo"]
    t0 = time.perf_counter()
    params = random_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    model = WhisperModel.from_parts(params, cfg, build_synthetic_tokenizer(base_vocab=50257))
    torch.cuda.synchronize()
    print(f"large-v3-turbo random weights on the card: {time.perf_counter() - t0:.3f} s, "
          f"vocab {cfg.n_vocab}")
    long_clip, short_clip = synth_audio(45.0, seed=1), synth_audio(20.0, seed=2)
    requests = [
        ("a: 45 s, language detection, beam 5, temperature ladder, timestamps",
         long_clip, dict(language=None, beam_size=5)),
        ("b: 45 s, en, beam 5, without timestamps",
         long_clip, dict(language="en", beam_size=5, without_timestamps=True)),
        ("c: 20 s, beam 1, temperature 0", short_clip, dict(beam_size=1, temperature=0.0)),
    ]

    reset_counts()
    for name, audio, kwargs in requests:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        segments, info = model.transcribe(audio, **kwargs)
        segments = list(segments)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_segments(segments, info, len(audio) / 16000, cfg.n_vocab)
        n_tokens = sum(len(s.tokens) for s in segments)
        print(f"request {name}: {len(segments)} segments, {n_tokens} tokens, "
              f"language {info.language}, {seconds:.3f} s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, counts so far {read_counts()}")
    counts = read_counts()
    print(f"main path counts: {counts}")
    if counts["steps"] == 0 or counts["k1"] != cfg.n_text_layer * counts["steps"]:
        raise AssertionError(f"K1 launches {counts['k1']} != {cfg.n_text_layer} x {counts['steps']} decode steps")
    if counts["encodes"] == 0 or counts["k3"] != cfg.n_audio_layer * counts["encodes"]:
        raise AssertionError(f"K3 launches {counts['k3']} != {cfg.n_audio_layer} x {counts['encodes']} encodes")
    return counts


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
    """The card's path (bf16, K3 in the encoder) against the same weights
    in float32 on the CPU (plain versions) on a small input: encoder
    states, and the language probabilities of the first decoder step,
    within the bf16 tolerance of their largest value."""
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
    m_cpu = WhisperModel.from_parts(cpu, cfg, tok, compute_type="float32", device="cpu")
    m_gpu = WhisperModel.from_parts(cpu, cfg, tok, compute_type="bfloat16", device="cuda")
    audio = synth_audio(12.0, seed=3)
    feats = m_cpu.feature_extractor(audio)[:, :3000]
    feats = np.pad(feats, ((0, 0), (0, 3000 - feats.shape[1])))
    x_cpu = m_cpu.encode(feats)
    x_gpu = m_gpu.encode(feats)
    err = (x_gpu.float().cpu() - x_cpu).abs().max().item()
    tol = 3 * BF16_REL_TOL * x_cpu.abs().max().item()
    print(f"small model encoder, card bf16 vs CPU f32: max|err| {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError("encoder on the card disagrees with the CPU reference")
    p_cpu = dict(m_cpu.model.detect_language(x_cpu)[0])
    p_gpu = m_gpu.model.detect_language(x_gpu)[0]
    d = max(abs(p_cpu[k] - p) for k, p in p_gpu)
    top = max(p_cpu.values())
    tol = BF16_REL_TOL * top
    print(f"small model language probabilities, card vs CPU: max|diff| {d:.3e} "
          f"(tolerance {tol:.3e}; CPU probabilities span {min(p_cpu.values()):.3e}..{top:.3e})")
    if not d <= tol:
        raise AssertionError("language probabilities on the card disagree with the CPU reference")


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
    k3_err = check_flash_attention()
    phase("kernels against plain versions", t0)

    t0 = time.perf_counter()
    k1_t = time_beam_attention()
    k3_t = time_flash_attention()
    for label, t in (("K1", k1_t), ("K3", k3_t)):
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        print(f"{label} {t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library {lib}, bound {t['bound_ms']:.4f} ms ({t['bound_by']}) on {card}")
    k3_b8 = time_flash_attention(B=8)
    print(f"K3 {k3_b8['shape']}: kernel {k3_b8['ms']:.4f} ms, library {k3_b8['library_ms']:.4f} ms, "
          f"bound {k3_b8['bound_ms']:.4f} ms on {card}")
    k1_b5 = time_beam_attention(B=5, pos=223)
    print(f"K1 {k1_b5['shape']}: kernel {k1_b5['ms']:.4f} ms, bound {k1_b5['bound_ms']:.4f} ms on {card}")
    phase("times", t0)

    t0 = time.perf_counter()
    counts = run_main_path()
    check_small_model_against_cpu()
    phase("main path", t0)

    kernels = [
        dict(name="beam_attend_append (K1)", route="cuda",
             source="faster_whisper_tpu_torch/csrc/beam_attention.cu",
             replaces=K1_REPLACES, launches=counts["k1"], max_abs_err=k1_err,
             **{k: k1_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="mha_flash (K3)", route="cuda",
             source="faster_whisper_tpu_torch/csrc/flash_attention.cu",
             replaces=K3_REPLACES, launches=counts["k3"], max_abs_err=k3_err,
             **{k: k3_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
    ]
    print(f"[phase] total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
