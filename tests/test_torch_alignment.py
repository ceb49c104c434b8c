"""The port's word-alignment pieces against the JAX package's, and against
HF ``transformers``' own chain.

- The DTW: the port's numpy version and its native one (``csrc/dtw.cpp``,
  built here by ``g++``) against the JAX ``_dtw_path_numpy``, index for
  index, on random and tie-heavy cost matrices.
- The alignment pass ``_align_forward_post`` on the same weights and the
  same encoder states (numpy, from a seed), at float32 and at int8
  (the port's ``int8_float32`` against the JAX package's int8 on float32
  weights), at B=1 and B=3 (a pow2 dummy row), with ragged text lengths
  and content frames, median width 7 and 1, explicit and fallback heads.
  Probabilities within 1e-5 and the matrix within 1e-4: f32 sums over
  64-wide dot products and 1500-wide softmaxes in another order, then a
  division by a column's standard deviation over a few rows, which
  magnifies absolute error by ~10 (measured: 4e-9 and 6e-5).  At int8
  both packages quantize the same float32 activations with the same
  rounding, and no code differed on these inputs.
- ``align`` (the pass and the DTW) gives the JAX package's paths and
  probabilities; the device chain equals the host oracle
  ``alignment_matrix`` on the pass's own raw scores.
- The tokenizer's word splitting (spaces, and unicode for zh/ja) and
  ``decode_with_timestamps`` against the JAX tokenizer over ``tokenizers``
  on the same ``tokenizer.json``, on runs that cut multi-byte characters
  and runs with <|endoftext|> and timestamps; ``merge_punctuations``.
- HF ``transformers``' Whisper on a random checkpoint written with
  ``save_pretrained`` and read by the port's loader: its cross-attention
  weights through HF's ``_median_filter`` against the port's chain, its
  teacher-forced probabilities, and HF's ``_dynamic_time_warping`` against
  the native DTW on shared matrices.

The JAX side runs with FWT_CACHE_ARTIFACTS=/nonexistent."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import transformers  # noqa: F401  (at collection, before any test can stub onnxruntime)

from faster_whisper_tpu.models import engine as jengine
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.tokenizer import Tokenizer as JaxWhisperTokenizer
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu.transcribe import merge_punctuations as jax_merge_punctuations
from faster_whisper_tpu_torch import dtw
from faster_whisper_tpu_torch.bpe import BPETokenizer, bytes_to_unicode
from faster_whisper_tpu_torch.models import engine
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.load import load_model, params_from_jax
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer, tokenizer_json, word_merges
from faster_whisper_tpu_torch.tokenizer import Tokenizer
from faster_whisper_tpu_torch.transcribe import WhisperModel, merge_punctuations

PROB_TOL = 1e-5
MATRIX_TOL = 1e-4
_TOK = build_synthetic_tokenizer()
EOT = _TOK.token_to_id("<|endoftext|>")
# sot, en, transcribe: the sot sequence of an English transcription
SOT_SEQUENCE = [_TOK.token_to_id(t) for t in ("<|startoftranscript|>", "<|en|>", "<|transcribe|>")]
PREFIX = SOT_SEQUENCE + [_TOK.token_to_id("<|notimestamps|>")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (see
    test_torch_transcribe.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


# ---------------------------------------------------------------------------
# (a) the DTW
# ---------------------------------------------------------------------------


def _cost(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(2, 40)), int(rng.integers(2, 300))
    if kind == "random":
        return rng.standard_normal((n, m))
    if kind == "constant":
        return np.full((n, m), -0.5)
    if kind == "blocks":  # constant blocks: ties wherever two blocks meet
        rows = rng.integers(0, 3, n)[:, None]
        cols = rng.integers(0, 3, m)[None, :]
        return (rows * 3 + cols).astype(np.float64) / 4.0
    if kind == "repeated-rows":
        row = np.round(rng.standard_normal(m), 1)
        return np.repeat(row[None], n, axis=0)
    if kind == "rounded":  # few distinct values: ties everywhere
        return np.round(rng.standard_normal((n, m)), 0)
    if kind == "one-row":
        return rng.standard_normal((1, m))
    if kind == "one-column":
        return rng.standard_normal((n, 1))
    raise ValueError(kind)


@pytest.mark.parametrize(
    "kind", ["random", "constant", "blocks", "repeated-rows", "rounded", "one-row", "one-column"]
)
def test_dtw_native_and_numpy_match_jax(kind):
    for seed in range(6):
        cost = _cost(kind, seed)
        want_text, want_time = jengine._dtw_path_numpy(cost.copy())
        for got_text, got_time in (dtw._dtw_path_numpy(cost.copy()), dtw.dtw_path(cost.copy())):
            np.testing.assert_array_equal(got_text, want_text)
            np.testing.assert_array_equal(got_time, want_time)


# ---------------------------------------------------------------------------
# (b) the alignment pass
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    return jax_random_params(jax_config(), seed=0, dtype="float32")


@pytest.fixture(scope="module")
def engines(weights):
    """{compute: (JAX engine, port engine)} on the same float32 weights:
    float32, and int8 (the JAX package's int8 on float32 weights against
    the port's int8_float32)."""
    out = {}
    for compute, jax_type, port_type in (("float32", "float32", "float32"), ("int8", "int8", "int8_float32")):
        jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer(), compute_type=jax_type)
        pm = WhisperModel.from_parts(
            params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
            tiny_test_config(), build_synthetic_tokenizer(), compute_type=port_type, device="cpu",
        )
        out[compute] = (jm.model, pm.model)
    return out


def _pass_inputs(b: int, seed: int):
    """A token buffer of b rows (prefix, ragged text, eot, zero padding),
    the row starts, text rows and content frames, and encoder states."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((b, 64), np.int64)
    n_rows, t_frames = [], []
    for i in range(b):
        n_text = int(rng.integers(3, 20)) if i < b - 1 or b == 1 else 0  # B=3: a dummy row, no text
        seq = PREFIX + rng.integers(0, EOT, n_text).tolist() + [EOT]
        tokens[i, : len(seq)] = seq
        n_rows.append(n_text + 1)
        t_frames.append(int(rng.integers(40, 1500)))
    xa = rng.standard_normal((b, 1500, 64)).astype(np.float32)
    return tokens, len(PREFIX) - 1, np.array(n_rows), np.array(t_frames), xa


PASS_CASES = {
    "f32-b1-w7-explicit": ("float32", 1, 7, ((1, 0), (1, 1), (0, 1))),
    "f32-b3-w7-fallback": ("float32", 3, 7, None),
    "f32-b3-w1-explicit": ("float32", 3, 1, ((0, 0), (1, 1))),
    "int8-b3-w7-fallback": ("int8", 3, 7, None),
    "int8-b1-w1-explicit": ("int8", 1, 1, ((1, 0), (0, 1))),
}


@pytest.mark.parametrize("case", list(PASS_CASES), ids=list(PASS_CASES))
def test_align_forward_post_matches_jax(engines, case):
    compute, b, width, heads = PASS_CASES[case]
    jeng, peng = engines[compute]
    if heads is None:
        heads = peng._alignment_heads()
        assert heads == jeng._alignment_heads() == ((1, 0), (1, 1))
    tokens, start, n_rows, tfr, xa = _pass_inputs(b, seed=b * 10 + width)
    want_p, want_m = jengine._align_forward_post(
        jeng.params, jeng.config, heads, jnp.asarray(tokens, jnp.int32), jnp.asarray(xa),
        jnp.full((b,), start, jnp.int32), jnp.asarray(n_rows, jnp.int32), jnp.asarray(tfr, jnp.int32),
        eot=EOT, median_width=width,
    )
    want_p, want_m = np.asarray(want_p), np.asarray(want_m)
    with torch.no_grad():
        got_p, got_m = engine._align_forward_post(
            peng.params, peng.config, heads, torch.from_numpy(tokens), torch.from_numpy(xa),
            torch.full((b,), start), torch.from_numpy(n_rows), torch.from_numpy(tfr),
            eot=EOT, median_width=width,
        )
    got_p, got_m = got_p.numpy(), got_m.numpy()
    for i in range(b):
        rows = slice(start, start + n_rows[i])  # the text rows and the eot row
        cols = slice(0, tfr[i])  # columns past the content are never read
        np.testing.assert_allclose(got_p[i, start : start + n_rows[i] - 1],
                                   want_p[i, start : start + n_rows[i] - 1], atol=PROB_TOL, rtol=0)
        np.testing.assert_allclose(got_m[i, rows, cols], want_m[i, rows, cols], atol=MATRIX_TOL, rtol=0)


def test_align_paths_and_probabilities_match_jax(engines):
    """``align`` end to end at float32, a batch of 3 (bucketed to 4) with
    ragged texts and frames: equal DTW paths, probabilities within
    PROB_TOL."""
    jeng, peng = engines["float32"]
    rng = np.random.default_rng(7)
    xa = rng.standard_normal((3, 1500, 64)).astype(np.float32)
    texts = [rng.integers(0, EOT, n).tolist() for n in (5, 17, 0)]
    frames = [3000, 801, 2400]
    want = jeng.align(jnp.asarray(xa), SOT_SEQUENCE, texts, frames)
    got = peng.align(torch.from_numpy(xa), SOT_SEQUENCE, texts, frames)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.alignments == w.alignments
        np.testing.assert_allclose(g.text_token_probs, w.text_token_probs, atol=PROB_TOL, rtol=0)
    assert got[2].alignments == [] and got[0].alignments[-1] == (5, 1499)


@pytest.mark.parametrize("width", [7, 1])
def test_device_chain_matches_host_oracle(engines, width):
    """``_align_forward_post``'s matrix against ``alignment_matrix`` (the
    host's softmax, truncation, standardisation and scipy median filter)
    on the raw scores of ``_forward_with_alignment``, per item."""
    _, peng = engines["float32"]
    heads = peng._alignment_heads()
    tokens, start, n_rows, tfr, xa = _pass_inputs(3, seed=5)
    with torch.no_grad():
        _, matrix = engine._align_forward_post(
            peng.params, peng.config, heads, torch.from_numpy(tokens), torch.from_numpy(xa),
            torch.full((3,), start), torch.from_numpy(n_rows), torch.from_numpy(tfr),
            eot=EOT, median_width=width,
        )
        _, qk = engine._forward_with_alignment(
            peng.params, peng.config, heads, torch.from_numpy(tokens), torch.from_numpy(xa)
        )
    for i in range(3):
        want = engine.alignment_matrix(qk[i, :, start : start + n_rows[i]].numpy(), int(tfr[i]), width)
        np.testing.assert_allclose(
            matrix[i, start : start + n_rows[i], : tfr[i]].numpy(), want, atol=MATRIX_TOL, rtol=0
        )


# ---------------------------------------------------------------------------
# (c), (d) word splitting and punctuation
# ---------------------------------------------------------------------------

WORDS = (" hello", " world", " fellow", " Americans", "你好", "世界", "日本語", "テキスト", " ask")


@pytest.fixture(scope="module")
def tokenizers_pair():
    """The same tokenizer.json (merges for a few words, some of them
    multi-byte) through ``tokenizers`` and through the port's reader."""
    from tokenizers import Tokenizer as HFTokenizer

    text = tokenizer_json(1024, word_merges(WORDS))
    return HFTokenizer.from_str(text), BPETokenizer.from_str(text)


def _token_runs(hf, seed):
    """Runs of text tokens that cut multi-byte characters (byte tokens of
    CJK and emoji text in random slices), with eot and timestamps inside."""
    rng = np.random.default_rng(seed)
    base = hf.encode(
        " hello 你好世界。 日本語のテキスト, ask 😀 world! (fellow) Americans's 한국어",
        add_special_tokens=False,
    ).ids
    eot = hf.token_to_id("<|endoftext|>")
    ts = hf.token_to_id("<|0.00|>")
    runs = [base, base + [eot]]
    for _ in range(12):
        a, b = sorted(rng.integers(0, len(base), 2))
        run = base[a : b + 1]
        if rng.random() < 0.5:
            run = run + [eot]
        if rng.random() < 0.5:
            k = int(rng.integers(0, len(run) + 1))
            run = run[:k] + [ts + int(rng.integers(0, 1500))] + run[k:]
        runs.append(run)
    runs.append(rng.integers(0, 256, 30).tolist() + [eot])  # raw bytes
    return runs


@pytest.mark.parametrize("language", ["en", "zh", "ja"])
def test_split_to_word_tokens_matches_jax(tokenizers_pair, language):
    hf, port = tokenizers_pair
    ours = Tokenizer(port, True, task="transcribe", language=language)
    ref = JaxWhisperTokenizer(hf, True, task="transcribe", language=language)
    for run in _token_runs(hf, seed=len(language)):
        assert ours.decode_with_timestamps(run) == ref.decode_with_timestamps(run), run
        assert ours.split_to_word_tokens(run) == ref.split_to_word_tokens(run), run
    cut = hf.encode("你好", add_special_tokens=False).ids  # one merged token of six bytes
    assert len(cut) == 1


def test_replacement_characters_match_tokenizers(tokenizers_pair):
    """A byte run cut inside a multi-byte character decodes to the same
    U+FFFD run as ``tokenizers``' decode, with and without eot."""
    hf, port = tokenizers_pair
    byte_symbol = bytes_to_unicode()
    data = "你😀é한".encode("utf-8")
    eot = hf.token_to_id("<|endoftext|>")
    for a in range(len(data)):
        for b in range(a + 1, len(data) + 1):
            ids = [hf.token_to_id(byte_symbol[x]) for x in data[a:b]]
            for run in (ids, ids + [eot], [eot] + ids):
                assert port.decode(run) == hf.decode(run), (a, b)


@pytest.mark.parametrize(
    "words",
    [
        [" Hello", ",", " (", "world", ")", "."],
        [" \"", "quote", "\"", " ¿", "qué", "?"],
        [" a", " -", "b", "!", "!", " '", "c"],
        ["。", " x", "、", "y", "”"],
        [" ", "only", " "],
    ],
)
def test_merge_punctuations_matches_jax(words):
    alignment = [dict(word=w, tokens=[i], start=i * 0.1, end=i * 0.1 + 0.1) for i, w in enumerate(words)]
    ours = [dict(a, tokens=list(a["tokens"])) for a in alignment]
    ref = [dict(a, tokens=list(a["tokens"])) for a in alignment]
    prepend, append = "\"'“¿([{-", "\"'.。,，!！?？:：”)]}、"
    merge_punctuations(ours, prepend, append)
    jax_merge_punctuations(ref, prepend, append)
    assert ours == ref


# ---------------------------------------------------------------------------
# (f) HF transformers' chain
# ---------------------------------------------------------------------------

HF_VOCAB, HF_START, HF_EOT, HF_NO_TS = 1000, 3, 890, 900
HF_HEADS = ((0, 1), (1, 0), (1, 3))


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """A random HF Whisper saved as safetensors and read by the port."""
    from transformers import WhisperConfig as HFConfig, WhisperForConditionalGeneration

    cfg = HFConfig(
        vocab_size=HF_VOCAB, num_mel_bins=80, d_model=64, encoder_layers=2,
        encoder_attention_heads=4, decoder_layers=2, decoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_ffn_dim=128, max_source_positions=1500,
        max_target_positions=448, pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=HF_START, suppress_tokens=None, begin_suppress_tokens=None,
    )
    torch.manual_seed(1)
    cfg._attn_implementation = "eager"  # sdpa returns no attention weights
    hf = WhisperForConditionalGeneration(cfg).eval()
    model_dir = tmp_path_factory.mktemp("hf_align_ckpt")
    hf.save_pretrained(model_dir, safe_serialization=True)
    params, config = load_model(str(model_dir), dtype=torch.float32, device="cpu")
    config = dataclasses.replace(config, alignment_heads=HF_HEADS)
    token_ids = dict(eot=HF_EOT, timestamp_begin=HF_NO_TS + 1, no_timestamps=HF_NO_TS,
                     no_speech=4, blank=[5], sot=HF_START, languages=[])
    return hf, engine.WhisperEngine(params, config, token_ids=token_ids)


def _hf_chain(hf, mel, tokens, n_text, t_frames):
    """HF's cross-attentions of the heads, standardised, through HF's
    median filter; the probabilities over the text vocabulary."""
    from transformers.models.whisper.generation_whisper import _median_filter

    with torch.no_grad():
        out = hf(input_features=torch.from_numpy(mel), decoder_input_ids=torch.tensor([tokens]),
                 output_attentions=True)
    cross = torch.stack(out.cross_attentions)  # (L, B, H, S, T), softmaxed
    start = tokens.index(HF_NO_TS)
    w = torch.stack([cross[l, 0, h] for l, h in HF_HEADS])[:, start : start + n_text + 1, :t_frames].double()
    w = (w - w.mean(dim=-2, keepdim=True)) / (w.std(dim=-2, keepdim=True, unbiased=False) + 1e-9)
    matrix = _median_filter(w, 7).mean(dim=0).numpy()
    lp = torch.log_softmax(out.logits.float()[..., :HF_EOT], -1)[0]
    probs = [float(lp[start + i, t].exp()) for i, t in enumerate(tokens[start + 1 : start + 1 + n_text])]
    return matrix, probs


def test_alignment_chain_matches_hf(hf_checkpoint):
    """The port's matrix and probabilities against HF's chain on the same
    checkpoint, within MATRIX_TOL and PROB_TOL (measured: 1.4e-5 and
    7e-10), and ``align``'s DTW path equal to HF's DTW on HF's matrix."""
    from transformers.models.whisper.generation_whisper import _dynamic_time_warping

    hf, eng = hf_checkpoint
    rng = np.random.default_rng(0)
    for seed in range(4):
        mel = np.random.default_rng(200 + seed).standard_normal((1, 80, 3000)).astype(np.float32) * 0.5
        n_text = int(rng.integers(4, 12))
        text = [int(t) for t in rng.integers(10, 800, n_text)]
        num_frames = int(rng.integers(500, 3000))
        t_frames = max(1, num_frames // 2)
        tokens = [HF_START, HF_NO_TS] + text + [HF_EOT]
        want_matrix, want_probs = _hf_chain(hf, mel, tokens, n_text, t_frames)

        xa = eng.encode(mel)
        buf = torch.zeros((1, 64), dtype=torch.long)
        buf[0, : len(tokens)] = torch.tensor(tokens)
        with torch.no_grad():
            probs, matrix = engine._align_forward_post(
                eng.params, eng.config, HF_HEADS, buf, xa, torch.tensor([1]),
                torch.tensor([n_text + 1]), torch.tensor([t_frames]), eot=HF_EOT, median_width=7,
            )
        np.testing.assert_allclose(matrix[0, 1 : n_text + 2, :t_frames].numpy(), want_matrix,
                                   atol=MATRIX_TOL, rtol=0)
        np.testing.assert_allclose(probs[0, 1 : 1 + n_text].numpy(), want_probs, atol=PROB_TOL, rtol=0)
        res = eng.align(xa, [HF_START], [text], num_frames)[0]
        np.testing.assert_allclose(res.text_token_probs, want_probs, atol=PROB_TOL, rtol=0)
        want_text, want_time = _dynamic_time_warping(-want_matrix.astype(np.float64))
        assert res.alignments == list(zip(want_text.tolist(), want_time.tolist()))


def test_native_dtw_matches_hf():
    """The native DTW reproduces HF's backtrace exactly on shared matrices
    (tie-break compatibility)."""
    from transformers.models.whisper.generation_whisper import _dynamic_time_warping

    for seed in range(8):
        rng = np.random.default_rng(seed)
        n, m = int(rng.integers(3, 30)), int(rng.integers(10, 200))
        mat = rng.standard_normal((n, m))
        want_text, want_time = _dynamic_time_warping(mat.copy())
        got_text, got_time = dtw.dtw_path(mat.copy())
        np.testing.assert_array_equal(got_text, want_text)
        np.testing.assert_array_equal(got_time, want_time)
