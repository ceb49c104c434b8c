"""Hermetic test and benchmark helpers.

The port runs tests and benchmarks without a network (no vocabulary
download) and without the ``tokenizers``, ``safetensors`` or
``transformers`` packages.

``build_synthetic_tokenizer`` is a byte-level tokenizer with the same
token ids as ``faster_whisper_tpu.testing.build_synthetic_tokenizer``: the
256 GPT-2 byte symbols in code-point order, ``<unusedN>`` filler up to
``base_vocab``, then the Whisper specials in canonical order (eot, sot, 100
language tokens, translate/transcribe, sot_lm, sot_prev, no_speech,
no_timestamps, 1501 timestamps), as special added tokens.  It has no BPE
merges, so every byte of the text is one token.

``build_test_model`` is a random-weight micro ``WhisperModel``, the
acceptance gate's ``--mock`` model (``validate.py``).

The checkpoint writers build model directories from a parameter tree:
``write_ct2`` / ``serialize_ct2`` a CTranslate2 ``model.bin`` (float32,
float16, or int8 linear weights with per-row scales), ``tokenizer_json``
a ``tokenizer.json`` with the same layout plus BPE merges, and
``write_hf_dir`` an HF-named ``model.safetensors`` with its
``config.json`` and ``generation_config.json``.  Each is the inverse of
the port's loader (``models/load.py``, ``bpe.py``).
"""

import io
import json
import os
import struct

from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from faster_whisper_tpu_torch.bpe import BPETokenizer, bytes_to_unicode as _bytes_to_unicode
from faster_whisper_tpu_torch.tokenizer import _LANGUAGE_CODES


def _special_tokens(n_timestamps: int) -> List[str]:
    specials = ["<|endoftext|>", "<|startoftranscript|>"]
    specials += ["<|%s|>" % code for code in _LANGUAGE_CODES]
    specials += [
        "<|translate|>",
        "<|transcribe|>",
        "<|startoflm|>",
        "<|startofprev|>",
        "<|nospeech|>",
        "<|notimestamps|>",
    ]
    specials += ["<|%.2f|>" % (0.02 * i) for i in range(n_timestamps)]
    return specials


def build_synthetic_tokenizer(n_timestamps: int = 1501, base_vocab: int = 256):
    """The synthetic tokenizer: the ``tokenizer.json`` reader of ``bpe.py``
    over ``tokenizer_json`` without merges, so that every byte of the text
    is one token.  ``base_vocab=50257`` gives the large-v3 vocabulary size
    of 51866."""
    return BPETokenizer.from_str(tokenizer_json(base_vocab, n_timestamps=n_timestamps))


def synthetic_vocab_size(n_timestamps: int = 1501, base_vocab: int = 256) -> int:
    return base_vocab + 2 + len(_LANGUAGE_CODES) + 6 + n_timestamps


def build_test_model(seed: int = 0, dtype: str = "float32", device="cuda"):
    """A complete ``WhisperModel`` over the micro config
    (``models/config.py::tiny_test_config``) and the synthetic tokenizer,
    with random weights from ``seed`` (``models/load.py::random_params``)
    at ``dtype`` ("float32" or "bfloat16", also the compute type), on
    ``device`` (the card by default).  Its text is meaningless, but every
    stage of the pipeline runs as it would with released weights.  On the
    card the micro widths double to 128 (two heads of 64): the card's
    attention kernels take heads of 64 only."""
    import dataclasses

    import torch

    from faster_whisper_tpu_torch.models.config import tiny_test_config
    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.transcribe import WhisperModel
    from faster_whisper_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    config = tiny_test_config()
    if dev.type == "cuda":
        config = dataclasses.replace(config, n_audio_state=128, n_text_state=128)
    params = random_params(config, seed=seed, dtype=getattr(torch, dtype), device=dev)
    return WhisperModel.from_parts(
        params, config, build_synthetic_tokenizer(), compute_type=dtype, device=dev
    )


# ---------------------------------------------------------------------------
# tokenizer.json
# ---------------------------------------------------------------------------


def word_merges(words: Iterable[str]) -> List[Tuple[str, str]]:
    """BPE merges that make each word one token, left to right over its
    byte symbols (" the" -> ("Ġ", "t"), ("Ġt", "h"), ("Ġth", "e")); a
    merge already listed is not repeated."""
    byte_char = _bytes_to_unicode()
    merges, made = [], set()
    for word in words:
        symbols = [byte_char[b] for b in word.encode("utf-8")]
        left = symbols[0]
        for right in symbols[1:]:
            if left + right not in made:
                made.add(left + right)
                merges.append((left, right))
            left += right
    return merges


def tokenizer_json(
    base_vocab: int = 256,
    merges: Sequence[Tuple[str, str]] = (),
    n_timestamps: int = 1501,
    string_merges: bool = False,
) -> str:
    """A ``tokenizer.json`` with the synthetic tokenizer's layout: the 256
    byte symbols, then the result of each merge in order, ``<unusedN>``
    filler up to ``base_vocab``, and the Whisper specials as special added
    tokens.  ``base_vocab=50257`` gives large-v3's 51866 ids.  Merges are
    written as ``["a", "b"]`` pairs, or as ``"a b"`` strings (older files)
    with ``string_merges``."""
    alphabet = sorted(_bytes_to_unicode().values())
    vocab = {ch: i for i, ch in enumerate(alphabet)}
    for a, b in merges:
        if a not in vocab or b not in vocab:
            raise ValueError(f"merge {(a, b)} before its parts are in the vocabulary")
        vocab.setdefault(a + b, len(vocab))
    if len(vocab) > base_vocab:
        raise ValueError(f"{len(vocab)} tokens do not fit in base_vocab={base_vocab}")
    for i in range(len(vocab), base_vocab):
        vocab[f"<unused{i}>"] = i
    added = [
        {"id": base_vocab + k, "content": tok, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True}
        for k, tok in enumerate(_special_tokens(n_timestamps))
    ]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                  "use_regex": True}
    spec = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": added,
        "normalizer": None,
        "pre_tokenizer": byte_level,
        "post_processor": None,
        "decoder": dict(byte_level, add_prefix_space=True),
        "model": {
            "type": "BPE", "dropout": None, "unk_token": None,
            "continuing_subword_prefix": None, "end_of_word_suffix": None,
            "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
            "vocab": vocab,
            "merges": [f"{a} {b}" if string_merges else [a, b] for a, b in merges],
        },
    }
    return json.dumps(spec, ensure_ascii=False)


# ---------------------------------------------------------------------------
# CTranslate2 model.bin
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    """A float32 host copy of one tensor (torch, on any device, or numpy)."""
    if hasattr(t, "detach"):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def ct2_variables(params, config) -> Iterator[Tuple[str, np.ndarray]]:
    """(name, float32 array) of a parameter tree in CTranslate2's Whisper
    layout, one variable at a time, in the JAX package's order
    (``faster_whisper_tpu/testing.py::_ct2_variables``): the inverse of
    ``load_ct2_model``'s name mapping, with fused QKV and cross KV whose k
    bias is zero."""
    enc, dec = params["encoder"], params["decoder"]
    yield "encoder/conv1/weight", _np(enc["conv1_w"]).transpose(2, 1, 0)
    yield "encoder/conv1/bias", _np(enc["conv1_b"])
    yield "encoder/conv2/weight", _np(enc["conv2_w"]).transpose(2, 1, 0)
    yield "encoder/conv2/bias", _np(enc["conv2_b"])
    yield "encoder/position_encodings", _np(enc["pos_embed"])
    yield "encoder/layer_norm/gamma", _np(enc["ln_post_g"])
    yield "encoder/layer_norm/beta", _np(enc["ln_post_b"])

    def layer(tree, i):
        return {k: layer(v, i) if isinstance(v, dict) else _np(v[i]) for k, v in tree.items()}

    def fused_qkv(base, a):
        yield f"{base}/linear_0/weight", np.concatenate([a["wq"].T, a["wk"].T, a["wv"].T], axis=0)
        yield f"{base}/linear_0/bias", np.concatenate([a["bq"], np.zeros_like(a["bq"]), a["bv"]])
        yield f"{base}/linear_1/weight", a["wo"].T
        yield f"{base}/linear_1/bias", a["bo"]

    def ffn(base, ln_g, ln_b, m):
        yield f"{base}/layer_norm/gamma", ln_g
        yield f"{base}/layer_norm/beta", ln_b
        yield f"{base}/linear_0/weight", m["w1"].T
        yield f"{base}/linear_0/bias", m["b1"]
        yield f"{base}/linear_1/weight", m["w2"].T
        yield f"{base}/linear_1/bias", m["b2"]

    for i in range(config.n_audio_layer):
        L = layer(enc["layers"], i)
        base = f"encoder/layer_{i}"
        yield f"{base}/self_attention/layer_norm/gamma", L["ln1_g"]
        yield f"{base}/self_attention/layer_norm/beta", L["ln1_b"]
        yield from fused_qkv(f"{base}/self_attention", L["attn"])
        yield from ffn(f"{base}/ffn", L["ln2_g"], L["ln2_b"], L["mlp"])

    yield "decoder/embeddings/weight", _np(dec["token_embed"])
    yield "decoder/position_encodings", _np(dec["pos_embed"])
    yield "decoder/layer_norm/gamma", _np(dec["ln_g"])
    yield "decoder/layer_norm/beta", _np(dec["ln_b"])

    for i in range(config.n_text_layer):
        L = layer(dec["layers"], i)
        ca = L["cross_attn"]
        base = f"decoder/layer_{i}"
        yield f"{base}/self_attention/layer_norm/gamma", L["ln1_g"]
        yield f"{base}/self_attention/layer_norm/beta", L["ln1_b"]
        yield from fused_qkv(f"{base}/self_attention", L["self_attn"])
        yield f"{base}/attention/layer_norm/gamma", L["ln2_g"]
        yield f"{base}/attention/layer_norm/beta", L["ln2_b"]
        yield f"{base}/attention/linear_0/weight", ca["wq"].T
        yield f"{base}/attention/linear_0/bias", ca["bq"]
        yield f"{base}/attention/linear_1/weight", np.concatenate([ca["wk"].T, ca["wv"].T], axis=0)
        yield f"{base}/attention/linear_1/bias", np.concatenate([np.zeros_like(ca["bv"]), ca["bv"]])
        yield f"{base}/attention/linear_2/weight", ca["wo"].T
        yield f"{base}/attention/linear_2/bias", ca["bo"]
        yield from ffn(f"{base}/ffn", L["ln3_g"], L["ln3_b"], L["mlp"])


_CT2_TAGS = {"float32": 0, "int8": 1, "float16": 4}
# weights= -> (float type of the other variables, linear weights to int8)
_CT2_WEIGHTS = {
    "float32": (np.float32, False),
    "float16": (np.float16, False),
    "int8": (np.float32, True),
    "int8_float16": (np.float16, True),
}


def _ct2_write_string(f, s: str) -> None:
    raw = s.encode("utf-8")
    f.write(struct.pack("<H", len(raw) + 1) + raw + b"\x00")


def _ct2_write_var(f, name: str, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    _ct2_write_string(f, name)
    f.write(struct.pack("<B", arr.ndim))
    for d in arr.shape:
        f.write(struct.pack("<I", d))
    f.write(struct.pack("<BI", _CT2_TAGS[arr.dtype.name], arr.nbytes))
    f.write(arr.tobytes())


def _ct2_encode(name: str, arr: np.ndarray, weights: str):
    """The variables that ``weights`` stores for one float32 variable: an
    int8 linear weight with its ``weight_scale`` (scale = 127 / amax per
    output row, dequantized as q / scale), or the variable in the float
    type; the JAX package's ``serialize_ct2_int8`` arithmetic."""
    float_type, int8 = _CT2_WEIGHTS[weights]
    if int8 and name.endswith("/weight") and "linear_" in name and arr.ndim == 2:
        amax = np.maximum(np.abs(arr).max(axis=1), 1e-10)
        scale = 127.0 / amax
        yield name, np.clip(np.round(arr * scale[:, None]), -127, 127).astype(np.int8)
        yield name + "_scale", scale.astype(np.float32)
    else:
        yield name, arr.astype(float_type)


def write_ct2(f, params, config, weights: str = "float32") -> None:
    """Write a CTranslate2 ``model.bin`` (binary version 6, WhisperSpec
    revision 3) of ``params`` to the binary file object ``f``, one variable
    at a time.  ``weights``: "float32"; "float16", every variable float16 as
    the hub's faster-whisper checkpoints are; "int8", linear weights int8
    with a float32 ``weight_scale`` per output row and the rest float32;
    "int8_float16", the same with the rest float16."""
    if weights not in _CT2_WEIGHTS:
        raise ValueError(f"unknown CT2 weights {weights!r}: one of {sorted(_CT2_WEIGHTS)}")
    f.write(struct.pack("<I", 6))  # binary version
    _ct2_write_string(f, "WhisperSpec")
    f.write(struct.pack("<I", 3))  # spec revision
    count_at = f.tell()
    f.write(struct.pack("<I", 0))
    count = 0
    for name, arr in ct2_variables(params, config):
        for var_name, var in _ct2_encode(name, arr, weights):
            _ct2_write_var(f, var_name, var)
            count += 1
    end = f.tell()
    f.seek(count_at)
    f.write(struct.pack("<I", count))
    f.seek(end)


def serialize_ct2(params, config, weights: str = "float32") -> bytes:
    """``write_ct2`` into bytes (the ``files=`` loading mode)."""
    buf = io.BytesIO()
    write_ct2(buf, params, config, weights)
    return buf.getvalue()


def serialize_ct2_int8(params, config) -> bytes:
    """An int8 ``model.bin``, byte for byte the JAX package's
    ``serialize_ct2_int8`` of the same weights."""
    return serialize_ct2(params, config, "int8")


def preprocessor_config(config) -> dict:
    return {"chunk_length": 30, "feature_size": config.n_mels, "hop_length": 160,
            "n_fft": 400, "n_samples": 480000, "nb_max_frames": 3000, "sampling_rate": 16000}


def write_ct2_dir(model_dir: str, params, config, tokenizer: str, weights: str = "float16") -> None:
    """A CTranslate2 model directory: ``model.bin`` (``write_ct2``),
    ``config.json`` (``attention_heads`` and ``alignment_heads`` from the
    config), ``preprocessor_config.json`` and ``tokenizer.json`` (the
    text ``tokenizer``)."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "model.bin"), "wb") as f:
        write_ct2(f, params, config, weights)
    _write_json(model_dir, "config.json", {
        "alignment_heads": [list(h) for h in config.alignment_heads],
        "attention_heads": config.n_audio_head,
    })
    _write_json(model_dir, "preprocessor_config.json", preprocessor_config(config))
    with open(os.path.join(model_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        f.write(tokenizer)


def _write_json(model_dir: str, name: str, obj) -> None:
    with open(os.path.join(model_dir, name), "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2)


# ---------------------------------------------------------------------------
# HF safetensors
# ---------------------------------------------------------------------------


def hf_state_dict(params, config, dtype=np.float32) -> dict:
    """{name: array} of a parameter tree under the names of transformers'
    ``WhisperForConditionalGeneration`` (``model.`` prefix; linear weights
    (out, in), convolutions (out, in, k); ``proj_out`` is tied to the token
    embedding and left out, as ``save_pretrained`` leaves it)."""
    out = {}

    def put(name, arr):
        out["model." + name] = np.ascontiguousarray(arr).astype(dtype)

    def attn(base, a, i):
        for proj, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "o")):
            put(f"{base}.{proj}.weight", _np(a["w" + key][i]).T)
            if "b" + key in a:
                put(f"{base}.{proj}.bias", _np(a["b" + key][i]))

    def ln(base, g, b, i):
        put(f"{base}.weight", _np(g[i]))
        put(f"{base}.bias", _np(b[i]))

    def mlp(base, m, i):
        put(f"{base}.fc1.weight", _np(m["w1"][i]).T)
        put(f"{base}.fc1.bias", _np(m["b1"][i]))
        put(f"{base}.fc2.weight", _np(m["w2"][i]).T)
        put(f"{base}.fc2.bias", _np(m["b2"][i]))

    enc, dec = params["encoder"], params["decoder"]
    put("encoder.conv1.weight", _np(enc["conv1_w"]).transpose(2, 1, 0))
    put("encoder.conv1.bias", _np(enc["conv1_b"]))
    put("encoder.conv2.weight", _np(enc["conv2_w"]).transpose(2, 1, 0))
    put("encoder.conv2.bias", _np(enc["conv2_b"]))
    put("encoder.embed_positions.weight", _np(enc["pos_embed"]))
    L = enc["layers"]
    for i in range(config.n_audio_layer):
        base = f"encoder.layers.{i}"
        attn(f"{base}.self_attn", L["attn"], i)
        ln(f"{base}.self_attn_layer_norm", L["ln1_g"], L["ln1_b"], i)
        mlp(base, L["mlp"], i)
        ln(f"{base}.final_layer_norm", L["ln2_g"], L["ln2_b"], i)
    put("encoder.layer_norm.weight", _np(enc["ln_post_g"]))
    put("encoder.layer_norm.bias", _np(enc["ln_post_b"]))

    put("decoder.embed_tokens.weight", _np(dec["token_embed"]))
    put("decoder.embed_positions.weight", _np(dec["pos_embed"]))
    L = dec["layers"]
    for i in range(config.n_text_layer):
        base = f"decoder.layers.{i}"
        attn(f"{base}.self_attn", L["self_attn"], i)
        ln(f"{base}.self_attn_layer_norm", L["ln1_g"], L["ln1_b"], i)
        attn(f"{base}.encoder_attn", L["cross_attn"], i)
        ln(f"{base}.encoder_attn_layer_norm", L["ln2_g"], L["ln2_b"], i)
        mlp(base, L["mlp"], i)
        ln(f"{base}.final_layer_norm", L["ln3_g"], L["ln3_b"], i)
    put("decoder.layer_norm.weight", _np(dec["ln_g"]))
    put("decoder.layer_norm.bias", _np(dec["ln_b"]))
    return out


def write_hf_dir(model_dir: str, params, config, tokenizer: str, dtype=np.float32) -> None:
    """An HF-format Whisper directory: ``model.safetensors``
    (``hf_state_dict``), a transformers ``config.json``, a
    ``generation_config.json`` with the config's ``alignment_heads``,
    ``preprocessor_config.json`` and ``tokenizer.json``.  The token ids in
    the configs are those of the synthetic layout (eot right after the
    base vocabulary)."""
    from faster_whisper_tpu_torch.models.safetensors import save_file

    os.makedirs(model_dir, exist_ok=True)
    save_file(hf_state_dict(params, config, dtype), os.path.join(model_dir, "model.safetensors"),
              metadata={"format": "pt"})
    eot = config.n_vocab - synthetic_vocab_size(base_vocab=0)
    ids = {"bos_token_id": eot, "eos_token_id": eot, "pad_token_id": eot,
           "decoder_start_token_id": eot + 1}
    _write_json(model_dir, "config.json", {
        "architectures": ["WhisperForConditionalGeneration"],
        "model_type": "whisper",
        "activation_function": "gelu",
        "d_model": config.n_audio_state,
        "encoder_layers": config.n_audio_layer,
        "encoder_attention_heads": config.n_audio_head,
        "encoder_ffn_dim": 4 * config.n_audio_state,
        "decoder_layers": config.n_text_layer,
        "decoder_attention_heads": config.n_text_head,
        "decoder_ffn_dim": 4 * config.n_text_state,
        "num_mel_bins": config.n_mels,
        "vocab_size": config.n_vocab,
        "max_source_positions": config.n_audio_ctx,
        "max_target_positions": config.n_text_ctx,
        "scale_embedding": False,
        "tie_word_embeddings": True,
        "torch_dtype": np.dtype(dtype).name,
        **ids,
    })
    _write_json(model_dir, "generation_config.json", {
        "alignment_heads": [list(h) for h in config.alignment_heads], **ids,
    })
    _write_json(model_dir, "preprocessor_config.json", preprocessor_config(config))
    with open(os.path.join(model_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        f.write(tokenizer)
