"""The inputs of a run, all made from ``--seed``: the weights, the
vocabulary and the audio. Both the program and the reference receive
exactly these.

* Weights: the published parameter layout (stacked layers, matmul weights
  stored (in, out)), random normal with std 0.02 for every weight matrix
  and embedding, biases 0, LayerNorm gains 1, the encoder's fixed
  sinusoids; drawn on the device from a ``torch.Generator`` seeded with
  the run's seed, one call per stacked leaf, in bfloat16.
* Vocabulary: a ``tokenizer.json`` of the published size, 51866: the 256
  byte symbols, ``<unusedN>`` filler up to 50257, then Whisper's specials
  in their canonical order (end-of-text, start, 100 languages, translate,
  transcribe, start-of-LM, start-of-previous, no-speech, no-timestamps,
  1501 timestamps). No merges: every byte of a text is one token.
* Audio: the frozen 11 s of speech (``speech/jfk_16k.s16``) tiled with
  gaps of silence and low noise (``compose``): every seed gets the same
  gap lengths and the same amount of speech, in its own order.
"""

import json
import os

from typing import Dict, NamedTuple, Sequence

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SR = 16000

_LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms cs ro da hu ta no "
    "th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn et mk br eu is hy ne mn bs kk sq sw "
    "gl mr pa si km sn yo so af oc ka be tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl "
    "mg as tt haw ln ha ba jw su yue"
).split()


class Dims(NamedTuple):
    n_mels: int
    d: int
    heads: int
    enc_layers: int
    dec_layers: int
    vocab: int
    audio_ctx: int
    text_ctx: int
    ffn: int


def dims_of(config: dict) -> Dims:
    """The sizes of a configuration file (Hugging Face names)."""
    return Dims(
        n_mels=config["num_mel_bins"], d=config["d_model"], heads=config["encoder_attention_heads"],
        enc_layers=config["encoder_layers"], dec_layers=config["decoder_layers"],
        vocab=config["vocab_size"], audio_ctx=config["max_source_positions"],
        text_ctx=config["max_target_positions"], ffn=config["encoder_ffn_dim"],
    )


# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------


def _byte_chars() -> Dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
    bs += list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def tokenizer_spec(vocab_size: int, n_timestamps: int = 1501) -> dict:
    """The synthetic ``tokenizer.json`` of ``vocab_size`` ids."""
    specials = ["<|endoftext|>", "<|startoftranscript|>"] + [f"<|{c}|>" for c in _LANGUAGES]
    specials += ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
                 "<|nospeech|>", "<|notimestamps|>"]
    specials += ["<|%.2f|>" % (0.02 * i) for i in range(n_timestamps)]
    base = vocab_size - len(specials)
    vocab = {ch: i for i, ch in enumerate(sorted(_byte_chars().values()))}
    for i in range(len(vocab), base):
        vocab[f"<unused{i}>"] = i
    added = [{"id": base + k, "content": tok, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True} for k, tok in enumerate(specials)]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": True}
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": None, "pre_tokenizer": byte_level, "post_processor": None,
        "decoder": dict(byte_level, add_prefix_space=True),
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab, "merges": []},
    }


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def param_shapes(dm: Dims) -> dict:
    """(shape, kind) of every leaf; kind: "w" random normal, "zero", "one",
    "sinusoid"."""
    d, le, ld, f = dm.d, dm.enc_layers, dm.dec_layers, dm.ffn

    def attn(L):
        return {"wq": ((L, d, d), "w"), "bq": ((L, d), "zero"), "wk": ((L, d, d), "w"),
                "wv": ((L, d, d), "w"), "bv": ((L, d), "zero"), "wo": ((L, d, d), "w"),
                "bo": ((L, d), "zero")}

    def mlp(L):
        return {"w1": ((L, d, f), "w"), "b1": ((L, f), "zero"), "w2": ((L, f, d), "w"),
                "b2": ((L, d), "zero")}

    def norms(L, names):
        out = {}
        for n in names:
            out[f"{n}_g"] = ((L, d), "one")
            out[f"{n}_b"] = ((L, d), "zero")
        return out

    return {
        "encoder": {
            "conv1_w": ((3, dm.n_mels, d), "w"), "conv1_b": ((d,), "zero"),
            "conv2_w": ((3, d, d), "w"), "conv2_b": ((d,), "zero"),
            "pos_embed": ((dm.audio_ctx, d), "sinusoid"),
            "layers": dict(norms(le, ("ln1", "ln2")), attn=attn(le), mlp=mlp(le)),
            "ln_post_g": ((d,), "one"), "ln_post_b": ((d,), "zero"),
        },
        "decoder": {
            "token_embed": ((dm.vocab, d), "w"), "pos_embed": ((dm.text_ctx, d), "w"),
            "layers": dict(norms(ld, ("ln1", "ln2", "ln3")), self_attn=attn(ld), cross_attn=attn(ld),
                           mlp=mlp(ld)),
            "ln_g": ((d,), "one"), "ln_b": ((d,), "zero"),
        },
    }


def sinusoids(length: int, channels: int) -> np.ndarray:
    inc = np.log(10000) / (channels // 2 - 1)
    scaled = np.arange(length)[:, None] * np.exp(-inc * np.arange(channels // 2))[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)


def draw_weights(dm: Dims, seed: int, device, dtype=None) -> dict:
    """The parameter tree from ``seed`` on ``device`` (bfloat16 unless
    ``dtype`` says otherwise). The same seed and device give the same bits."""
    import torch

    dtype = torch.bfloat16 if dtype is None else dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def make(tree):
        if isinstance(tree, dict):
            return {k: make(v) for k, v in tree.items()}
        shape, kind = tree
        if kind == "w":
            w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
            return w.mul_(0.02)
        if kind == "one":
            return torch.ones(shape, device=device, dtype=dtype)
        if kind == "zero":
            return torch.zeros(shape, device=device, dtype=dtype)
        return torch.as_tensor(sinusoids(*shape), device=device).to(dtype)

    return make(param_shapes(dm))


# ---------------------------------------------------------------------------
# Audio
# ---------------------------------------------------------------------------


def speech() -> np.ndarray:
    """The frozen speech: int16 samples at 16 kHz."""
    return np.fromfile(os.path.join(HERE, "speech", "jfk_16k.s16"), dtype="<i2")


def compose(seconds: float, rng: np.random.Generator, gap_s: Sequence[float], noise: float,
            offset_tiles: int = 0) -> np.ndarray:
    """``seconds`` of audio as int16: gap, speech, gap, speech, ... cut at
    the end. The gaps are evenly spaced over [gap_s[0], gap_s[1]] and put
    in an order that ``rng`` draws; every sample gets Gaussian noise of
    ``noise`` int16 steps. The same ``seconds`` give every seed the same
    gaps and speech, in its own order."""
    sp = speech()
    n = int(round(seconds * SR))
    tiles = int(np.ceil(n / (len(sp) + gap_s[0] * SR))) + 1
    gaps = np.linspace(gap_s[0], gap_s[1], tiles)
    rng.shuffle(gaps)
    parts = []
    for g in gaps:
        parts.append(np.zeros(int(round(g * SR)), np.int32))
        parts.append(sp.astype(np.int32))
    a = np.concatenate(parts)[:n]
    a = a + np.round(rng.normal(0.0, noise, n)).astype(np.int32)
    return np.clip(a, -32768, 32767).astype(np.int16)


def as_float(a: np.ndarray) -> np.ndarray:
    """int16 samples as the float32 the program is handed (exact)."""
    return a.astype(np.float32) / np.float32(32768.0)


def read_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)
