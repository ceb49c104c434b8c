"""The port's pure-Python ``tokenizer.json`` reader (``bpe.py``) against
``tokenizers`` on the same file.

The file is trained here with ``tokenizers``' ``BpeTrainer`` over a
ByteLevel pre-tokenizer on a fixed multilingual corpus, with the Whisper
specials added as special tokens and the timestamps as plain added tokens.
It is read once as saved (merges as ``["a", "b"]`` pairs) and once
rewritten with ``"a b"`` string merges, as older files have them.  Encode
ids and tokens, and decode strings with and without the specials, must be
equal on a fixed list of hard cases and on hypothesis text."""

import json
import time

import pytest

from hypothesis import given, settings, strategies as st
from tokenizers import AddedToken, Tokenizer, decoders, pre_tokenizers, trainers
from tokenizers.models import BPE

from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.tokenizer import Tokenizer as JaxWhisperTokenizer
from faster_whisper_tpu_torch import bpe
from faster_whisper_tpu_torch.bpe import BPETokenizer
from faster_whisper_tpu_torch.testing import (
    _special_tokens,
    build_synthetic_tokenizer,
    tokenizer_json,
    word_merges,
)
from faster_whisper_tpu_torch.tokenizer import Tokenizer as WhisperTokenizer

CORPUS = [
    "And so, my fellow Americans: ask not what your country can do for you, "
    "ask what you can do for your country.",
    "It's what we'll do; they've said I'm sure you'd agree, and they're right.",
    "日本語のテキストと中文文本，한국어 텍스트도 있습니다。",
    "ภาษาไทยไม่มีช่องว่างระหว่างคำ สวัสดีครับ",
    "emoji 😀🎉👍🏽 and flags 🇫🇷🇯🇵 mixed with text",
    "Ünïcödé façade naïve café Ελληνικά русский текст, ещё 12345 ٣٤٥ ½ Ⅻ",
    "  multiple   spaces\tand\ttabs\nand\n\nnewlines  ",
    "code: def f(x): return x**2 + 1  # comment <tag> [1, 2] {'a': 3}",
]

CASES = CORPUS + [
    "",
    " ",
    "    ",
    "a  b   c",
    "trailing spaces   ",
    "\n\n\n",
    "'s't're've'm'll'd 'S 'T",
    "don't won't can't I'll you're we've she'd",
    " \x1cb \x1d\x1e\x1f x\x1f",
    " \x85b \xa0b x\xa0\xa0y \u2003\u3000z \u200b\u2028\u2029",
    "<|endoftext|><|startoftranscript|><|en|><|transcribe|><|0.00|> hello<|1.00|>",
    "text<|en|>inside<|notimestamps|>words <|0.02|>",
    "<|endoftext|",
    "<|notatoken|>",
    "x" * 500,
    " the the the the",
    "🇫🇷" * 10,
    "\ud7ff\uffff\U0010ffff \U000e0001",
    "ᏣᎳᎩ ꓘ 𝔘𝔫𝔦𝔠𝔬𝔡𝔢 𝟘𝟙𝟚",
    "ⅠⅡⅢ ¹²³ ①②③",
    "a\u0301e\u0301 combining marks",
    "\u1c89\u1c8a new letters \U00016130\U00016139 \U0002ebf0",
    "\x00\x01\x7f\x80\x9f",
]


def _train():
    tok = Tokenizer(BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=2000,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False,
    )
    tok.train_from_iterator(CORPUS * 20, trainer)
    specials = [t for t in _special_tokens(1501) if not t.startswith("<|0") and "." not in t]
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False) for t in specials])
    timestamps = ["<|%.2f|>" % (0.02 * i) for i in range(1501)]
    tok.add_tokens([AddedToken(t, special=False, normalized=False) for t in timestamps])
    return tok


@pytest.fixture(scope="module")
def trained():
    return _train().to_str()


def _string_merges(text):
    spec = json.loads(text)
    spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]
    return json.dumps(spec)


@pytest.fixture(scope="module", params=["pair-merges", "string-merges"])
def pair(request, trained):
    text = trained if request.param == "pair-merges" else _string_merges(trained)
    if request.param == "pair-merges":
        assert isinstance(json.loads(text)["model"]["merges"][0], list)
    return Tokenizer.from_str(text), BPETokenizer.from_str(text)


def _assert_same(ref, port, text):
    want = ref.encode(text, add_special_tokens=False)
    got = port.encode(text)
    assert got.ids == want.ids, text
    assert got.tokens == want.tokens, text
    for skip in (True, False):
        assert port.decode(want.ids, skip_special_tokens=skip) == ref.decode(
            want.ids, skip_special_tokens=skip
        ), text


@pytest.mark.parametrize("case", range(len(CASES)))
def test_fixed_cases_match_tokenizers(pair, case):
    _assert_same(*pair, CASES[case])


def test_vocabulary_and_added_tokens_match(pair):
    ref, port = pair
    assert port.get_vocab_size() == ref.get_vocab_size() > 1501 + 256
    assert port.get_vocab_size(with_added_tokens=False) == ref.get_vocab_size(False)
    for token in ["<|endoftext|>", "<|en|>", "<|0.00|>", "<|30.00|>", "Ġ", "a", "<|nope|>"]:
        assert port.token_to_id(token) == ref.token_to_id(token), token
    for i in [0, 255, 256, ref.get_vocab_size() - 1, ref.get_vocab_size() + 3]:
        assert port.id_to_token(i) == ref.id_to_token(i), i


_TEXT = st.text(alphabet=st.characters(blacklist_categories=("Cs",)), max_size=80)
_PIECES = st.lists(
    st.one_of(_TEXT, st.sampled_from(["<|en|>", "<|endoftext|>", "<|0.00|>", " ", "'s", "  "])),
    max_size=6,
)


@pytest.fixture(scope="module")
def saved(trained):
    return Tokenizer.from_str(trained), BPETokenizer.from_str(trained)


@settings(max_examples=150, deadline=2000)
@given(pieces=_PIECES)
def test_hypothesis_text_matches_tokenizers(saved, pieces):
    _assert_same(*saved, "".join(pieces))


@settings(max_examples=150, deadline=2000)
@given(ids=st.lists(st.integers(min_value=0, max_value=4000), max_size=24))
def test_hypothesis_decode_matches_tokenizers(saved, ids):
    """Arbitrary ids, broken UTF-8 runs and unknown ids included."""
    ref, port = saved
    for skip in (True, False):
        assert port.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip)


def test_pattern_classes_match_tokenizers_over_the_code_points():
    """The scanner's letter, number and white-space classes against the
    ByteLevel pre-tokenizer's pattern: every code point of the Basic
    Multilingual Plane, every 7th above it, and every letter and number of
    Unicode 15.1 and 16.0."""
    pre = pre_tokenizers.ByteLevel(add_prefix_space=False)
    points = [c for c in range(0x10000) if not 0xD800 <= c < 0xE000]
    points += list(range(0x10000, 0x110000, 7))
    points += [c for lo, hi, _ in bpe._NEWER_L_N for c in range(lo, hi + 1)]

    def probe(c):
        c = chr(c)
        return "a" + c + "1" + c + "!" + c + " " + c + " " + c + c + "'s" + c + "\n"

    def port_pieces(text):
        return ["".join(bpe._BYTE_SYMBOLS[b] for b in w.encode()) for w in bpe.split_words(text)]

    bad = []
    for k in range(0, len(points), 2000):
        chunk = points[k : k + 2000]
        text = "".join(probe(c) for c in chunk)
        if port_pieces(text) != [p for p, _ in pre.pre_tokenize_str(text)]:
            bad += [
                hex(c) for c in chunk
                if port_pieces(probe(c)) != [p for p, _ in pre.pre_tokenize_str(probe(c))]
            ]
    assert not bad, bad[:20]


def test_merges_are_memoised_per_piece(trained, monkeypatch):
    """A 448-token prompt of repeated words merges each distinct piece once."""
    port = BPETokenizer.from_str(trained)
    calls = []
    merge_word = port._merge_word
    monkeypatch.setattr(port, "_merge_word", lambda w: calls.append(w) or merge_word(w))
    text = " ".join(CORPUS[0].split()[:8]) + " "
    text = text * 40
    t0 = time.perf_counter()
    ids = port.encode(text).ids
    seconds = time.perf_counter() - t0
    assert len(ids) >= 300
    assert len(calls) == len(set(calls)) <= 12, calls
    assert ids == Tokenizer.from_str(trained).encode(text, add_special_tokens=False).ids
    assert seconds < 5.0  # seconds, far above the milliseconds it takes


def test_the_whisper_wrapper_sees_the_same_layout(trained):
    """The port's Whisper ``Tokenizer`` over the reader against the JAX
    package's over ``tokenizers``: special ids, the sot sequence, the
    non-speech suppress set, encode and decode."""
    ref = JaxWhisperTokenizer(Tokenizer.from_str(trained), True, task="transcribe", language="de")
    port = WhisperTokenizer(BPETokenizer.from_str(trained), True, task="transcribe", language="de")
    for name in ("sot", "eot", "no_timestamps", "no_speech", "timestamp_begin", "sot_prev",
                 "sot_lm", "transcribe", "translate", "language"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.sot_sequence == ref.sot_sequence
    assert port.non_speech_tokens == ref.non_speech_tokens
    for text in CASES[:8]:
        ids = ref.encode(" " + text) + [ref.eot, ref.timestamp_begin]
        assert port.encode(" " + text) == ids[:-2]
        assert port.decode(ids) == ref.decode(ids)


@pytest.mark.parametrize("string_merges", [False, True], ids=["pair-merges", "string-merges"])
def test_written_tokenizer_json_reads_the_same_in_both(string_merges):
    """The port's ``tokenizer_json`` writer: ``tokenizers`` and the reader
    agree on it, and without merges (the port's synthetic tokenizer) its
    ids are the JAX package's synthetic tokenizer's."""
    merges = word_merges([" the", " and", " ask", " country", " what", " you", "ask"])
    text = tokenizer_json(512, merges, string_merges=string_merges)
    ref, port = Tokenizer.from_str(text), BPETokenizer.from_str(text)
    assert port.get_vocab_size() == ref.get_vocab_size() == 512 + 1609
    for case in CASES:
        _assert_same(ref, port, case)
    assert port.encode(" the country").ids == [ref.token_to_id("Ġthe"), ref.token_to_id("Ġcountry")]

    synthetic, jax_synthetic = build_synthetic_tokenizer(), jax_tokenizer()
    assert synthetic.get_vocab_size() == jax_synthetic.get_vocab_size() == 256 + 1609
    for case in CASES:
        ids = jax_synthetic.encode(case, add_special_tokens=False).ids
        assert synthetic.encode(case).ids == ids, case
        assert synthetic.decode(ids) == jax_synthetic.decode(ids), case
    for tok in _special_tokens(1501):
        assert synthetic.token_to_id(tok) == jax_synthetic.token_to_id(tok)


def test_unsupported_files_and_arguments_raise(trained, tmp_path):
    spec = json.loads(trained)
    path = tmp_path / "tokenizer.json"
    path.write_text(trained, encoding="utf-8")
    assert BPETokenizer.from_file(str(path)).encode("ask").ids == BPETokenizer.from_buffer(
        trained.encode("utf-8")
    ).encode("ask").ids
    for key, value in (("normalizer", {"type": "NFC"}), ("decoder", {"type": "WordPiece"}),
                       ("pre_tokenizer", {"type": "Whitespace"})):
        with pytest.raises(ValueError, match="not supported"):
            BPETokenizer(dict(spec, **{key: value}))
    with pytest.raises(ValueError, match="not supported"):
        BPETokenizer(dict(spec, model=dict(spec["model"], dropout=0.1)))
    bad = dict(spec, model=dict(spec["model"], merges=[["Ġ", "nope"]]))
    with pytest.raises(ValueError, match="outside the vocabulary"):
        BPETokenizer(bad)
    with_post = dict(spec, post_processor={"type": "TemplateProcessing"})
    with pytest.raises(ValueError, match="add_special_tokens"):
        BPETokenizer(with_post).encode("x", add_special_tokens=True)
