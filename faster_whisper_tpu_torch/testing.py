"""Hermetic test and benchmark helpers.

The port runs tests and benchmarks without a network (no vocabulary
download) and without the ``tokenizers`` package.
``build_synthetic_tokenizer`` is a pure-Python byte-level tokenizer with the
same token ids as ``faster_whisper_tpu.testing.build_synthetic_tokenizer``:
the 256 GPT-2 byte symbols in code-point order, ``<unusedN>`` filler up to
``base_vocab``, then the Whisper specials in canonical order (eot, sot, 100
language tokens, translate/transcribe, sot_lm, sot_prev, no_speech,
no_timestamps, 1501 timestamps).  With no BPE merges every byte of the text
is one token, so encode and decode need no merge table.
"""

from typing import List, NamedTuple

from faster_whisper_tpu_torch.tokenizer import _LANGUAGE_CODES


def _bytes_to_unicode() -> dict:
    """GPT-2's reversible byte -> printable-character table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class Encoding(NamedTuple):
    ids: List[int]


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


class SyntheticTokenizer:
    """Byte-level tokenizer with the Whisper special-token layout.

    ``encode`` maps each UTF-8 byte of the text to its symbol's id (special
    tokens written inside the text are not parsed); ``decode`` drops special
    ids, maps byte symbols back to bytes and decodes UTF-8 with replacement
    characters, as the byte-level decoder of ``tokenizers`` does.
    """

    def __init__(self, n_timestamps: int = 1501, base_vocab: int = 256):
        byte_char = _bytes_to_unicode()
        alphabet = sorted(byte_char.values())
        self._vocab = {ch: i for i, ch in enumerate(alphabet)}
        char_byte = {c: b for b, c in byte_char.items()}
        self._id_to_byte = [char_byte[ch] for ch in alphabet]
        self._byte_to_id = [0] * 256
        for i, b in enumerate(self._id_to_byte):
            self._byte_to_id[b] = i
        self._pieces = {}  # id -> text of non-byte, non-special tokens
        for i in range(256, base_vocab):
            self._vocab[f"<unused{i}>"] = i
            self._pieces[i] = f"<unused{i}>"
        self._first_special = base_vocab
        for i, tok in enumerate(_special_tokens(n_timestamps)):
            self._vocab[tok] = base_vocab + i
        self._size = base_vocab + len(_special_tokens(n_timestamps))

    def get_vocab_size(self) -> int:
        return self._size

    def token_to_id(self, token: str):
        return self._vocab.get(token)

    def encode(self, text: str, add_special_tokens: bool = False) -> Encoding:
        return Encoding([self._byte_to_id[b] for b in text.encode("utf-8")])

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if i < 256:
                out.append(self._id_to_byte[i])
            elif i < self._first_special:
                out.extend(self._pieces[i].encode("utf-8"))
        return out.decode("utf-8", errors="replace")


def build_synthetic_tokenizer(n_timestamps: int = 1501, base_vocab: int = 256):
    """The synthetic tokenizer; ``base_vocab=50257`` gives the large-v3
    vocabulary size of 51866."""
    return SyntheticTokenizer(n_timestamps=n_timestamps, base_vocab=base_vocab)


def synthetic_vocab_size(n_timestamps: int = 1501, base_vocab: int = 256) -> int:
    return base_vocab + 2 + len(_LANGUAGE_CODES) + 6 + n_timestamps
