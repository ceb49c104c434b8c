"""A byte-level BPE tokenizer read from a ``tokenizer.json``, in pure Python.

The port's reader of the vocabulary files that Whisper checkpoints ship
(HF and CTranslate2 directories alike), for machines without the
``tokenizers`` package.  It reproduces what ``tokenizers`` does with such a
file, step by step:

1. added tokens are matched in the raw text, leftmost-longest, first those
   with ``normalized: false`` and then the others, and become one id each;
2. each stretch of text between them is split by the GPT-2 pattern
   ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``,
   here a scanner over ``unicodedata`` categories: ``\\p{L}`` and
   ``\\p{N}`` are the L* and N* categories and ``\\s`` is Unicode
   White_Space (not ``str.isspace``, which also takes U+001C..U+001F);
3. each piece's UTF-8 bytes become GPT-2's printable byte symbols, and the
   merges are applied lowest rank first, the leftmost of equal ranks first,
   memoised per piece;
4. ``decode`` maps the symbols back to bytes and decodes UTF-8 with
   replacement characters, one run between added tokens at a time; added
   tokens are written as their text, or dropped when they are special.

Only what Whisper's files use is read: no normalizer, the ByteLevel
pre-tokenizer and decoder, a BPE model without dropout or affixes.  A file
that asks for more raises ``ValueError``.  ``model.merges`` may be ``"a b"``
strings (older files) or ``["a", "b"]`` pairs (``tokenizers`` >= 0.20).
"""

import bisect
import heapq
import json
import re
import unicodedata

from typing import Dict, List, NamedTuple, Optional, Tuple

# Unicode White_Space: what ``\s`` matches in the pattern above.
_WHITE_SPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
    "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000"
)
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
_CACHE_LIMIT = 10_000  # memoised pieces, as ``tokenizers`` keeps


def bytes_to_unicode() -> Dict[int, str]:
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


_BYTE_CHAR = bytes_to_unicode()
_CHAR_BYTE = {c: b for b, c in _BYTE_CHAR.items()}
_BYTE_SYMBOLS = [_BYTE_CHAR[b] for b in range(256)]


# Letters and numbers of Unicode 15.1 and 16.0, which the pattern's engine
# in ``tokenizers`` 0.22 knows and ``unicodedata`` before Python 3.13 calls
# unassigned (Cn): (first, last, class) code point ranges.
_NEWER_L_N = (
    (0x1C89, 0x1C8A, "L"),
    (0xA7CB, 0xA7CD, "L"),
    (0xA7DA, 0xA7DC, "L"),
    (0x105C0, 0x105F3, "L"),
    (0x10D40, 0x10D49, "N"),
    (0x10D4A, 0x10D65, "L"),
    (0x10D6F, 0x10D85, "L"),
    (0x10EC2, 0x10EC4, "L"),
    (0x11380, 0x11389, "L"),
    (0x1138B, 0x1138B, "L"),
    (0x1138E, 0x1138E, "L"),
    (0x11390, 0x113B5, "L"),
    (0x113B7, 0x113B7, "L"),
    (0x113D1, 0x113D1, "L"),
    (0x113D3, 0x113D3, "L"),
    (0x116D0, 0x116E3, "N"),
    (0x11BC0, 0x11BE0, "L"),
    (0x11BF0, 0x11BF9, "N"),
    (0x13460, 0x143FA, "L"),
    (0x16100, 0x1611D, "L"),
    (0x16130, 0x16139, "N"),
    (0x16D40, 0x16D6C, "L"),
    (0x16D70, 0x16D79, "N"),
    (0x18CFF, 0x18CFF, "L"),
    (0x1CCF0, 0x1CCF9, "N"),
    (0x1E5D0, 0x1E5ED, "L"),
    (0x1E5F0, 0x1E5F0, "L"),
    (0x1E5F1, 0x1E5FA, "N"),
    (0x2EBF0, 0x2EE5D, "L"),
)
_NEWER_STARTS = [r[0] for r in _NEWER_L_N]


def _char_class(c: str) -> str:
    """'L' letter, 'N' number, 'S' white space, 'O' anything else."""
    cat = unicodedata.category(c)
    if cat[0] in "LN":
        return cat[0]
    if cat == "Cn":
        k = bisect.bisect_right(_NEWER_STARTS, ord(c)) - 1
        if k >= 0 and ord(c) <= _NEWER_L_N[k][1]:
            return _NEWER_L_N[k][2]
    return "S" if c in _WHITE_SPACE else "O"


def split_words(text: str) -> List[str]:
    """The GPT-2 pattern's matches in ``text``, which cover all of it."""
    n = len(text)
    cls = [_char_class(c) for c in text]
    out = []
    i = 0
    while i < n:
        if text[i] == "'":  # 's|'t|'re|'ve|'m|'ll|'d
            for suffix in _CONTRACTIONS:
                if text.startswith(suffix, i + 1):
                    j = i + 1 + len(suffix)
                    out.append(text[i:j])
                    i = j
                    break
            else:
                suffix = None
            if suffix is not None:
                continue
        start, kind = i, cls[i]
        if text[i] == " " and i + 1 < n and cls[i + 1] != "S":
            # ' ?\p{L}+', ' ?\p{N}+' and ' ?[^\s\p{L}\p{N}]+' take the space
            i += 1
            kind = cls[i]
        j = i + 1
        while j < n and cls[j] == kind:
            j += 1
        if kind == "S" and j < n and j - 1 > i:
            j -= 1  # '\s+(?!\S)': the last space goes with the next piece
        out.append(text[start:j])
        i = j
    return out


class Encoding(NamedTuple):
    ids: List[int]
    tokens: List[str]


class _AddedToken(NamedTuple):
    id: int
    content: str
    special: bool
    lstrip: bool
    rstrip: bool
    normalized: bool


def _reject(what: str):
    raise ValueError(f"tokenizer.json: {what} is not supported by the pure-Python reader")


class BPETokenizer:
    """The subset of ``tokenizers.Tokenizer`` that Whisper needs:
    ``token_to_id``, ``id_to_token``, ``encode(text).ids``, ``decode(ids)``
    and ``get_vocab_size``, read from a ``tokenizer.json``."""

    def __init__(self, spec: dict):
        if spec.get("normalizer") is not None:
            _reject("a normalizer")
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") != "ByteLevel" or not pre.get("use_regex", True):
            _reject(f"the pre_tokenizer {pre!r}")
        self._add_prefix_space = bool(pre.get("add_prefix_space", False))
        decoder = spec.get("decoder") or {}
        if decoder.get("type") != "ByteLevel":
            _reject(f"the decoder {decoder!r}")
        self._post_processor = spec.get("post_processor")

        model = spec.get("model") or {}
        if model.get("type", "BPE") != "BPE":
            _reject(f"the model type {model.get('type')!r}")
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if model.get(key):
                _reject(f"model.{key}={model[key]!r}")
        if model.get("byte_fallback"):
            _reject("model.byte_fallback")
        self._ignore_merges = bool(model.get("ignore_merges", False))
        self._fuse_unk = bool(model.get("fuse_unk", False))

        self._vocab: Dict[str, int] = dict(model["vocab"])
        self._id_to_model_token = {i: t for t, i in self._vocab.items()}
        unk = model.get("unk_token")
        self._unk_id = self._vocab.get(unk) if unk is not None else None
        if unk is not None and self._unk_id is None:
            raise ValueError(f"tokenizer.json: unk_token {unk!r} is not in the vocabulary")

        # (left id, right id) -> (rank, merged id); a pair listed twice keeps
        # its later rank, as ``tokenizers`` builds its map
        self._merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, merge in enumerate(model.get("merges", [])):
            if isinstance(merge, str):
                parts = merge.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"tokenizer.json: malformed merge {merge!r}")
            else:
                parts = list(merge)
            a, b = parts
            try:
                key = (self._vocab[a], self._vocab[b])
                merged = self._vocab[a + b]
            except KeyError as e:
                raise ValueError(f"tokenizer.json: merge {merge!r} names {e} outside the vocabulary")
            self._merges[key] = (rank, merged)

        self._added: Dict[str, _AddedToken] = {}
        for tok in spec.get("added_tokens", []):
            if tok.get("single_word"):
                _reject(f"single_word on the added token {tok['content']!r}")
            self._added[tok["content"]] = _AddedToken(
                int(tok["id"]), tok["content"], bool(tok.get("special", False)),
                bool(tok.get("lstrip", False)), bool(tok.get("rstrip", False)),
                bool(tok.get("normalized", not tok.get("special", False))),
            )
        self._added_by_id = {t.id: t for t in self._added.values()}
        # leftmost-longest: at each position the alternation tries the
        # longest content first
        self._added_patterns = [
            self._pattern([t.content for t in self._added.values() if t.normalized == normalized])
            for normalized in (False, True)
        ]
        self._cache: Dict[str, List[int]] = {}

    @staticmethod
    def _pattern(contents: List[str]) -> Optional["re.Pattern"]:
        if not contents:
            return None
        contents = sorted(contents, key=len, reverse=True)
        return re.compile("|".join(map(re.escape, contents)))

    @classmethod
    def from_str(cls, text: str) -> "BPETokenizer":
        return cls(json.loads(text))

    @classmethod
    def from_buffer(cls, data: bytes) -> "BPETokenizer":
        if isinstance(data, (bytes, bytearray, memoryview)):
            data = bytes(data).decode("utf-8")
        return cls.from_str(data)

    @classmethod
    def from_file(cls, path: str) -> "BPETokenizer":
        with open(path, "r", encoding="utf-8") as f:
            return cls(json.load(f))

    # ------------------------------------------------------------------

    def get_vocab_size(self, with_added_tokens: bool = True) -> int:
        if not with_added_tokens:
            return len(self._vocab)
        return len(self._vocab.keys() | self._added.keys())

    def token_to_id(self, token: str) -> Optional[int]:
        added = self._added.get(token)
        return added.id if added is not None else self._vocab.get(token)

    def id_to_token(self, i: int) -> Optional[str]:
        added = self._added_by_id.get(i)
        return added.content if added is not None else self._id_to_model_token.get(i)

    # ------------------------------------------------------------------

    def _split_added(self, text: str) -> List[Tuple[str, Optional[_AddedToken]]]:
        """(text, None) stretches and (content, token) matches, in order."""
        parts: List[Tuple[str, Optional[_AddedToken]]] = [(text, None)]
        for pattern in self._added_patterns:
            if pattern is None:
                continue
            out = []
            for piece, tok in parts:
                if tok is not None:
                    out.append((piece, tok))
                    continue
                pos = 0
                for m in pattern.finditer(piece):
                    added = self._added[m.group()]
                    start, stop = m.start(), m.end()
                    if added.lstrip:
                        while start > pos and piece[start - 1] in _WHITE_SPACE:
                            start -= 1
                    if added.rstrip:
                        while stop < len(piece) and piece[stop] in _WHITE_SPACE:
                            stop += 1
                    if start > pos:
                        out.append((piece[pos:start], None))
                    out.append((piece[start:stop], added))
                    pos = stop
                if pos < len(piece):
                    out.append((piece[pos:], None))
            parts = out
        return parts

    def _bpe(self, word: str) -> List[int]:
        """The merged ids of one pre-tokenized piece (byte symbols)."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        if self._ignore_merges and word in self._vocab:
            ids = [self._vocab[word]]
        else:
            ids = self._merge_word(word)
        if len(self._cache) >= _CACHE_LIMIT:
            self._cache.clear()
        self._cache[word] = ids
        return ids

    def _merge_word(self, word: str) -> List[int]:
        ids: List[int] = []
        for ch in word:
            i = self._vocab.get(ch)
            if i is None:
                if self._unk_id is None:
                    continue  # dropped, as ``tokenizers`` does without an unk token
                if self._fuse_unk and ids and ids[-1] == self._unk_id:
                    continue
                i = self._unk_id
            ids.append(i)
        n = len(ids)
        if n < 2:
            return ids
        # doubly linked symbols; a removed symbol has alive[pos] False
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        merges = self._merges
        heap = []
        for pos in range(n - 1):
            m = merges.get((ids[pos], ids[pos + 1]))
            if m is not None:
                heap.append((m[0], pos, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new_id:
                continue  # a stale entry: one of its symbols has merged since
            ids[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0:
                m = merges.get((ids[prv[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] < n:
                m = merges.get((new_id, ids[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [i for i, a in zip(ids, alive) if a]

    def encode(self, text: str, add_special_tokens: bool = False) -> Encoding:
        """Token ids of ``text``.  No post-processor runs: asking for one
        (``add_special_tokens`` on a file that has one) raises."""
        if add_special_tokens and self._post_processor is not None:
            _reject("add_special_tokens=True (the post_processor)")
        ids: List[int] = []
        for piece, added in self._split_added(text):
            if added is not None:
                ids.append(added.id)
                continue
            if self._add_prefix_space and not piece.startswith(" "):
                piece = " " + piece
            for word in split_words(piece):
                ids.extend(self._bpe("".join(_BYTE_SYMBOLS[b] for b in word.encode("utf-8"))))
        return Encoding(ids, [self.id_to_token(i) for i in ids])

    @staticmethod
    def _decode_symbols(tokens: List[str]) -> str:
        out = bytearray()
        for tok in tokens:
            raw = [_CHAR_BYTE.get(c) for c in tok]
            out.extend(tok.encode("utf-8") if None in raw else raw)
        return out.decode("utf-8", errors="replace")

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        """Text of ``ids``; unknown ids are skipped."""
        result: List[str] = []
        run: List[str] = []
        for i in ids:
            i = int(i)
            added = self._added_by_id.get(i)
            if added is not None:
                if skip_special_tokens and added.special:
                    continue
                result.append(self._decode_symbols(run))
                result.append(added.content)
                run = []
                continue
            tok = self._id_to_model_token.get(i)
            if tok is not None:
                run.append(tok)
        result.append(self._decode_symbols(run))
        return "".join(result)
