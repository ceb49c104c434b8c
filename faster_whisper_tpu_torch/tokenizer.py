"""Whisper tokenizer wrapper.

The port's own copy of ``faster_whisper_tpu/tokenizer.py``, so that the
port needs no ``tokenizers`` package.  It wraps any object with
``token_to_id(str)``, ``encode(text, add_special_tokens=False).ids`` and
``decode(ids)`` -- a ``tokenizers.Tokenizer`` or the pure-Python synthetic
tokenizer of ``testing.py`` -- and implements the Whisper special-token
layout: task/language tokens, ``timestamp_begin = no_timestamps + 1``,
decode filtering of special ids, 0.02 s timestamp steps, the non-speech
suppress set, and the unicode/space word splitting of word timestamps.
"""

import string

from functools import cached_property
from typing import List, Optional, Tuple

_TASKS = ("transcribe", "translate")

# The 100 languages of multilingual Whisper (v3 adds yue), in trained order.
_LANGUAGE_CODES = tuple(
    (
        "af am ar as az ba be bg bn bo br bs ca cs cy da de el en es et eu fa fi fo fr "
        "gl gu ha haw he hi hr ht hu hy id is it ja jw ka kk km kn ko la lb ln lo lt "
        "lv mg mi mk ml mn mr ms mt my ne nl nn no oc pa pl ps pt ro ru sa sd si sk sl "
        "sn so sq sr su sv sw ta te tg th tk tl tr tt uk ur uz vi yi yo zh yue"
    ).split()
)

# Languages written without spaces: their words split at unicode
# boundaries instead of spaces.
_NO_SPACE_LANGUAGES = frozenset({"zh", "ja", "th", "lo", "my", "yue"})


class Tokenizer:
    """Wraps a base tokenizer with the Whisper token layout."""

    def __init__(
        self,
        tokenizer,
        multilingual: bool,
        task: Optional[str] = None,
        language: Optional[str] = None,
    ):
        self.tokenizer = tokenizer

        if multilingual:
            if task not in _TASKS:
                raise ValueError(
                    "'%s' is not a valid task (accepted tasks: %s)"
                    % (task, ", ".join(_TASKS))
                )
            if language not in _LANGUAGE_CODES:
                raise ValueError(
                    "'%s' is not a valid language code (accepted language codes: %s)"
                    % (language, ", ".join(_LANGUAGE_CODES))
                )
            self.task = self.tokenizer.token_to_id("<|%s|>" % task)
            self.language = self.tokenizer.token_to_id("<|%s|>" % language)
            self.language_code = language
        else:
            self.task = None
            self.language = None
            self.language_code = "en"

    def _special(self, token: str) -> int:
        return self.tokenizer.token_to_id(token)

    @cached_property
    def transcribe(self) -> int:
        return self._special("<|transcribe|>")

    @cached_property
    def translate(self) -> int:
        return self._special("<|translate|>")

    @cached_property
    def sot(self) -> int:
        return self._special("<|startoftranscript|>")

    @cached_property
    def sot_lm(self) -> int:
        return self._special("<|startoflm|>")

    @cached_property
    def sot_prev(self) -> int:
        return self._special("<|startofprev|>")

    @cached_property
    def eot(self) -> int:
        return self._special("<|endoftext|>")

    @cached_property
    def no_timestamps(self) -> int:
        return self._special("<|notimestamps|>")

    @cached_property
    def no_speech(self) -> int:
        # Older vocabularies name this token <|nocaptions|>.
        token = self._special("<|nospeech|>")
        return token if token is not None else self._special("<|nocaptions|>")

    @property
    def timestamp_begin(self) -> int:
        return self.no_timestamps + 1

    @property
    def sot_sequence(self) -> List[int]:
        sequence = [self.sot]
        if self.language is not None:
            sequence.append(self.language)
        if self.task is not None:
            sequence.append(self.task)
        return sequence

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text, add_special_tokens=False).ids

    def decode(self, tokens: List[int]) -> str:
        # Specials (eot and above) are stripped before decoding.
        return self.tokenizer.decode([t for t in tokens if t < self.eot])

    def decode_with_timestamps(self, tokens: List[int]) -> str:
        """Decode, rendering timestamp tokens as <|t.tt|> markers (0.02 s
        per step); the base tokenizer drops the other specials."""
        parts: List[str] = []
        run: List[int] = []

        def flush():
            if run:
                parts.append(self.tokenizer.decode(run))
                run.clear()

        for token in tokens:
            if token >= self.timestamp_begin:
                flush()
                parts.append(f"<|{(token - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                run.append(token)
        flush()
        return "".join(parts)

    @cached_property
    def non_speech_tokens(self) -> Tuple[int]:
        """Token ids to suppress so the model avoids speaker tags and other
        non-speech annotations.  Keeps basic punctuation; bans
        bracketing/quoting symbols and music notes, plus word-initial
        hyphen/apostrophe."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        )

        # U+2640-U+267F misc symbols share their leading UTF-8 bytes, so
        # suppressing the first sub-token is safe even when multi-token.
        miscellaneous = set("♩♪♫♬♭♮♯")
        assert all(0x2640 <= ord(c) <= 0x267F for c in miscellaneous)

        # Allow hyphens and single quotes between words but not word-initial.
        result = {self.encode(" -")[0], self.encode(" '")[0]}
        for symbol in symbols + list(miscellaneous):
            for tokens in (self.encode(symbol), self.encode(" " + symbol)):
                if len(tokens) == 1 or symbol in miscellaneous:
                    result.add(tokens[0])

        return tuple(sorted(result))

    def split_to_word_tokens(self, tokens: List[int]) -> Tuple[List[str], List[List[int]]]:
        if self.language_code in _NO_SPACE_LANGUAGES:
            return self.split_tokens_on_unicode(tokens)
        return self.split_tokens_on_spaces(tokens)

    def split_tokens_on_unicode(self, tokens: List[int]) -> Tuple[List[str], List[List[int]]]:
        """Split at positions where the accumulated tokens decode to valid
        unicode: no dangling U+FFFD, unless the full decode holds one at
        the same offset."""
        decoded_full = self.decode_with_timestamps(tokens)
        replacement_char = "\ufffd"

        words: List[str] = []
        word_tokens: List[List[int]] = []
        current_tokens: List[int] = []
        unicode_offset = 0

        for token in tokens:
            current_tokens.append(token)
            decoded = self.decode_with_timestamps(current_tokens)

            rc_index = decoded.find(replacement_char)
            boundary_ok = rc_index == -1 or (
                rc_index + unicode_offset < len(decoded_full)
                and decoded_full[rc_index + unicode_offset] == replacement_char
            )
            if boundary_ok:
                words.append(decoded)
                word_tokens.append(current_tokens)
                current_tokens = []
                unicode_offset += len(decoded)

        return words, word_tokens

    def split_tokens_on_spaces(self, tokens: List[int]) -> Tuple[List[str], List[List[int]]]:
        """Merge the unicode-split subwords into space-delimited words,
        keeping specials and punctuation as entries of their own."""
        subwords, subword_tokens_list = self.split_tokens_on_unicode(tokens)
        words: List[str] = []
        word_tokens: List[List[int]] = []

        for subword, subword_tokens in zip(subwords, subword_tokens_list):
            is_special = subword_tokens[0] >= self.eot
            starts_new_word = (
                is_special
                or subword.startswith(" ")
                or subword.strip() in string.punctuation
                or not words
            )
            if starts_new_word:
                words.append(subword)
                word_tokens.append(subword_tokens)
            else:
                words[-1] += subword
                word_tokens[-1].extend(subword_tokens)

        return words, word_tokens
