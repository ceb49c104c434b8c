"""Token ids, prompts and the suppression rule of a byte-level Whisper
vocabulary, read from its ``tokenizer.json`` (a dict).

The rules are Whisper's (openai/whisper ``tokenizer.py``, as faster-whisper
applies them): the suppressed set is the non-speech symbols plus the task,
start and no-speech tokens; blank suppression at the first sampled position
bans " " and end-of-text. The vocabulary has no merges, so a text is one
token per UTF-8 byte.
"""

from typing import Dict, List


def byte_chars() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable-character table."""
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


class Vocab:
    def __init__(self, spec: dict):
        if spec["model"].get("merges"):
            raise ValueError("the reference reads a vocabulary without merges")
        self.ids = dict(spec["model"]["vocab"])
        for tok in spec["added_tokens"]:
            self.ids[tok["content"]] = tok["id"]
        self.size = max(self.ids.values()) + 1
        self._byte = byte_chars()
        i = self.ids
        self.eot = i["<|endoftext|>"]
        self.sot = i["<|startoftranscript|>"]
        self.sot_prev = i["<|startofprev|>"]
        self.sot_lm = i["<|startoflm|>"]
        self.no_speech = i["<|nospeech|>"]
        self.no_timestamps = i["<|notimestamps|>"]
        self.transcribe = i["<|transcribe|>"]
        self.translate = i["<|translate|>"]

    def encode(self, text: str) -> List[int]:
        return [self.ids[self._byte[b]] for b in text.encode("utf-8")]

    def non_speech(self) -> List[int]:
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        misc = set("♩♪♫♬♭♮♯")
        out = {self.encode(" -")[0], self.encode(" '")[0]}
        for symbol in symbols + sorted(misc):
            for tokens in (self.encode(symbol), self.encode(" " + symbol)):
                if len(tokens) == 1 or symbol in misc:
                    out.add(tokens[0])
        return sorted(out)

    def suppressed(self) -> List[int]:
        """``suppress_tokens=[-1]``: the non-speech symbols and the specials."""
        extra = [self.transcribe, self.translate, self.sot, self.sot_prev, self.sot_lm, self.no_speech]
        return sorted(set(self.non_speech()) | set(extra))

    def blank(self) -> List[int]:
        """Banned at the first sampled position (``suppress_blank``)."""
        return self.encode(" ") + [self.eot]

    def prompt(self, language: str = "en") -> List[int]:
        """The batched pipeline's prompt: <|startoftranscript|>, the
        language, <|transcribe|>, <|notimestamps|>."""
        return [self.sot, self.ids[f"<|{language}|>"], self.transcribe, self.no_timestamps]
