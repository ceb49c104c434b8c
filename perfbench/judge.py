"""The comparison that decides ``correct``.

For each sampled request the reference works its windows out again from
the audio: the VAD, the chunks and each chunk's log-mel. It runs its
encoder on them and teacher-forces its decoder over each window's prompt
and the whole hypothesis the engine kept for it (every token it decoded,
also those that the segment rule drops after a cut; ``drivers.Capture``).
Four numbers follow, each the worst over the sampled windows:

* ``windows_differ``: windows that one side has and the other lacks (the
  chunks are the reference VAD's, found by their seek; a hypothesis per
  chunk), and windows whose segments are not the ones the segment rule
  (``reference/segments.py``) makes of the hypothesis: their tokens, start
  and end;
* ``score_gap``: |the hypothesis's log-probability as the program scored
  it - the reference's|, per token;
* ``rank_gap``: how far (in log-probability) a kept token lies below the
  reference's beam-th best non-eot token at its position: a beam search
  keeps a token only among the beam best extensions of its prefix;
* ``nospeech_gap``: |log of the program's no-speech probability - the
  reference's|, at the first decode position.

A control (``controls``: the reference at a precision below, put in the
program's place) is read by the same formulas at the same positions: its
log-probability of the same tokens is its score, the token it puts first
at a position is the token it keeps there, and its no-speech probability
is its own. ``correct`` holds either side's numbers to the limits.
"""

from typing import Dict, List

import numpy as np
import torch

from perfbench import inputs
from perfbench.reference import frontend, segments, whisper
from perfbench.reference.vocab import Vocab

TIME_TOL = 1e-6
NUMBERS = ("windows_differ", "score_gap", "rank_gap", "nospeech_gap")


def correct(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return numbers["windows"] > 0 and all(numbers[k] <= limit for k, limit in limits.items())


class Judge:
    def __init__(self, params: dict, dims: inputs.Dims, vocab_spec: dict, traffic: dict, silero: dict,
                 quant, controls=()):
        rd = whisper.Dims(dims.n_mels, dims.d, dims.heads, dims.enc_layers, dims.dec_layers, dims.vocab)
        self.ref = whisper.Whisper(params, rd, quant)
        self.controls = {q: whisper.Whisper(params, rd, q) for q in controls}
        self.dims, self.traffic, self.silero = dims, traffic, silero
        self.vocab = Vocab(vocab_spec)
        self.tsb = self.vocab.ids["<|0.00|>"]
        self.suppressed, self.blank = self.vocab.suppressed(), self.vocab.blank()
        self.beam = traffic["options"]["beam_size"]
        self.max_new = traffic["options"]["max_new_tokens"]
        self.length_penalty = traffic["options"].get("length_penalty", 1.0)
        self.batch = traffic["batch_size"]
        self.device = params["decoder"]["token_embed"].device

    # -- the windows of one request ----------------------------------------

    def _windows(self, req, out):
        """[(offset s, duration s, features, hypothesis)] of the windows both
        sides have, each checked against the segment rule."""
        audio = inputs.as_float(req.audio).astype(np.float64)
        spans = frontend.speech_timestamps(frontend.vad_probs(audio, self.silero), len(audio))
        chunk_spans = frontend.chunks(spans)
        tm = frontend.TimeMap(spans)
        # a hypothesis per chunk: each batch's rows in chunk order, past its
        # pow2 padding rows
        hyps = []
        for k, rows in enumerate(req.hypotheses):
            hyps += rows[: max(0, min(self.batch, len(chunk_spans) - k * self.batch))]
        out["windows_differ"] += abs(len(hyps) - len(chunk_spans))
        groups = {}
        for s in req.segments:
            groups.setdefault(s[0], []).append(s)
        windows, seeks = [], set()
        for group, (offset, duration), hyp in zip(chunk_spans, frontend.chunk_offsets(chunk_spans), hyps):
            seek = int(offset * 100)
            seeks.add(seek)
            expected = segments.split(hyp[0], self.tsb, offset, duration)
            if not self._same(expected, groups.get(seek, []), tm):
                out["windows_differ"] += 1
                continue
            chunk = np.concatenate([audio[s["start"] : s["end"]] for s in group])
            windows.append((offset, duration, frontend.chunk_log_mel(chunk, self.dims.n_mels), hyp))
        out["windows_differ"] += len(set(groups) - seeks)
        return windows

    @staticmethod
    def _same(expected, segs, tm) -> bool:
        """The program's segments of a window are the rule's: the same
        tokens, and times mapped back through the VAD's silences."""
        return len(expected) == len(segs) and all(
            list(e[2]) == list(s[3]) and abs(tm.original(e[0]) - s[1]) <= TIME_TOL
            and abs(tm.original(e[1], is_end=True) - s[2]) <= TIME_TOL
            for e, s in zip(expected, segs))

    # -- the numbers -------------------------------------------------------

    def judge(self, requests) -> Dict[str, float]:
        """The four numbers over ``requests``; with controls, also each
        control's, under ``control.<precision>.*``."""
        v = self.vocab
        out = dict.fromkeys(NUMBERS, 0.0)
        ctl = {q: dict.fromkeys(NUMBERS, 0.0) for q in self.controls}
        n_tokens = n_windows = n_cut = 0
        prompt = v.prompt()
        first = len(prompt) - 1
        for req in requests:
            for offset, duration, feats, (hyp, score, no_speech_prob) in self._windows(req, out):
                finished = len(hyp) < self.max_new
                tokens = prompt + hyp + ([v.eot] if finished else [])
                n = max(len(hyp), 1)
                mel = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
                lp, ns = self._read(self.ref, mel, tokens, len(prompt))
                total, rank = whisper.served_readings(lp, hyp, first, self.beam, v.eot, finished)
                program_total = score * len(hyp) ** self.length_penalty
                out["score_gap"] = max(out["score_gap"], abs(program_total - total) / n)
                out["rank_gap"] = max(out["rank_gap"], rank)
                out["nospeech_gap"] = max(out["nospeech_gap"],
                                          abs(float(np.log(max(no_speech_prob, 1e-300))) - ns))
                for q, model in self.controls.items():
                    lp_c, ns_c = self._read(model, mel, tokens, len(prompt))
                    total_c, _ = whisper.served_readings(lp_c, hyp, first, self.beam, v.eot, finished)
                    kept_c = whisper.first_tokens(lp_c, first, len(hyp), v.eot)
                    _, rank_c = whisper.served_readings(lp, kept_c, first, self.beam, v.eot, False)
                    c = ctl[q]
                    c["score_gap"] = max(c["score_gap"], abs(total_c - total) / n)
                    c["rank_gap"] = max(c["rank_gap"], rank_c)
                    c["nospeech_gap"] = max(c["nospeech_gap"], abs(ns_c - ns))
                n_tokens += len(hyp)
                n_windows += 1
                n_cut += len(segments.consecutive(hyp, self.tsb)) > 0
        out.update(windows=n_windows, cut_windows=n_cut, served_tokens=n_tokens)
        for q, c in ctl.items():
            c.update(windows=n_windows)
            out.update({f"control.{q}.{k}": x for k, x in c.items()})
        return out

    def _read(self, model, mel, tokens: List[int], n_prompt: int):
        """(masked log-probs of every position, log no-speech probability)."""
        v = self.vocab
        logits = model.logits(model.encode(mel), tokens, n_prompt)
        lp = whisper.masked_log_softmax(logits, self.suppressed, self.blank, n_prompt - 1)
        return lp, whisper.no_speech_logprob(logits[tokens.index(v.sot)], v.no_speech)
