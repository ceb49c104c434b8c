"""WhisperEngine: the device-side inference surface.

Counterpart of ``faster_whisper_tpu/models/engine.py``: the
``ctranslate2.models.Whisper`` surface that the policy layer
(``transcribe.py``) drives -- ``encode``, ``generate`` and
``detect_language`` plus ``is_multilingual``/``n_mels``.  Alignment (word
timestamps) is not ported yet.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from faster_whisper_tpu_torch.generation.generate import (
    WhisperGenerationResult,
    generate_collect,
    generate_dispatch,
)
from faster_whisper_tpu_torch.generation.processors import TokenMeta
from faster_whisper_tpu_torch.models import model as M
from faster_whisper_tpu_torch.models.config import WhisperConfig
from faster_whisper_tpu_torch.tokenizer import _LANGUAGE_CODES


def resolve_token_ids(hf_tokenizer) -> dict:
    """The Whisper special-token layout of a base tokenizer."""

    def tid(tok):
        return hf_tokenizer.token_to_id(tok)

    eot = tid("<|endoftext|>")
    no_timestamps = tid("<|notimestamps|>")
    no_speech = tid("<|nospeech|>")
    if no_speech is None:
        no_speech = tid("<|nocaptions|>")
    languages = []
    for code in _LANGUAGE_CODES:
        t = tid("<|%s|>" % code)
        if t is not None:
            languages.append((code, t))
    blank = hf_tokenizer.encode(" ", add_special_tokens=False).ids
    return {
        "eot": eot,
        "sot": tid("<|startoftranscript|>"),
        "no_timestamps": no_timestamps,
        "timestamp_begin": no_timestamps + 1,
        "no_speech": no_speech if no_speech is not None else eot,
        "blank": blank,
        "languages": languages,
    }


class WhisperEngine:
    """Device-side Whisper inference engine on the parameters' device."""

    def __init__(
        self,
        params,
        config: WhisperConfig,
        hf_tokenizer=None,
        token_ids: Optional[dict] = None,
        kv_int8: bool = False,
    ):
        """``kv_int8`` decodes over int8 self and cross KV caches (the int8
        compute types; ``params`` is then an int8 tree from
        ``ops/quant.py::quantize_params``)."""
        self.params = params
        self.kv_int8 = kv_int8
        self.config = config
        self.device = params["decoder"]["token_embed"].device
        if token_ids is None:
            token_ids = resolve_token_ids(hf_tokenizer)
        self.meta = TokenMeta(
            eot=token_ids["eot"],
            timestamp_begin=token_ids["timestamp_begin"],
            no_timestamps=token_ids["no_timestamps"],
            no_speech=token_ids["no_speech"],
            blank=tuple(token_ids["blank"]),
            vocab_size=config.n_vocab,
        )
        self.sot_id = token_ids["sot"]
        # [(code, token_id)] for language detection
        self.language_tokens: List[Tuple[str, int]] = token_ids["languages"]

    @property
    def is_multilingual(self) -> bool:
        return self.config.is_multilingual and bool(self.language_tokens)

    @property
    def n_mels(self) -> int:
        return self.config.n_mels

    def encode(self, features) -> torch.Tensor:
        """(B, n_mels, 3000) or (n_mels, 3000) mel, numpy or tensor ->
        encoder states (B, 1500, d) on the engine's device."""
        feats = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        if feats.dim() == 2:
            feats = feats[None]
        with torch.no_grad():
            return M.encode(self.params, self.config, feats)

    def generate(self, encoder_output, prompts, **kwargs) -> List[WhisperGenerationResult]:
        return generate_collect(self.generate_dispatch(encoder_output, prompts, **kwargs))

    @staticmethod
    def generate_collect(pending) -> List[WhisperGenerationResult]:
        """Unpack a ``generate_dispatch`` result on the host."""
        return generate_collect(pending)

    def generate_dispatch(
        self,
        encoder_output: torch.Tensor,
        prompts: Sequence[Sequence[int]],
        *,
        beam_size: int = 5,
        patience: float = 1.0,
        num_hypotheses: int = 1,
        length_penalty: float = 1.0,
        repetition_penalty: float = 1.0,
        no_repeat_ngram_size: int = 0,
        max_length: int = 448,
        suppress_blank: bool = True,
        suppress_tokens: Optional[Sequence[int]] = (),
        max_initial_timestamp_index: int = 50,
        sampling_temperature=1.0,  # float or per-row Sequence[float]
        sampling_topk: int = 1,
        rng_seed=None,
    ):
        """Run the decode; ``generate_collect`` unpacks the result.  As in
        CT2, the timestamp rules are active unless the prompt carries
        <|notimestamps|>."""
        prompts = [list(p) for p in prompts]
        return generate_dispatch(
            self.params,
            self.config,
            self.meta,
            encoder_output,
            prompts,
            sot_id=self.sot_id,
            beam_size=beam_size,
            patience=patience,
            length_penalty=length_penalty,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size,
            max_length=max_length,
            suppress_blank=suppress_blank,
            suppress_tokens=suppress_tokens,
            max_initial_timestamp_index=max_initial_timestamp_index,
            sampling_temperature=sampling_temperature,
            sampling_topk=sampling_topk,
            num_hypotheses=num_hypotheses,
            with_timestamps=self.meta.no_timestamps not in prompts[0],
            rng_seed=rng_seed,
            kv_int8=self.kv_int8,
        )

    def detect_language(self, encoder_output: torch.Tensor):
        """Per-row [(language token, probability)], most probable first."""
        b = encoder_output.shape[0]
        if not self.language_tokens:
            return [[("<|en|>", 1.0)] for _ in range(b)]
        dev = encoder_output.device
        with torch.no_grad():
            logits, _ = M.decoder_prefill(
                self.params,
                self.config,
                torch.full((b, 1), self.sot_id, dtype=torch.long, device=dev),
                torch.ones((b,), dtype=torch.long, device=dev),
                encoder_output,
                torch.zeros((b, 1), dtype=torch.long, device=dev),
                ctx=1,
            )
        lang_ids = np.array([tid for _, tid in self.language_tokens])
        lang_logits = logits[:, 0].cpu().numpy()[:, lang_ids]
        lang_logits = lang_logits - lang_logits.max(axis=-1, keepdims=True)
        probs = np.exp(lang_logits)
        probs /= probs.sum(axis=-1, keepdims=True)

        results = []
        for row in probs:
            order = np.argsort(-row)
            results.append(
                [("<|%s|>" % self.language_tokens[i][0], float(row[i])) for i in order]
            )
        return results
