"""Whisper architecture configurations.

The port's own copy of ``faster_whisper_tpu/models/config.py``: every size
of the registry (tiny..large-v3, the distil family, large-v3-turbo), with
the published dimension tables (conv stem stride 2 -> 1500 audio states,
decoder context 448).
"""

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class WhisperConfig:
    name: str = "tiny"
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4
    # (layer, head) pairs of cross-attention heads that track time
    # alignment (word timestamps), read from checkpoints.
    alignment_heads: Tuple[Tuple[int, int], ...] = ()
    # None -> infer from the vocabulary size (multilingual vocabs are
    # >= 51865); tests override.
    multilingual: Optional[bool] = None

    @property
    def is_multilingual(self) -> bool:
        if self.multilingual is not None:
            return self.multilingual
        return self.n_vocab >= 51865

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


def _cfg(name, state, head, layer, dec_layer=None, n_mels=80, n_vocab=51865):
    return WhisperConfig(
        name=name,
        n_mels=n_mels,
        n_audio_state=state,
        n_audio_head=head,
        n_audio_layer=layer,
        n_text_state=state,
        n_text_head=head,
        n_text_layer=dec_layer if dec_layer is not None else layer,
        n_vocab=n_vocab,
    )


# English-only vocab is 51864; multilingual v1/v2 51865; v3 adds yue -> 51866.
CONFIGS = {
    "tiny.en": _cfg("tiny.en", 384, 6, 4, n_vocab=51864),
    "tiny": _cfg("tiny", 384, 6, 4),
    "base.en": _cfg("base.en", 512, 8, 6, n_vocab=51864),
    "base": _cfg("base", 512, 8, 6),
    "small.en": _cfg("small.en", 768, 12, 12, n_vocab=51864),
    "small": _cfg("small", 768, 12, 12),
    "medium.en": _cfg("medium.en", 1024, 16, 24, n_vocab=51864),
    "medium": _cfg("medium", 1024, 16, 24),
    "large-v1": _cfg("large-v1", 1280, 20, 32),
    "large-v2": _cfg("large-v2", 1280, 20, 32),
    "large-v3": _cfg("large-v3", 1280, 20, 32, n_mels=128, n_vocab=51866),
    "large": _cfg("large", 1280, 20, 32, n_mels=128, n_vocab=51866),
    "distil-small.en": _cfg("distil-small.en", 768, 12, 12, dec_layer=4, n_vocab=51864),
    "distil-medium.en": _cfg(
        "distil-medium.en", 1024, 16, 24, dec_layer=2, n_vocab=51864
    ),
    "distil-large-v2": _cfg("distil-large-v2", 1280, 20, 32, dec_layer=2),
    "distil-large-v3": _cfg(
        "distil-large-v3", 1280, 20, 32, dec_layer=2, n_mels=128, n_vocab=51866
    ),
    "distil-large-v3.5": _cfg(
        "distil-large-v3.5", 1280, 20, 32, dec_layer=2, n_mels=128, n_vocab=51866
    ),
    "large-v3-turbo": _cfg(
        "large-v3-turbo", 1280, 20, 32, dec_layer=4, n_mels=128, n_vocab=51866
    ),
    "turbo": _cfg("turbo", 1280, 20, 32, dec_layer=4, n_mels=128, n_vocab=51866),
}


def config_from_dims(
    n_mels: int,
    n_audio_state: int,
    n_audio_head: int,
    n_audio_layer: int,
    n_text_state: int,
    n_text_head: int,
    n_text_layer: int,
    n_vocab: int,
    name: str = "custom",
    alignment_heads=(),
) -> WhisperConfig:
    """The config of a checkpoint, from the dimensions its weights and
    config file give; ``is_multilingual`` follows the vocabulary size."""
    return WhisperConfig(
        name=name,
        n_mels=n_mels,
        n_audio_state=n_audio_state,
        n_audio_head=n_audio_head,
        n_audio_layer=n_audio_layer,
        n_text_state=n_text_state,
        n_text_head=n_text_head,
        n_text_layer=n_text_layer,
        n_vocab=n_vocab,
        alignment_heads=tuple(tuple(int(x) for x in h) for h in alignment_heads),
    )


def tiny_test_config(
    n_vocab: Optional[int] = None, n_audio_ctx: int = 1500
) -> WhisperConfig:
    """A miniature config for hermetic tests: real structure, toy sizes."""
    from faster_whisper_tpu_torch.testing import synthetic_vocab_size

    return WhisperConfig(
        name="test-micro",
        n_mels=80,
        n_audio_ctx=n_audio_ctx,
        n_audio_state=64,
        n_audio_head=2,
        n_audio_layer=2,
        n_vocab=n_vocab if n_vocab is not None else synthetic_vocab_size(),
        n_text_ctx=448,
        n_text_state=64,
        n_text_head=2,
        n_text_layer=2,
        multilingual=True,
    )
