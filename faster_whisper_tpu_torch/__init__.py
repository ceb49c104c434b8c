"""faster-whisper-tpu on PyTorch and CUDA (NVIDIA Hopper).

The same import surface as ``faster_whisper_tpu``, ported to PyTorch.  Model
code runs on the card (``device="cuda"``) unless the caller asks for the
CPU.  Submodules load lazily so that importing the package is cheap.
"""

from faster_whisper_tpu_torch.version import __version__

__all__ = [
    "BatchedInferencePipeline",
    "WhisperModel",
    "decode_audio",
    "format_timestamp",
    "__version__",
]

_LAZY = {
    "BatchedInferencePipeline": ("faster_whisper_tpu_torch.transcribe", "BatchedInferencePipeline"),
    "WhisperModel": ("faster_whisper_tpu_torch.transcribe", "WhisperModel"),
    "decode_audio": ("faster_whisper_tpu_torch.audio", "decode_audio"),
    "format_timestamp": ("faster_whisper_tpu_torch.utils", "format_timestamp"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
