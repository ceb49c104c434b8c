"""faster-whisper-tpu on PyTorch and CUDA (NVIDIA Hopper).

The same import surface as ``faster_whisper_tpu``, ported to PyTorch.  Model
code runs on the card (``device="cuda"``) unless the caller asks for the
CPU.  Submodules load lazily so that importing the package is cheap.
"""

from faster_whisper_tpu_torch.version import __version__

__all__ = [
    "available_models",
    "decode_audio",
    "WhisperModel",
    "BatchedInferencePipeline",
    "download_model",
    "format_timestamp",
    "__version__",
]

_LAZY = {
    "decode_audio": ("faster_whisper_tpu_torch.audio", "decode_audio"),
    "WhisperModel": ("faster_whisper_tpu_torch.transcribe", "WhisperModel"),
    "BatchedInferencePipeline": ("faster_whisper_tpu_torch.transcribe", "BatchedInferencePipeline"),
    "available_models": ("faster_whisper_tpu_torch.utils", "available_models"),
    "download_model": ("faster_whisper_tpu_torch.utils", "download_model"),
    "format_timestamp": ("faster_whisper_tpu_torch.utils", "format_timestamp"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
