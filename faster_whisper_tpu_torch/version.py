"""Version of the PyTorch/CUDA port of faster-whisper-tpu."""

__version__ = "0.1.0"
