"""The benchmark of faster_whisper_tpu_torch on the H100 (``run.py``)."""
