"""The benchmark's plain reference: float32 PyTorch and NumPy, written from
the published descriptions. Nothing here imports jax, faster_whisper_tpu or
faster_whisper_tpu_torch, and nothing here takes a value that the program
made: the harness hands both sides the same weights, vocabulary and audio.
"""
