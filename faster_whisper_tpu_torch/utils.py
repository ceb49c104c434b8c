"""Host-side helpers: timestamps, logging, device selection and the
float32 scope of the feature paths."""

import contextlib
import logging
import threading

import torch


def get_logger():
    """Returns the module logger."""
    return logging.getLogger("faster_whisper_tpu_torch")


def resolve_device(device="cuda") -> torch.device:
    """The device that model code runs on.

    The default is the card.  Without one, asking for it raises: the port
    never runs on the CPU unless the caller says ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card, but "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "on the host"
        )
    return dev


# The refusal of a feature that the port does not have yet names its item.
NOT_PORTED = "not ported to the PyTorch package yet (ROADMAP.md, Queue 1 item {})"

_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def exact_float32():
    """Run float32 matmuls, convolutions and cuDNN RNNs without TF32
    inside the block, then restore the caller's settings.  The VAD and the
    device log-mel feed thresholds and a global-max clamp, which TF32's
    10-bit mantissa visibly moves.  The flags are process-wide: the lock
    keeps two threads in such blocks from restoring each other's values."""
    with _TF32_LOCK:
        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn


def format_timestamp(
    seconds: float,
    always_include_hours: bool = False,
    decimal_marker: str = ".",
) -> str:
    """Format seconds as [HH:]MM:SS.mmm."""
    assert seconds >= 0, "non-negative timestamp expected"
    milliseconds = round(seconds * 1000.0)

    hours, milliseconds = divmod(milliseconds, 3_600_000)
    minutes, milliseconds = divmod(milliseconds, 60_000)
    seconds, milliseconds = divmod(milliseconds, 1_000)

    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return (
        f"{hours_marker}{minutes:02d}:{seconds:02d}{decimal_marker}{milliseconds:03d}"
    )

