"""Host-side helpers: timestamps, logging and device selection."""

import logging

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

