"""Host-side helpers: the model registry and its local-cache lookup,
timestamps, logging, the spans and phase stamps (``span``, ``phase_timer``,
re-exported from ``tracing``), device selection, the
side streams of the speculative encode and the pipelined upload,
the float32 scope of the feature paths and ``get_end`` of word
timestamps."""

import contextlib
import logging
import os
import re
import threading

from typing import Dict, List, Optional, Tuple, Union

import torch

from faster_whisper_tpu_torch.tracing import phase_timer, span  # noqa: F401

# Name -> Hugging Face repo of the CTranslate2 conversion, the registry of
# faster-whisper.
_MODELS = {
    "tiny.en": "Systran/faster-whisper-tiny.en",
    "tiny": "Systran/faster-whisper-tiny",
    "base.en": "Systran/faster-whisper-base.en",
    "base": "Systran/faster-whisper-base",
    "small.en": "Systran/faster-whisper-small.en",
    "small": "Systran/faster-whisper-small",
    "medium.en": "Systran/faster-whisper-medium.en",
    "medium": "Systran/faster-whisper-medium",
    "large-v1": "Systran/faster-whisper-large-v1",
    "large-v2": "Systran/faster-whisper-large-v2",
    "large-v3": "Systran/faster-whisper-large-v3",
    "large": "Systran/faster-whisper-large-v3",
    "distil-large-v2": "Systran/faster-distil-whisper-large-v2",
    "distil-medium.en": "Systran/faster-distil-whisper-medium.en",
    "distil-small.en": "Systran/faster-distil-whisper-small.en",
    "distil-large-v3": "Systran/faster-distil-whisper-large-v3",
    "distil-large-v3.5": "distil-whisper/distil-large-v3.5-ct2",
    "large-v3-turbo": "mobiuslabsgmbh/faster-whisper-large-v3-turbo",
    "turbo": "mobiuslabsgmbh/faster-whisper-large-v3-turbo",
}


def available_models() -> List[str]:
    """Returns the names of available models."""
    return list(_MODELS.keys())


def hub_cache_dir(cache_dir: Optional[str] = None) -> str:
    """The Hugging Face cache directory that ``huggingface_hub`` would use:
    ``cache_dir``, else ``$HF_HUB_CACHE`` (or the older
    ``$HUGGINGFACE_HUB_CACHE``), else ``$HF_HOME/hub``, else
    ``$XDG_CACHE_HOME/huggingface/hub``, else ``~/.cache/huggingface/hub``."""
    if cache_dir is not None:
        return str(cache_dir)
    hub = os.environ.get("HF_HUB_CACHE") or os.environ.get("HUGGINGFACE_HUB_CACHE")
    if hub:
        return os.path.expanduser(hub)
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.join("~", ".cache"), "huggingface"
    )
    return os.path.join(os.path.expanduser(home), "hub")


def download_model(
    size_or_id: str,
    output_dir: Optional[str] = None,
    local_files_only: bool = False,
    cache_dir: Optional[str] = None,
    revision: Optional[str] = None,
    use_auth_token: Optional[Union[str, bool]] = None,
) -> str:
    """The local directory of a Whisper model, by size name or Hub repo id.

    The port downloads nothing: it resolves the name in the local Hugging
    Face cache only, where ``huggingface_hub.snapshot_download`` (or an
    earlier download by faster-whisper) left it:
    ``models--<org>--<name>/refs/<revision>`` names the snapshot
    ``snapshots/<hash>/``; a 40-digit ``revision`` names it directly.  An
    ``output_dir`` that already holds a checkpoint is returned as it is.
    ``local_files_only`` and ``use_auth_token`` change nothing here.
    Raises ``FileNotFoundError`` naming the directories searched when the
    model is not there.
    """
    if re.match(r".*/.*", size_or_id):
        repo_id = size_or_id
    else:
        repo_id = _MODELS.get(size_or_id)
        if repo_id is None:
            raise ValueError(
                "Invalid model size '%s', expected one of: %s"
                % (size_or_id, ", ".join(_MODELS.keys()))
            )
    if output_dir is not None and os.path.isdir(output_dir) and any(
        f == "model.bin" or f.endswith(".safetensors") for f in os.listdir(output_dir)
    ):
        return output_dir

    revision = revision or "main"
    repo = os.path.join(hub_cache_dir(cache_dir), "models--" + repo_id.replace("/", "--"))
    commit = revision
    ref = os.path.join(repo, "refs", revision)
    if not re.fullmatch(r"[0-9a-f]{40}", revision) and os.path.isfile(ref):
        with open(ref) as f:
            commit = f.read().strip()
    snapshot = os.path.join(repo, "snapshots", commit)
    if os.path.isdir(snapshot):
        return snapshot
    raise FileNotFoundError(
        f"faster_whisper_tpu_torch downloads nothing: model {size_or_id!r} "
        f"(repo {repo_id}, revision {revision}) is not in the local Hugging Face "
        f"cache; searched {snapshot} (through {ref}). Pass the path of a local "
        "model directory (CTranslate2 model.bin or HF safetensors, with "
        "tokenizer.json) instead."
    )


def get_logger():
    """Returns the module logger."""
    return logging.getLogger("faster_whisper_tpu_torch")


def resolve_device(device="cuda") -> torch.device:
    """The device that model code runs on.

    The default is the card, as is ``"auto"``.  Without one, asking for it
    raises: the port never runs on the CPU unless the caller says
    ``device="cpu"``.
    """
    dev = torch.device("cuda" if device == "auto" else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card, but "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "on the host"
        )
    return dev


# (device, use) -> a CUDA stream beside the default one
_streams: Dict[Tuple[torch.device, str], "torch.cuda.Stream"] = {}


def side_stream(device: torch.device, use: str) -> "torch.cuda.Stream":
    """The CUDA stream of ``device`` kept for ``use`` (the speculative
    encode, the pipelined upload's copies), made at first use.  Its
    priority is 0, CUDA's least, which is also the default stream's, on
    which the decode runs: none is lower, and the decode stays on the
    default stream, which K1/K2/K4's per-device buffers assume."""
    key = (device, use)
    stream = _streams.get(key)
    if stream is None:
        stream = _streams.setdefault(key, torch.cuda.Stream(device, priority=0))
    return stream


_TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def exact_float32():
    """Run float32 matmuls, convolutions and cuDNN RNNs without TF32
    inside the block, then restore the caller's settings.  The VAD and the
    device log-mel feed thresholds and a global-max clamp, which TF32's
    10-bit mantissa visibly moves.  The flags are process-wide: the lock
    keeps two threads in such blocks from restoring each other's values,
    and ``steady_float32`` keeps model code out of them."""
    with _TF32_LOCK:
        matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def steady_float32():
    """Launch float32 work under the process's own TF32 settings: the block
    waits while another thread is inside ``exact_float32`` (whose flags
    would otherwise reach this thread's launches) and keeps such blocks out
    until it ends.  The flags are read when an operation is launched, so
    only the host side of the launches is held."""
    with _TF32_LOCK:
        yield


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



def get_end(segments: List[dict]) -> Optional[float]:
    """End time of the last word of a list of segment dicts, else of the
    last segment; None for no segments."""
    return next(
        (w["end"] for s in reversed(segments) for w in reversed(s["words"])),
        segments[-1]["end"] if segments else None,
    )
