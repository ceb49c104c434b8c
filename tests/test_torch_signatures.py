"""The port's public signatures against the JAX package's (the reference's
own check is its tests/test_transcribe.py:237-244, batched against
sequential).

For each function or method, the parameters must agree in name, kind and
default value, in order: what a caller relies on.  Annotations are not
compared; they name each package's own classes.  The allowed differences,
each a deliberate one, are listed in ``ALLOWED``:

- ``get_speech_timestamps`` takes ``device=``, where the JAX package takes
  ``audio_device=`` and ``probs_device=``;
- ``WhisperModel.from_parts`` takes ``device=`` (default the card) beside
  the JAX package's arguments: the port's only way to build a model on the
  host from parts, as ``WhisperModel(device="cpu")`` is from a directory.

The serving surface is held the same way: ``ContinuousBatcher``, the HTTP
server's ``make_server``, ``serve`` and ``TranscriptionService``,
``warm_parallel``, and the command lines of the CLI, the server, the
acceptance gate (``validate``) and the offline warm (``precompile``), each
option's flags, destination, default, type, choices, count and action.
One default differs on purpose (``COMMAND_LINE_ALLOWED``): the gate's
``--data-dir``, which in the JAX package names a directory outside the
repository and in the port is the repository's own ``docker/``.

The dataclasses ``Word``, ``Segment``, ``TranscriptionOptions``,
``TranscriptionInfo`` and ``VadOptions`` must have the same fields, in
order, with the same defaults, and the same methods; ``Word._asdict`` and
``Segment._asdict`` warn and return the dict as the JAX package's do."""

import argparse
import dataclasses
import inspect
import warnings

import pytest

import jax  # noqa: F401  (test files import both frameworks)
import torch  # noqa: F401

import faster_whisper_tpu.__main__ as jax_cli
import faster_whisper_tpu.audio as jax_audio
import faster_whisper_tpu.precompile as jax_precompile
import faster_whisper_tpu.scheduler as jax_scheduler
import faster_whisper_tpu.server as jax_server
import faster_whisper_tpu.transcribe as jax_transcribe
import faster_whisper_tpu.validate as jax_validate
import faster_whisper_tpu.vad as jax_vad
import faster_whisper_tpu_torch.__main__ as port_cli
import faster_whisper_tpu_torch.audio as port_audio
import faster_whisper_tpu_torch.precompile as port_precompile
import faster_whisper_tpu_torch.scheduler as port_scheduler
import faster_whisper_tpu_torch.server as port_server
import faster_whisper_tpu_torch.transcribe as port_transcribe
import faster_whisper_tpu_torch.validate as port_validate
import faster_whisper_tpu_torch.vad as port_vad

FUNCTIONS = {
    "WhisperModel.__init__": (jax_transcribe.WhisperModel.__init__, port_transcribe.WhisperModel.__init__),
    "WhisperModel.from_parts": (jax_transcribe.WhisperModel.from_parts, port_transcribe.WhisperModel.from_parts),
    "WhisperModel.transcribe": (jax_transcribe.WhisperModel.transcribe, port_transcribe.WhisperModel.transcribe),
    "WhisperModel.detect_language": (
        jax_transcribe.WhisperModel.detect_language, port_transcribe.WhisperModel.detect_language,
    ),
    "WhisperModel.add_word_timestamps": (
        jax_transcribe.WhisperModel.add_word_timestamps, port_transcribe.WhisperModel.add_word_timestamps,
    ),
    "WhisperModel.find_alignment": (
        jax_transcribe.WhisperModel.find_alignment, port_transcribe.WhisperModel.find_alignment,
    ),
    "WhisperModel.encode": (jax_transcribe.WhisperModel.encode, port_transcribe.WhisperModel.encode),
    "WhisperModel.generate_segments": (
        jax_transcribe.WhisperModel.generate_segments, port_transcribe.WhisperModel.generate_segments,
    ),
    "WhisperModel.generate_with_fallback": (
        jax_transcribe.WhisperModel.generate_with_fallback,
        port_transcribe.WhisperModel.generate_with_fallback,
    ),
    "BatchedInferencePipeline.__init__": (
        jax_transcribe.BatchedInferencePipeline.__init__, port_transcribe.BatchedInferencePipeline.__init__,
    ),
    "BatchedInferencePipeline.transcribe": (
        jax_transcribe.BatchedInferencePipeline.transcribe,
        port_transcribe.BatchedInferencePipeline.transcribe,
    ),
    "decode_audio": (jax_audio.decode_audio, port_audio.decode_audio),
    "get_speech_timestamps": (jax_vad.get_speech_timestamps, port_vad.get_speech_timestamps),
    "ContinuousBatcher.__init__": (
        jax_scheduler.ContinuousBatcher.__init__, port_scheduler.ContinuousBatcher.__init__,
    ),
    "ContinuousBatcher.submit": (
        jax_scheduler.ContinuousBatcher.submit, port_scheduler.ContinuousBatcher.submit,
    ),
    "server.make_server": (jax_server.make_server, port_server.make_server),
    "server.serve": (jax_server.serve, port_server.serve),
    "TranscriptionService.__init__": (
        jax_server.TranscriptionService.__init__, port_server.TranscriptionService.__init__,
    ),
    "TranscriptionService.stream_bytes": (
        jax_server.TranscriptionService.stream_bytes, port_server.TranscriptionService.stream_bytes,
    ),
    "warm_parallel": (jax_precompile.warm_parallel, port_precompile.warm_parallel),
}

# name -> the module whose ``main(argv)`` builds that command line
COMMAND_LINES = {
    "cli": (jax_cli, port_cli),
    "server": (jax_server, port_server),
    "validate": (jax_validate, port_validate),
    "precompile": (jax_precompile, port_precompile),
}

# name -> {option dest: the port's default}, where that default differs
COMMAND_LINE_ALLOWED = {
    "validate": {"data_dir": port_validate.DEFAULT_DATA_DIR},
}

# name -> (parameters only the JAX package has, parameters only the port has)
ALLOWED = {
    "get_speech_timestamps": ({"audio_device", "probs_device"}, {"device"}),
    "WhisperModel.from_parts": (set(), {"device"}),
}

DATACLASSES = {
    "Word": (jax_transcribe.Word, port_transcribe.Word),
    "Segment": (jax_transcribe.Segment, port_transcribe.Segment),
    "TranscriptionOptions": (jax_transcribe.TranscriptionOptions, port_transcribe.TranscriptionOptions),
    "TranscriptionInfo": (jax_transcribe.TranscriptionInfo, port_transcribe.TranscriptionInfo),
    "VadOptions": (jax_vad.VadOptions, port_vad.VadOptions),
}


def _params(fn, drop):
    return [
        (p.name, p.kind, p.default)
        for p in inspect.signature(fn).parameters.values()
        if p.name not in drop
    ]


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_signature_matches_jax(name):
    ref_fn, port_fn = FUNCTIONS[name]
    only_jax, only_port = ALLOWED.get(name, (set(), set()))
    ref_names = set(inspect.signature(ref_fn).parameters)
    port_names = set(inspect.signature(port_fn).parameters)
    assert ref_names - port_names == only_jax and port_names - ref_names == only_port
    assert _params(port_fn, only_port) == _params(ref_fn, only_jax)


def _methods(cls):
    return sorted(k for k, v in vars(cls).items() if callable(v) and not k.startswith("__"))


@pytest.mark.parametrize("name", list(DATACLASSES))
def test_dataclass_fields_and_methods_match_jax(name):
    ref, ours = DATACLASSES[name]
    fields = [(f.name, f.default, f.default_factory) for f in dataclasses.fields(ours)]
    assert fields == [(f.name, f.default, f.default_factory) for f in dataclasses.fields(ref)]
    assert _methods(ours) == _methods(ref)


@pytest.mark.parametrize("name", ["Word", "Segment"])
def test_asdict_shims_warn_and_return_the_dict(name):
    """``Word._asdict()`` and ``Segment._asdict()``: the reference's
    deprecated shims, with the JAX package's warning text."""
    word = dict(start=0.0, end=0.5, word=" ask", probability=0.9)
    fields = dict(
        id=1, seek=0, start=0.0, end=1.0, text=" ask", tokens=[1, 2], avg_logprob=-0.3,
        compression_ratio=1.2, no_speech_prob=0.1, temperature=0.0,
    )
    out = []
    for module in (jax_transcribe, port_transcribe):
        if name == "Word":
            obj = module.Word(**word)
        else:
            obj = module.Segment(**fields, words=[module.Word(**word)])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            d = obj._asdict()
        assert d == dataclasses.asdict(obj)
        assert [w.category for w in caught] == [DeprecationWarning]
        out.append((d, str(caught[0].message), caught[0].filename))
    assert out[0][:2] == out[1][:2]
    assert out[1][2] == __file__  # stacklevel 2: the caller's line


class _Parsed(Exception):
    """Raised by ``parse_args`` to hand back the parser of a ``main``."""


def command_line(module, monkeypatch):
    """[(flags, dest, default, type, choices, nargs, action)] of the
    options that ``module.main`` parses, read off its parser before it
    parses anything."""

    def capture(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as info:
        module.main(["x"])
    monkeypatch.undo()
    return [
        (tuple(a.option_strings), a.dest, a.default, a.type, a.choices, a.nargs, type(a).__name__)
        for a in info.value.args[0]._actions
    ]


@pytest.mark.parametrize("name", list(COMMAND_LINES))
def test_command_line_matches_jax(name, monkeypatch):
    ref, ours = COMMAND_LINES[name]
    want = command_line(ref, monkeypatch)
    assert len(want) > 5
    defaults = COMMAND_LINE_ALLOWED.get(name, {})
    want = [
        (flags, dest, defaults.get(dest, default), *rest)
        for flags, dest, default, *rest in want
    ]
    assert command_line(ours, monkeypatch) == want
