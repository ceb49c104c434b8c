"""Checkpoints, the model directory and the native FLAC decoder of the port
against the JAX package.

Every fixture is built here: CTranslate2 ``model.bin`` files by the port's
writer (``testing.py::write_ct2``, byte for byte the JAX package's
``serialize_ct2`` / ``serialize_ct2_int8`` where both exist), HF
directories by ``transformers``' ``save_pretrained`` and by the port's
writer, ``tokenizer.json`` files by the port's writer.  On the same files
the two packages' loaders give bit-equal float32 parameter trees, and
``WhisperModel(directory, device="cpu")`` gives the JAX package's tokens,
texts, seeks and start/end at beam 5 and temperature 0, ``avg_logprob``
within 1e-4 (as ``test_torch_transcribe.py``).  The JAX side runs with
FWT_CACHE_ARTIFACTS=/nonexistent."""

import dataclasses
import io
import json
import logging
import os
import struct

import numpy as np
import pytest

import jax
import torch

from faster_whisper_tpu import utils as jax_utils
from faster_whisper_tpu.audio import decode_audio as jax_decode_audio
from faster_whisper_tpu.flac import decode_flac as jax_decode_flac
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import load_ct2_model as jax_load_ct2
from faster_whisper_tpu.models.load import load_hf_safetensors as jax_load_hf
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.models.load import read_ct2_variables as jax_read_ct2
from faster_whisper_tpu.testing import serialize_ct2 as jax_serialize_ct2
from faster_whisper_tpu.testing import serialize_ct2_int8 as jax_serialize_ct2_int8
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch import audio, flac, testing
from faster_whisper_tpu_torch import utils as port_utils
from faster_whisper_tpu_torch.models import load
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.safetensors import load_file
from faster_whisper_tpu_torch.ops import _build
from faster_whisper_tpu_torch.transcribe import WhisperModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFK = os.path.join(ROOT, "docker", "jfk.flac")
LOGPROB_TOL = 1e-4
BASE_VOCAB = 512  # 256 byte symbols, the merges below, then filler
N_VOCAB = BASE_VOCAB + 1609  # + the Whisper specials
HEADS = ((1, 0), (1, 1))
MERGES = testing.word_merges(
    [" the", " and", " ask", " not", " what", " your", " country", " can", " do", " for", " you"]
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the other port test files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_cache_artifacts(monkeypatch):
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


@pytest.fixture(scope="module")
def weights():
    """The JAX package's float32 micro model with a 2121-token vocabulary."""
    return jax_random_params(jax_config(n_vocab=N_VOCAB), seed=0, dtype="float32")


@pytest.fixture(scope="module")
def port_weights(weights):
    return load.params_from_jax(jax.tree.map(np.asarray, weights), device="cpu")


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(tiny_test_config(n_vocab=N_VOCAB), alignment_heads=HEADS)


@pytest.fixture(scope="module")
def tokenizer():
    return testing.tokenizer_json(BASE_VOCAB, MERGES)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def assert_trees_bit_equal(jax_tree, port_tree):
    leaves = jax.tree_util.tree_leaves_with_path(jax_tree)
    assert len(leaves) == len(jax.tree.leaves(port_tree)) > 30
    for path, leaf in leaves:
        t = port_tree
        for key in path:
            t = t[key.key]
        want = np.asarray(leaf)
        got = t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        assert got.shape == want.shape, path
        assert np.array_equal(got.view(_bits(want).dtype), _bits(want)), path


def assert_configs_equal(jax_cfg, port_cfg):
    for field in ("n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head", "n_audio_layer",
                  "n_vocab", "n_text_ctx", "n_text_state", "n_text_head", "n_text_layer",
                  "alignment_heads", "name", "is_multilingual"):
        assert getattr(port_cfg, field) == getattr(jax_cfg, field), field


def _ct2_config(cfg):
    return json.dumps({"alignment_heads": [list(h) for h in cfg.alignment_heads],
                       "attention_heads": cfg.n_audio_head}).encode()


# ---------------------------------------------------------------------------
# CTranslate2 model.bin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_ct2_writer_matches_the_jax_serializer(weights, port_weights, cfg, kind):
    jax_ser = jax_serialize_ct2 if kind == "float32" else jax_serialize_ct2_int8
    assert testing.serialize_ct2(port_weights, cfg, kind) == jax_ser(weights, jax_config(N_VOCAB))


@pytest.mark.parametrize("source", ["directory", "files"])
@pytest.mark.parametrize("kind", ["float32", "float16", "int8", "int8_float16"])
def test_ct2_trees_are_bit_equal(port_weights, cfg, tmp_path, kind, source):
    blob = testing.serialize_ct2(port_weights, cfg, kind)
    if source == "directory":
        (tmp_path / "model.bin").write_bytes(blob)
        (tmp_path / "config.json").write_bytes(_ct2_config(cfg))
        args, files = (str(tmp_path),), None
    else:
        args, files = ("in-memory",), {"model.bin": blob, "config.json": _ct2_config(cfg)}
    want, want_cfg = jax_load_ct2(*args, dtype="float32", files=dict(files or {}))
    got, got_cfg = load.load_ct2_model(*args, dtype=torch.float32, files=files, device="cpu")
    assert_trees_bit_equal(want, got)
    assert_configs_equal(want_cfg, got_cfg)
    assert got_cfg.alignment_heads == HEADS and got_cfg.n_vocab == N_VOCAB


def test_float16_checkpoint_to_bfloat16_matches_jax(port_weights, cfg):
    """The card's default load: float16 file, bfloat16 leaves, one rounding."""
    files = {"model.bin": testing.serialize_ct2(port_weights, cfg, "float16"),
             "config.json": _ct2_config(cfg)}
    want, _ = jax_load_ct2("m", dtype="bfloat16", files=dict(files))
    got, _ = load.load_ct2_model("m", dtype="bfloat16", files=files, device="cpu")
    assert_trees_bit_equal(want, got)


def _old_format_model_bin(port_weights, cfg, bf16: bool) -> bytes:
    """A model.bin whose float32 variables carry the old item-size tag (4),
    or, with ``bf16``, are stored as bfloat16 (tag 5); int8 linear weights
    with their float32 scales."""
    buf = io.BytesIO()
    buf.write(struct.pack("<I", 5 if not bf16 else 6))
    testing._ct2_write_string(buf, "WhisperSpec")
    buf.write(struct.pack("<II", 3, 0))
    count = 0
    for name, arr in testing.ct2_variables(port_weights, cfg):
        for var_name, var in testing._ct2_encode(name, arr, "int8" if "ffn" in name else "float32"):
            if var.dtype == np.float32 and bf16 and not var_name.endswith("_scale"):
                tag, var = 5, (var.view(np.uint32) >> 16).astype("<u2")
            else:
                tag = var.dtype.itemsize
            testing._ct2_write_string(buf, var_name)
            buf.write(struct.pack("<B", var.ndim) + struct.pack(f"<{var.ndim}I", *var.shape))
            buf.write(struct.pack("<BI", tag, var.nbytes) + var.tobytes())
            count += 1
    blob = bytearray(buf.getvalue())
    at = 4 + 2 + len("WhisperSpec") + 1 + 4
    blob[at : at + 4] = struct.pack("<I", count)
    return bytes(blob)


@pytest.mark.parametrize("bf16", [False, True], ids=["item-size-tags", "bf16-tag-5"])
def test_ct2_old_item_size_tags_and_bf16(port_weights, cfg, bf16):
    blob = _old_format_model_bin(port_weights, cfg, bf16)
    want_vars, got_vars = jax_read_ct2(blob), load.read_ct2_variables(blob)
    assert want_vars.keys() == got_vars.keys()
    for name, want in want_vars.items():
        if name == "__spec__":
            assert list(got_vars[name]) == list(want) == ["WhisperSpec"]
            continue
        assert got_vars[name].dtype == want.dtype and np.array_equal(got_vars[name], want), name
    files = {"model.bin": blob, "config.json": _ct2_config(cfg)}
    want, _ = jax_load_ct2("m", dtype="float32", files=dict(files))
    got, _ = load.load_ct2_model("m", dtype="float32", files=files, device="cpu")
    assert_trees_bit_equal(want, got)


@pytest.mark.parametrize("fault", ["binary-version", "payload-size"])
def test_ct2_reader_refuses_malformed_files(fault):
    buf = io.BytesIO()
    buf.write(struct.pack("<I", 11 if fault == "binary-version" else 6))
    testing._ct2_write_string(buf, "WhisperSpec")
    buf.write(struct.pack("<II", 3, 1))
    testing._ct2_write_string(buf, "a/weight")
    buf.write(struct.pack("<BIIBI", 2, 2, 3, 0, 7) + bytes(7))  # 6 float32 need 24 bytes
    match = "binary version" if fault == "binary-version" else "cannot infer dtype"
    for reader in (jax_read_ct2, load.read_ct2_variables):
        with pytest.raises(ValueError, match=match):
            reader(buf.getvalue())


# ---------------------------------------------------------------------------
# HF safetensors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["one-file", "sharded"])
def hf_dir(request, tmp_path_factory):
    """``save_pretrained`` of a random transformers Whisper, with a
    generation_config.json that names alignment heads."""
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    hf_cfg = WhisperConfig(
        vocab_size=1000, num_mel_bins=80, d_model=64, encoder_layers=2,
        encoder_attention_heads=4, decoder_layers=3, decoder_attention_heads=4,
        encoder_ffn_dim=256, decoder_ffn_dim=256, max_source_positions=1500,
        max_target_positions=448, pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=3, suppress_tokens=None, begin_suppress_tokens=None,
    )
    torch.manual_seed(0)
    model = WhisperForConditionalGeneration(hf_cfg).eval()
    path = tmp_path_factory.mktemp(f"hf_{request.param}")
    shard = dict(max_shard_size="300KB") if request.param == "sharded" else {}
    model.save_pretrained(path, safe_serialization=True, **shard)
    with open(path / "generation_config.json") as f:
        gen = json.load(f)
    gen["alignment_heads"] = [[2, 1], [2, 3], [1, 0]]
    with open(path / "generation_config.json", "w") as f:
        json.dump(gen, f)
    n_files = len([f for f in os.listdir(path) if f.endswith(".safetensors")])
    assert n_files > 1 if request.param == "sharded" else n_files == 1
    return str(path)


def test_hf_trees_configs_and_alignment_heads_are_equal(hf_dir):
    want, want_cfg = jax_load_hf(hf_dir, dtype="float32")
    got, got_cfg = load.load_hf_safetensors(hf_dir, dtype="float32", device="cpu")
    assert_trees_bit_equal(want, got)
    assert_configs_equal(want_cfg, got_cfg)
    assert got_cfg.alignment_heads == ((2, 1), (2, 3), (1, 0))
    assert (got_cfg.n_text_layer, got_cfg.n_audio_head, got_cfg.n_vocab) == (3, 4, 1000)
    assert load.load_model(hf_dir, dtype="float32", device="cpu")[1] == got_cfg


def test_hf_writer_is_what_transformers_saves(weights, port_weights, cfg, tokenizer, tmp_path):
    """The port's HF writer: the JAX loader reads back the weights it was
    given, and transformers loads the directory with no key missing or
    unexpected and the same tensors."""
    from transformers import WhisperForConditionalGeneration

    testing.write_hf_dir(str(tmp_path), port_weights, cfg, tokenizer)
    want, want_cfg = jax_load_hf(str(tmp_path), dtype="float32")
    assert_trees_bit_equal(weights, load.load_hf_safetensors(str(tmp_path), "float32", "cpu")[0])
    assert_trees_bit_equal(want, port_weights)
    assert want_cfg.alignment_heads == HEADS
    model, info = WhisperForConditionalGeneration.from_pretrained(str(tmp_path), output_loading_info=True)
    assert not info["missing_keys"] and not info["unexpected_keys"], info
    state = model.state_dict()
    written = testing.hf_state_dict(port_weights, cfg)
    assert set(written) <= set(state)
    for name, arr in written.items():
        assert np.array_equal(state[name].numpy(), arr), name
    assert torch.equal(model.proj_out.weight, model.model.decoder.embed_tokens.weight)


def test_safetensors_reader_matches_the_safetensors_package(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, generator=g).bfloat16(),
        "i64": torch.arange(6).reshape(2, 3),
        "i8": torch.arange(-4, 4, dtype=torch.int8),
        "scalar": torch.tensor(1.5),
    }
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got = load_file(str(tmp_path / "x.safetensors"))
    assert got.keys() == tensors.keys()
    for name, t in tensors.items():
        want = t.float().numpy() if name == "bf16" else t.numpy()
        assert got[name].dtype == want.dtype and np.array_equal(got[name], want), name


# ---------------------------------------------------------------------------
# WhisperModel(directory)
# ---------------------------------------------------------------------------


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    gate = np.sin(2 * np.pi * 0.5 * t) > 0
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * gate + 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def _write_dir(path, kind, port_weights, cfg, tokenizer):
    if kind == "hf":
        testing.write_hf_dir(str(path), port_weights, cfg, tokenizer)
    else:
        testing.write_ct2_dir(str(path), port_weights, cfg, tokenizer, weights=kind)
    return str(path)


def _dir_files(path):
    return {name: open(os.path.join(path, name), "rb").read() for name in os.listdir(path)}


def _assert_segments_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    assert max(s.seek for s in ours) > 0  # the seek loop crossed into the second window
    for s, r in zip(ours, ref):
        assert (s.id, s.seek, s.text, s.tokens) == (r.id, r.seek, r.text, r.tokens)
        assert (s.start, s.end) == (r.start, r.end)
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=LOGPROB_TOL)


@pytest.mark.parametrize("kind,source", [
    ("float32", "directory"), ("float16", "files"), ("hf", "directory"),
])
def test_transcribe_from_a_directory_matches_jax(port_weights, cfg, tokenizer, tmp_path, kind, source):
    path = _write_dir(tmp_path / "model", kind, port_weights, cfg, tokenizer)
    if source == "files":
        jm = JaxWhisperModel("in-memory", files=_dir_files(path), compute_type="float32")
        pm = WhisperModel("in-memory", files=_dir_files(path), device="cpu", compute_type="float32")
    else:
        jm = JaxWhisperModel(path, compute_type="float32")
        pm = WhisperModel(path, device="cpu", compute_type="float32")
    assert pm.device == torch.device("cpu")
    assert pm.model.config.alignment_heads == HEADS
    assert pm.feat_kwargs == jm.feat_kwargs and pm.feat_kwargs["feature_size"] == 80
    kwargs = dict(beam_size=5, temperature=0.0, max_new_tokens=48, initial_prompt=" ask not what")
    audio = synth_audio(45.0, seed=1)
    ref, ref_info = jm.transcribe(audio, **kwargs)
    ref = list(ref)
    ours, info = pm.transcribe(audio, **kwargs)
    ours = list(ours)
    assert info.language == ref_info.language == "en"
    _assert_segments_equal(ours, ref)


def test_int8_checkpoint_transcribe_matches_jax(port_weights, cfg, tokenizer, tmp_path, monkeypatch):
    """An int8 ``model.bin`` at ``compute_type="int8_float32"`` in both
    packages: dequantized and quantized again, the same int8 tree; each
    window decoded from the JAX package's encoder states (the int8
    encoders agree to an activation code, test_torch_transcribe.py)."""
    path = _write_dir(tmp_path / "model", "int8", port_weights, cfg, tokenizer)
    jm = JaxWhisperModel(path, compute_type="int8_float32")
    pm = WhisperModel(path, device="cpu", compute_type="int8_float32")
    assert pm.model.kv_int8
    w_jax = jm.model.params["decoder"]["layers"]["mlp"]["w1"]
    w_port = pm.model.params["decoder"]["layers"]["mlp"]["w1"]
    assert np.array_equal(np.asarray(w_jax.q), w_port.q.numpy())
    assert np.array_equal(_bits(w_jax.s), _bits(w_port.s.numpy()))

    states = []
    jax_dispatch = jm.model.generate_dispatch

    def record(encoder_output, prompts, **kw):
        states.append(np.array(encoder_output))
        return jax_dispatch(encoder_output, prompts, **kw)

    monkeypatch.setattr(jm.model, "generate_dispatch", record)
    kwargs = dict(beam_size=5, temperature=0.0, max_new_tokens=48)
    audio = synth_audio(45.0, seed=4)
    ref = list(jm.transcribe(audio, **kwargs)[0])
    replay = iter(states)
    port_generate = pm.model.generate
    monkeypatch.setattr(
        pm.model, "generate",
        lambda encoder_output, prompts, **kw: port_generate(torch.from_numpy(next(replay)), prompts, **kw),
    )
    _assert_segments_equal(list(pm.transcribe(audio, **kwargs)[0]), ref)


@pytest.mark.parametrize("n_vocab", [51864, 51865], ids=["english-only", "multilingual"])
def test_vocabulary_size_decides_multilingual(n_vocab, tmp_path):
    """``is_multilingual`` follows the embedding's row count, as in the JAX
    package; the tokenizer's size comes from its own file."""
    jcfg = jax_config(n_vocab=n_vocab)
    params = load.params_from_jax(
        jax.tree.map(np.asarray, jax_random_params(jcfg, seed=1, dtype="float32")), device="cpu"
    )
    path = str(tmp_path)
    testing.write_ct2_dir(path, params, tiny_test_config(n_vocab=n_vocab),
                          testing.tokenizer_json(n_vocab - 1609), weights="float16")
    pm = WhisperModel(path, device="cpu", compute_type="float32")
    jm = JaxWhisperModel(path, compute_type="float32")
    assert pm.model.config.n_vocab == pm.hf_tokenizer.get_vocab_size() == n_vocab
    assert pm.model.is_multilingual == jm.model.is_multilingual == (n_vocab == 51865)
    assert pm.supported_languages == jm.supported_languages


@pytest.mark.parametrize("case", [
    "no-device", "cuda", "cuda:1", "device-list", "tensor-parallel", "int4", "int4-group",
    "no-tokenizer", "unknown-device",
])
def test_arguments_outside_the_port_raise(port_weights, cfg, tokenizer, tmp_path, monkeypatch, case):
    """The card raises without one (no fallback to the host); more than
    one device names item 13.  ``compute_type="int4"`` loads, with and
    without ``int4_group_size``: the JAX package's int4 tree of the same
    directory, code for code.  A directory without tokenizer.json raises
    when the local cache lacks ``openai/whisper-tiny.en`` too (the micro
    vocabulary is English-only), naming where it looked."""
    path = _write_dir(tmp_path / "model", "float16", port_weights, cfg, tokenizer)
    if case in ("int4", "int4-group"):
        group = None if case == "int4" else 16
        pm = WhisperModel(path, device="cpu", compute_type="int4", int4_group_size=group)
        jm = JaxWhisperModel(path, compute_type="int4", int4_group_size=group)
        assert pm.model.int4 and pm.model.kv_int8 and jm.model.int4
        ref, ours = jm.model.params["decoder"], pm.model.params["decoder"]
        for sec, name in (("self_attn", "wq"), ("cross_attn", "wv"), ("mlp", "w2")):
            j, t = ref["layers"][sec][name], ours["layers"][sec][name]
            assert np.array_equal(t.q.numpy(), np.asarray(j.q)), (sec, name)
            assert np.array_equal(t.s.numpy(), np.asarray(j.s)), (sec, name)
            assert t.s.dim() == t.q.dim() - (group is None) and int(t.q.abs().max()) <= 7
        v = ref["logits_w"].q.shape[-1]
        assert np.array_equal(ours["logits_w"].q[:, :v].numpy(), np.asarray(ref["logits_w"].q))
        return
    expect = {
        "no-device": (RuntimeError, dict(), "CUDA card"),
        "cuda": (RuntimeError, dict(device="cuda", device_index=0), "CUDA card"),
        "cuda:1": (RuntimeError, dict(device="cuda:1"), "CUDA card"),
        "device-list": (NotImplementedError, dict(device="cpu", device_index=[0, 1]), "item 13"),
        "tensor-parallel": (NotImplementedError, dict(device="cpu", tensor_parallel=2), "item 13"),
        "no-tokenizer": (FileNotFoundError, dict(device="cpu"), "downloads nothing"),
        "unknown-device": (ValueError, dict(device="tpu"), "unsupported device"),
    }
    error, kwargs, match = expect[case]
    if case == "no-tokenizer":
        os.remove(os.path.join(path, "tokenizer.json"))
        monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty-cache"))
    with pytest.raises(error, match=match) as e:
        WhisperModel(path, **kwargs)
    if case == "no-tokenizer":
        assert str(tmp_path / "empty-cache" / "models--openai--whisper-tiny.en") in str(e.value)


@pytest.mark.parametrize("source", ["directory", "empty-bytes"])
def test_a_model_without_tokenizer_json_reads_the_cached_whisper_tiny(
    port_weights, cfg, tokenizer, tmp_path, monkeypatch, source
):
    """The reference's fallback, offline: without tokenizer.json (or with
    empty bytes for it, which the JAX package also passes over) the
    vocabulary is ``openai/whisper-tiny.en``'s for an English-only model,
    ``openai/whisper-tiny``'s for a multilingual one, from the local cache;
    a cached snapshot without the file raises."""
    from faster_whisper_tpu_torch.bpe import BPETokenizer
    from faster_whisper_tpu_torch.transcribe import _fallback_tokenizer

    path = _write_dir(tmp_path / "model", "float16", port_weights, cfg, tokenizer)
    os.remove(os.path.join(path, "tokenizer.json"))
    cache = tmp_path / "hub"
    cached = testing.tokenizer_json(BASE_VOCAB, MERGES[:3])
    _cache_tree(str(cache), "openai/whisper-tiny.en", {"tokenizer.json": cached.encode()})
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    if source == "directory":
        pm = WhisperModel(path, device="cpu", compute_type="float32")
    else:
        files = dict(_dir_files(path), **{"tokenizer.json": b""})
        pm = WhisperModel("in-memory", files=files, device="cpu", compute_type="float32")
    assert not pm.model.is_multilingual
    assert pm.hf_tokenizer.get_vocab_size() == N_VOCAB
    # the cached vocabulary merges " the" only; the model's own, removed, " and" too
    want = BPETokenizer.from_str(cached).encode(" the and").ids
    assert pm.hf_tokenizer.encode(" the and").ids == want == [258, 220, 64, 77, 67]
    assert BPETokenizer.from_str(tokenizer).encode(" the and").ids != want
    with pytest.raises(FileNotFoundError, match="models--openai--whisper-tiny"):
        _fallback_tokenizer(True)
    _cache_tree(str(cache), "openai/whisper-tiny", {"config.json": b"{}"})
    with pytest.raises(FileNotFoundError, match="has none either"):
        _fallback_tokenizer(True)


def test_ignored_arguments_warn(port_weights, cfg, tokenizer, tmp_path, caplog):
    path = _write_dir(tmp_path / "model", "float16", port_weights, cfg, tokenizer)
    with caplog.at_level(logging.WARNING, logger="faster_whisper_tpu_torch"):
        model = WhisperModel(path, device="cpu", device_index=[0], cpu_threads=4, num_workers=2)
    assert "cpu_threads=4 is ignored" in caplog.text and "num_workers=2 is ignored" in caplog.text
    assert model.device == torch.device("cpu")
    assert model.model.params["decoder"]["token_embed"].dtype == torch.bfloat16  # "default"


# ---------------------------------------------------------------------------
# The local Hugging Face cache
# ---------------------------------------------------------------------------


def _cache_tree(root, repo_id, files, commit="0123456789abcdef0123456789abcdef01234567"):
    repo = os.path.join(root, "models--" + repo_id.replace("/", "--"))
    snapshot = os.path.join(repo, "snapshots", commit)
    os.makedirs(snapshot)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(commit)
    for name, data in files.items():
        with open(os.path.join(snapshot, name), "wb") as f:
            f.write(data)
    return snapshot


@pytest.mark.parametrize("how", ["size-name", "repo-id-env", "revision-hash", "hf-home"])
def test_download_model_resolves_the_local_cache_as_huggingface_hub(
    port_weights, cfg, tokenizer, tmp_path, monkeypatch, how
):
    """The snapshot directory that ``huggingface_hub.snapshot_download(...,
    local_files_only=True)`` returns for the same cache (which reads its
    environment at import, so it is given the directory)."""
    from huggingface_hub import snapshot_download

    cache = str(tmp_path / "home" / "hub")
    model = _write_dir(tmp_path / "model", "float16", port_weights, cfg, tokenizer)
    repo_id = "Systran/faster-whisper-tiny" if how == "size-name" else "someone/whisper-micro"
    snapshot = _cache_tree(cache, repo_id, _dir_files(model))
    for var in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE", "HF_HOME", "XDG_CACHE_HOME"):
        monkeypatch.delenv(var, raising=False)
    kwargs = dict(cache_dir=cache)
    if how == "size-name":
        got = port_utils.download_model("tiny", cache_dir=cache)
    elif how == "repo-id-env":
        monkeypatch.setenv("HF_HUB_CACHE", cache)
        got = port_utils.download_model(repo_id)
    elif how == "revision-hash":
        kwargs["revision"] = os.path.basename(snapshot)
        got = port_utils.download_model(repo_id, **kwargs)
    else:
        monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
        got = port_utils.download_model(repo_id)
    assert got == snapshot_download(repo_id, local_files_only=True, **kwargs) == snapshot
    if how == "size-name":
        pm = WhisperModel("tiny", download_root=cache, device="cpu", compute_type="float32")
        assert pm.model.config.n_vocab == N_VOCAB


def test_an_empty_cache_raises_the_port_downloads_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="downloads nothing") as e:
        port_utils.download_model("large-v3")
    assert str(tmp_path / "models--Systran--faster-whisper-large-v3") in str(e.value)
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        WhisperModel("turbo", device="cpu")
    with pytest.raises(ValueError, match="Invalid model size"):
        port_utils.download_model("huge")
    assert port_utils.available_models() == jax_utils.available_models()
    assert port_utils._MODELS == jax_utils._MODELS


# ---------------------------------------------------------------------------
# FLAC
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jfk_bytes():
    with open(JFK, "rb") as f:
        return f.read()


def test_native_flac_is_the_numpy_decoder_and_the_jax_one_bit_for_bit(jfk_bytes):
    native, rate = flac.decode_flac_native(jfk_bytes)
    plain, plain_rate = flac.decode_flac(jfk_bytes)
    ref, ref_rate = jax_decode_flac(jfk_bytes)
    assert rate == plain_rate == ref_rate == 44100
    assert native.dtype == plain.dtype == np.float32 and native.shape == plain.shape == (485100, 2)
    assert np.array_equal(native.view(np.uint32), plain.view(np.uint32))
    assert np.array_equal(native.view(np.uint32), np.asarray(ref, np.float32).view(np.uint32))


def test_decode_audio_decodes_flac_natively_and_matches_jax(jfk_bytes, monkeypatch):
    """``decode_audio`` never calls the numpy decoder; its output is the
    JAX package's, mono and split."""

    def refuse(data):
        raise AssertionError("the numpy FLAC decoder ran on the main path")

    monkeypatch.setattr(flac, "decode_flac", refuse)
    mono = audio.decode_audio(io.BytesIO(jfk_bytes))
    left, right = audio.decode_audio(JFK, split_stereo=True)
    assert np.array_equal(mono, jax_decode_audio(io.BytesIO(jfk_bytes), sampling_rate=16000))
    ref_left, ref_right = jax_decode_audio(JFK, sampling_rate=16000, split_stereo=True)
    assert np.array_equal(left, ref_left) and np.array_equal(right, ref_right)
    assert mono.shape == (176000,)
    with pytest.raises(ValueError, match="malformed FLAC"):
        audio.decode_audio(io.BytesIO(jfk_bytes[:20]))


def test_a_failed_host_build_raises(tmp_path, monkeypatch):
    """No fallback: when g++ fails, loading the FLAC library raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_gxx", lambda: "false")
    with pytest.raises(RuntimeError, match="native build failed"):
        flac.decode_flac_native(b"fLaC" + bytes(60))
    assert not list(tmp_path.glob("*.so"))
