"""``device_index`` lists: the data axis of the port's mesh, on the host.

``WhisperModel(device="cpu", device_index=[0, 1])`` holds two replicas of
the micro model on the host and splits each batch whose rows divide 2 over
them, one host thread each (``models/engine.py``).  The JAX package's
``device_index=[0, 1]`` on its virtual CPU mesh (``virtual_mesh`` of
``tests/conftest.py``) shards the same batches.  Held here: ``make_mesh``
shapes; the JAX package's three ValueError texts of ``tensor_parallel``
(the model axis itself: ``tests/test_torch_tensor_parallel.py``); the pipeline's
segments on the mesh equal to the JAX package's on its mesh and to the
port's own on one device (tokens, texts, seeks and times equal,
``avg_logprob`` within 1e-4: float32 sums of log-probabilities in another
order); the sequential path, word timestamps, language detection and a
seeded T>0 sample on the mesh equal to one device exactly (the same
float32 arithmetic on the same rows: the port's decode is batch-invariant
on the host), and its language probabilities within 1e-6."""

import os

import numpy as np
import pytest

import jax
import torch

from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.transcribe import BatchedInferencePipeline as JaxPipeline
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch import BatchedInferencePipeline, WhisperModel, decode_audio
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.engine import ShardedPending, ShardedStates
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.parallel.mesh import HOST_DEVICES, device_count, make_mesh
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer

LOGPROB_TOL = 1e-4
JFK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docker", "jfk.flac")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: under the
    suite's parallel workers, more threads wait at every op's barrier for
    cores that the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


@pytest.fixture(scope="module")
def weights():
    return jax_random_params(jax_config(), seed=0, dtype="float32")


@pytest.fixture(scope="module")
def speech():
    """``docker/jfk.flac`` tiled to 66 s: three VAD chunks."""
    return np.tile(decode_audio(JFK, sampling_rate=16000), 6)


def port_model(weights, **kwargs):
    return WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"), tiny_test_config(),
        build_synthetic_tokenizer(), compute_type="float32", device="cpu", **kwargs,
    )


def assert_segments_equal(segments, ref, words=False):
    assert len(segments) == len(ref) > 0
    for s, r in zip(segments, ref):
        assert (s.id, s.seek, s.text, s.tokens, s.start, s.end) == (
            r.id, r.seek, r.text, r.tokens, r.start, r.end
        )
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=LOGPROB_TOL)
        assert s.no_speech_prob == pytest.approx(r.no_speech_prob, abs=1e-5)
        if words:
            assert s.words == r.words


def test_make_mesh_shapes():
    cpu = [torch.device("cpu")] * 4
    mesh = make_mesh(n_devices=4, data=2, model=2, devices=cpu)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.devices.size == 4
    assert make_mesh(devices=cpu).shape == {"data": 4, "model": 1}
    assert make_mesh(n_devices=2, devices=cpu).shape == {"data": 2, "model": 1}
    assert make_mesh(n_devices=4, model=4, devices=cpu).shape == {"data": 1, "model": 4}
    cuda = make_mesh(devices=[torch.device("cuda", 0), torch.device("cuda", 0)])
    assert list(cuda.devices[:, 0]) == [torch.device("cuda", 0)] * 2  # a device twice
    with pytest.raises(ValueError):
        make_mesh(n_devices=3, model=2, devices=cpu)
    assert device_count("cpu") == HOST_DEVICES == 8


@pytest.mark.parametrize("device_index,tensor_parallel", [
    ([0], 2),  # fewer listed devices than the model axis
    ([0, 9], 2),  # 9 is not a visible device: one usable
    ([0, 1, 2, 3], 3),  # 3 does not divide 4
    (list(range(8)), 4),  # 4 does not divide the micro model's 2 heads
])
def test_tensor_parallel_errors_are_the_jax_packages(weights, virtual_mesh, device_index,
                                                     tensor_parallel):
    if not virtual_mesh(8):
        return
    kwargs = dict(device_index=device_index, tensor_parallel=tensor_parallel)
    with pytest.raises(ValueError) as ref:
        JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer(), **kwargs)
    with pytest.raises(ValueError) as ours:
        port_model(weights, **kwargs)
    assert str(ours.value) == str(ref.value)


def test_indices_outside_the_host_are_dropped(weights):
    """The JAX rule: unusable indices drop out; one usable is one device."""
    assert port_model(weights, device_index=[0, 8]).mesh is None
    assert port_model(weights, device_index=[-1, 3]).mesh is None
    model = port_model(weights, device_index=[9, 0, 1])
    assert model.mesh.shape == {"data": 2, "model": 1}


def test_pipeline_on_the_mesh_gives_the_jax_mesh_segments(weights, speech, virtual_mesh):
    if not virtual_mesh(2):
        return
    kwargs = dict(language="en", beam_size=5, batch_size=4, max_new_tokens=48)
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer(), device_index=[0, 1])
    assert jm.mesh is not None and jm.mesh.shape["data"] == 2
    ref = list(JaxPipeline(jm).transcribe(speech, **kwargs)[0])

    pm = port_model(weights, device_index=[0, 1])
    encoded = []
    encode = pm.model.encode
    pm.model.encode = lambda feats: encoded.append(encode(feats)) or encoded[-1]
    segments = list(BatchedInferencePipeline(pm).transcribe(speech, **kwargs)[0])
    assert [type(x) for x in encoded] == [ShardedStates]  # 3 chunks, 4 rows, 2 + 2
    assert pm.model.replica_batches == [1, 1]
    assert_segments_equal(segments, ref)
    single = list(BatchedInferencePipeline(port_model(weights)).transcribe(speech, **kwargs)[0])
    assert_segments_equal(segments, single)


@pytest.mark.parametrize("case", ["words", "multilingual", "sequential"])
def test_the_mesh_equals_one_device(weights, speech, case):
    """Word timestamps (the alignment of each shard on its replica), the
    pipeline's per-batch language detection, and the sequential path (a
    window of one row runs whole on the first replica)."""
    mesh, one = port_model(weights, device_index=[0, 1]), port_model(weights)
    if case == "sequential":
        kwargs = dict(language="en", beam_size=2, max_new_tokens=32, temperature=0.0)
        got = list(mesh.transcribe(speech[: 16000 * 40], **kwargs)[0])
        want = list(one.transcribe(speech[: 16000 * 40], **kwargs)[0])
        assert mesh.model.replica_batches[1] == 0 and mesh.model.replica_batches[0] > 0
        assert_segments_equal(got, want)
        return
    kwargs = dict(beam_size=2, batch_size=4, max_new_tokens=24)
    kwargs.update(dict(language="en", word_timestamps=True) if case == "words"
                  else dict(multilingual=True, language=None))
    got = list(BatchedInferencePipeline(mesh).transcribe(speech, **kwargs)[0])
    want = list(BatchedInferencePipeline(one).transcribe(speech, **kwargs)[0])
    assert mesh.model.replica_batches == [1, 1]
    assert_segments_equal(got, want, words=case == "words")


def test_a_seeded_sample_sharded_equals_unsharded(weights):
    """Per-row temperatures and seeds: each row draws from the seed of its
    row in the whole batch, so the shards draw what one device draws."""
    mesh, one = port_model(weights, device_index=[0, 1]), port_model(weights)
    mel = np.random.default_rng(5).standard_normal((4, 80, 3000)).astype(np.float32)
    states = mesh.model.encode(mel)
    assert isinstance(states, ShardedStates) and states.shape == (4, 1500, 64)
    assert [t.shape[0] for t in states.shards] == [2, 2] and states.replicas == [0, 1]
    assert [t.shape[0] for t in states[1:3].shards] == [1, 1]
    prompts = [[one.model.sot_id]] * 4
    kwargs = dict(beam_size=1, sampling_temperature=[0.5, 0.7, 0.9, 1.1], sampling_topk=0,
                  num_hypotheses=2, max_length=24, rng_seed=11)
    pending = mesh.model.generate_dispatch(states, prompts, **kwargs)
    assert isinstance(pending, ShardedPending) and len(pending.parts) == 2
    got = mesh.model.generate_collect(pending)
    want = one.model.generate(one.model.encode(mel), prompts, **kwargs)
    for g, w in zip(got, want):
        assert g.sequences_ids == w.sequences_ids and g.scores == w.scores
    # language probabilities: a softmax over prefill logits of 2 rows and
    # of 4, whose float32 products round apart in the last bits
    got = mesh.model.detect_language(states)
    want = one.model.detect_language(one.model.encode(mel))
    for g, w in zip(got, want):
        assert [c for c, _ in g[:3]] == [c for c, _ in w[:3]]
        np.testing.assert_allclose(sorted(p for _, p in g), sorted(p for _, p in w), atol=1e-6, rtol=0)


def test_the_servers_num_mesh_devices_reach_the_mesh(weights, monkeypatch):
    """``python -m faster_whisper_tpu_torch.server --num-mesh-devices 2``
    loads its model with ``device_index=[0, 1]``: here a mesh of two host
    replicas."""
    from faster_whisper_tpu_torch import server, transcribe

    seen = {}

    def load(name, compute_type="default", **kwargs):
        seen["kwargs"] = kwargs
        return port_model(weights, **kwargs)

    monkeypatch.setattr(transcribe, "WhisperModel", load)
    monkeypatch.setattr(server, "serve", lambda model, *a, **k: seen.setdefault("model", model))
    server.main(["--model", "test-micro", "--num-mesh-devices", "2", "--no-warm"])
    assert seen["kwargs"] == {"device_index": [0, 1]}
    assert seen["model"].mesh.shape == {"data": 2, "model": 1}
    assert len(seen["model"].model.replicas) == 2
