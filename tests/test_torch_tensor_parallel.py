"""``tensor_parallel``: the model axis of the port's mesh, on the host.

``WhisperModel(device="cpu", device_index=[...], tensor_parallel=2)``
column/row-shards each replica of the micro model (2 heads) over two host
"devices" in the JAX package's Megatron layouts, one host thread driving
each group of shards (``parallel/mesh.py``, ``parallel/collectives.py``).
Held here, against the JAX package on the virtual 8-device CPU mesh of
``tests/conftest.py``:

- ``shard_params``: the slice of every leaf on every shard equal to the
  one JAX ``shard_params`` puts on that device (``addressable_shards``) at
  float32, int8 (with the vocab-sharded int8 head) and int4 per channel;
  with int4 group scales the codes so, and the scales equal to the whole
  array sliced by the port's rule (the JAX rule places group scales
  differently; ``parallel/mesh.py::_scale_spec``);
- the pipeline on a 4x2 and a 1x2 mesh: texts equal to the JAX package's
  on its 4x2 mesh and to the port's on one device, with timestamps within
  0.0201 s (the JAX test's own rule, ``tests/test_transcribe.py``);
- int8: every row-parallel product is an exact int32 sum, so tokens,
  texts, times and scores equal one device's;
- the sequential path, word timestamps, language detection and a seeded
  T>0 sample equal to one device's within stated tolerances (float32
  partial sums in another order: ``LOGPROB_TOL``, ``PROB_TOL``);
- ``WhisperEngine.set_mesh`` on a 2x2 mesh, the collectives, and the
  layouts the code cannot run (an int4 group wider than a shard's rows).
"""

import os

import numpy as np
import pytest

import jax
import torch

from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.ops.quant import quantize_params as jax_quantize
from faster_whisper_tpu.ops.quant import quantize_params_int4 as jax_quantize_int4
from faster_whisper_tpu.parallel.mesh import make_mesh as jax_make_mesh
from faster_whisper_tpu.parallel.mesh import shard_params as jax_shard_params
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.transcribe import BatchedInferencePipeline as JaxPipeline
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch import BatchedInferencePipeline, WhisperModel, decode_audio
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.engine import ShardedStates, WhisperEngine
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.ops.quant import (
    QuantizedLinear,
    int8_dense,
    int8_dense_rows,
    quantize_params,
    quantize_weight,
)
from faster_whisper_tpu_torch.parallel.collectives import ShardGroup
from faster_whisper_tpu_torch.parallel.mesh import ShardedParams, make_mesh, shard_params
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer

# float32 partial sums of the row-parallel products in another order than
# one device's: a segment's mean log-probability and the language and word
# probabilities move in the last bits
LOGPROB_TOL = 1e-4
PROB_TOL = 1e-5
TIME_TOL = 0.0201  # one 0.02 s timestamp quantum (tests/test_transcribe.py)
JFK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docker", "jfk.flac")
CPU = torch.device("cpu")


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def port_model(weights, **kwargs):
    kwargs.setdefault("compute_type", "float32")
    return WhisperModel.from_parts(
        params_from_jax(_np(weights), device="cpu"), tiny_test_config(),
        build_synthetic_tokenizer(), device="cpu", **kwargs,
    )


def assert_segments_close(segments, ref, exact=False, words=False):
    assert len(segments) == len(ref) > 0
    for s, r in zip(segments, ref):
        assert (s.id, s.seek, s.text, s.tokens) == (r.id, r.seek, r.text, r.tokens)
        if exact:
            assert (s.start, s.end, s.avg_logprob, s.no_speech_prob) == (
                r.start, r.end, r.avg_logprob, r.no_speech_prob
            )
        assert abs(s.start - r.start) <= TIME_TOL and abs(s.end - r.end) <= TIME_TOL
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=LOGPROB_TOL)
        assert s.no_speech_prob == pytest.approx(r.no_speech_prob, abs=PROB_TOL)
        if words:
            assert [w.word for w in s.words] == [w.word for w in r.words]
            for a, b in zip(s.words, r.words):
                assert abs(a.start - b.start) <= TIME_TOL and abs(a.end - b.end) <= TIME_TOL
                assert a.probability == pytest.approx(b.probability, abs=PROB_TOL)


# ---------------------------------------------------------------------------
# shard_params against the JAX package's shards
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    """(path, leaf) of a parameter tree, a QuantizedLinear's fields as
    ``path.q`` and ``path.s``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    elif hasattr(tree, "q") and hasattr(tree, "s"):
        yield f"{prefix}.q", tree.q
        yield f"{prefix}.s", tree.s
    else:
        yield prefix, tree


def _pad_head(tree):
    """The port's layout of a JAX int8 tree: the int8 head's columns
    zero-padded to a multiple of 8 (``ops/quant.py::_quantize_params``)."""
    lw = tree["decoder"]["logits_w"]
    pad = -lw.q.shape[-1] % 8
    tree["decoder"]["logits_w"] = QuantizedLinear(
        torch.nn.functional.pad(lw.q, (0, pad)), torch.nn.functional.pad(lw.s, (0, pad))
    )
    return tree


@pytest.mark.parametrize("form", ["float32", "int8", "int4", "int4-groups"])
def test_shard_params_gives_the_jax_packages_shards(virtual_mesh, form):
    """Every leaf of every shard of rows 0 and 3 of a 4x2 mesh against the
    JAX package's shard on that device.  The vocabulary is even (1866) so
    that the int8 head is vocab-sharded, as JAX shards it: the port's shard
    holds the same columns, zero-padded to a multiple of 8."""
    if not virtual_mesh(8):
        return
    cfg = jax_config(n_vocab=1866)
    jp = jax_random_params(cfg, seed=0, dtype="float32")
    if form == "int8":
        jp = jax_quantize(jp)
    elif form.startswith("int4"):
        jp = jax_quantize_int4(jp, group_size=16 if form == "int4-groups" else None)
    pp = params_from_jax(_np(jp), device="cpu")
    if form != "float32":
        pp = _pad_head(pp)
    jmesh = jax_make_mesh(n_devices=8, data=4, model=2)
    jsharded = jax_shard_params(jp, jmesh)
    pmesh = make_mesh(n_devices=8, data=4, model=2, devices=[CPU] * 8)
    vocab_cols = 1866 // 2
    grouped_scales = 0
    theirs_all, wholes = dict(_leaves(jsharded)), dict(_leaves(jp))
    for row in (0, 3):
        shards = shard_params(pp, pmesh, row=row)
        assert len(shards) == 2
        for j, tree in enumerate(shards):
            device = jmesh.devices[row, j]
            ours_all = dict(_leaves(tree))
            assert sorted(ours_all) == sorted(theirs_all)
            for path, ours in ours_all.items():
                theirs, whole = theirs_all[path], wholes[path]
                (piece,) = [s.data for s in theirs.addressable_shards if s.device == device]
                piece, ours = np.asarray(piece), ours.numpy()
                if path.startswith("decoder.logits_w"):
                    assert ours.shape[-1] % 8 == 0 and not ours[..., vocab_cols:].any()
                    ours = ours[..., :vocab_cols]
                grouped = path.endswith(".s") and np.ndim(whole) == np.ndim(wholes[path[:-2] + ".q"])
                if grouped:
                    # group scales: the port's rule, on the whole array
                    grouped_scales += 1
                    column = path.split(".")[-2] in ("wq", "wk", "wv", "w1", "logits_w")
                    axis = np.ndim(whole) - (1 if column else 2)
                    whole = np.asarray(whole)
                    n = whole.shape[axis] // 2
                    want = np.take(whole, range(j * n, (j + 1) * n), axis=axis)
                    np.testing.assert_array_equal(ours, want, err_msg=path)
                    continue
                if path.startswith("decoder.logits_w"):
                    assert piece.shape[-1] == vocab_cols  # JAX shards the head too
                assert ours.shape == piece.shape, (path, ours.shape, piece.shape)
                np.testing.assert_array_equal(ours, piece, err_msg=path)
    # the decoder's 4 + 4 + 2 weights and the head, in two shards of two rows
    assert grouped_scales == (2 * 2 * 11 if form == "int4-groups" else 0)


def test_int4_groups_wider_than_a_shards_rows_raise(weights):
    """int4 groups of 64 input rows: a row-parallel attention output of 64
    rows gives each of two shards 32, which no group of 64 fits."""
    with pytest.raises(ValueError, match="group size 64"):
        port_model(weights, compute_type="int4", int4_group_size=64,
                   device_index=[0, 1], tensor_parallel=2)


# ---------------------------------------------------------------------------
# The collectives and the row-parallel int8 product
# ---------------------------------------------------------------------------


def test_host_groups_sum_locally_and_mixed_kinds_raise():
    group = ShardGroup([CPU, CPU, CPU])
    assert group.transport == "local" and group.first == [0, 0, 0]
    parts = [torch.tensor([1.0, -2.0]), torch.tensor([3.0, 5.0]), torch.tensor([-1.0, 4.0])]
    assert all(torch.equal(s, torch.tensor([3.0, 7.0])) for s in group.all_reduce_sum(parts))
    assert all(torch.equal(m, torch.tensor([3.0, 5.0])) for m in group.all_reduce_max(parts))
    assert group.broadcast(parts[0])[2] is parts[0]
    with pytest.raises(ValueError):
        ShardGroup([CPU, torch.device("cuda", 0)])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("group_size", [None, 16])
def test_a_row_parallel_int8_product_equals_one_devices(n, group_size):
    """Per output channel: bit-equal to the unsharded product (a global row
    scale, then an exact int32 sum).  With group scales: the float32 group
    sums reduced in another order, within 1e-6 of the largest output."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 128), generator=g)
    w = quantize_weight(0.02 * torch.randn((128, 64), generator=g),
                        qmax=7 if group_size else 127, group_size=group_size)
    b = torch.randn((64,), generator=g)
    want = int8_dense(x, w, b)
    k = 128 // n
    rows = [QuantizedLinear(w.q[i * k:(i + 1) * k], w.s[i * k // 16:(i + 1) * k // 16] if group_size else w.s)
            for i in range(n)]
    got = int8_dense_rows([x[..., i * k:(i + 1) * k] for i in range(n)], rows, [b] * n,
                          ShardGroup([CPU] * n))
    for y in got:
        if group_size:
            np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-6 * float(want.abs().max()), rtol=0)
        else:
            assert torch.equal(y, want)


# ---------------------------------------------------------------------------
# The pipeline and the sequential path on the model axis
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single_run(weights, speech):
    kwargs = dict(language="en", beam_size=2, batch_size=4, max_new_tokens=32)
    return kwargs, list(BatchedInferencePipeline(port_model(weights)).transcribe(speech, **kwargs)[0])


def test_pipeline_on_a_4x2_mesh_gives_the_jax_meshs_texts(weights, speech, single_run, virtual_mesh):
    if not virtual_mesh(8):
        return
    kwargs, single = single_run
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer(),
                                    device_index=list(range(8)), tensor_parallel=2)
    assert dict(jm.mesh.shape) == {"data": 4, "model": 2}
    ref = list(JaxPipeline(jm).transcribe(speech, **kwargs)[0])

    pm = port_model(weights, device_index=list(range(8)), tensor_parallel=2)
    assert pm.mesh.shape == {"data": 4, "model": 2}
    assert len(pm.model.replicas) == 4
    assert all(isinstance(p, ShardedParams) and p.group.size == 2 for _, p in pm.model.replicas)
    segments = list(BatchedInferencePipeline(pm).transcribe(speech, **kwargs)[0])
    assert pm.model.replica_batches == [1, 1, 1, 1]  # 3 chunks, padded to 4 rows, 1 + 1 + 1 + 1
    assert_segments_close(segments, ref)
    assert_segments_close(segments, single)


def test_pipeline_on_one_group_of_two_equals_one_device(weights, speech, single_run):
    kwargs, single = single_run
    pm = port_model(weights, device_index=[0, 1], tensor_parallel=2)
    assert pm.mesh.shape == {"data": 1, "model": 2}
    assert pm.model.group_devices() == [CPU, CPU]
    assert pm.model.replicas[0][1].group.transport == "local"
    segments = list(BatchedInferencePipeline(pm).transcribe(speech, **kwargs)[0])
    assert_segments_close(segments, single)


@pytest.mark.parametrize("compute_type", ["int8_float32", "int4"])
def test_int8_and_int4_on_the_model_axis_equal_one_device(weights, speech, compute_type):
    """Every row-parallel product is an exact int32 sum after a global
    row scale, and every other operation runs per head or replicated: the
    segments equal one device's, scores and times too."""
    kwargs = dict(language="en", beam_size=2, batch_size=4, max_new_tokens=24)
    one = port_model(weights, compute_type=compute_type)
    tp = port_model(weights, compute_type=compute_type, device_index=[0, 1], tensor_parallel=2)
    want = list(BatchedInferencePipeline(one).transcribe(speech, **kwargs)[0])
    got = list(BatchedInferencePipeline(tp).transcribe(speech, **kwargs)[0])
    assert_segments_close(got, want, exact=True)


def test_a_vocab_sharded_int8_head_gives_one_devices_decode():
    """An even vocabulary (1866) vocab-shards the int8 head over two
    shards: the logits are gathered to the lead, and the beams, scores and
    no-speech probabilities equal one device's."""
    cfg = tiny_test_config(n_vocab=1866)
    params = quantize_params(params_from_jax(_np(jax_random_params(jax_config(n_vocab=1866), seed=1)),
                                             device="cpu"))
    tok = build_synthetic_tokenizer()
    one = WhisperEngine(params, cfg, tok, kv_int8=True)
    tp = WhisperEngine(params, cfg, tok, kv_int8=True)
    tp.set_mesh(make_mesh(n_devices=2, data=1, model=2, devices=[CPU] * 2))
    head = tp.params.trees[1]["decoder"]["logits_w"]
    assert head.q.shape[-1] == 936  # 933 columns of the vocabulary, padded to 8
    mel = np.random.default_rng(2).standard_normal((2, 80, 3000)).astype(np.float32)
    xa = one.encode(mel)
    assert torch.equal(tp.encode(mel), xa)
    prompts = [[one.sot_id]] * 2
    kwargs = dict(beam_size=3, max_length=20)
    for g, w in zip(tp.generate(xa, prompts, **kwargs), one.generate(xa, prompts, **kwargs)):
        assert (g.sequences_ids, g.scores, g.no_speech_prob) == (w.sequences_ids, w.scores, w.no_speech_prob)


@pytest.mark.parametrize("case", ["words", "multilingual", "sequential"])
def test_the_model_axis_equals_one_device(weights, speech, case):
    """Word timestamps (each alignment head read on the shard that holds
    it, its recipe gathered to the lead), the pipeline's per-batch language
    detection, and the sequential path with its speculative encode."""
    tp, one = port_model(weights, device_index=[0, 1], tensor_parallel=2), port_model(weights)
    if case == "sequential":
        kwargs = dict(language="en", beam_size=2, max_new_tokens=32, temperature=0.0)
        got = list(tp.transcribe(speech[: 16000 * 40], **kwargs)[0])
        want = list(one.transcribe(speech[: 16000 * 40], **kwargs)[0])
        assert tp.model.replica_batches[0] > 0 and len(got) > 1
        assert_segments_close(got, want)
        return
    kwargs = dict(beam_size=2, batch_size=4, max_new_tokens=24)
    kwargs.update(dict(language="en", word_timestamps=True) if case == "words"
                  else dict(multilingual=True, language=None))
    got = list(BatchedInferencePipeline(tp).transcribe(speech, **kwargs)[0])
    want = list(BatchedInferencePipeline(one).transcribe(speech, **kwargs)[0])
    assert_segments_close(got, want, words=case == "words")


def test_a_seeded_sample_and_language_detection_on_a_2x2_mesh(weights):
    """``set_mesh`` on a 2x2 mesh: two groups of two shards; a batch of 4
    rows encodes as two shards of 2 rows, each on its group.  Per-row
    temperatures and seeds: the same draws as one device; language
    probabilities within ``PROB_TOL``."""
    one = port_model(weights).model
    mesh = WhisperEngine(params_from_jax(_np(weights), device="cpu"), tiny_test_config(),
                         build_synthetic_tokenizer())
    mesh.set_mesh(make_mesh(n_devices=4, data=2, model=2, devices=[CPU] * 4))
    assert [type(p) for _, p in mesh.replicas] == [ShardedParams] * 2
    assert mesh.params is mesh.replicas[0][1]
    mel = np.random.default_rng(5).standard_normal((4, 80, 3000)).astype(np.float32)
    states = mesh.encode(mel)
    assert isinstance(states, ShardedStates) and [t.shape[0] for t in states.shards] == [2, 2]
    xa = one.encode(mel)
    np.testing.assert_allclose(torch.cat(states.shards).numpy(), xa.numpy(), atol=1e-5, rtol=0)
    prompts = [[one.sot_id]] * 4
    kwargs = dict(beam_size=1, sampling_temperature=[0.5, 0.7, 0.9, 1.1], sampling_topk=0,
                  num_hypotheses=2, max_length=24, rng_seed=11)
    got = mesh.generate_collect(mesh.generate_dispatch(states, prompts, **kwargs))
    want = one.generate(xa, prompts, **kwargs)
    for g, w in zip(got, want):
        assert g.sequences_ids == w.sequences_ids
        np.testing.assert_allclose(g.scores, w.scores, atol=LOGPROB_TOL, rtol=0)
    for g, w in zip(mesh.detect_language(states), one.detect_language(xa)):
        assert [c for c, _ in g[:3]] == [c for c, _ in w[:3]]
        np.testing.assert_allclose(sorted(p for _, p in g), sorted(p for _, p in w), atol=PROB_TOL, rtol=0)
    assert mesh.memory_report(batch_size=1)["weights_bytes"] > one.memory_report(batch_size=1)["weights_bytes"]


def test_the_servers_tensor_parallel_reaches_a_sharded_model(weights, monkeypatch):
    """``python -m faster_whisper_tpu_torch.server --num-mesh-devices 2
    --tensor-parallel 2`` loads one group of two shards, warmed."""
    from faster_whisper_tpu_torch import precompile, server, transcribe

    seen = {}
    real_warm = precompile.warm_parallel

    def load(name, compute_type="default", **kwargs):
        seen["kwargs"] = kwargs
        return port_model(weights, **kwargs)

    def warm(model, **kwargs):
        seen["warm"] = real_warm(model, durations_s=(5.0,), batch_size=2, max_new_tokens=4)
        return seen["warm"]

    monkeypatch.setattr(transcribe, "WhisperModel", load)
    monkeypatch.setattr(precompile, "warm_parallel", warm)
    monkeypatch.setattr(server, "serve", lambda model, *a, **k: seen.setdefault("model", model))
    server.main(["--model", "test-micro", "--num-mesh-devices", "2", "--tensor-parallel", "2"])
    assert seen["kwargs"] == {"device_index": [0, 1], "tensor_parallel": 2}
    assert seen["model"].mesh.shape == {"data": 1, "model": 2}
    assert seen["warm"] == []
