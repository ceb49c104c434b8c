"""``compute_type="int4"`` of the port against the JAX package's, on the
micro model (``tiny_test_config``) and inputs made with numpy from a seed.

- ``quantize_params_int4``, per output channel and with group scales:
  codes and scales bit-equal to the JAX package's (the same float32
  operations in the same order; the JAX side under ``jit``, as it runs
  there), the decoder and the logits head at 4-bit range, the encoder at
  int8 range.  The port pads the logits head's columns to a multiple of 8.
- ``int8_dense`` over group scales within 1e-5 of the largest JAX output
  (exact int32 partials; the float32 sum over the groups may be taken in
  another order), and equal to the per-channel product where both schemes
  share their scales.
- The guards of ``int4=True``, with the JAX package's texts.
- ``beam_search`` at T=0 over the same int4 tree with float32 activations
  (the JAX package's int4 on float32 weights), per channel and grouped:
  equal tokens, scores within 1e-5.  The JAX package packs the codes to
  int4 inside its program, an exact conversion; the port keeps them in
  int8 storage.
- ``WhisperModel.from_parts(compute_type="int4")`` end to end with and
  without ``int4_group_size``: the seek loop and the int4 decode give the
  JAX package's segments from the JAX package's encoder states (the
  int8-range encoders differ by whole activation-code steps, as at int8),
  at float32 activations within 1e-4 and at bf16 with equal tokens.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from faster_whisper_tpu.generation import generate as JG
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.engine import WhisperEngine as JaxEngine
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.ops import quant as JQ
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.tokenizer import Tokenizer as JaxTokenizer
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch.generation import generate as PG
from faster_whisper_tpu_torch.generation import processors as PP
from faster_whisper_tpu_torch.models import model as PM
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.engine import WhisperEngine
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.ops import quant as PQ
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
from faster_whisper_tpu_torch.transcribe import WhisperModel

F32_REL = 1e-5
SCORE_TOL = 1e-5
LOGPROB_TOL = 1e-4
# avg_logprob at bf16 activations: the two packages agree to ~8e-4 on the
# micro model (bf16 rounds every layer's activations, after sums taken in
# other orders), with equal tokens.
BF16_LOGPROB_TOL = 2e-3
GROUP = 16  # divides every input width of the micro model (64, 256)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (see
    tests/test_torch_generate.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    """The JAX side runs without the shipped compile-cache entries."""
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


@pytest.fixture(scope="module")
def weights():
    """The JAX package's float32 micro weights and the port's copy."""
    jp = jax_random_params(jax_config(), seed=0, dtype="float32")
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _quant_leaves(ref, ours):
    """(path, JAX QuantizedLinear, port QuantizedLinear) of every quantized
    weight; the port's logits head is cut back to the vocabulary."""
    flat = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda n: isinstance(n, JQ.QuantizedLinear)
    )[0]
    for path, leaf in flat:
        if not isinstance(leaf, JQ.QuantizedLinear):
            continue
        t = ours
        for key in path:
            t = t[key.key]
        assert isinstance(t, PQ.QuantizedLinear), path
        name = "/".join(k.key for k in path)
        if path[-1].key == "logits_w":
            v = leaf.q.shape[-1]
            assert t.q.shape[-1] % 8 == 0 and t.q.shape[-1] - v < 8
            assert not t.q[:, v:].any()
            t = PQ.QuantizedLinear(t.q[:, :v], t.s[..., :v])
        yield name, leaf, t


@pytest.mark.parametrize("group_size", [None, GROUP], ids=["per-channel", "grouped"])
def test_quantize_params_int4_matches_jax(weights, group_size):
    jp, pp = weights
    ref = JQ.quantize_params_int4(jp, group_size=group_size)
    ours = PQ.quantize_params_int4(pp, group_size=group_size)
    n = 0
    for name, leaf, t in _quant_leaves(ref, ours):
        assert t.q.dtype == torch.int8 and t.s.dtype == torch.float32, name
        assert t.s.dim() == t.q.dim() - (group_size is None or name.startswith("encoder")), name
        np.testing.assert_array_equal(_np(t.q), _np(leaf.q), err_msg=name)
        np.testing.assert_array_equal(_np(t.s), _np(leaf.s), err_msg=name)
        # the ranges of the JAX package's tests/test_int4.py: 4-bit decoder
        # and logits head, int8 encoder
        amax = int(t.q.abs().max())
        assert amax <= 7 if not name.startswith("encoder") else amax > 7, (name, amax)
        n += 1
    assert n == 6 + 10 + 1


@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48)])
@pytest.mark.parametrize("qmax,group_size", [(7, None), (7, 16), (7, 64), (127, 16)])
def test_quantize_weight_matches_jax(shape, qmax, group_size):
    """Group-wise and per-channel codes and scales, bit-equal, with an
    outlier and an all-zero group; then the JAX package's test of what the
    groups buy: their dequantized error is never worse than per channel,
    and the outlier's column keeps its resolution outside its group."""
    rng = np.random.default_rng(len(shape) + qmax)
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0, 0] = 40.0  # an outlier in group 0 of column 0
    w[..., 16:32, 5] = 0.0  # an all-zero group takes the 1e-10 floor
    quant = jax.jit(JQ.quantize_weight, static_argnames=("qmax", "group_size"))
    ref = quant(jnp.asarray(w), qmax=qmax, group_size=group_size)
    ours = PQ.quantize_weight(torch.from_numpy(w), qmax=qmax, group_size=group_size)
    np.testing.assert_array_equal(_np(ours.q), _np(ref.q))
    np.testing.assert_array_equal(_np(ours.s), _np(ref.s))
    if group_size is None:
        return
    assert tuple(ours.s.shape) == shape[:-2] + (64 // group_size, 48)

    def dequant(ql):
        q = _np(ql.q).astype(np.float32)
        if ql.s.dim() == ql.q.dim():
            s = np.repeat(_np(ql.s), 64 // ql.s.shape[-2], axis=-2)
            return q * s
        return q * _np(ql.s)[..., None, :]

    per_ch = PQ.quantize_weight(torch.from_numpy(w), qmax=qmax)
    err_ch, err_g = np.abs(dequant(per_ch) - w), np.abs(dequant(ours) - w)
    assert err_g.mean() <= err_ch.mean()
    if group_size < 64:
        assert err_g[..., group_size:, 0].mean() < err_ch[..., group_size:, 0].mean()


def test_quantize_weight_rejects_a_group_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        PQ.quantize_weight(torch.ones(64, 8), qmax=7, group_size=24)


@pytest.mark.parametrize(
    "x_shape,bias,out_dtype,group_size",
    [((5, 64), False, None, 16), ((2, 7, 64), True, None, 16),
     ((2, 7, 64), True, "float32", 32), ((3, 64), False, None, 64)],
    ids=["rank2", "rank3-bias", "rank3-bias-f32-out", "one-group"],
)
def test_int8_dense_groups_match_jax(x_shape, bias, out_dtype, group_size):
    rng = np.random.default_rng(sum(x_shape) + group_size)
    x = rng.standard_normal(x_shape).astype(np.float32)
    x[0, ...] = 0.0  # an all-zero row takes the 1e-10 activation floor
    w = (0.05 * rng.standard_normal((64, 96))).astype(np.float32)
    b = rng.standard_normal((96,)).astype(np.float32) if bias else None
    quant = jax.jit(JQ.quantize_weight, static_argnames=("qmax", "group_size"))
    jw = quant(jnp.asarray(w), qmax=7, group_size=group_size)
    pw = PQ.quantize_weight(torch.from_numpy(w), qmax=7, group_size=group_size)
    dense = jax.jit(JQ.int8_dense, static_argnames="out_dtype")
    ref = dense(
        jnp.asarray(x), jw, None if b is None else jnp.asarray(b),
        out_dtype=None if out_dtype is None else getattr(jnp, out_dtype),
    )
    ours = PQ.int8_dense(
        torch.from_numpy(x), pw, None if b is None else torch.from_numpy(b),
        out_dtype=None if out_dtype is None else getattr(torch, out_dtype),
    )
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=0, atol=F32_REL * np.abs(_np(ref)).max())


def test_int8_dense_group_scales_match_per_channel_at_equal_scales():
    """The JAX package's equal-scales case: where every group shares its
    column's max, group-wise and per-channel codes are equal, and so are
    the two products (exact int32 partials, small integer sums)."""
    rng = np.random.default_rng(4)
    base = rng.integers(-7, 8, size=(32, 24)).astype(np.float32)
    base[0, :] = 7.0  # every column's max in group 0 ...
    base[16, :] = 7.0  # ... and in group 1
    col_scale = rng.uniform(0.5, 2.0, size=(1, 24)).astype(np.float32)
    w = torch.from_numpy(base * col_scale)
    per_ch = PQ.quantize_weight(w, qmax=7)
    grouped = PQ.quantize_weight(w, qmax=7, group_size=16)
    assert torch.equal(per_ch.q, grouped.q)
    x = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32))
    np.testing.assert_allclose(
        _np(PQ.int8_dense(x, grouped)), _np(PQ.int8_dense(x, per_ch)), rtol=1e-6, atol=1e-6
    )


def test_int4_guards_reject_mispairing(weights):
    """int4 refuses int8-range weights, an unquantized tree and
    ``kv_int8=False``, in the engine, the decode options and
    ``generate_dispatch``, with the JAX package's texts (the ``match``
    strings of its tests/test_int4.py)."""
    jp, pp = weights
    cfg, tok = tiny_test_config(), build_synthetic_tokenizer()
    cases = [
        ("int8-range", dict(params=PQ.quantize_params(pp), kv_int8=True)),
        ("kv_int8", dict(params=PQ.quantize_params_int4(pp), kv_int8=False)),
        ("requires quantized params", dict(params=pp, kv_int8=True)),
    ]
    jax_params = {
        "int8-range": JQ.quantize_params(jp), "kv_int8": JQ.quantize_params_int4(jp),
        "requires quantized params": jp,
    }
    for match, kw in cases:
        with pytest.raises(ValueError, match=match) as ours:
            WhisperEngine(kw["params"], cfg, tok, kv_int8=kw["kv_int8"], int4=True)
        with pytest.raises(ValueError) as ref:
            JaxEngine(jax_params[match], jax_config(), jax_tokenizer(), kv_int8=kw["kv_int8"], int4=True)
        assert str(ours.value) == str(ref.value)

    eng = WhisperEngine(PQ.quantize_params_int4(pp), cfg, tok, kv_int8=True)
    xa = torch.zeros((1, cfg.n_audio_ctx, cfg.n_audio_state))
    with pytest.raises(ValueError, match="kv_int8") as ours:
        PG.generate_dispatch(
            eng.params, cfg, eng.meta, xa, [[1, 2, 3]], sot_id=eng.sot_id, int4=True, kv_int8=False,
        )
    jeng = JaxEngine(JQ.quantize_params_int4(jp), jax_config(), jax_tokenizer(), kv_int8=True)
    with pytest.raises(ValueError) as ref:
        JG.generate_dispatch(
            jeng.params, jax_config(), jeng.meta, jnp.zeros((1, cfg.n_audio_ctx, cfg.n_audio_state)),
            [[1, 2, 3]], sot_id=jeng.sot_id, int4=True, kv_int8=False,
        )
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="kv_int8"):
        PG.GenOptions(int4=True)


@pytest.fixture(scope="module")
def decode_setup(weights):
    """The JAX package's encoder states of two random mel windows, its
    tokenizer, and the port's engine (for the token ids)."""
    jp, pp = weights
    from faster_whisper_tpu.models import model as JM

    mel = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)
    xa = np.array(JM.encode(jp, jax_config(), jnp.asarray(mel)))
    jtok = JaxTokenizer(jax_tokenizer(), True, task="transcribe", language="en")
    engine = WhisperEngine(pp, tiny_test_config(), build_synthetic_tokenizer())
    return xa, jtok, engine


def test_int4_expand_caches_match_jax(weights, decode_setup):
    """The prefill over the int4 tree and ``_expand_caches`` with the cross
    cache at 4-bit range: codes and bf16 scales equal to the JAX package's
    before its s4 packing (``cross_s4=False``, which its tests/test_int4.py
    holds equal to the packed run)."""
    jp, pp = weights
    xa, jtok, engine = decode_setup
    jq, pq = JQ.quantize_params_int4(jp), PQ.quantize_params_int4(pp)
    b, K, ctx = 2, 3, 32
    prompt = np.array([list(jtok.sot_sequence)] * b, np.int32)
    lengths = np.full((b,), prompt.shape[1], np.int32)
    gather = (lengths - 1)[:, None]
    from faster_whisper_tpu.models import model as JM

    prefill = jax.jit(JM.decoder_prefill, static_argnames=("config", "ctx"))
    j_logits, j_cache = prefill(jq, jax_config(), prompt, lengths, jnp.asarray(xa), gather, ctx=ctx)
    p_logits, p_cache = PM.decoder_prefill(
        pq, engine.config, torch.from_numpy(prompt).long(), torch.from_numpy(lengths).long(),
        torch.from_numpy(xa), torch.from_numpy(gather).long(), ctx=ctx,
    )
    np.testing.assert_allclose(_np(p_logits), _np(j_logits), atol=SCORE_TOL, rtol=0)
    j_caches = jax.jit(JG._expand_caches, static_argnums=(1, 2, 3))(j_cache, K, True, 7)
    p_caches = PG._expand_caches(p_cache, K, True, cross_qmax=7)
    for i, (jc, pc) in enumerate(zip(j_caches, p_caches)):
        assert pc.s.dtype == torch.bfloat16 and tuple(pc.q.shape) == jc.q.shape
        np.testing.assert_array_equal(pc.q.numpy(), np.asarray(jc.q))
        np.testing.assert_array_equal(pc.s.float().numpy(), np.asarray(jc.s, np.float32))
        assert int(pc.q.abs().max()) <= (127 if i < 2 else 7)


@pytest.mark.parametrize("group_size", [None, GROUP], ids=["per-channel", "grouped"])
@pytest.mark.parametrize("beam_size,with_timestamps", [(1, True), (5, True), (5, False)])
def test_int4_beam_search_matches_jax(weights, decode_setup, group_size, beam_size, with_timestamps):
    jp, pp = weights
    xa, jtok, engine = decode_setup
    jq = JQ.quantize_params_int4(jp, group_size=group_size)
    pq = PQ.quantize_params_int4(pp, group_size=group_size)
    prompt = list(jtok.sot_sequence) + ([] if with_timestamps else [jtok.no_timestamps])
    kwargs = dict(
        sot_id=jtok.sot, beam_size=beam_size, max_length=len(prompt) + 48,
        with_timestamps=with_timestamps, suppress_tokens=(jtok.no_speech,),
    )
    m = engine.meta
    meta = JG.TokenMeta(
        eot=m.eot, timestamp_begin=m.timestamp_begin, no_timestamps=m.no_timestamps,
        no_speech=m.no_speech, blank=m.blank, vocab_size=m.vocab_size,
    )
    # One row, as the int8 tests decode: the JAX package's own score of a
    # row moves by up to 1e-4 with the other rows of its batch.
    ref = JG.generate(jq, jax_config(), meta, jnp.asarray(xa[:1]), [prompt],
                      kv_int8=True, int4=True, **kwargs)
    ours = PG.generate_collect(
        PG.generate_dispatch(pq, engine.config, engine.meta, torch.from_numpy(xa[:1]), [prompt],
                             kv_int8=True, int4=True, **kwargs)
    )
    assert isinstance(engine.meta, PP.TokenMeta)
    for r, o in zip(ref, ours):
        assert o.sequences_ids == r.sequences_ids
        np.testing.assert_allclose(o.scores, r.scores, atol=SCORE_TOL, rtol=0)
        assert o.no_speech_prob == pytest.approx(r.no_speech_prob, abs=SCORE_TOL)


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    """A tone that switches on and off over noise, 16 kHz float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    gate = np.sin(2 * np.pi * 0.5 * t) > 0
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * gate + 0.05 * rng.standard_normal(t.size)
    return x.astype(np.float32)


@pytest.mark.parametrize(
    "group_size,activations",
    [(None, "float32"), (GROUP, "float32"), (None, "bfloat16")],
    ids=["per-channel", "grouped", "bf16"],
)
def test_int4_transcribe_matches_jax(weights, monkeypatch, group_size, activations):
    """``from_parts(compute_type="int4")`` end to end.  At float32
    activations (the JAX package's int4 on float32 weights; the port's
    int4 model takes bf16, so its engine is rebuilt at float32 over the
    port's own ``quantize_params_int4``) the segments equal the JAX
    package's and ``avg_logprob`` agrees within 1e-4.  At bf16 (both
    packages' int4 models on the same bf16 weights) the tokens are equal
    and ``avg_logprob`` agrees within BF16_LOGPROB_TOL: XLA and PyTorch
    round the bf16 activations of each layer after sums taken in other
    orders.  Each window is decoded from the JAX package's encoder
    states."""
    jp, pp = weights
    if activations == "bfloat16":
        jp = jax_random_params(jax_config(), seed=0, dtype="bfloat16")
        pp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    kwargs = dict(beam_size=5, temperature=0.0, max_new_tokens=48)
    audio = synth_audio(45.0, seed=4)

    pm = WhisperModel.from_parts(
        pp, tiny_test_config(), build_synthetic_tokenizer(), compute_type="int4",
        int4_group_size=group_size, device="cpu",
    )
    assert pm.model.int4 and pm.model.kv_int8
    w1 = pm.model.params["decoder"]["layers"]["mlp"]["w1"]
    assert w1.s.dim() == w1.q.dim() - (group_size is None) and int(w1.q.abs().max()) <= 7
    if activations == "float32":
        segments = list(pm.transcribe(audio, **kwargs)[0])
        assert segments and all(0.0 <= s.start <= s.end for s in segments)
        pm.model = WhisperEngine(
            PQ.quantize_params_int4(pp, group_size=group_size), tiny_test_config(),
            build_synthetic_tokenizer(), kv_int8=True, int4=True,
        )

    jm = JaxWhisperModel.from_parts(
        jp, jax_config(), jax_tokenizer(), compute_type="int4", int4_group_size=group_size,
    )
    states = []  # the JAX package's encoder states, one per decoded window
    jax_dispatch = jm.model.generate_dispatch

    def record(encoder_output, prompts, **kw):
        states.append(np.asarray(encoder_output.astype(jnp.float32)))
        return jax_dispatch(encoder_output, prompts, **kw)

    monkeypatch.setattr(jm.model, "generate_dispatch", record)
    ref_segments, ref_info = jm.transcribe(audio, **kwargs)
    ref_segments = list(ref_segments)

    replay = iter(states)
    port_generate = pm.model.generate
    dtype = getattr(torch, activations)
    monkeypatch.setattr(
        pm.model, "generate",
        lambda encoder_output, prompts, **kw: port_generate(
            torch.from_numpy(next(replay)).to(dtype), prompts, **kw
        ),
    )
    segments, info = pm.transcribe(audio, **kwargs)
    segments = list(segments)
    tol = LOGPROB_TOL if activations == "float32" else BF16_LOGPROB_TOL
    assert info.language == ref_info.language
    assert next(replay, None) is None
    assert len(segments) == len(ref_segments) > 0
    assert max(s.seek for s in segments) > 0
    for s, r in zip(segments, ref_segments):
        assert (s.id, s.seek, s.text, s.tokens) == (r.id, r.seek, r.text, r.tokens)
        assert (s.start, s.end) == (r.start, r.end)
        assert s.avg_logprob == pytest.approx(r.avg_logprob, abs=tol)
