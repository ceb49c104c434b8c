"""The port's decode loop and logits rules against the JAX package at the
micro config, on the same float32 weights and encoder states.

Greedy and beam-5 decodes, with and without timestamps, must give the JAX
package's tokens exactly and its scores to 1e-5 (float32; sums of
log-probabilities in another order), on float32 weights and on the same
weights quantized to int8 with int8 KV caches.  The int8 prefill and
decoder step give the JAX package's logits to 1e-5 and its cache codes
and scales exactly (int32 products are exact, and the float32 chains
around them run in the same order).  Sampling cannot match JAX's
threefry bit for bit, so it is held to seeded reproducibility and to the
logits rules instead."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from faster_whisper_tpu.generation import generate as JG
from faster_whisper_tpu.generation import processors as JP
from faster_whisper_tpu.models import model as JM
from faster_whisper_tpu.models.config import tiny_test_config as jax_config
from faster_whisper_tpu.models.load import random_params as jax_random_params
from faster_whisper_tpu.ops import quant as JQ
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.tokenizer import Tokenizer as JaxTokenizer
from faster_whisper_tpu_torch.generation import generate as PG
from faster_whisper_tpu_torch.generation import processors as PP
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.engine import WhisperEngine
from faster_whisper_tpu_torch.models import model as PM
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.ops import quant as PQ
from faster_whisper_tpu_torch.ops.quant import QuantKV
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer

SCORE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: under the
    suite's parallel workers, more threads wait at every op's barrier for
    cores that the other workers hold (a VAD call took 35 s so, 0.3 s on
    one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_shipped_compile_cache(monkeypatch):
    """The JAX side runs without the shipped compile-cache entries."""
    monkeypatch.setenv("FWT_CACHE_ARTIFACTS", "/nonexistent")


@pytest.fixture(scope="module")
def setup():
    jp = jax_random_params(jax_config(), seed=0, dtype="float32")
    mel = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)
    xa = np.array(JM.encode(jp, jax_config(), jnp.asarray(mel)))
    jtok = JaxTokenizer(jax_tokenizer(), True, task="transcribe", language="en")
    engine = WhisperEngine(
        params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
        tiny_test_config(),
        build_synthetic_tokenizer(),
    )
    return jp, xa, jtok, engine


def _meta(engine):
    m = engine.meta
    return JP.TokenMeta(
        eot=m.eot, timestamp_begin=m.timestamp_begin, no_timestamps=m.no_timestamps,
        no_speech=m.no_speech, blank=m.blank, vocab_size=m.vocab_size,
    )


@pytest.mark.parametrize(
    "beam_size,with_timestamps,rows",
    [(1, True, 1), (1, False, 1), (5, True, 1), (5, False, 1), (5, True, 2)],
)
def test_beam_search_and_greedy_match_jax(setup, beam_size, with_timestamps, rows):
    jp, xa, jtok, engine = setup
    prompt = list(jtok.sot_sequence) + ([] if with_timestamps else [jtok.no_timestamps])
    # a second row with a longer prompt exercises padding and per-row lengths
    prompts = [prompt, [jtok.sot_prev, 300, 301] + prompt][:rows]
    kwargs = dict(
        sot_id=jtok.sot, beam_size=beam_size, max_length=len(prompt) + 48,
        with_timestamps=with_timestamps, suppress_tokens=(jtok.no_speech,),
    )
    ref = JG.generate(jp, jax_config(), _meta(engine), jnp.asarray(xa[:rows]), prompts, **kwargs)
    ours = PG.generate_collect(
        PG.generate_dispatch(
            engine.params, engine.config, engine.meta,
            torch.from_numpy(xa[:rows]), prompts, **kwargs,
        )
    )
    for r, o in zip(ref, ours):
        assert o.sequences_ids == r.sequences_ids
        np.testing.assert_allclose(o.scores, r.scores, atol=SCORE_TOL, rtol=0)
        assert o.no_speech_prob == pytest.approx(r.no_speech_prob, abs=SCORE_TOL)


def _grammar_ok(seq, tsb):
    """Timestamps first, paired, non-decreasing (CT2/openai rules)."""
    ts = [t for t in seq if t >= tsb]
    return bool(seq) and seq[0] >= tsb and ts == sorted(ts)


def test_sampling_is_reproducible_under_a_seed_and_keeps_the_rules(setup):
    jp, xa, jtok, engine = setup
    sup = tuple(range(300, 340))
    kwargs = dict(
        beam_size=1, sampling_temperature=0.8, sampling_topk=0,
        num_hypotheses=3, max_length=40, suppress_tokens=sup,
    )
    x = torch.from_numpy(xa[:1])
    r1 = engine.generate(x, [jtok.sot_sequence], rng_seed=7, **kwargs)[0]
    r2 = engine.generate(x, [jtok.sot_sequence], rng_seed=7, **kwargs)[0]
    r3 = engine.generate(x, [jtok.sot_sequence], rng_seed=8, **kwargs)[0]
    assert r1.sequences_ids == r2.sequences_ids and r1.scores == r2.scores
    assert r1.sequences_ids != r3.sequences_ids
    assert r1.scores == sorted(r1.scores, reverse=True)
    for seq in r1.sequences_ids:
        assert _grammar_ok(seq, engine.meta.timestamp_begin)
        assert not set(seq) & set(sup)
        assert engine.meta.no_timestamps not in seq


def test_batched_ladder_rows_draw_what_each_rung_draws_alone(setup):
    jp, xa, jtok, engine = setup
    x = torch.from_numpy(xa[:1])
    kwargs = dict(beam_size=1, sampling_topk=0, num_hypotheses=2, max_length=30)
    both = engine.generate(
        x.expand(2, -1, -1), [jtok.sot_sequence] * 2,
        sampling_temperature=[0.4, 1.0], rng_seed=[11, 12], **kwargs,
    )
    solo = engine.generate(x, [jtok.sot_sequence], sampling_temperature=1.0, rng_seed=[12], **kwargs)
    assert both[1].sequences_ids == solo[0].sequences_ids


def _rule_case(rng, meta, ctx=24):
    """Random logits and token buffers, timestamps mixed into the history."""
    r = 6
    logits = rng.standard_normal((r, meta.vocab_size)).astype(np.float32)
    tokens = rng.integers(0, meta.vocab_size, (r, ctx)).astype(np.int32)
    tokens[:, 5:] = np.where(rng.random((r, ctx - 5)) < 0.3, tokens[:, 5:] % 300, tokens[:, 5:])
    tokens[1, 7:9] = tokens[1, 3:5]  # a repeated bigram for no-repeat-ngram
    sample_begin = np.full((r,), 4, np.int32)
    cur_len = np.array([4, 12, 5, 6, 20, 24], np.int32)
    return logits, tokens, cur_len, sample_begin


@pytest.mark.parametrize(
    "opts",
    [
        dict(),
        dict(with_timestamps=False),
        dict(suppress_blank=False, max_initial_timestamp_index=3),
        dict(repetition_penalty=1.5),
        dict(no_repeat_ngram_size=2, with_timestamps=False),
    ],
)
def test_logits_rules_match_jax(setup, opts):
    jp, xa, jtok, engine = setup
    meta = engine.meta
    rng = np.random.default_rng(len(str(opts)))
    logits, tokens, cur_len, sample_begin = _rule_case(rng, meta)
    po = PP.ProcessorOptions(suppress_tokens=(1, 5, 300), **opts)
    jo = JP.ProcessorOptions(suppress_tokens=(1, 5, 300), **opts)
    ref = np.asarray(
        JP.apply_logits_rules_logprobs(
            jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(cur_len),
            jnp.asarray(sample_begin), _meta(engine), jo,
        )
    )
    ours = PP.apply_logits_rules_logprobs(
        torch.from_numpy(logits), torch.from_numpy(tokens), torch.from_numpy(cur_len),
        torch.from_numpy(sample_begin), meta, po,
    ).numpy()
    np.testing.assert_array_equal(ours < -1e29, ref < -1e29)
    live = ref > -1e29
    np.testing.assert_allclose(ours[live], ref[live], atol=SCORE_TOL, rtol=0)

    if po.repetition_penalty == 1.0 and po.no_repeat_ngram_size == 0:
        # the carried variant sees the same history through three integers
        n = torch.from_numpy(cur_len - sample_begin).long()
        t = torch.from_numpy(tokens).long()
        idx = torch.from_numpy(cur_len).long()
        last = t.gather(1, (idx - 1).clamp(0)[:, None])[:, 0]
        penult = t.gather(1, (idx - 2).clamp(0)[:, None])[:, 0]
        pos = torch.arange(t.shape[1])[None, :]
        window = (pos >= torch.from_numpy(sample_begin)[:, None]) & (pos < idx[:, None])
        ts_max = torch.where(window & (t >= meta.timestamp_begin), t, -1).max(dim=1).values
        carried = PP.apply_logits_rules_logprobs_carried(
            torch.from_numpy(logits), n, last, penult, ts_max, meta, po
        ).numpy()
        np.testing.assert_array_equal(carried, ours)


def test_beam_candidate_select_matches_jax():
    """The port picks the 2K beam candidates with one ``torch.topk`` over the
    flattened (B, K*V) scores; the JAX package uses its chunked
    ``_exact_topk``.  Both must give the same values and indices at the
    beam grid of the 51866-token vocabulary (no ties in this input)."""
    x = np.random.default_rng(4).standard_normal((3, 5 * 51866)).astype(np.float32)
    jv, ji = JG._exact_topk(jnp.asarray(x), 10)
    v, i = torch.topk(torch.from_numpy(x), 10)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# int8 (compute_type int8: W8A8 weights, int8 self and cross caches)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_params(setup):
    """The same float32 weights quantized by each package."""
    jp, xa, jtok, engine = setup
    return JQ.quantize_params(jp), PQ.quantize_params(engine.params)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def test_int8_prefill_caches_and_decoder_step_match_jax(setup, int8_params):
    """The int8 prefill, ``_expand_caches(kv_int8=True)`` and one decoder
    step (K2's and K4's plain versions in every layer) against the JAX
    package's unfused step on the same caches."""
    jp, xa, jtok, engine = setup
    jq, pq = int8_params
    b, K, ctx = 2, 3, 32
    prompt = np.array([list(jtok.sot_sequence)] * b, np.int32)
    lengths = np.full((b,), prompt.shape[1], np.int32)
    gather = (lengths - 1)[:, None]

    prefill = jax.jit(JM.decoder_prefill, static_argnames=("config", "ctx"))
    j_logits, j_cache = prefill(jq, jax_config(), prompt, lengths, jnp.asarray(xa), gather, ctx=ctx)
    p_logits, p_cache = PM.decoder_prefill(
        pq, engine.config, torch.from_numpy(prompt).long(), torch.from_numpy(lengths).long(),
        torch.from_numpy(xa), torch.from_numpy(gather).long(), ctx=ctx,
    )
    np.testing.assert_allclose(_np(p_logits), _np(j_logits), atol=SCORE_TOL, rtol=0)

    j_caches = jax.jit(JG._expand_caches, static_argnums=(1, 2))(j_cache, K, True)
    p_caches = PG._expand_caches(p_cache, K, True)
    for jc, pc in zip(j_caches, p_caches):
        assert pc.s.dtype == torch.bfloat16 and pc.q.is_contiguous()
        assert tuple(pc.q.shape) == jc.q.shape and tuple(pc.s.shape) == jc.s.shape
        np.testing.assert_array_equal(pc.q.numpy(), np.asarray(jc.q))
        np.testing.assert_array_equal(_np(pc.s), _np(jc.s))

    # one step from the JAX package's caches, carried across exactly
    caches = [QuantKV(torch.from_numpy(np.array(c.q)), torch.from_numpy(_np(c.s)).bfloat16())
              for c in j_caches]
    rng = np.random.default_rng(0)
    token = rng.integers(0, 256, (b, K)).astype(np.int32)
    pos = np.full((b, K), prompt.shape[1], np.int32)
    anc = rng.integers(0, K, (b, K, ctx)).astype(np.int32)
    anc[:, :, prompt.shape[1]] = np.arange(K)
    step = jax.jit(JG._gen_decoder_step, static_argnames=("config", "fused"))
    j_out, j_sk, j_sv = step(
        jq, jax_config(), token, pos, pos[:, 0], *j_caches, anc, fused=False,
    )
    p_out, p_sk, p_sv = PG._gen_decoder_step(
        pq, engine.config, torch.from_numpy(token).long(), torch.from_numpy(pos).long(),
        torch.from_numpy(pos[:, 0]), *caches, torch.from_numpy(anc),
    )
    np.testing.assert_allclose(_np(p_out), _np(j_out), atol=SCORE_TOL, rtol=0)
    for pc, jc in ((p_sk, j_sk), (p_sv, j_sv)):
        np.testing.assert_array_equal(pc.q.numpy(), np.asarray(jc.q))
        np.testing.assert_array_equal(_np(pc.s), _np(jc.s))


@pytest.mark.parametrize(
    "beam_size,with_timestamps", [(1, True), (5, True), (5, False)],
)
def test_int8_beam_search_and_greedy_match_jax(setup, int8_params, beam_size, with_timestamps):
    jp, xa, jtok, engine = setup
    jq, pq = int8_params
    prompt = list(jtok.sot_sequence) + ([] if with_timestamps else [jtok.no_timestamps])
    kwargs = dict(
        sot_id=jtok.sot, beam_size=beam_size, max_length=len(prompt) + 48,
        with_timestamps=with_timestamps, suppress_tokens=(jtok.no_speech,),
    )
    ref = JG.generate(jq, jax_config(), _meta(engine), jnp.asarray(xa[:1]), [prompt],
                      kv_int8=True, **kwargs)
    ours = PG.generate_collect(
        PG.generate_dispatch(
            pq, engine.config, engine.meta, torch.from_numpy(xa[:1]), [prompt],
            kv_int8=True, **kwargs,
        )
    )
    for r, o in zip(ref, ours):
        assert o.sequences_ids == r.sequences_ids
        np.testing.assert_allclose(o.scores, r.scores, atol=SCORE_TOL, rtol=0)
        assert o.no_speech_prob == pytest.approx(r.no_speech_prob, abs=SCORE_TOL)
