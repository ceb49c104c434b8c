"""The port's decode loops run one table of ``ctx_cap`` positions from the
first step on, and give the JAX package's results with its ctx ladder
(``GenOptions.multi_phase``, ``FWT_MULTI_PHASE``) off and on, at the micro
config.

``beam_search`` (beam 5, and beam 1 at temperature 0) and ``sample``
(three hypotheses at top-1, whose draws are the argmax in both packages)
give the JAX package's tokens and scores (within 1e-5: float32 sums of
log-probabilities in another order), whichever way the JAX package runs
its ladder; every decode step of the port sees the one table.
``WhisperModel.transcribe`` gives the JAX package's segments with its
ladder on: text, tokens and times equal, ``avg_logprob`` within 1e-4
(float32 sums over a few dozen tokens, taken in another order)."""

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
from faster_whisper_tpu.testing import build_synthetic_tokenizer as jax_tokenizer
from faster_whisper_tpu.tokenizer import Tokenizer as JaxTokenizer
from faster_whisper_tpu.transcribe import WhisperModel as JaxWhisperModel
from faster_whisper_tpu_torch.generation import generate as PG
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models.engine import WhisperEngine
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
from faster_whisper_tpu_torch.transcribe import WhisperModel

SCORE_TOL = 1e-5
LOGPROB_TOL = 1e-4


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
def setup(weights):
    mel = np.random.default_rng(0).standard_normal((2, 80, 3000)).astype(np.float32)
    xa = torch.from_numpy(np.array(JM.encode(weights, jax_config(), jnp.asarray(mel))))
    jtok = JaxTokenizer(jax_tokenizer(), True, task="transcribe", language="en")
    engine = WhisperEngine(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"),
        tiny_test_config(),
        build_synthetic_tokenizer(),
    )
    return xa, jtok, engine


@pytest.fixture
def tables(monkeypatch):
    """Per decode of the port: its ``ctx_cap`` and the table widths its
    steps saw (the self cache the decoder step receives)."""
    seen = []
    step = PG._gen_decoder_step

    def capped(loop):
        def run(params, config, gen_opts, *args, **kwargs):
            seen.append((min(gen_opts.ctx_cap, config.n_text_ctx), set()))
            return loop(params, config, gen_opts, *args, **kwargs)
        return run

    def spy(params, config, token, pos, pos_row, self_k, *args, **kwargs):
        seen[-1][1].add(self_k.shape[4])
        return step(params, config, token, pos, pos_row, self_k, *args, **kwargs)

    spy.calls = 0  # the step counts its calls on the module's name
    monkeypatch.setattr(PG, "_gen_decoder_step", spy)
    monkeypatch.setattr(PG, "beam_search", capped(PG.beam_search))
    monkeypatch.setattr(PG, "sample", capped(PG.sample))
    return seen


def _meta(engine):
    m = engine.meta
    return JP.TokenMeta(
        eot=m.eot, timestamp_begin=m.timestamp_begin, no_timestamps=m.no_timestamps,
        no_speech=m.no_speech, blank=m.blank, vocab_size=m.vocab_size,
    )


@pytest.mark.parametrize("jax_ladder", [True, False])
@pytest.mark.parametrize("kind", ["beam5", "greedy", "sample"])
def test_one_table_gives_the_jax_tokens_and_scores(setup, weights, monkeypatch, tables, kind, jax_ladder):
    """The port on one 192-column table against the JAX package with its
    ladder on (64, then 128, then 192 columns) or off."""
    xa, jtok, engine = setup
    prompt = list(jtok.sot_sequence)
    prompts = [prompt, [jtok.sot_prev, 300, 301] + prompt]
    kwargs = dict(sot_id=jtok.sot, max_length=len(prompt) + 150, suppress_tokens=(jtok.no_speech,))
    if kind == "beam5":
        kwargs.update(beam_size=5)
    elif kind == "greedy":
        kwargs.update(beam_size=1, sampling_temperature=0.0)
    else:
        kwargs.update(beam_size=1, sampling_temperature=0.8, sampling_topk=1, num_hypotheses=3, rng_seed=7)
    monkeypatch.setenv("FWT_MULTI_PHASE", "1" if jax_ladder else "0")
    assert JG._ctx_phases(len(prompt), 192, JG.GenOptions(multi_phase=jax_ladder, fused_attn=True)) == (
        [64, 128, 192] if jax_ladder else [192])
    ref = JG.generate(weights, jax_config(), _meta(engine), jnp.asarray(xa.numpy()), prompts, **kwargs)
    ours = PG.generate_collect(PG.generate_dispatch(
        engine.params, engine.config, engine.meta, xa[: len(prompts)], prompts, **kwargs
    ))
    assert tables == [(192, {192})]
    assert max(len(s) for r in ours for s in r.sequences_ids) > 64 - len(prompt)
    for a, b in zip(ours, ref):
        assert a.sequences_ids == b.sequences_ids
        np.testing.assert_allclose(a.scores, b.scores, atol=SCORE_TOL, rtol=0)
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, abs=SCORE_TOL)


def test_transcribe_gives_the_jax_segments_with_the_ladder_on(weights, monkeypatch, tables):
    monkeypatch.setenv("FWT_MULTI_PHASE", "1")
    t = np.arange(8 * 16000) / 16000
    rng = np.random.default_rng(4)
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    jm = JaxWhisperModel.from_parts(weights, jax_config(), jax_tokenizer())
    pm = WhisperModel.from_parts(
        params_from_jax(jax.tree.map(np.asarray, weights), device="cpu"), tiny_test_config(),
        build_synthetic_tokenizer(), compute_type="float32", device="cpu",
    )
    kwargs = dict(language="en", beam_size=2, max_new_tokens=100, temperature=0.0)
    ref = list(jm.transcribe(audio, **kwargs)[0])
    ours = list(pm.transcribe(audio, **kwargs)[0])
    assert tables and all(widths == {cap} for cap, widths in tables), tables
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert (a.text, a.tokens, a.start, a.end) == (b.text, b.tokens, b.start, b.end)
        assert a.avg_logprob == pytest.approx(b.avg_logprob, abs=LOGPROB_TOL)
