"""The beam-search step over its fixed state (``generation/generate.py::
_beam_step``, ``_BeamState``, ``_StepGraph``) on the CPU, where every step
runs eagerly over the state that the card's CUDA graph replays on.

At the micro config, on the JAX package's float32 weights and encoder
states: greedy and beam-5 decodes with and without timestamps, two prompt
widths in one batch, rows that finish at different steps and rows that
reach ``max_length`` give the JAX package's tokens, finished pools and
no-speech probabilities, scores within 1e-5 (float32 sums of
log-probabilities in another order).  Two dispatches of one key share the
kept state and each hands back its own tables, whichever is collected
first; a decode that finds its key's state held runs on a state of its
own.  The step counter advances once a step, and a record taken apart
(``_build.counted_apart``, what a capture does) adds back to the same
counts (``_build.add_counts``, what a replay does)."""

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
from faster_whisper_tpu_torch.generation import generate as PG
from faster_whisper_tpu_torch.models.config import tiny_test_config
from faster_whisper_tpu_torch.models import model as PM
from faster_whisper_tpu_torch.models.engine import WhisperEngine
from faster_whisper_tpu_torch.models.load import params_from_jax
from faster_whisper_tpu_torch.ops import _build
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer

SCORE_TOL = 1e-5


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
def setup():
    jp = jax_random_params(jax_config(), seed=0, dtype="float32")
    mel = np.random.default_rng(0).standard_normal((3, 80, 3000)).astype(np.float32)
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


def _dispatch(engine, xa, prompts, **kwargs):
    return PG.generate_dispatch(engine.params, engine.config, engine.meta, torch.from_numpy(xa), prompts,
                                graphs=engine.step_graphs, **kwargs)


def _rows(results):
    return [(r.sequences_ids, r.scores, r.no_speech_prob) for r in results]


def _prompts(jtok, with_timestamps=True):
    prompt = list(jtok.sot_sequence) + ([] if with_timestamps else [jtok.no_timestamps])
    return prompt, [prompt, [jtok.sot_prev, 300, 301] + prompt]


def _assert_jax_results(ours, ref):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.sequences_ids == r.sequences_ids  # the whole finished pool, in order
        np.testing.assert_allclose(o.scores, r.scores, atol=SCORE_TOL, rtol=0)
        assert o.no_speech_prob == pytest.approx(r.no_speech_prob, abs=SCORE_TOL)


@pytest.mark.parametrize("beam_size", [1, 5])
@pytest.mark.parametrize("with_timestamps", [True, False])
def test_the_step_gives_the_jax_results_for_two_prompt_widths(setup, beam_size, with_timestamps):
    jp, xa, jtok, engine = setup
    prompt, prompts = _prompts(jtok, with_timestamps)
    kwargs = dict(sot_id=jtok.sot, beam_size=beam_size, sampling_temperature=0.0,
                  max_length=len(prompt) + 48, with_timestamps=with_timestamps,
                  suppress_tokens=(jtok.no_speech,))
    ref = JG.generate(jp, jax_config(), _meta(engine), jnp.asarray(xa[:2]), prompts, **kwargs)
    _assert_jax_results(PG.generate_collect(_dispatch(engine, xa[:2], prompts, **kwargs)), ref)


def test_rows_that_finish_at_different_steps(setup):
    """Three rows of prompt widths 4, 6 and 7 decode 150 positions: the
    random micro decoder keeps clear of end-of-text, so each row ends at
    the shared cap, three steps apart, and the rows done first run on at a
    frozen position until the last."""
    jp, xa, jtok, engine = setup
    prompt, prompts = _prompts(jtok)
    prompts = prompts + [[jtok.sot_prev, 400] + prompt]
    kwargs = dict(sot_id=jtok.sot, beam_size=5, max_length=len(prompt) + 150,
                  suppress_tokens=(jtok.no_speech,))
    ref = JG.generate(jp, jax_config(), _meta(engine), jnp.asarray(xa), prompts, **kwargs)
    calls = PG._gen_decoder_step.calls
    pending = _dispatch(engine, xa, prompts, **kwargs)
    ends = (pending.arrays[5].numpy() - pending.prompt_lens).tolist()
    assert ends == [150, 147, 148] and PG._gen_decoder_step.calls - calls == 150
    _assert_jax_results(PG.generate_collect(pending), ref)


@pytest.mark.parametrize("beam_size", [1, 5])
def test_rows_that_reach_max_length(setup, beam_size):
    """Every row stops at the cap of 12 new tokens, which the step counter
    shows: one call of the decoder step a step."""
    jp, xa, jtok, engine = setup
    prompt, _ = _prompts(jtok)
    prompts = [prompt, prompt]
    kwargs = dict(sot_id=jtok.sot, beam_size=beam_size, sampling_temperature=0.0,
                  max_length=len(prompt) + 12, suppress_tokens=(jtok.no_speech, jtok.eot))
    ref = JG.generate(jp, jax_config(), _meta(engine), jnp.asarray(xa[:2]), prompts, **kwargs)
    calls = PG._gen_decoder_step.calls
    pending = _dispatch(engine, xa[:2], prompts, **kwargs)
    assert PG._gen_decoder_step.calls - calls == 12
    assert (pending.arrays[5].numpy() == kwargs["max_length"]).all()
    _assert_jax_results(PG.generate_collect(pending), ref)


def test_two_dispatches_of_one_key_collected_in_reverse_order(setup, monkeypatch):
    """The second dispatch of a key rewrites the state the first ran on;
    the tables each hands back are its own, whichever is collected first."""
    jp, xa, jtok, engine = setup
    prompt, prompts = _prompts(jtok)
    kwargs = dict(sot_id=jtok.sot, beam_size=5, max_length=len(prompt) + 40,
                  suppress_tokens=(jtok.no_speech,))
    alone = [_rows(PG.generate_collect(_dispatch(engine, x, prompts, **kwargs))) for x in (xa[:2], xa[1:])]
    assert alone[0] != alone[1]
    taken = []
    take = engine.step_graphs.take

    def spy(*args):
        taken.append(take(*args))
        return taken[-1]

    monkeypatch.setattr(engine.step_graphs, "take", spy)
    first = _dispatch(engine, xa[:2], prompts, **kwargs)
    second = _dispatch(engine, xa[1:], prompts, **kwargs)
    assert taken[0] is not None and taken[0] is taken[1] and not taken[0].busy
    state = taken[0].state
    assert all(a.data_ptr() != b.data_ptr() for a in first.arrays for b in
               (state.hist_tok, state.hist_par, state.cur_len, state.sum_lp))
    assert _rows(PG.generate_collect(second)) == alone[1]
    assert _rows(PG.generate_collect(first)) == alone[0]


def test_a_decode_that_finds_its_key_held_runs_on_its_own_state(setup, monkeypatch):
    """A decode started inside another of the same key (after its first
    step, while it holds the key's state) gets no step graph, decodes on a
    state of its own, and both give what each gives alone."""
    jp, xa, jtok, engine = setup
    prompt, prompts = _prompts(jtok)
    kwargs = dict(sot_id=jtok.sot, beam_size=5, max_length=len(prompt) + 40,
                  suppress_tokens=(jtok.no_speech,))
    alone = [_rows(PG.generate_collect(_dispatch(engine, x, prompts, **kwargs))) for x in (xa[:2], xa[1:])]
    taken, inner = [], []
    take = engine.step_graphs.take

    def spy(*args):
        taken.append(take(*args))
        return taken[-1]

    monkeypatch.setattr(engine.step_graphs, "take", spy)
    with PG.after_first_launch(lambda: inner.append(_rows(PG.generate_collect(
            _dispatch(engine, xa[1:], prompts, **kwargs))))):
        outer = _rows(PG.generate_collect(_dispatch(engine, xa[:2], prompts, **kwargs)))
    assert taken[0] is not None and taken[1] is None
    assert outer == alone[0] and inner == [alone[1]]


def test_a_record_taken_apart_adds_back_to_the_same_counts(setup):
    """Inside ``counted_apart`` a decode leaves the counters alone and its
    record holds what it counted; ``add_counts`` adds that, as each replay
    of a captured step adds the capture's record."""
    jp, xa, jtok, engine = setup
    prompt, prompts = _prompts(jtok)
    kwargs = dict(sot_id=jtok.sot, beam_size=5, max_length=len(prompt) + 10,
                  suppress_tokens=(jtok.no_speech, jtok.eot))
    before = PG._gen_decoder_step.calls
    with _build.counted_apart() as record:
        PG.generate_collect(_dispatch(engine, xa[:2], prompts, **kwargs))
    assert PG._gen_decoder_step.calls == before
    assert record == {(PG._gen_decoder_step, "calls"): 10, (PM.decoder_prefill, "calls"): 1}
    _build.add_counts(record)
    _build.add_counts(record)
    assert PG._gen_decoder_step.calls == before + 20
    PG.generate_collect(_dispatch(engine, xa[:2], prompts, **kwargs))
    assert PG._gen_decoder_step.calls == before + 30


def test_a_model_s_step_graphs_go_with_it(setup):
    """A model's step graphs, their states and the caches in them, belong
    to its engine and are freed with it."""
    import gc
    import weakref

    jp, xa, jtok, engine = setup
    prompt, prompts = _prompts(jtok)
    own = WhisperEngine(engine.params, engine.config, build_synthetic_tokenizer())
    own.generate(torch.from_numpy(xa[:2]), prompts, max_length=len(prompt) + 6)
    (graph,) = own.step_graphs.graphs()
    state = weakref.ref(graph.state.self_k)
    assert all(g is not graph for g in engine.step_graphs.graphs())
    del own, graph
    gc.collect()
    assert state() is None


def test_the_step_graphs_keep_at_most_their_limit(setup):
    """Beyond ``limit`` keys the least recently used idle graph is dropped;
    while all are held a new key gets none (its decode runs eagerly), and
    a held key's second decode gets none either."""
    jp, xa, jtok, engine = setup
    graphs = PG.StepGraphs(limit=2)
    opts, proc, cpu = PG.GenOptions(), PG.ProcessorOptions(), torch.device("cpu")

    def take(b):
        return graphs.take(engine.params, engine.config, opts, proc, engine.meta, b, cpu)

    one, two = take(1), take(2)
    assert one is not None and two is not None and one is not two
    assert take(1) is None and take(3) is None
    graphs.release(one)
    three = take(3)
    assert three is not None and graphs.graphs() == [two, three]
    graphs.release(two)
    assert take(2) is two and graphs.graphs() == [three, two]


def test_the_step_graphs_limit_counts_each_device_apart(setup):
    """A device's ``limit`` graphs leave room for another device's keys,
    and a new key drops only an idle graph of its own device."""
    jp, xa, jtok, engine = setup
    graphs = PG.StepGraphs(limit=2)
    opts, proc = PG.GenOptions(), PG.ProcessorOptions()
    cpu, other = torch.device("cpu"), torch.device("meta")

    def take(b, dev):
        return graphs.take(engine.params, engine.config, opts, proc, engine.meta, b, dev)

    one, two = take(1, cpu), take(2, cpu)
    assert take(3, cpu) is None
    elsewhere = take(1, other)
    assert elsewhere is not None and graphs.graphs() == [one, two, elsewhere]
    graphs.release(elsewhere)
    graphs.release(one)
    three = take(3, cpu)
    assert three is not None and graphs.graphs() == [two, elsewhere, three]


def test_a_capture_keeps_the_masks_the_rules_read(setup):
    """Inside ``masks_kept`` (what a capture does) the decode's rules add
    each vocabulary mask they read, the cache's own tensors, to the record,
    which keeps them after the cache lets them go."""
    from faster_whisper_tpu_torch.generation import processors as P

    jp, xa, jtok, engine = setup
    prompt, prompts = _prompts(jtok)
    suppress = (jtok.no_speech, 300)
    kwargs = dict(sot_id=jtok.sot, beam_size=2, max_length=len(prompt) + 3, suppress_tokens=suppress)
    with P.masks_kept() as masks:
        PG.generate_collect(_dispatch(engine, xa[:2], prompts, **kwargs))
    v, cpu = engine.meta.vocab_size, torch.device("cpu")
    wanted = [P._id_mask(suppress, v, cpu), P._id_mask(tuple(engine.meta.blank) + (engine.meta.eot,), v, cpu)]
    assert {id(m) for m in masks} == {id(m) for m in wanted}
    P._id_mask.cache_clear()
    assert P._id_mask(suppress, v, cpu) is not wanted[0] and torch.equal(wanted[0], P._id_mask(suppress, v, cpu))
