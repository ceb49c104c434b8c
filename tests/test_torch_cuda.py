"""The port's CUDA kernels on the card: build them from ``csrc/`` with
nvcc, then hold every form of K1, K2, K3 and K4 (bfloat16 and float32
activations, raw and int8 caches) and the probe kernels P1, P2b and P2h
against their plain versions at the main path's shapes and at ragged ones (``chip_smoke.py`` phases 2 and 3:
K1/K2 with the write position on and beside their column chunks'
boundaries, and in a CUDA graph), a row of K1/K2/K4 alone against its
batch and its head slice (bit-equal), a small model at every compute
type against the CPU, and at int8 the same tokens at batch 8 and 2 and
under ``tensor_parallel=2``; the LayerNorm kernel against its plain
version, a row's bits alone and among 10 to 12000 rows, and the int8
pipeline at large-v3-turbo width giving equal segments at batch 8 and at
batch 2; P2b bit for bit equal to its exact int64 reference; the
whole-file log-mel on the card against the host path; a decode replayed
from its step graph bit-equal to the eager one at the benchmark cells'
widths, and two threads decoding one key at once.  Skips without
a card; on the card run

    python -m pytest -m cuda tests/test_torch_cuda.py

Unlike the parity tests, this file does not import JAX, so that it runs
where only PyTorch is installed.
"""

import os
import shutil

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    if shutil.which("nvcc") is None and not os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.build_kernels()
    return torch.cuda.get_device_name(0)


def test_beam_attention_kernel_matches_plain_version(card):
    assert chip_smoke.check_beam_attention() >= 0.0


def test_float32_beam_attention_kernel_matches_plain_version(card):
    assert chip_smoke.check_beam_attention(dtype=torch.float32) >= 0.0


def test_int8_beam_attention_kernel_matches_plain_version(card):
    err, _codes_one_unit_apart = chip_smoke.check_beam_attention_int8()
    assert err >= 0.0


def test_int8_beam_attention_kernel_with_float32_activations_matches_plain_version(card):
    err, _codes_one_unit_apart = chip_smoke.check_beam_attention_int8(dtype=torch.float32)
    assert err >= 0.0


def test_beam_attention_kernels_in_a_cuda_graph_reset_their_tickets(card):
    """Every form of K1/K2, two layers in one CUDA graph, replayed twice."""
    for form in chip_smoke.K1_FORMS:
        chip_smoke.check_beam_attention_graph(form)


def test_flash_attention_kernel_matches_plain_version(card):
    assert chip_smoke.check_flash_attention(**chip_smoke.K3_SHAPES) >= 0.0


def test_float32_flash_attention_kernel_matches_plain_version(card):
    assert chip_smoke.check_flash_attention(**chip_smoke.K3_SHAPES, dtype=torch.float32) >= 0.0


def test_cross_attention_kernel_matches_plain_version(card):
    """Every form at ragged and full T, 1 to 16 beams, two calls back to
    back and two layers in one CUDA graph."""
    worst = chip_smoke.check_cross_attention(
        batches=(1, 8), Ts=(1, 100, 1500, 1501), Ks=(1, 5, 16), L=2
    )
    assert set(worst) == {"bf16", "int8", "f32", "int8 f32", "int8 qmax7", "int8 qmax7 f32"}


def test_small_model_on_the_card_matches_the_cpu_at_every_compute_type(card):
    chip_smoke.check_small_model_against_cpu()


def test_int8_dense_on_the_card_matches_the_cpu(card):
    """The card's int8 product (the W8A8 kernel of ``csrc/w8a8.cu`` on the
    codes laid out by ``card_layout``) gives the CPU's exact int32 sums: at
    5 rows, the decode's beam grid, at the padded 51872-column logits head,
    and over 64 input rows (a row-parallel shard of a 128-wide model) at 40
    and 1500 rows."""
    from faster_whisper_tpu_torch.ops.quant import card_layout, int8_dense, quantize_weight

    g = torch.Generator().manual_seed(0)
    for rows, n_in, n_out in ((5, 1280, 1280), (40, 1280, 51872), (40, 64, 128), (1500, 64, 128)):
        x = torch.randn((rows, n_in), generator=g)
        w = quantize_weight(0.02 * torch.randn((n_in, n_out), generator=g))
        cpu = int8_dense(x, w, out_dtype=torch.float32)
        w_card = card_layout(type(w)(w.q.cuda(), w.s.cuda()))
        card = int8_dense(x.cuda(), w_card, out_dtype=torch.float32).cpu()
        torch.testing.assert_close(card, cpu, rtol=1e-6, atol=1e-6)


def test_grouped_int8_dense_on_the_card_matches_the_cpu(card):
    """int4's group-wise product on the card (one torch._int_mm per group
    of input rows; rows padded to 17, and to a multiple of 32 for groups
    below 128 rows) against the CPU's, at the beam grid's 5 rows, the
    batched pipeline's 40 and an encoder window's 1500 and 3000, over 1280
    and 5120 input rows in groups of 32, 64 and 128: exact int32 partials,
    the float32 sum over the groups within 1e-6."""
    from faster_whisper_tpu_torch.ops.quant import int8_dense, quantize_weight

    g = torch.Generator().manual_seed(1)
    for rows, n_in, group in ((5, 1280, 128), (40, 5120, 128), (5, 1280, 64), (40, 1280, 32),
                              (1500, 1280, 64), (3000, 256, 64), (1500, 5120, 128)):
        x = torch.randn((rows, n_in), generator=g)
        w = quantize_weight(0.02 * torch.randn((n_in, 1280), generator=g), qmax=7, group_size=group)
        cpu = int8_dense(x, w, out_dtype=torch.float32)
        card = int8_dense(x.cuda(), type(w)(w.q.cuda(), w.s.cuda()), out_dtype=torch.float32).cpu()
        torch.testing.assert_close(card, cpu, rtol=1e-6, atol=1e-6)


def test_wrappers_count_launches_and_reject_what_the_kernels_do_not_take(card):
    from faster_whisper_tpu_torch.ops.attention import mha_flash
    from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append

    q, k, v = chip_smoke.k3_inputs(1, S=100)
    n = (mha_flash.launches, mha_flash.launches_f32)
    mha_flash(q, k, v)
    mha_flash(q.float(), k.float(), v.float())
    assert (mha_flash.launches, mha_flash.launches_f32) == (n[0] + 1, n[1] + 1)
    with pytest.raises(TypeError):
        mha_flash(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        mha_flash(q, k.float(), v)
    with pytest.raises(ValueError):
        mha_flash(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

    x = chip_smoke.k1_inputs(1, 3)
    n = beam_attend_append.launches
    chip_smoke._k1_call(beam_attend_append, x)
    assert beam_attend_append.launches == n + 1
    with pytest.raises(TypeError):
        beam_attend_append(
            0, x["pos_row"].long(), x["q"], x["k_new"], x["v_new"],
            x["self_k"], x["self_v"], x["anc"],
        )
    with pytest.raises(ValueError):  # the kernel is built for a head dim of 64
        chip_smoke._k1_call(beam_attend_append, chip_smoke.k1_inputs(1, 3, D=32))

    x = chip_smoke.k2_inputs(1, 3)
    n, n1 = beam_attend_append.launches_int8, beam_attend_append.launches
    chip_smoke._k1_call(beam_attend_append, x)
    assert (beam_attend_append.launches_int8, beam_attend_append.launches) == (n + 1, n1)
    with pytest.raises(TypeError):  # f32 scales: the kernel takes bf16
        sk = type(x["self_k"])(x["self_k"].q, x["self_k"].s.float())
        beam_attend_append(
            0, x["pos_row"], x["q"], x["k_new"], x["v_new"], sk, x["self_v"], x["anc"],
        )

    from faster_whisper_tpu_torch.ops.cross_attention import cross_attend

    names = ("launches", "launches_f32", "launches_int8", "launches_int8_f32")
    for quant, dtype, counter in (
        (False, torch.bfloat16, "launches"), (False, torch.float32, "launches_f32"),
        (True, torch.bfloat16, "launches_int8"), (True, torch.float32, "launches_int8_f32"),
    ):
        layer, q, ck, cv = chip_smoke.k4_inputs(1, quant, T=100, dtype=dtype)
        n = {a: getattr(cross_attend, a) for a in names}
        cross_attend(layer, q, ck, cv)
        assert {a: getattr(cross_attend, a) for a in names} == {a: n[a] + (a == counter) for a in names}
        with pytest.raises(TypeError):
            cross_attend(layer, q.half(), ck, cv)
        with pytest.raises(ValueError):  # more beams than the kernel holds
            cross_attend(layer, q.repeat(1, 1, 4, 1), ck, cv)
        if not quant:
            with pytest.raises(TypeError):  # a raw cache in another dtype than q
                other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
                cross_attend(layer, q, ck.to(other), cv.to(other))


def test_probe_kernels_match_their_plain_versions(card):
    """P1, P2b and P2h at the probe scripts' shape (``chip_smoke.py``
    phase 3): equal q codes, P1's weight codes at most one unit apart,
    P1's output within the bf16 tolerance, P2's sums within 1e-5 of their
    terms' magnitudes; P2h twice in a row (its sums and tickets reset)."""
    errs, _moved = chip_smoke.check_probes()
    assert set(errs) == {"P1", "P2b", "P2h"}


def test_probe_kernels_leave_no_state_between_calls(card):
    """P1 (clusters of 2 CTAs at ctx=64, of 4 at 192) and P2h (clusters
    of 4 CTAs at H=4, of 10 at H=20) twice in a row on the same inputs:
    the second call equals the first, and both equal a call on a copy."""
    from faster_whisper_tpu_torch.ops import probes

    for shape in ((2, 4, 5, 64, 64, 2), (8, 20, 5, 192, 64, 1)):
        x = probes.probe_inputs(*shape, device="cuda", pos=shape[3] // 2)
        args = (shape[5] - 1, x["pos"], x["q"], x["self_k"], x["self_v"], x["anc"])
        first, second = probes.attend_only(*args), probes.attend_only(*args)
        assert torch.equal(first, second)
        kq = x["self_k"].q
        first, second = probes.scores_perhead(0, x["q_flat"], kq), probes.scores_perhead(0, x["q_flat"], kq)
        again = probes.scores_perhead(0, x["q_flat"].clone(), kq.clone())
        assert torch.equal(first, second) and torch.equal(first, again)


def test_a_rows_kernel_outputs_are_the_same_bits_alone_in_a_batch_and_as_a_head_slice(card):
    """K1/K2 and K4, every form (``chip_smoke.py`` phase 3): one row alone,
    inside its batch of 8 and as heads 10-19 of its 20, bit-equal."""
    assert chip_smoke.check_batch_invariance() == 2 * (len(chip_smoke.K1_FORMS) + len(chip_smoke.K4_FORMS))


def test_int8_tokens_of_a_chunk_are_the_same_at_batch_8_and_at_batch_2(card):
    """A small model at int8 (bf16 activations): the beam decode of two
    chunks' encoder states inside a batch of 8 and as a batch of 2 gives
    equal tokens and scores, since no kernel's plan moves with the
    batch."""
    from faster_whisper_tpu_torch.tokenizer import Tokenizer
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg, cpu, tok = chip_smoke.small_model_parts()
    model = WhisperModel.from_parts(cpu, cfg, tok, compute_type="int8", device="cuda")
    g = torch.Generator(device="cuda").manual_seed(16)
    states = model.model.encode(torch.randn((8, cfg.n_mels, 3000), generator=g, device="cuda"))
    tokenizer = Tokenizer(model.hf_tokenizer, model.model.is_multilingual, task="transcribe", language="en")
    prompt = model.get_prompt(tokenizer, [], without_timestamps=True)
    kwargs = dict(beam_size=5, max_length=len(prompt) + 64, suppress_tokens=chip_smoke.SMALL_SPECIALS)
    at8 = model.model.generate(states, [prompt] * 8, **kwargs)[6:]
    at2 = model.model.generate(states[6:].contiguous(), [prompt] * 2, **kwargs)
    assert [(r.sequences_ids, r.scores) for r in at8] == [(r.sequences_ids, r.scores) for r in at2]
    assert all(len(r.sequences_ids[0]) > 0 for r in at2)


def test_int8_tensor_parallel_on_one_card_gives_one_devices_tokens_and_times(card):
    """``tensor_parallel=2`` on ``[0, 0]`` at int8 against one device: every
    product is exact, every all-reduce an integer sum and K1/K2/K4 split a
    row alike at 1 head per shard as at 2, so the tokens and times are
    bit-equal."""
    cfg, cpu, tok = chip_smoke.small_model_parts()
    audio = chip_smoke.synth_audio(40.0, seed=4)
    _, want = _tp_segments(cfg, cpu, tok, "int8_bfloat16", 0, 1, audio)
    model, got = _tp_segments(cfg, cpu, tok, "int8_bfloat16", [0, 0], 2, audio)
    assert model.mesh.shape == {"data": 1, "model": 2}
    assert [r[:4] for r in got] == [r[:4] for r in want] and len(got) > 0


def test_layer_norm_kernel_matches_plain_version(card):
    """bf16 within BF16_REL_TOL and float32 within LN_F32_REL_TOL of the
    output scale at a decode step's and an encode's rows and at other
    widths, a second call equal to the first (``chip_smoke.py`` phase 3)."""
    errs = chip_smoke.check_layer_norm()
    assert set(errs) == {"LN", "LN bf16", "LN f32"}


def test_a_layer_norm_row_is_the_same_bits_alone_and_among_any_rows(card):
    """A row alone and inside 10, 16, 40 and 12000 rows: the kernel's
    layout follows the width alone."""
    for dtype in (torch.bfloat16, torch.float32):
        differ = chip_smoke.ln_rows_differ(dtype)
        assert {(1, 10), (1, 16), (1, 40), (1, 12000), (10, 40), (40, 12000)} <= set(differ)
        assert not any(differ.values()), differ


def test_layer_norm_wrapper_counts_launches_and_rejects_what_the_kernel_does_not_take(card):
    from faster_whisper_tpu_torch.models.model import layer_norm

    x, w, b = chip_smoke.ln_inputs(40, 1280, torch.bfloat16, seed=1)
    n = layer_norm.launches
    first, second = layer_norm(x, w, b), layer_norm(x, w, b)
    assert torch.equal(first, second) and layer_norm.launches == n + 2
    with pytest.raises(ValueError):  # a width that is not a multiple of 8
        layer_norm(x[:, :100].contiguous(), w[:100].contiguous(), b[:100].contiguous())
    with pytest.raises(ValueError):  # wider than 1024 threads of 8
        y, wy, by = chip_smoke.ln_inputs(2, 8200, torch.bfloat16, seed=2)
        layer_norm(y, wy, by)
    with pytest.raises(TypeError):  # float16: the kernel takes bfloat16 or float32
        layer_norm(x.half(), w.half(), b.half())
    with pytest.raises(TypeError):  # a gain in another dtype than x
        layer_norm(x, w.float(), b)
    with pytest.raises(ValueError):  # a strided last axis
        layer_norm(torch.empty((1280, 40), dtype=torch.bfloat16, device="cuda").t(), w, b)
    with pytest.raises(ValueError):  # rows 8 bytes off a 16-byte boundary
        layer_norm(x.view(-1)[4 : 4 + 39 * 1280].view(39, 1280), w, b)
    assert layer_norm.launches == n + 2


def test_int8_pipeline_gives_the_same_segments_at_batch_8_and_at_batch_2(card):
    """The card's counterpart of the JAX suite's
    ``test_transcribe.py::test_partial_trailing_batch_matches_unpadded``:
    ``docker/jfk.flac`` tiled to 5 minutes through the pipeline at
    large-v3-turbo width, int8, at batch 8 (batches of 8 and 2) and at
    batch 2 (five of 2) gives equal segments: tokens, times and
    ``avg_logprob`` bit for bit, since every op of the int8 path (the
    LayerNorm kernel among them) splits a row alike in any batch."""
    from faster_whisper_tpu_torch.models.config import CONFIGS
    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline, WhisperModel

    cfg = CONFIGS["large-v3-turbo"]
    params = random_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    model = WhisperModel.from_parts(params, cfg, build_synthetic_tokenizer(base_vocab=50257),
                                    compute_type="int8")
    del params
    _, speech = chip_smoke.tiled_speech()
    pipe = BatchedInferencePipeline(model)
    kwargs = dict(language="en", beam_size=5, max_new_tokens=128)

    def rows(segments):
        return [(s.seek, s.start, s.end, s.tokens, s.avg_logprob) for s in segments]

    at8 = rows(pipe.transcribe(speech, batch_size=8, **kwargs)[0])
    at2 = rows(pipe.transcribe(speech, batch_size=2, **kwargs)[0])
    del model, pipe
    torch.cuda.empty_cache()
    assert at8 == at2 and len(at8) >= 8


def test_p2b_equals_its_exact_reference_bit_for_bit(card):
    """P2b's int64 total over its exact s32 column sums, scaled once: the
    bits of ``scores_batched_exact`` at the probe shape, a small one, the
    most rows it takes (K=8, ctx=448) and one row per (b, h); a second call
    equal to the first."""
    from faster_whisper_tpu_torch.ops import probes

    for shape in ((2, 4, 5, 64, 64, 2), (8, 20, 5, 192, 64, 2), (1, 2, 8, 448, 64, 1), (3, 2, 1, 1, 64, 1)):
        x = probes.probe_inputs(*shape, device="cuda", seed=11)
        kq = x["self_k"].q
        for layer in range(shape[5]):
            out = probes.scores_batched(layer, x["q"], kq)
            again = probes.scores_batched(layer, x["q"], kq)
            assert torch.equal(out, probes.scores_batched_exact(layer, x["q"], kq)), shape
            assert torch.equal(out, again)


def test_probe_wrappers_count_launches_and_reject_what_the_kernels_do_not_take(card):
    from faster_whisper_tpu_torch.ops import probes

    x = probes.probe_inputs(2, 4, 5, 64, 64, 2, device="cuda", pos=30)
    kq = x["self_k"].q
    n = (probes.attend_only.launches, probes.scores_batched.launches, probes.scores_perhead.launches)
    probes.attend_only(1, x["pos"], x["q"], x["self_k"], x["self_v"], x["anc"])
    probes.scores_batched(1, x["q"], kq)
    probes.scores_perhead(1, x["q_flat"], kq)
    assert (probes.attend_only.launches, probes.scores_batched.launches,
            probes.scores_perhead.launches) == tuple(c + 1 for c in n)
    with pytest.raises(TypeError):  # the kernels take bf16 queries
        probes.scores_batched(1, x["q"].float(), kq)
    with pytest.raises(ValueError):  # layer outside the cache
        probes.scores_perhead(2, x["q_flat"], kq)
    with pytest.raises(ValueError):  # more beams than the kernels hold
        y = probes.probe_inputs(1, 2, 9, 16, 64, 1, device="cuda", pos=3)
        probes.attend_only(0, y["pos"], y["q"], y["self_k"], y["self_v"], y["anc"])
    with pytest.raises(TypeError):  # f32 scales: the kernel takes bf16
        sk = type(x["self_k"])(kq, x["self_k"].s.float())
        probes.attend_only(1, x["pos"], x["q"], sk, x["self_v"], x["anc"])


def test_the_ctx_ladder_and_the_mesh_on_the_card(card):
    """A small model at bf16: every decode on one table of its ctx cap (the
    port runs no ctx ladder), and the pipeline on ``device_index=[0, 0]``
    gives one device's segments."""
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline, WhisperModel

    cfg, cpu, tok = chip_smoke.small_model_parts()
    model = WhisperModel.from_parts(cpu, cfg, tok, compute_type="bfloat16", device="cuda")
    audio = chip_smoke.synth_audio(40.0, seed=4)
    with chip_smoke.WidthProbe() as tables:
        segments = model.transcribe(audio, language="en", beam_size=5, max_new_tokens=150,
                                    temperature=0.0, suppress_tokens=chip_smoke.SMALL_SPECIALS)[0]
        assert list(segments)
    assert tables.widths and tables.widths == tables.caps
    _, speech = chip_smoke.tiled_speech(66.0)
    mesh = WhisperModel.from_parts(cpu, cfg, tok, compute_type="bfloat16", device="cuda",
                                   device_index=[0, 0])
    kwargs = dict(language="en", batch_size=4, max_new_tokens=48)
    one = [(s.seek, s.tokens) for s in BatchedInferencePipeline(model).transcribe(speech, **kwargs)[0]]
    two = [(s.seek, s.tokens) for s in BatchedInferencePipeline(mesh).transcribe(speech, **kwargs)[0]]
    assert one == two and mesh.model.replica_batches == [1, 1]


def test_replica_threads_run_on_their_replicas_cards(card, monkeypatch):
    """A mesh over the cards (``[0, 0]`` on a one-card machine, else two
    or four): each replica's encode and decode run on a host thread whose
    current device is the replica's card, every replica decodes a shard of
    the one batch of 4 chunks, and the pipeline gives one device's
    segments at the shards' batch size."""
    import threading

    from faster_whisper_tpu_torch.models import engine as E
    from faster_whisper_tpu_torch.transcribe import BatchedInferencePipeline, WhisperModel

    n = torch.cuda.device_count()
    idx = [0, 1, 2, 3][: 4 if n >= 4 else 2] if n > 1 else [0, 0]
    cfg, cpu, tok = chip_smoke.small_model_parts()
    model = WhisperModel.from_parts(cpu, cfg, tok, compute_type="bfloat16", device="cuda")
    mesh = WhisperModel.from_parts(cpu, cfg, tok, compute_type="bfloat16", device="cuda",
                                   device_index=idx)
    seen = []

    def spy(fn, what):
        def run(*args, **kwargs):
            states = args[3] if what == "decode" else mesh.model.replicas[args[0]][0]
            dev = states.device if what == "decode" else states
            seen.append((what, threading.current_thread().name, dev.index, torch.cuda.current_device()))
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(E, "generate_dispatch", spy(E.generate_dispatch, "decode"))
    monkeypatch.setattr(mesh.model, "_encode_on", spy(mesh.model._encode_on, "encode"))
    _, speech = chip_smoke.tiled_speech(66.0)
    kwargs = dict(language="en", max_new_tokens=48)
    two = [(s.seek, s.tokens) for s in BatchedInferencePipeline(mesh).transcribe(
        speech, batch_size=4, **kwargs)[0]]
    monkeypatch.undo()
    one = [(s.seek, s.tokens) for s in BatchedInferencePipeline(model).transcribe(
        speech, batch_size=4 // len(idx), **kwargs)[0]]
    on_replicas = [s for s in seen if s[1].startswith("fwt-replica")]
    assert {s[0] for s in on_replicas} == {"encode", "decode"}
    assert all(dev == current for _, _, dev, current in on_replicas), on_replicas
    assert mesh.model.replica_batches == [1] * len(idx), mesh.model.replica_batches
    assert one == two


def test_kernels_on_a_second_card_launch_there_from_card_0s_thread(card):
    """With card 0 current: a small model on card 1 (K1, K3, K4 at bf16,
    K2 and K4b at int8) gives card 0's segments, and P1, P2b and P2h on
    card 1's tensors equal their results on card 0.  Needs two cards."""
    from faster_whisper_tpu_torch.ops import probes
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the launch on a card that is not the current device")
    assert torch.cuda.current_device() == 0
    cfg, cpu, tok = chip_smoke.small_model_parts()
    audio = chip_smoke.synth_audio(40.0, seed=4)
    for compute_type in ("bfloat16", "int8_bfloat16"):
        rows = []
        for index in (0, 1):
            model = WhisperModel.from_parts(cpu, cfg, tok, compute_type=compute_type, device="cuda",
                                            device_index=index)
            segments = model.transcribe(audio, language="en", beam_size=5, max_new_tokens=100,
                                        temperature=0.0, suppress_tokens=chip_smoke.SMALL_SPECIALS)[0]
            rows.append([(s.seek, s.tokens, s.avg_logprob) for s in segments])
        assert rows[0] == rows[1], compute_type
    outs = []
    for dev in ("cuda:0", "cuda:1"):
        x = probes.probe_inputs(2, 4, 5, 64, 64, 2, device=dev, pos=30)
        outs.append([
            probes.attend_only(1, x["pos"], x["q"], x["self_k"], x["self_v"], x["anc"]).cpu(),
            probes.scores_batched(1, x["q"], x["self_k"].q).cpu(),
            probes.scores_perhead(1, x["q_flat"], x["self_k"].q).cpu(),
        ])
    torch.cuda.synchronize(1)
    assert torch.cuda.current_device() == 0
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_speculative_encode_on_the_side_stream_equals_the_in_line_encode(card):
    """A small model at bf16, int8 and float32: the side stream's encode is
    ``torch.equal`` to the in-line one and launches K3 and no K1, K2 or
    K4; with speculation on, a sequential request gives the segments it
    gives with speculation off, with at least one hit."""
    chip_smoke.check_small_speculation()


def test_upload_with_vad_on_the_card_equals_the_serial_upload(card):
    """``upload_with_vad`` over ``docker/jfk.flac`` tiled to 150 s (three
    slices): the PCM equal to ``upload_audio``'s, the probabilities within
    the VAD's tolerance of the whole-buffer forward, equal speech
    timestamps."""
    jfk, speech = chip_smoke.tiled_speech(150.0)
    assert chip_smoke.check_pipelined_vad(speech, card) <= chip_smoke.VAD_PROB_TOL


def test_memory_report_on_the_card_returns_both_programs(card):
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cfg, cpu, tok = chip_smoke.small_model_parts()
    for compute_type in ("bfloat16", "int8"):
        model = WhisperModel.from_parts(cpu, cfg, tok, compute_type=compute_type, device="cuda")
        rep = model.model.memory_report(batch_size=2, beam_size=2, max_new_tokens=8)
        assert list(rep) == ["weights_bytes", "encode", "decode"]
        for name in ("encode", "decode"):
            r = rep[name]
            assert list(r) == ["argument_bytes", "output_bytes", "temp_bytes", "code_bytes", "peak_bytes"]
            assert r["peak_bytes"] == r["argument_bytes"] + r["temp_bytes"]
            assert r["argument_bytes"] > rep["weights_bytes"] > 0 and r["temp_bytes"] >= r["output_bytes"] > 0
            assert r["code_bytes"] > 0


def test_mock_gate_on_the_card(card):
    from faster_whisper_tpu_torch import validate

    assert validate.main(["--mock"]) == 0


def _tp_segments(cfg, params, tok, compute_type, device_index, tensor_parallel, audio):
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    model = WhisperModel.from_parts(params, cfg, tok, compute_type=compute_type, device="cuda",
                                    device_index=device_index, tensor_parallel=tensor_parallel)
    segments = model.transcribe(audio, language="en", beam_size=5, max_new_tokens=100,
                                temperature=0.0, suppress_tokens=chip_smoke.SMALL_SPECIALS)[0]
    return model, [(s.seek, s.start, s.end, s.tokens, s.avg_logprob) for s in segments]


def test_tensor_parallel_on_one_card_equals_the_cpu(card):
    """A small float32 model as one group of two shards on ``[0, 0]``,
    through the pipeline, against the same group on the host: equal
    tokens and times (``chip_smoke.py`` phase 14)."""
    jfk, _ = chip_smoke.tiled_speech(11.0)
    chip_smoke.check_small_pipeline_against_cpu(jfk, tensor_parallel=2)


def test_tensor_parallel_over_two_cards_equals_one_card_bitwise(card):
    """``tensor_parallel=2`` on ``[0, 1]`` (NCCL) against ``[0, 0]`` (the
    local sum) at bf16 and int8: one rounding of a sum of two partials on
    either transport, so equal segments and scores.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the NCCL transport")
    cfg, cpu, tok = chip_smoke.small_model_parts()
    audio = chip_smoke.synth_audio(40.0, seed=4)
    for compute_type in ("bfloat16", "int8_bfloat16"):
        local, want = _tp_segments(cfg, cpu, tok, compute_type, [0, 0], 2, audio)
        nccl, got = _tp_segments(cfg, cpu, tok, compute_type, [0, 1], 2, audio)
        assert local.model.params.group.transport == "local"
        assert nccl.model.params.group.transport == "nccl"
        assert got == want and len(got) > 0


def test_tensor_parallel_over_four_cards_gives_one_cards_tokens(card):
    """``tensor_parallel=4`` over four cards (a small float32 model of 4
    heads of 64, one per shard) against one card: equal tokens, times
    within one 0.02 s quantum.  Needs four cards."""
    import dataclasses

    from faster_whisper_tpu_torch.models.load import random_params

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    cfg, _, tok = chip_smoke.small_model_parts()
    cfg = dataclasses.replace(cfg, n_audio_state=256, n_audio_head=4, n_text_state=256, n_text_head=4)
    params = random_params(cfg, seed=5, dtype=torch.float32, device="cpu")
    audio = chip_smoke.synth_audio(40.0, seed=4)
    _, want = _tp_segments(cfg, params, tok, "float32", 0, 1, audio)
    model, got = _tp_segments(cfg, params, tok, "float32", [0, 1, 2, 3], 4, audio)
    assert model.mesh.shape == {"data": 1, "model": 4}
    assert [r[3] for r in got] == [r[3] for r in want] and len(got) > 0
    for g, w in zip(got, want):
        assert abs(g[1] - w[1]) <= 0.0201 and abs(g[2] - w[2]) <= 0.0201


def test_a_group_on_cards_1_and_2_runs_from_card_0s_thread(card):
    """With card 0 current, a group on cards 1 and 2 (the sequential path
    runs in the calling thread) gives the segments of the same group on
    ``[0, 0]``.  Needs three cards."""
    if torch.cuda.device_count() < 3:
        pytest.skip("needs three cards: a group on cards 1 and 2 beside card 0")
    assert torch.cuda.current_device() == 0
    cfg, cpu, tok = chip_smoke.small_model_parts()
    audio = chip_smoke.synth_audio(40.0, seed=4)
    _, want = _tp_segments(cfg, cpu, tok, "bfloat16", [0, 0], 2, audio)
    model, got = _tp_segments(cfg, cpu, tok, "bfloat16", [1, 2], 2, audio)
    assert model.device == torch.device("cuda", 1) and torch.cuda.current_device() == 0
    assert got == want and len(got) > 0


def test_device_log_mel_matches_the_host_path(card):
    """The sequential path's whole-file log-mel on the card and the host
    numpy path, each against a float64 DFT and against each other, at
    479990 samples (the last frame reads the bucket's zeros) and at
    150 s."""
    errs = chip_smoke.check_device_log_mel(card, lengths=(479990, chip_smoke.P_SAMPLES))
    assert set(errs) == {479990, chip_smoke.P_SAMPLES}
    assert max(errs.values()) <= chip_smoke.LOG_MEL_TOL


def _results(results):
    return [(r.sequences_ids, r.scores, r.no_speech_prob) for r in results]


@pytest.mark.parametrize("size,compute_type,rows", [("large-v3", "int8", 8), ("large-v3-turbo", "bfloat16", 16)])
@pytest.mark.parametrize("timestamps", [False, True])
def test_a_replayed_beam_step_gives_the_eager_decode_bit_for_bit(card, size, compute_type, rows, timestamps):
    """At the widths of the benchmark cells' models and batches, four
    decoder layers, random weights: a decode replayed from its captured
    step gives the eager decode's tables, tokens, scores and no-speech
    probabilities bit for bit, with the same counts."""
    model = chip_smoke.graph_model(size, compute_type, decoder_layers=4)
    xa, prompts, kwargs = chip_smoke.graph_decode_inputs(model, rows, seed=5, timestamps=timestamps)
    model.model.generate(xa, prompts, **kwargs)  # its first step eager, then the capture
    sides = chip_smoke.graph_decode_pair(model, xa, prompts, kwargs)
    g, e = sides["graph"], sides["eager"]
    assert all(torch.equal(a, b) for a, b in zip(g["pending"].arrays, e["pending"].arrays))
    assert _results(g["results"]) == _results(e["results"])
    assert g["counts"] == e["counts"] and g["counts"]["steps"] > 0


def test_two_threads_decoding_one_key_at_once_both_finish_correct(card, monkeypatch):
    """Thread a holds the key's step graph (it waits after its first step);
    thread b decodes the same key meanwhile, eagerly on a state of its own;
    both give what each gives alone."""
    import threading

    from faster_whisper_tpu_torch.generation import generate as G

    model = chip_smoke.graph_model("large-v3-turbo", "bfloat16", decoder_layers=4)
    eng = model.model
    xa, prompts, kwargs = chip_smoke.graph_decode_inputs(model, 4, seed=6)
    xb = chip_smoke.graph_decode_inputs(model, 4, seed=7)[0]
    alone = {name: _results(eng.generate(x, prompts, **kwargs)) for name, x in (("a", xa), ("b", xb))}
    assert alone["a"] != alone["b"]
    taken, out = {}, {}
    take = eng.step_graphs.take

    def spy(*args):
        taken[threading.current_thread().name] = graph = take(*args)
        return graph

    monkeypatch.setattr(eng.step_graphs, "take", spy)
    in_loop, finished = threading.Event(), threading.Event()

    def first():
        with G.after_first_launch(lambda: (in_loop.set(), finished.wait(600))):
            out["a"] = _results(eng.generate(xa, prompts, **kwargs))

    def second():
        try:
            assert in_loop.wait(600)
            out["b"] = _results(eng.generate(xb, prompts, **kwargs))
        finally:
            finished.set()

    threads = [threading.Thread(target=first, name="a"), threading.Thread(target=second, name="b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    assert taken["a"] is not None and taken["a"].step is not None and taken["b"] is None
    assert out == alone


def test_a_replay_reads_its_masks_after_the_mask_cache_drops_them(card):
    """A captured step keeps the vocabulary masks it reads: with
    ``_id_mask``'s cache cleared and the freed memory taken by all-true
    masks of the vocabulary's size, a replayed decode suppressing tokens
    gives what it gave before, bit for bit."""
    import gc

    from faster_whisper_tpu_torch.generation import processors as P

    model = chip_smoke.graph_model("large-v3-turbo", "bfloat16", decoder_layers=2)
    eng = model.model
    xa, prompts, kwargs = chip_smoke.graph_decode_inputs(model, 2, seed=8)
    kwargs = dict(kwargs, suppress_tokens=[eng.meta.no_speech, eng.meta.no_timestamps, 220, 11])
    eng.generate(xa, prompts, **kwargs)  # its first step eager, then the capture
    before = _results(eng.generate(xa, prompts, **kwargs))
    assert [g.step is not None for g in eng.step_graphs.graphs()] == [True]
    P._id_mask.cache_clear()
    gc.collect()
    refill = [torch.ones(eng.meta.vocab_size, dtype=torch.bool, device="cuda") for _ in range(256)]
    assert _results(eng.generate(xa, prompts, **kwargs)) == before
    del refill
