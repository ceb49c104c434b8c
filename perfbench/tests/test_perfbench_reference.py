"""The reference against the program's host path at a tiny size: the same
weights, vocabulary and audio give the same windows and, within float32
rounding, the same scores, ranks and no-speech probabilities, under both
precision rules."""

import pytest

import tiny


@pytest.mark.parametrize("seed", [11, 13])
def test_reference_equals_the_programs_float32_path(monkeypatch, tmp_path, seed):
    res = tiny.run(monkeypatch, tmp_path, "batched", seed=seed)
    assert res["correct"], res["checks"]
    assert res["checks"]["windows_differ"]["value"] == 0
    assert res["checks"]["score_gap"]["value"] < 1e-5


def test_reference_int8_rule_equals_the_programs_int8_path(monkeypatch, tmp_path):
    # W8A8 and int8 caches on float32 activations: a code that rounds the
    # other way moves a score by a few 1e-4 at most at this size
    limits = dict(tiny.LIMITS, score_gap=5e-3, rank_gap=5e-3, nospeech_gap=5e-3)
    res = tiny.run(monkeypatch, tmp_path, "batched", seed=12, compute_type="int8_float32", limits=limits)
    assert res["correct"], res["checks"]


def test_reference_encoder_matches_the_ports_encoder():
    import numpy as np
    import torch

    from faster_whisper_tpu_torch.models import model as M
    from faster_whisper_tpu_torch.models.config import config_from_dims
    from perfbench import inputs
    from perfbench.reference import whisper

    dm = inputs.dims_of(tiny.TINY)
    params = inputs.draw_weights(dm, 3, torch.device("cpu"), dtype=torch.float32)
    mel = torch.as_tensor(np.random.default_rng(0).normal(size=(1, dm.n_mels, 3000)), dtype=torch.float32)
    cfg = config_from_dims(dm.n_mels, dm.d, dm.heads, dm.enc_layers, dm.d, dm.heads, dm.dec_layers, dm.vocab)
    ours = whisper.Whisper(params, whisper.Dims(*dm[:6])).encode(mel[0])
    theirs = M.encode(params, cfg, mel)[0]
    assert torch.allclose(ours, theirs, atol=1e-4), (ours - theirs).abs().max()


def test_windows_cut_at_timestamps_are_judged_by_the_rule(monkeypatch, tmp_path):
    # timestamp rows of the embedding scaled up: the decode keeps timestamps,
    # in pairs too, and the pipeline cuts those windows into segments
    from perfbench import inputs

    real = inputs.draw_weights

    def stamped(dm, seed, device, dtype=None):
        p = real(dm, seed, device, dtype)
        p["decoder"]["token_embed"][dm.vocab - 1501:] *= 1.6
        return p

    monkeypatch.setattr(inputs, "draw_weights", stamped)
    res = tiny.run(monkeypatch, tmp_path, "batched", seed=43, controls=("int8",))
    assert res["correct"], res["checks"]
    assert res["readings"]["cut_windows"] > 0
