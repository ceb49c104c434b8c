"""The comparison fails what it should: the timed path broken underneath
(the harness's look for a card skipped) makes ``correct`` false, once for
each fault a cell of this benchmark can have, and each cell's controls
come out not correct by the cell's own limits, which a sound run meets.
The cells run on one card, so no exchange between cards can be left
out."""

import json
import os
import time

import pytest
import torch

import run as bench_run
import tiny


# Each cell's controls at a size that the host can run, held to the cell's
# own limits: the configuration's compute type is sound there, and the
# program's lower-precision path, or the reference one precision down in
# the program's place, is not.
SIZED = dict(tiny.TINY, d_model=256, encoder_attention_heads=4, decoder_attention_heads=4, encoder_layers=4,
             encoder_ffn_dim=1024, decoder_ffn_dim=1024)
CELLS = {"turbo-bf16.batched": ("float16", None, "fp8"), "v3-int8.batched": ("int8", "int4", "int4")}


def _cell_limits(cell):
    with open(os.path.join(bench_run.HERE, "limits", cell + ".json")) as f:
        return json.load(f)


def _unchanged_state(monkeypatch):
    from faster_whisper_tpu_torch.generation import generate as G

    real = G.beam_attend_append

    def clone(cache):  # a raw cache, or an int8 one's codes and scales
        return type(cache)(*(t.clone() for t in cache)) if isinstance(cache, tuple) else cache.clone()

    def step(layer, pos_row, q, k_new, v_new, self_k, self_v, *args, **kwargs):
        out, _, _ = real(layer, pos_row, q, k_new, v_new, clone(self_k), clone(self_v), *args, **kwargs)
        return out, self_k, self_v  # the caches come back without the new column

    monkeypatch.setattr(G, "beam_attend_append", step)


def _half_batch(model):
    engine = model.model
    real = engine.encode

    def encode(feats):
        b = feats.shape[0]
        h = max(1, b // 2)
        enc = real(feats[:h])
        return torch.cat([enc, enc[: b - h]]) if b > h else enc

    engine.encode = encode


def _altered_token(model):
    engine = model.model
    real = engine.generate_collect

    def collect(pending):
        results = real(pending)
        for r in results:
            seq = r.sequences_ids[0]
            if len(seq) > 2:
                seq[2] = 30000 + (seq[2] % 7)
        return results

    engine.generate_collect = collect


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", ["unchanged_state", "altered_token"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, tmp_path, fault, cell):
    hooks = {}
    if fault == "unchanged_state":
        _unchanged_state(monkeypatch)
    else:
        hooks["after_build"] = _altered_token
    monkeypatch.setitem(tiny.TRAFFIC["batched"]["options"], "max_new_tokens", 16)
    res = tiny.run(monkeypatch, tmp_path, "batched", seed=21, hooks=hooks, compute_type=CELLS[cell][0],
                   limits=_cell_limits(cell), config=SIZED)
    assert not res["correct"], res["checks"]


def test_half_the_batch_left_out_is_not_correct_at_float32(monkeypatch, tmp_path):
    # The random-weight decoder barely depends on which window's encoder
    # states it reads (another window's move score_gap by 0.002-0.003 at
    # this size, under the cells' limits): this fault shows only against a
    # float32 program's own tight limits
    res = tiny.run(monkeypatch, tmp_path, "batched", seed=21, hooks={"after_build": _half_batch})
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_of_the_same_cell_is_correct(monkeypatch, tmp_path, cell):
    res = tiny.run(monkeypatch, tmp_path, "batched", seed=21, compute_type=CELLS[cell][0],
                   limits=_cell_limits(cell))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_controls_are_not_correct_by_the_cells_limits(monkeypatch, tmp_path, cell):
    compute_type, lower_path, lower_reference = CELLS[cell]
    limits = _cell_limits(cell)
    monkeypatch.setitem(tiny.TRAFFIC["batched"]["options"], "max_new_tokens", 16)
    sound = tiny.run(monkeypatch, tmp_path, "batched", seed=23, compute_type=compute_type, limits=limits,
                     config=SIZED, controls=(lower_reference,))
    assert sound["correct"], sound["checks"]
    assert not sound["readings"][f"control.{lower_reference}.correct"], sound["readings"]
    if lower_path:
        program = tiny.run(monkeypatch, tmp_path, "batched", seed=23, compute_type=compute_type, limits=limits,
                           config=SIZED, program=lower_path)
        assert not program["correct"], program["checks"]


def test_a_stall_lowers_the_rate(monkeypatch, tmp_path):
    def stall(model):
        engine = model.model
        real = engine.generate_dispatch

        def dispatch(*args, **kwargs):
            time.sleep(5.0)
            return real(*args, **kwargs)

        engine.generate_dispatch = dispatch

    base = tiny.run(monkeypatch, tmp_path, "batched", seed=31, seconds=1.0)["metrics"]["audio_s_per_s"]["value"]
    slow = tiny.run(monkeypatch, tmp_path, "batched", seed=31, seconds=1.0,
                    hooks={"after_build": stall})["metrics"]["audio_s_per_s"]["value"]
    assert slow < 0.6 * base
