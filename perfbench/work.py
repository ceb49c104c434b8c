"""The work of the model, counted from its published shapes, and the
table of peaks (``peaks.json``). The counts do not follow the kernels that
do the work today, so a later kernel is read against the same work.

Operations count a multiply-add as two. Bytes count each input read once
and each output written once (the arithmetic of ``chip_smoke.py``'s kernel
bounds, frozen here). Where the bytes depend on the data, the least that
the inputs need is counted: the beams of a row may share their whole
history, so a decode step's self-attention reads each earlier position's
K and V once per row.
"""

import json
import os

from perfbench.inputs import Dims

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks() -> dict:
    with open(_PEAKS) as f:
        return json.load(f)


def encoder_ops(dm: Dims) -> dict:
    """Per 30 s window: the conv stem, the layers' matmuls and their
    attention (QK and PV)."""
    t = dm.audio_ctx
    conv = 2 * 3 * (2 * t * dm.n_mels * dm.d + t * dm.d * dm.d)
    matmul = dm.enc_layers * 2 * t * (4 * dm.d * dm.d + 2 * dm.d * dm.ffn)
    attn = dm.enc_layers * 4 * t * t * dm.d
    return {"conv": conv, "matmul": matmul, "attn": attn}


def cross_kv_ops(dm: Dims) -> int:
    """Per window: every decoder layer's cross K and V of the 1500 states."""
    return dm.dec_layers * 2 * 2 * dm.audio_ctx * dm.d * dm.d


def decoder_token_ops(dm: Dims, pos: int) -> dict:
    """One token at position ``pos`` (attending to pos + 1 positions):
    the matmuls (self q k v o, cross q o, the MLP), self- and
    cross-attention, and its logits."""
    matmul = dm.dec_layers * 2 * (6 * dm.d * dm.d + 2 * dm.d * dm.ffn)
    attn = dm.dec_layers * 4 * dm.d * ((pos + 1) + dm.audio_ctx)
    logits = 2 * dm.d * dm.vocab
    return {"matmul": matmul, "attn": attn, "logits": logits}


def decode_ops(dm: Dims, rows: int, beams: int, prompt: int, steps: int) -> dict:
    """A beam decode of ``steps`` steps over ``rows`` rows: the prompt's
    pass (one row each) and each step's ``beams`` tokens."""
    out = {"matmul": 0, "attn": 0, "logits": 0}
    for p in range(prompt):
        for k, v in decoder_token_ops(dm, p).items():
            out[k] += rows * v if k != "logits" else 0
    out["logits"] += rows * 2 * 2 * dm.d * dm.vocab  # the prompt's last and <|sot|> positions
    for s in range(steps):
        for k, v in decoder_token_ops(dm, prompt + s).items():
            out[k] += rows * beams * v
    return out


def decode_attn_bytes(dm: Dims, rows: int, beams: int, prompt: int, steps: int, kv_int8: bool,
                      act_bytes: int = 2) -> int:
    """Bytes the decode steps' self- and cross-attention need: per step and
    layer, each row's earlier K/V positions once, the new position per
    beam, the cross K/V once per row, and q and the output per beam. An
    int8 row is 64 codes and a 2-byte scale."""
    dh = dm.d // dm.heads
    row = (dh + 2) if kv_int8 else dh * act_bytes
    total = 0
    for s in range(steps):
        pos = prompt + s
        self_rows = rows * pos + rows * beams  # history once per row, the new column per beam
        total += dm.heads * (2 * self_rows * row + 4 * rows * beams * dh * act_bytes)
        total += dm.heads * (2 * rows * dm.audio_ctx * row + 2 * rows * beams * dh * act_bytes)
    return dm.dec_layers * total


def encoder_attn_ops(dm: Dims, windows: int) -> int:
    """QK and PV of every encoder layer over ``windows`` windows."""
    return windows * dm.enc_layers * 4 * dm.audio_ctx * dm.audio_ctx * dm.d
