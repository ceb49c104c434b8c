"""The work counts against values worked out by hand at small shapes."""

from perfbench import work
from perfbench.inputs import Dims

D = Dims(n_mels=2, d=4, heads=2, enc_layers=1, dec_layers=1, vocab=10, audio_ctx=3, text_ctx=8, ffn=16)


def test_encoder_ops():
    # conv1: 2*3*(2*3) (k=3, 2 mels, 3000 frames = 2 x positions) per d: 2*3*(2*3*2*4) = 288
    # conv2: 2*3*(3*4*4) = 288; matmuls: 2*3*(4*16 + 2*4*16) = 1152; attention 4*3*3*4 = 144
    assert work.encoder_ops(D) == {"conv": 576, "matmul": 1152, "attn": 144}


def test_cross_kv_and_token_ops():
    assert work.cross_kv_ops(D) == 2 * 2 * 3 * 16  # K and V of 3 states, 4x4
    # matmuls 2*(6*16 + 2*4*16) = 448; attention 4*4*((pos+1) + 3) at pos 2 = 96; logits 2*4*10
    assert work.decoder_token_ops(D, 2) == {"matmul": 448, "attn": 96, "logits": 80}


def test_decode_ops():
    ops = work.decode_ops(D, rows=1, beams=2, prompt=1, steps=1)
    # the prompt token at 0: 448 + 4*4*(1+3) = 64; its two logits rows 160; one step of 2 beams at 1
    assert ops == {"matmul": 448 + 2 * 448, "attn": 64 + 2 * 80, "logits": 160 + 2 * 80}


def test_decode_attn_bytes():
    # bf16 rows of dh=2: per step and head, K and V of 1 history row + 2 new (beams),
    # q, k_new, v_new and out of 2 beams, cross K/V of 3 states, q and out of 2 beams
    got = work.decode_attn_bytes(D, rows=1, beams=2, prompt=1, steps=1, kv_int8=False)
    per_head = 2 * 3 * 4 + 4 * 2 * 2 * 2 + 2 * 3 * 4 + 2 * 2 * 2 * 2
    assert got == 2 * per_head
    # int8 rows: 2 codes and a 2-byte scale
    got8 = work.decode_attn_bytes(D, rows=1, beams=2, prompt=1, steps=1, kv_int8=True)
    assert got8 == 2 * (2 * 3 * 4 + 4 * 2 * 2 * 2 + 2 * 3 * 4 + 2 * 2 * 2 * 2)


def test_encoder_attn_ops():
    assert work.encoder_attn_ops(D, 2) == 2 * 4 * 9 * 4
