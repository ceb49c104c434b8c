"""Whisper encoder and decoder forward passes in PyTorch.

Counterpart of ``faster_whisper_tpu/models/model.py``.  Parameters are the
nested dict of ``models/load.py`` with layers stacked along a leading axis;
the layers run in a Python loop over views of that axis.  Matmuls run in
the parameter dtype (bf16 or float32) with f32 where the JAX package asks
for it: layernorm statistics, attention scores and softmax, and the final
logits.  Encoder self-attention goes through ``mha_full`` (kernel K3 on the
card); decode self- and cross-attention live in ``generation/generate.py``
(kernels K1/K2 and K4).  In an int8 tree (``ops/quant.py``) every layer
matmul is a W8A8 ``int8_dense`` and the logits use the int8 head
``decoder.logits_w``.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from faster_whisper_tpu_torch.models.config import WhisperConfig
from faster_whisper_tpu_torch.ops.attention import mha_full, mha_hmajor
from faster_whisper_tpu_torch.ops.quant import QuantizedLinear, int8_dense


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    """LayerNorm with f32 statistics, output in the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _dense(x, w, b=None):
    if isinstance(w, QuantizedLinear):
        return int8_dense(x, w, b)
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def _split_heads(x, n_head):
    b, s, d = x.shape
    return x.reshape(b, s, n_head, d // n_head)


def _merge_heads(x):
    b, s, h, dh = x.shape
    return x.reshape(b, s, h * dh)


def _layer(tree, i):
    """Views of layer ``i`` of a stacked parameter subtree.  A
    QuantizedLinear is sliced field by field (``tree[i]`` on the NamedTuple
    would pick its field i)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedLinear):
        return QuantizedLinear(tree.q[i], tree.s[i])
    return tree[i]


def _attn_qkv(p, x, n_head):
    """Project q/k/v for self-attention on x."""
    q = _split_heads(_dense(x, p["wq"], p["bq"]), n_head)
    k = _split_heads(_dense(x, p["wk"]), n_head)  # Whisper: no k bias
    v = _split_heads(_dense(x, p["wv"], p["bv"]), n_head)
    return q, k, v


def _mlp(p, x):
    h = F.gelu(_dense(x, p["w1"], p["b1"]))  # exact (erf) GELU
    return _dense(h, p["w2"], p["b2"])


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Fixed sinusoidal position embeddings (Whisper encoder)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1)


def _encoder_layer(x, p, n_head):
    h = layer_norm(x, p["ln1_g"], p["ln1_b"])
    q, k, v = _attn_qkv(p["attn"], h, n_head)
    x = x + _dense(
        _merge_heads(mha_full(q.contiguous(), k.contiguous(), v.contiguous())),
        p["attn"]["wo"], p["attn"]["bo"],
    )
    h = layer_norm(x, p["ln2_g"], p["ln2_b"])
    return x + _mlp(p["mlp"], h)


def encode(params, config: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """Encoder forward: (B, n_mels, 3000) mel -> (B, 1500, d) states.

    Conv stem (k3 s1 + GELU, k3 s2 + GELU), then ``n_audio_layer``
    pre-norm transformer blocks, each with one ``mha_full`` (K3 on the
    card).  Counts its calls in ``encode.calls``."""
    encode.calls += 1
    enc = params["encoder"]
    dtype = enc["conv1_w"].dtype
    x = mel.to(dtype)  # (B, n_mels, 3000), channels first

    # weights are stored (k, in, out); conv1d takes (out, in, k)
    x = F.conv1d(x, enc["conv1_w"].permute(2, 1, 0), padding=1)
    x = F.gelu(x + enc["conv1_b"][None, :, None])
    x = F.conv1d(x, enc["conv2_w"].permute(2, 1, 0), stride=2, padding=1)
    x = F.gelu(x + enc["conv2_b"][None, :, None])
    x = x.transpose(1, 2) + enc["pos_embed"].to(dtype)  # (B, 1500, d)

    for i in range(config.n_audio_layer):
        x = _encoder_layer(x, _layer(enc["layers"], i), config.n_audio_head)

    return layer_norm(x, enc["ln_post_g"], enc["ln_post_b"])


encode.calls = 0


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Decoding state, head-major.

    self_k/self_v: (L, B, H, ctx, D), written as tokens are decoded.
    cross_k/cross_v: (L, B, H, T, D), computed once per window.
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def _logits(params, x):
    """Tied-embedding output projection, in f32.  An int8 tree carries its
    own transposed int8 head ``logits_w``, whose padding columns are
    sliced off here."""
    embed = params["decoder"]["token_embed"]
    lw = params["decoder"].get("logits_w")
    if lw is not None:
        return int8_dense(x, lw, out_dtype=torch.float32)[..., : embed.shape[0]]
    return torch.matmul(x.float(), embed.float().t())


def init_cache(params, config: WhisperConfig, xa: torch.Tensor, ctx: int = None) -> KVCache:
    """Zeroed self-attention cache of ``ctx`` slots (default: the model's
    448) and the cross K/V of the encoder states ``xa`` (B, T, d)."""
    b, t, _ = xa.shape
    h, dh = config.n_text_head, config.n_text_state // config.n_text_head
    L = config.n_text_layer
    dec = params["decoder"]
    dtype = dec["token_embed"].dtype
    if ctx is None:
        ctx = config.n_text_ctx
    xa = xa.to(dtype)
    cross_k, cross_v = [], []
    for i in range(L):
        p = _layer(dec["layers"]["cross_attn"], i)
        cross_k.append(_split_heads(_dense(xa, p["wk"]), h).transpose(1, 2))
        cross_v.append(_split_heads(_dense(xa, p["wv"], p["bv"]), h).transpose(1, 2))
    zeros = torch.zeros((L, b, h, ctx, dh), dtype=dtype, device=xa.device)
    return KVCache(
        self_k=zeros,
        self_v=zeros.clone(),
        cross_k=torch.stack(cross_k).contiguous(),
        cross_v=torch.stack(cross_v).contiguous(),
    )


def decoder_prefill(
    params,
    config: WhisperConfig,
    tokens: torch.Tensor,  # (B, P) prompt tokens, right-padded
    lengths: torch.Tensor,  # (B,) true prompt lengths (padding is masked by causality)
    xa: torch.Tensor,  # (B, T, d) encoder states
    gather_pos: torch.Tensor,  # (B, G) positions whose next-token logits to return
    ctx: int = None,
) -> Tuple[torch.Tensor, KVCache]:
    """Run the decoder over the (padded) prompt, filling the KV cache.

    Returns (logits at ``gather_pos``: (B, G, n_vocab) f32, cache).
    Padded positions write garbage into cache slots >= lengths[b]; those
    slots are never attended and are overwritten as tokens are decoded."""
    dec = params["decoder"]
    b, s = tokens.shape
    dtype = dec["token_embed"].dtype
    n_head = config.n_text_head

    x = (dec["token_embed"][tokens] + dec["pos_embed"][:s][None]).to(dtype)
    cache = init_cache(params, config, xa, ctx=ctx)
    i = torch.arange(s, device=x.device)
    causal = (i[None, :] <= i[:, None])[None, None]  # (1, 1, S, S)

    for li in range(config.n_text_layer):
        p = _layer(dec["layers"], li)
        h = layer_norm(x, p["ln1_g"], p["ln1_b"])
        q, k_new, v_new = _attn_qkv(p["self_attn"], h, n_head)
        cache.self_k[li, :, :, :s] = k_new.transpose(1, 2)
        cache.self_v[li, :, :, :s] = v_new.transpose(1, 2)
        # Slots >= s are masked for every query, so only the first s are read.
        attn = mha_hmajor(q, cache.self_k[li, :, :, :s], cache.self_v[li, :, :, :s], mask=causal)
        x = x + _dense(_merge_heads(attn), p["self_attn"]["wo"], p["self_attn"]["bo"])

        h = layer_norm(x, p["ln2_g"], p["ln2_b"])
        cp = p["cross_attn"]
        qx = _split_heads(_dense(h, cp["wq"], cp["bq"]), n_head)
        attn = mha_hmajor(qx, cache.cross_k[li], cache.cross_v[li])
        x = x + _dense(_merge_heads(attn), cp["wo"], cp["bo"])

        h = layer_norm(x, p["ln3_g"], p["ln3_b"])
        x = x + _mlp(p["mlp"], h)

    x = layer_norm(x, dec["ln_g"], dec["ln_b"])
    rows = torch.arange(b, device=x.device)[:, None]
    logits = _logits(params, x[rows, gather_pos.long()])  # (B, G, V)
    return logits, cache
