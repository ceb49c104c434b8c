"""Whisper encoder and decoder forward passes in PyTorch.

Counterpart of ``faster_whisper_tpu/models/model.py``.  Parameters are the
nested dict of ``models/load.py`` with layers stacked along a leading axis;
the layers run in a Python loop over views of that axis.  Matmuls run in
the parameter dtype (bf16 or float32) with f32 where the JAX package asks
for it: layernorm statistics, attention scores and softmax, and the final
logits.  Every LayerNorm is ``ops/layer_norm.py::layer_norm`` (the port's
LayerNorm kernel on the card).  Encoder self-attention goes through
``mha_full`` (kernel K3 on the card); decode self- and cross-attention
live in ``generation/generate.py`` (kernels K1/K2 and K4).  In an int8
tree (``ops/quant.py``) every layer matmul is a W8A8 ``int8_dense`` and
the logits use the int8 head ``decoder.logits_w``.

Every function takes one parameter tree or a ``ShardedParams``, one
replica over a model-axis group (``parallel/mesh.py``,
``parallel/collectives.py``); one tree is the group of one, and the same
code runs both.  Activations are lists with one tensor per shard: a
replicated value is computed once per device (``ShardGroup.replicated``);
each shard computes its heads' column-parallel products and attention
(K3 in the encoder at ``n_audio_head / N`` heads), then the row-parallel
partials are all-reduced (``_row_dense``) and the replicated bias added.
The logits run on the lead shard, or on every shard where the int8 head is
vocab-sharded, gathered to the lead.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from faster_whisper_tpu_torch.models.config import WhisperConfig
from faster_whisper_tpu_torch.ops import _build
from faster_whisper_tpu_torch.ops.attention import mha_full, mha_hmajor
from faster_whisper_tpu_torch.ops.layer_norm import layer_norm
from faster_whisper_tpu_torch.ops.quant import QuantizedLinear, int8_dense, int8_dense_many, int8_dense_rows
from faster_whisper_tpu_torch.parallel import collectives
from faster_whisper_tpu_torch.parallel.mesh import ShardedParams


def _dense(x, w, b=None):
    if isinstance(w, QuantizedLinear):
        return int8_dense(x, w, b)
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def _dense_many(x, ws, bs):
    """``_dense`` of one x by several weights; int8 weights share x's row
    quantization (``int8_dense_many``)."""
    if isinstance(ws[0], QuantizedLinear):
        return int8_dense_many(x, ws, bs)
    return [_dense(x, w, b) for w, b in zip(ws, bs)]


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


def shards(params):
    """(trees, group): a ``ShardedParams``' trees and group, or one tree
    and the group of one on its device."""
    if isinstance(params, ShardedParams):
        return params.trees, params.group
    return [params], collectives.single(params["decoder"]["token_embed"].device)


def lead(params) -> dict:
    """The lead shard's tree (the tree itself when there is one)."""
    return params.trees[0] if isinstance(params, ShardedParams) else params


def _row_dense(group, xs, ws, bs):
    """A row-parallel product: the sum over the shards of ``xs[i] @
    ws[i]`` (one all-reduce) plus the replicated bias, on every shard.  An
    int8 weight goes through ``int8_dense_rows``, whose int32 sum is
    exact, or through ``int8_dense`` in a group of one shard."""
    if isinstance(ws[0], QuantizedLinear):
        if group.size == 1:
            return [int8_dense(xs[0], ws[0], bs[0])]
        return int8_dense_rows(xs, ws, bs, group)
    ys = group.all_reduce_sum([torch.matmul(x, w) for x, w in zip(xs, ws)])
    return group.replicated(torch.add, ys, bs)


def _residual(group, xs, ys):
    return group.replicated(torch.add, xs, ys)


def _norm(group, xs, ps, g: str, b: str):
    """Each shard's layer norm ``ps[i][g], ps[i][b]`` of ``xs[i]``."""
    return group.replicated(lambda x, p: layer_norm(x, p[g], p[b]), xs, ps)


def _attn_qkv(p, x, n_head):
    """Project q/k/v for self-attention on x."""
    qkv = _dense_many(x, (p["wq"], p["wk"], p["wv"]), (p["bq"], None, p["bv"]))  # Whisper: no k bias
    return tuple(_split_heads(y, n_head) for y in qkv)


def _out(group, attn, ps, name):
    """The attention output projection of sublayer ``name`` (row-parallel)."""
    return _row_dense(group, attn, [p[name]["wo"] for p in ps], [p[name]["bo"] for p in ps])


def _mlp(group, hs, ps):
    """The MLP of each shard's layer ``ps[i]``: w1 column-parallel, w2
    row-parallel."""
    mid = [F.gelu(_dense(h, p["mlp"]["w1"], p["mlp"]["b1"])) for h, p in zip(hs, ps)]  # exact GELU
    return _row_dense(group, mid, [p["mlp"]["w2"] for p in ps], [p["mlp"]["b2"] for p in ps])


def _layers(trees, part: str, i: int):
    """Views of layer ``i`` of ``part`` ("encoder" or "decoder") per shard."""
    return [_layer(t[part]["layers"], i) for t in trees]


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


def _encoder_layer(group, xs, ps, n_head):
    hs = _norm(group, xs, ps, "ln1_g", "ln1_b")
    attn = []
    for h, p in zip(hs, ps):
        q, k, v = _attn_qkv(p["attn"], h, n_head)
        attn.append(_merge_heads(mha_full(q.contiguous(), k.contiguous(), v.contiguous())))
    xs = _residual(group, xs, _out(group, attn, ps, "attn"))
    hs = _norm(group, xs, ps, "ln2_g", "ln2_b")
    return _residual(group, xs, _mlp(group, hs, ps))


def _stem(enc, mel):
    """The conv stem and the position embedding: (B, n_mels, 3000) mel ->
    (B, 1500, d)."""
    dtype = enc["conv1_w"].dtype
    x = mel.to(dtype)  # (B, n_mels, 3000), channels first
    # weights are stored (k, in, out); conv1d takes (out, in, k)
    x = F.conv1d(x, enc["conv1_w"].permute(2, 1, 0), padding=1)
    x = F.gelu(x + enc["conv1_b"][None, :, None])
    x = F.conv1d(x, enc["conv2_w"].permute(2, 1, 0), stride=2, padding=1)
    x = F.gelu(x + enc["conv2_b"][None, :, None])
    # (B, 1500, d) with contiguous rows: the residual stream keeps its
    # input's layout through the layers, and the LayerNorm kernel reads rows
    return x.transpose(1, 2).contiguous() + enc["pos_embed"].to(dtype)


def encode(params, config: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """Encoder forward: (B, n_mels, 3000) mel -> (B, 1500, d) states, on
    the lead shard's device.

    Conv stem (k3 s1 + GELU, k3 s2 + GELU), then ``n_audio_layer``
    pre-norm transformer blocks, each with one ``mha_full`` (K3 on the
    card) per shard.  Counts its calls in ``encode.calls``."""
    _build.count(encode, "calls")
    trees, group = shards(params)
    xs = group.replicated(lambda t, m: _stem(t["encoder"], m), trees, group.broadcast(mel))
    n_head = config.n_audio_head // group.size
    for i in range(config.n_audio_layer):
        xs = _encoder_layer(group, xs, _layers(trees, "encoder", i), n_head)
    enc = trees[0]["encoder"]
    return layer_norm(xs[0], enc["ln_post_g"], enc["ln_post_b"])


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


def _logits(params, xs, select=None):
    """The final layer norm of the states ``xs`` (one per shard), the rows
    ``select`` picks, and the logits over them in f32 on the lead: the
    tied embedding on the lead; an int8 tree's own transposed int8 head
    ``logits_w``, whose padding columns are sliced off, on the lead, or
    vocab-sharded on every shard and gathered to the lead."""
    trees, group = shards(params)
    vocab = trees[0]["decoder"]["token_embed"].shape[0]
    lw = trees[0]["decoder"].get("logits_w")
    width = vocab // group.size if lw is not None and lw.q.shape[-1] < vocab else vocab
    parts = []
    for t, x in zip(trees[: vocab // width], xs):
        dec = t["decoder"]
        x = layer_norm(x, dec["ln_g"], dec["ln_b"])
        if select is not None:
            x = select(x)
        if lw is None:
            parts.append(torch.matmul(x.float(), dec["token_embed"].float().t()))
        else:
            parts.append(int8_dense(x, dec["logits_w"], out_dtype=torch.float32)[..., :width])
    return parts[0] if len(parts) == 1 else torch.cat(group.gather(parts), dim=-1)


def _init_shard_cache(tree, config: WhisperConfig, xa: torch.Tensor, ctx: int, n_head: int) -> KVCache:
    b, t, _ = xa.shape
    dh = config.n_text_state // config.n_text_head
    L = config.n_text_layer
    dec = tree["decoder"]
    dtype = dec["token_embed"].dtype
    xa = xa.to(dtype)
    cross_k, cross_v = [], []
    for i in range(L):
        p = _layer(dec["layers"]["cross_attn"], i)
        k, v = _dense_many(xa, (p["wk"], p["wv"]), (None, p["bv"]))
        cross_k.append(_split_heads(k, n_head).transpose(1, 2))
        cross_v.append(_split_heads(v, n_head).transpose(1, 2))
    zeros = torch.zeros((L, b, n_head, ctx, dh), dtype=dtype, device=xa.device)
    return KVCache(
        self_k=zeros,
        self_v=zeros.clone(),
        cross_k=torch.stack(cross_k).contiguous(),
        cross_v=torch.stack(cross_v).contiguous(),
    )


def init_cache(params, config: WhisperConfig, xa: torch.Tensor, ctx: int = None):
    """Zeroed self-attention cache of ``ctx`` slots (default: the model's
    448) and the cross K/V of the encoder states ``xa`` (B, T, d) on the
    lead: a ``KVCache``, or over a group a list of each shard's, at
    ``n_text_head / N`` heads on its device."""
    trees, group = shards(params)
    ctx = config.n_text_ctx if ctx is None else ctx
    n_head = config.n_text_head // group.size
    caches = [_init_shard_cache(t, config, x, ctx, n_head) for t, x in zip(trees, group.broadcast(xa))]
    return caches if isinstance(params, ShardedParams) else caches[0]


def _prompt_inputs(trees, group, tokens: torch.Tensor):
    """Each shard's embedded token buffer (B, S, d), positions from 0, and
    causal mask (1, 1, S, S): a decoder pass over whole sequences."""
    s = tokens.shape[1]

    def embed(t, tok):
        dec = t["decoder"]
        return (dec["token_embed"][tok] + dec["pos_embed"][:s][None]).to(dec["token_embed"].dtype)

    def causal_mask(tok):
        i = torch.arange(s, device=tok.device)
        return (i[None, :] <= i[:, None])[None, None]

    toks = group.broadcast(tokens)
    return group.replicated(embed, trees, toks), group.replicated(causal_mask, toks)


def decoder_prefill(
    params,
    config: WhisperConfig,
    tokens: torch.Tensor,  # (B, P) prompt tokens, right-padded
    lengths: torch.Tensor,  # (B,) true prompt lengths (padding is masked by causality)
    xa: torch.Tensor,  # (B, T, d) encoder states
    gather_pos: torch.Tensor,  # (B, G) positions whose next-token logits to return
    ctx: int = None,
):
    """Run the decoder over the (padded) prompt, filling the KV cache.

    Returns (logits at ``gather_pos``: (B, G, n_vocab) f32 on the lead,
    cache: as ``init_cache``).  Padded positions write garbage into cache
    slots >= lengths[b]; those slots are never attended and are
    overwritten as tokens are decoded.  Counts its calls in
    ``decoder_prefill.calls``."""
    _build.count(decoder_prefill, "calls")
    trees, group = shards(params)
    b, s = tokens.shape
    n_head = config.n_text_head // group.size

    caches = init_cache(params, config, xa, ctx=ctx)
    if not isinstance(caches, list):
        caches = [caches]
    xs, causal = _prompt_inputs(trees, group, tokens)

    for li in range(config.n_text_layer):
        ps = _layers(trees, "decoder", li)
        hs = _norm(group, xs, ps, "ln1_g", "ln1_b")
        attn = []
        for h, p, cache, mask in zip(hs, ps, caches, causal):
            q, k_new, v_new = _attn_qkv(p["self_attn"], h, n_head)
            cache.self_k[li, :, :, :s] = k_new.transpose(1, 2)
            cache.self_v[li, :, :, :s] = v_new.transpose(1, 2)
            # Slots >= s are masked for every query, so only the first s are read.
            attn.append(_merge_heads(mha_hmajor(
                q, cache.self_k[li, :, :, :s], cache.self_v[li, :, :, :s], mask=mask
            )))
        xs = _residual(group, xs, _out(group, attn, ps, "self_attn"))

        hs = _norm(group, xs, ps, "ln2_g", "ln2_b")
        attn = []
        for h, p, cache in zip(hs, ps, caches):
            cp = p["cross_attn"]
            qx = _split_heads(_dense(h, cp["wq"], cp["bq"]), n_head)
            attn.append(_merge_heads(mha_hmajor(qx, cache.cross_k[li], cache.cross_v[li])))
        xs = _residual(group, xs, _out(group, attn, ps, "cross_attn"))

        hs = _norm(group, xs, ps, "ln3_g", "ln3_b")
        xs = _residual(group, xs, _mlp(group, hs, ps))

    rows = torch.arange(b, device=gather_pos.device)[:, None]
    gather_pos = gather_pos.long()
    logits = _logits(params, xs, select=lambda x: x[rows.to(x.device), gather_pos.to(x.device)])  # (B, G, V)
    return logits, (caches if isinstance(params, ShardedParams) else caches[0])


decoder_prefill.calls = 0
