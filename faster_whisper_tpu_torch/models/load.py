"""Weights: the parameter layout, random init on the device, and conversion
of a JAX parameter tree.

The layout is that of ``faster_whisper_tpu/models/load.py::param_shapes``:
a nested dict whose transformer layers are stacked along a leading axis,
with every matmul weight stored (in, out)::

  encoder:
    conv1_w (3, n_mels, d)  conv1_b (d,)
    conv2_w (3, d, d)       conv2_b (d,)
    pos_embed (1500, d)                      # fixed sinusoids
    layers: ln1_g/ln1_b (L, d)
            attn: wq/wk/wv/wo (L, d, d), bq/bv/bo (L, d)
            ln2_g/ln2_b (L, d)
            mlp: w1 (L, d, 4d), b1 (L, 4d), w2 (L, 4d, d), b2 (L, d)
    ln_post_g/ln_post_b (d,)
  decoder:
    token_embed (V, d)      pos_embed (448, d)   # learned
    layers: ln1 + self_attn, ln2 + cross_attn, ln3 + mlp (same shapes)
    ln_g/ln_b (d,)
    logits_w                                 # int8 trees only (ops/quant.py)

In an int8 tree (``ops/quant.py::quantize_params``) every matmul weight of
the layers is a ``QuantizedLinear`` (q int8, s float32).

Checkpoint loaders (HF safetensors, CT2 model.bin) are not ported yet.
"""

import numpy as np
import torch

from faster_whisper_tpu_torch.models.config import WhisperConfig
from faster_whisper_tpu_torch.ops.quant import QuantizedLinear, QuantKV
from faster_whisper_tpu_torch.utils import resolve_device


def param_shapes(config: WhisperConfig):
    """Tree of (shape, kind) describing the full parameter structure;
    kind is 'w' (random-normal), 'zero', 'one', or 'sinusoid'."""
    d = config.n_audio_state
    dd = config.n_text_state
    Le, Ld = config.n_audio_layer, config.n_text_layer

    def attn(L, dim):
        return {
            "wq": ((L, dim, dim), "w"),
            "bq": ((L, dim), "zero"),
            "wk": ((L, dim, dim), "w"),
            "wv": ((L, dim, dim), "w"),
            "bv": ((L, dim), "zero"),
            "wo": ((L, dim, dim), "w"),
            "bo": ((L, dim), "zero"),
        }

    def mlp(L, dim):
        return {
            "w1": ((L, dim, 4 * dim), "w"),
            "b1": ((L, 4 * dim), "zero"),
            "w2": ((L, 4 * dim, dim), "w"),
            "b2": ((L, dim), "zero"),
        }

    return {
        "encoder": {
            "conv1_w": ((3, config.n_mels, d), "w"),
            "conv1_b": ((d,), "zero"),
            "conv2_w": ((3, d, d), "w"),
            "conv2_b": ((d,), "zero"),
            "pos_embed": ((config.n_audio_ctx, d), "sinusoid"),
            "layers": {
                "ln1_g": ((Le, d), "one"),
                "ln1_b": ((Le, d), "zero"),
                "attn": attn(Le, d),
                "ln2_g": ((Le, d), "one"),
                "ln2_b": ((Le, d), "zero"),
                "mlp": mlp(Le, d),
            },
            "ln_post_g": ((d,), "one"),
            "ln_post_b": ((d,), "zero"),
        },
        "decoder": {
            "token_embed": ((config.n_vocab, dd), "w"),
            "pos_embed": ((config.n_text_ctx, dd), "w"),
            "layers": {
                "ln1_g": ((Ld, dd), "one"),
                "ln1_b": ((Ld, dd), "zero"),
                "self_attn": attn(Ld, dd),
                "ln2_g": ((Ld, dd), "one"),
                "ln2_b": ((Ld, dd), "zero"),
                "cross_attn": attn(Ld, dd),
                "ln3_g": ((Ld, dd), "one"),
                "ln3_b": ((Ld, dd), "zero"),
                "mlp": mlp(Ld, dd),
            },
            "ln_g": ((dd,), "one"),
            "ln_b": ((dd,), "zero"),
        },
    }


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def random_params(
    config: WhisperConfig, seed: int = 0, dtype=torch.bfloat16, device="cuda"
):
    """Random-normal (std 0.02) weights with the production structure,
    drawn on ``device`` from a seeded ``torch.Generator``: no host-side
    draw of the full weight count.  Not the JAX package's numbers (a
    different generator); tests carry weights across with
    ``params_from_jax`` instead."""
    from faster_whisper_tpu_torch.models.model import sinusoids

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(leaf):
        shape, kind = leaf
        if kind == "w":
            w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
            return (w * 0.02).to(dtype)
        if kind == "one":
            return torch.ones(shape, device=dev, dtype=dtype)
        if kind == "zero":
            return torch.zeros(shape, device=dev, dtype=dtype)
        return torch.as_tensor(sinusoids(*shape), device=dev).to(dtype)

    return _map_tree(make, param_shapes(config))


def _to_tensor(a, device, dtype):
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from JAX
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


_QUANT_LEAVES = {"QuantizedLinear": QuantizedLinear, "QuantKV": QuantKV}


def params_from_jax(tree, device="cuda", dtype=None):
    """Carry a JAX parameter tree (arrays, or their numpy copies) across:
    the same nested dict of tensors on ``device``, float leaves in
    ``dtype`` (default: each leaf's own).  The JAX package's
    ``QuantizedLinear`` and ``QuantKV`` leaves (int8 trees) become the
    port's NamedTuples of the same name, with ``q`` kept int8 and ``s`` in
    its own dtype."""
    dev = resolve_device(device)

    def convert(a):
        cls = _QUANT_LEAVES.get(type(a).__name__)
        if cls is not None:
            return cls(*(_to_tensor(x, dev, None) for x in a))
        return _to_tensor(a, dev, dtype)

    return _map_tree(convert, tree)
