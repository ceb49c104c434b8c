"""Weights: the parameter layout, random init on the device, conversion of
a JAX parameter tree, and the checkpoint loaders (HF safetensors and
CTranslate2 ``model.bin``).

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

The loaders map a checkpoint file into memory and move it to the device one
tensor of one layer at a time, widened to float32 there (the JAX package's
numpy steps: float16 -> float32, int8 -> float32 / weight_scale) and cast
into the stacked leaf in the requested dtype.  The host never holds more
than one layer's tensor, so large-v3's 3 GB of float16 weights load without
the ~10 GB that widening the whole file on the host would take.  The bits
are the JAX package's: float16 -> float32 -> bfloat16 rounds once, as
float16 -> bfloat16 does.
"""

import json
import os
import struct

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from faster_whisper_tpu_torch.models.config import CONFIGS, WhisperConfig, config_from_dims
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


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else _DTYPE_NAMES[dtype]


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A file array (a read-only view of the mapped file) on ``dev``, in its
    own dtype; the host copy is one tensor of one layer."""
    return torch.from_numpy(np.array(arr)).to(dev)


def _stack_layers(layer: Callable[[int], dict], n: int, dtype: torch.dtype) -> dict:
    """The tree of ``layer(i)`` for i < n with every leaf stacked along a
    new leading axis, in ``dtype``; one layer's tensors exist at a time."""
    out = None

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    for i in range(n):
        tree = layer(i)
        if out is None:
            out = _map_tree(
                lambda t: torch.empty((n, *t.shape), dtype=dtype, device=t.device), tree
            )
        put(out, tree, i)
    return out


def load_hf_safetensors(model_dir: str, dtype=torch.bfloat16, device="cuda"):
    """Load a transformers-format Whisper checkpoint (``config.json`` and
    every ``*.safetensors`` file of the directory, so sharded checkpoints
    too) onto ``device``.  Returns (params, config)."""
    from faster_whisper_tpu_torch.models.safetensors import load_file

    dev, dtype = resolve_device(device), _torch_dtype(dtype)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)

    config = config_from_dims(
        n_mels=hf_cfg["num_mel_bins"],
        n_audio_state=hf_cfg["d_model"],
        n_audio_head=hf_cfg["encoder_attention_heads"],
        n_audio_layer=hf_cfg["encoder_layers"],
        n_text_state=hf_cfg["d_model"],
        n_text_head=hf_cfg["decoder_attention_heads"],
        n_text_layer=hf_cfg["decoder_layers"],
        n_vocab=hf_cfg["vocab_size"],
        name=os.path.basename(model_dir.rstrip("/")),
        alignment_heads=_hf_alignment_heads(model_dir, hf_cfg),
    )

    tensors = {}
    for fname in sorted(os.listdir(model_dir)):
        if fname.endswith(".safetensors"):
            tensors.update(load_file(os.path.join(model_dir, fname)))
    prefix = "model." if any(k.startswith("model.") for k in tensors) else ""

    def t(name):
        return _upload(tensors[prefix + name], dev)

    def lin_w(name):
        return t(name + ".weight").T  # (out, in) -> (in, out)

    def attn(base):
        return {
            "wq": lin_w(f"{base}.q_proj"),
            "bq": t(f"{base}.q_proj.bias"),
            "wk": lin_w(f"{base}.k_proj"),
            "wv": lin_w(f"{base}.v_proj"),
            "bv": t(f"{base}.v_proj.bias"),
            "wo": lin_w(f"{base}.out_proj"),
            "bo": t(f"{base}.out_proj.bias"),
        }

    def mlp(base):
        return {
            "w1": lin_w(f"{base}.fc1"),
            "b1": t(f"{base}.fc1.bias"),
            "w2": lin_w(f"{base}.fc2"),
            "b2": t(f"{base}.fc2.bias"),
        }

    def enc_layer(i):
        base = f"encoder.layers.{i}"
        return {
            "ln1_g": t(f"{base}.self_attn_layer_norm.weight"),
            "ln1_b": t(f"{base}.self_attn_layer_norm.bias"),
            "attn": attn(f"{base}.self_attn"),
            "ln2_g": t(f"{base}.final_layer_norm.weight"),
            "ln2_b": t(f"{base}.final_layer_norm.bias"),
            "mlp": mlp(base),
        }

    def dec_layer(i):
        base = f"decoder.layers.{i}"
        return {
            "ln1_g": t(f"{base}.self_attn_layer_norm.weight"),
            "ln1_b": t(f"{base}.self_attn_layer_norm.bias"),
            "self_attn": attn(f"{base}.self_attn"),
            "ln2_g": t(f"{base}.encoder_attn_layer_norm.weight"),
            "ln2_b": t(f"{base}.encoder_attn_layer_norm.bias"),
            "cross_attn": attn(f"{base}.encoder_attn"),
            "ln3_g": t(f"{base}.final_layer_norm.weight"),
            "ln3_b": t(f"{base}.final_layer_norm.bias"),
            "mlp": mlp(base),
        }

    def leaf(x):
        return x.to(dtype).contiguous()

    params = {
        "encoder": {
            # torch Conv1d weight (out, in, k) -> (k, in, out)
            "conv1_w": leaf(t("encoder.conv1.weight").permute(2, 1, 0)),
            "conv1_b": leaf(t("encoder.conv1.bias")),
            "conv2_w": leaf(t("encoder.conv2.weight").permute(2, 1, 0)),
            "conv2_b": leaf(t("encoder.conv2.bias")),
            "pos_embed": leaf(t("encoder.embed_positions.weight")),
            "layers": _stack_layers(enc_layer, config.n_audio_layer, dtype),
            "ln_post_g": leaf(t("encoder.layer_norm.weight")),
            "ln_post_b": leaf(t("encoder.layer_norm.bias")),
        },
        "decoder": {
            "token_embed": leaf(t("decoder.embed_tokens.weight")),
            "pos_embed": leaf(t("decoder.embed_positions.weight")),
            "layers": _stack_layers(dec_layer, config.n_text_layer, dtype),
            "ln_g": leaf(t("decoder.layer_norm.weight")),
            "ln_b": leaf(t("decoder.layer_norm.bias")),
        },
    }
    return params, config


def _hf_alignment_heads(model_dir, hf_cfg):
    """``alignment_heads`` of the directory's ``generation_config.json``,
    or () when it has none."""
    gen_path = os.path.join(model_dir, "generation_config.json")
    if os.path.exists(gen_path):
        try:
            with open(gen_path) as f:
                gen = json.load(f)
            heads = gen.get("alignment_heads")
            if heads:
                return tuple(tuple(h) for h in heads)
        except (json.JSONDecodeError, OSError):
            pass
    return ()


_CT2_DTYPES = {
    0: np.dtype(np.float32),
    1: np.dtype(np.int8),
    2: np.dtype(np.int16),
    3: np.dtype(np.int32),
    4: np.dtype(np.float16),
    5: np.dtype("<u2"),  # bfloat16 stored as raw uint16
}


def read_ct2_variables(path_or_bytes) -> Dict[str, np.ndarray]:
    """Parse a CTranslate2 model.bin (path, bytes, or file-like) into
    {name: ndarray}; a path is mapped into memory and the arrays are views
    of it.

    Binary layout (binary versions up to 10): uint32 binary_version,
    C-string spec name (uint16 length incl. NUL), uint32 spec revision,
    uint32 variable count, then per variable: name (same string encoding),
    uint8 rank, uint32 dims, uint8 dtype tag (the item size in old
    versions), uint32 payload byte count, raw payload.  The payload size
    tells the two tag meanings apart.  bfloat16 (tag 5) is widened to
    float32.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    elif hasattr(path_or_bytes, "read"):
        data = path_or_bytes.read()
    else:
        data = np.memmap(path_or_bytes, dtype=np.uint8, mode="r")

    off = 0

    def unpack(fmt):
        nonlocal off
        (v,) = struct.unpack_from(fmt, data, off)
        off += struct.calcsize(fmt)
        return v

    def cstr():
        nonlocal off
        n = unpack("<H")
        s = bytes(data[off : off + n - 1]).decode("utf-8")
        off += n
        return s

    binary_version = unpack("<I")
    if binary_version > 10:
        raise ValueError(f"unsupported CTranslate2 binary version {binary_version}")
    spec_name = cstr()
    revision = unpack("<I")
    num_vars = unpack("<I")

    variables: Dict[str, np.ndarray] = {}
    for _ in range(num_vars):
        name = cstr()
        rank = unpack("<B")
        dims = [unpack("<I") for _ in range(rank)]
        tag = unpack("<B")
        nbytes = unpack("<I")
        count = int(np.prod(dims)) if dims else 1

        dtype = _CT2_DTYPES.get(tag)
        if dtype is None or count * dtype.itemsize != nbytes:
            # Old format: the tag byte is the item size.
            if count * tag != nbytes:
                raise ValueError(
                    f"cannot infer dtype for CT2 variable {name!r}: "
                    f"tag={tag} dims={dims} nbytes={nbytes}"
                )
            dtype = {4: np.dtype(np.float32), 1: np.dtype(np.int8)}.get(tag)
            if dtype is None:
                raise ValueError(f"unsupported CT2 item size {tag} for {name!r}")

        arr = np.frombuffer(data, dtype=dtype, count=count, offset=off).reshape(dims)
        if tag == 5:
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        off += nbytes
        variables[name] = arr

    variables["__spec__"] = np.array([spec_name], dtype=object)
    variables["__revision__"] = np.array([revision])
    return variables


def read_blob(blob):
    """The contents of one ``files=`` entry: bytes, or a file-like object."""
    return blob.read() if hasattr(blob, "read") else blob


def load_ct2_model(model_dir: str, dtype=torch.bfloat16, files: Optional[dict] = None,
                   device="cuda"):
    """Load a CTranslate2-converted Whisper directory (model.bin +
    config.json) onto ``device``, or in-memory file contents via ``files``
    (name -> bytes or file-like).  Returns (params, config).

    CT2 fuses self-attention QKV into one linear (linear_0: (3d, d), whose
    k bias is dropped) and cross-attention KV into linear_1: (2d, d); they
    are split back out.  An int8 weight with a ``weight_scale`` is
    dequantized as ``q / scale`` in float32 (the int8 compute types
    quantize again, ``ops/quant.py``).  Layer norms may be named
    gamma/beta or weight/bias; without ``encoder/position_encodings`` the
    encoder takes the fixed sinusoids.
    """
    from faster_whisper_tpu_torch.models.model import sinusoids

    dev, dtype = resolve_device(device), _torch_dtype(dtype)
    files = files or {}
    if "config.json" in files:
        ct2_cfg = json.loads(read_blob(files["config.json"]))
    else:
        with open(os.path.join(model_dir, "config.json")) as f:
            ct2_cfg = json.load(f)

    variables = read_ct2_variables(files.get("model.bin", os.path.join(model_dir, "model.bin")))
    variables.pop("__spec__", None)
    variables.pop("__revision__", None)

    def get(name):
        arr = variables[name]
        t = _upload(arr, dev)
        scale_name = name.rsplit("/", 1)[0] + "/weight_scale"
        if arr.dtype == np.int8 and scale_name in variables:
            scale = _upload(variables[scale_name], dev).float()
            return t.float() / scale.reshape(-1, *([1] * (t.ndim - 1)))
        return t.float() if arr.dtype == np.float16 else t

    def lin_w(name):
        return get(name + "/weight").T

    def has(name):
        return name in variables

    def count_layers(prefix):
        i = 0
        while has(f"{prefix}/layer_{i}/self_attention/layer_norm/gamma") or has(
            f"{prefix}/layer_{i}/self_attention/layer_norm/weight"
        ):
            i += 1
        return i

    def ln(name, g, b):
        for g_key, b_key in (("gamma", "beta"), ("weight", "bias")):
            if has(f"{name}/{g_key}"):
                return {g: get(f"{name}/{g_key}"), b: get(f"{name}/{b_key}")}
        raise KeyError(name)

    def self_attn(base):
        wq, wk, wv = get(f"{base}/linear_0/weight").chunk(3, dim=0)  # (3d, d)
        bq, _bk, bv = get(f"{base}/linear_0/bias").chunk(3, dim=0)
        return {
            "wq": wq.T, "bq": bq, "wk": wk.T, "wv": wv.T, "bv": bv,
            "wo": lin_w(f"{base}/linear_1"), "bo": get(f"{base}/linear_1/bias"),
        }

    def cross_attn(base):
        wk, wv = get(f"{base}/linear_1/weight").chunk(2, dim=0)  # (2d, d)
        _bk, bv = get(f"{base}/linear_1/bias").chunk(2, dim=0)
        return {
            "wq": lin_w(f"{base}/linear_0"), "bq": get(f"{base}/linear_0/bias"),
            "wk": wk.T, "wv": wv.T, "bv": bv,
            "wo": lin_w(f"{base}/linear_2"), "bo": get(f"{base}/linear_2/bias"),
        }

    def mlp(base):
        return {
            "w1": lin_w(f"{base}/linear_0"), "b1": get(f"{base}/linear_0/bias"),
            "w2": lin_w(f"{base}/linear_1"), "b2": get(f"{base}/linear_1/bias"),
        }

    def enc_layer(i):
        base = f"encoder/layer_{i}"
        return {
            **ln(f"{base}/self_attention/layer_norm", "ln1_g", "ln1_b"),
            "attn": self_attn(f"{base}/self_attention"),
            **ln(f"{base}/ffn/layer_norm", "ln2_g", "ln2_b"),
            "mlp": mlp(f"{base}/ffn"),
        }

    def dec_layer(i):
        base = f"decoder/layer_{i}"
        return {
            **ln(f"{base}/self_attention/layer_norm", "ln1_g", "ln1_b"),
            "self_attn": self_attn(f"{base}/self_attention"),
            **ln(f"{base}/attention/layer_norm", "ln2_g", "ln2_b"),
            "cross_attn": cross_attn(f"{base}/attention"),
            **ln(f"{base}/ffn/layer_norm", "ln3_g", "ln3_b"),
            "mlp": mlp(f"{base}/ffn"),
        }

    def leaf(x):
        return x.to(dtype).contiguous()

    conv1_w = get("encoder/conv1/weight")  # (d, n_mels, 3)
    d_model, n_mels = conv1_w.shape[0], conv1_w.shape[1]
    token_embed = leaf(get("decoder/embeddings/weight"))
    n_enc, n_dec = count_layers("encoder"), count_layers("decoder")
    if has("encoder/position_encodings"):
        enc_pos = get("encoder/position_encodings")
    else:
        enc_pos = torch.from_numpy(sinusoids(1500, d_model).astype(np.float32)).to(dev)

    params = {
        "encoder": {
            "conv1_w": leaf(conv1_w.permute(2, 1, 0)),
            "conv1_b": leaf(get("encoder/conv1/bias")),
            "conv2_w": leaf(get("encoder/conv2/weight").permute(2, 1, 0)),
            "conv2_b": leaf(get("encoder/conv2/bias")),
            "pos_embed": leaf(enc_pos),
            "layers": _stack_layers(enc_layer, n_enc, dtype),
            **{k: leaf(v) for k, v in ln("encoder/layer_norm", "ln_post_g", "ln_post_b").items()},
        },
        "decoder": {
            "token_embed": token_embed,
            "pos_embed": leaf(get("decoder/position_encodings")),
            "layers": _stack_layers(dec_layer, n_dec, dtype),
            **{k: leaf(v) for k, v in ln("decoder/layer_norm", "ln_g", "ln_b").items()},
        },
    }

    n_head = int(ct2_cfg.get("attention_heads", d_model // 64))
    config = config_from_dims(
        n_mels=n_mels,
        n_audio_state=d_model,
        n_audio_head=n_head,
        n_audio_layer=n_enc,
        n_text_state=d_model,
        n_text_head=n_head,
        n_text_layer=n_dec,
        n_vocab=token_embed.shape[0],
        name=os.path.basename(model_dir.rstrip("/")),
        alignment_heads=ct2_cfg.get("alignment_heads", []),
    )
    return params, config


def load_model(model_dir: str, dtype=torch.bfloat16, files: Optional[dict] = None,
               device="cuda") -> Tuple[dict, WhisperConfig]:
    """Load whichever checkpoint format ``model_dir`` (or ``files``) holds."""
    if files and "model.bin" in files:
        return load_ct2_model(model_dir, dtype=dtype, files=files, device=device)
    if os.path.exists(os.path.join(model_dir, "model.bin")):
        return load_ct2_model(model_dir, dtype=dtype, device=device)
    if any(f.endswith(".safetensors") for f in os.listdir(model_dir)):
        return load_hf_safetensors(model_dir, dtype=dtype, device=device)
    raise ValueError(f"no model.bin or *.safetensors checkpoint found in {model_dir}")


def named_config(name: str) -> Optional[WhisperConfig]:
    return CONFIGS.get(name)
