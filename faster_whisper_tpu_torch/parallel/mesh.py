"""Device meshes and sharding layouts for serving on more than one device.

Counterpart of ``faster_whisper_tpu/parallel/mesh.py``.  A mesh is a
("data", "model") grid of devices.  The data axis holds one replica of the
parameters per row of the grid (``models/engine.py``): a batch whose rows
divide the data size is split into equal contiguous shards, one per
replica, each run on its own host thread, which is the reference's one
replica per GPU.  The model axis (``tensor_parallel``) splits each replica
over the row's devices in the JAX package's Megatron layouts
(``param_pspecs``, ``shard_params``): q/k/v and the MLP's up-projection
column-parallel (output axis over "model"), the attention output and the
MLP's down-projection row-parallel (input axis over "model"), everything
else replicated.  One host thread drives a row's shards as one group
(``ShardedParams``, ``parallel/collectives.py``), with one all-reduce
after each row-parallel product.

Unlike a JAX mesh, a mesh here may hold one device more than once:
``device_index=[0, 0]`` puts two replicas on ``cuda:0``, and on the host
(``device="cpu"``) every index names the host, which stands in for
``HOST_DEVICES`` devices, as the JAX tests' virtual CPU mesh does.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# The host's devices: as many as the JAX tests' virtual CPU mesh
# (--xla_force_host_platform_device_count=8).
HOST_DEVICES = 8


@dataclass(frozen=True)
class Mesh:
    """A grid of devices, ``devices`` (data, model), with named axes."""

    devices: np.ndarray  # of torch.device
    axis_names = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def device_count(kind: str) -> int:
    """Visible devices of ``kind``: the CUDA cards, or ``HOST_DEVICES``."""
    if kind == "cuda":
        return torch.cuda.device_count()
    if kind == "cpu":
        return HOST_DEVICES
    raise ValueError(f"no devices of kind {kind!r}")


def make_mesh(
    n_devices: Optional[int] = None,
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A ("data", "model") mesh over the first ``n_devices`` of ``devices``
    (default: every visible card), ``data`` x ``model`` of them (``data``
    defaults to ``n_devices // model``)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(device_count("cuda"))]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if data is None:
        if n_devices % model:
            raise ValueError(f"model axis {model} does not divide {n_devices} devices")
        data = n_devices // model
    if data * model != len(devices):
        raise ValueError(f"a {data} x {model} mesh needs {data * model} devices, got {len(devices)}")
    grid = np.empty((data, model), dtype=object)
    for i, dev in enumerate(devices):
        grid[i // model, i % model] = torch.device(dev)
    return Mesh(grid)


# ---------------------------------------------------------------------------
# The model axis: Megatron layouts.  A spec gives each leaf the axis that the
# model axis splits, or None (replicated); a QuantizedLinear's spec is a
# QuantizedLinear of its codes' and its scales' specs.  Layers are stacked
# on axis 0, so a (L, in, out) weight is column-parallel on axis 2 and
# row-parallel on axis 1, as the JAX package's P(None, None, "model") and
# P(None, "model", None).
# ---------------------------------------------------------------------------


def _attn_specs(tp: bool) -> dict:
    col, row, bias = (2, 1, 1) if tp else (None, None, None)
    return {"wq": col, "bq": bias, "wk": col, "wv": col, "bv": bias, "wo": row, "bo": None}


def _mlp_specs(tp: bool) -> dict:
    col, row, bias = (2, 1, 1) if tp else (None, None, None)
    return {"w1": col, "b1": bias, "w2": row, "b2": None}


def param_pspecs(tensor_parallel: bool = True) -> dict:
    """The spec tree of ``models/load.py``'s layout: q/k/v and ``mlp.w1``
    column-parallel, the attention output and ``mlp.w2`` row-parallel; the
    embeddings, the conv stem, the layer norms and the row-parallel
    biases replicated."""
    tp = tensor_parallel

    def layers(**attn):
        return dict({k: None for k in ("ln1_g", "ln1_b", "ln2_g", "ln2_b")},
                    mlp=_mlp_specs(tp), **attn)

    dec_layers = layers(self_attn=_attn_specs(tp), cross_attn=_attn_specs(tp))
    dec_layers.update(ln3_g=None, ln3_b=None)
    return {
        "encoder": dict(
            {k: None for k in ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "pos_embed",
                               "ln_post_g", "ln_post_b")},
            layers=layers(attn=_attn_specs(tp)),
        ),
        "decoder": dict(
            {k: None for k in ("token_embed", "pos_embed", "ln_g", "ln_b")}, layers=dec_layers,
        ),
    }


def _scale_spec(axis: Optional[int], q_dim: int, grouped: bool) -> Optional[int]:
    """A QuantizedLinear's scale spec from its codes' (..., in, out) spec.
    Per output channel (s (..., out)) the scale follows the output axis
    and a row-parallel weight's is replicated, as the JAX package's
    ``_scale_spec``.  Group scales (s (..., in/G, out)) are split with
    what they scale: along the output axis of a column-parallel weight,
    along the groups with the input rows of a row-parallel one.  (The JAX
    rule drops the scales' second-to-last axis in both forms, which puts a
    column-parallel weight's group scales on the model axis by group; the
    values are the same, only the placement differs.)"""
    if axis is None:
        return None
    if axis == q_dim - 1:
        return q_dim - 1 if grouped else q_dim - 2
    return q_dim - 2 if grouped else None


def specs_for_params(params, tensor_parallel: bool = True, model_size: int = 1):
    """The spec tree of a real parameter tree: int8 and int4 trees carry
    QuantizedLinear leaves (``_scale_spec``), the int8 head ``logits_w`` is
    vocab-sharded (axis 1) where the JAX rule shards it, when the model
    size divides the vocabulary (51866 = 2 x a prime: only 2 does), and
    any key the template does not know is replicated."""
    from faster_whisper_tpu_torch.ops.quant import QuantizedLinear

    template = param_pspecs(tensor_parallel)
    dec = params.get("decoder", {})
    if dec.get("logits_w") is not None:
        vocab = dec["token_embed"].shape[0]
        template["decoder"]["logits_w"] = (
            1 if tensor_parallel and model_size > 1 and vocab % model_size == 0 else None
        )

    def build(p, s):
        if isinstance(p, QuantizedLinear):
            axis = s if isinstance(s, int) else None
            return QuantizedLinear(axis, _scale_spec(axis, p.q.dim(), p.s.dim() == p.q.dim()))
        if isinstance(p, dict):
            return {k: build(v, s.get(k) if isinstance(s, dict) else None) for k, v in p.items()}
        return s if isinstance(s, int) else None

    return build(params, template)


class ShardedParams:
    """One replica's parameters over a model-axis group: ``trees[i]`` on
    ``group.devices[i]``, shard 0 the lead.  ``models/model.py`` runs a
    ``ShardedParams`` where it runs one tree (the group of one)."""

    __slots__ = ("trees", "group")

    def __init__(self, trees: List[dict], group):
        if len(trees) != group.size:
            raise ValueError(f"{len(trees)} parameter trees for a group of {group.size}")
        self.trees, self.group = list(trees), group


def _slice(t: torch.Tensor, axis: Optional[int], i: int, n: int, device) -> torch.Tensor:
    if axis is None:
        return t.to(device)
    size = t.shape[axis]
    if size % n:
        raise ValueError(f"the model axis {n} does not divide axis {axis} of a {tuple(t.shape)} leaf")
    return t.narrow(axis, i * (size // n), size // n).to(device).contiguous()


def _head_slice(lw, vocab: int, i: int, n: int, device):
    """Shard ``i`` of the int8 head, vocab-sharded: the columns [i V/n,
    (i+1) V/n) of the vocabulary, zero-padded to a multiple of 8 as the
    whole head is (``ops/quant.py::_quantize_params``)."""
    from faster_whisper_tpu_torch.ops.quant import _INT_MM_ALIGN, QuantizedLinear, card_layout

    w = vocab // n
    pad = -w % _INT_MM_ALIGN

    def cols(t):
        part = t.narrow(t.dim() - 1, i * w, w)
        return torch.nn.functional.pad(part, (0, pad)).to(device).contiguous()

    return card_layout(QuantizedLinear(cols(lw.q), cols(lw.s)))


def shard_params(params, mesh: Mesh, tensor_parallel: bool = True, row: int = 0) -> List[dict]:
    """One tree per model-axis position of ``mesh``'s data row ``row``:
    each leaf's slice (``specs_for_params``) on that position's device, a
    contiguous copy (a replicated leaf stays the same tensor on its own
    device; int8 codes on a card in ``ops/quant.py::card_layout``).  A
    row-parallel weight's group scales go with its input rows, which needs
    ``in / model`` to be a multiple of the group size."""
    from faster_whisper_tpu_torch.ops.quant import QuantizedLinear, card_layout

    devices = [torch.device(d) for d in mesh.devices[row]]
    n = len(devices)
    specs = specs_for_params(params, tensor_parallel, model_size=n)
    vocab = params["decoder"]["token_embed"].shape[0]

    def build(p, s, i):
        if isinstance(p, QuantizedLinear):
            if s.q is not None and s.s is not None and p.s.dim() == p.q.dim() and s.q == p.q.dim() - 2:
                n_g = p.s.shape[-2]
                if n_g % n:
                    raise ValueError(
                        f"tensor_parallel={n}: the input width {p.q.shape[-2]} over {n} shards is "
                        f"not a multiple of the group size {p.q.shape[-2] // n_g}"
                    )
            return card_layout(QuantizedLinear(_slice(p.q, s.q, i, n, devices[i]), _slice(p.s, s.s, i, n, devices[i])))
        if isinstance(p, dict):
            return {k: build(v, s[k], i) for k, v in p.items()}
        return _slice(p, s, i, n, devices[i])

    trees = []
    for i in range(n):
        tree = {k: build(v, specs[k], i) for k, v in params.items() if k != "decoder"}
        dec = params["decoder"]
        tree["decoder"] = {k: build(v, specs["decoder"][k], i) for k, v in dec.items() if k != "logits_w"}
        if "logits_w" in dec:
            lw = dec["logits_w"]
            tree["decoder"]["logits_w"] = (
                _head_slice(lw, vocab, i, n, devices[i]) if specs["decoder"]["logits_w"].q is not None
                else card_layout(QuantizedLinear(lw.q.to(devices[i]), lw.s.to(devices[i])))
            )
        trees.append(tree)
    return trees
