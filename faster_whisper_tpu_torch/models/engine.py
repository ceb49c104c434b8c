"""WhisperEngine: the device-side inference surface.

Counterpart of ``faster_whisper_tpu/models/engine.py``: the
``ctranslate2.models.Whisper`` surface that the policy layer
(``transcribe.py``) drives -- ``encode``, ``generate``, ``align`` and
``detect_language`` plus ``is_multilingual``/``n_mels``.

``align`` (word timestamps) is a teacher-forced decoder pass in plain
PyTorch, as the JAX package computes it outside any Pallas kernel: it
reduces the alignment heads' cross-attention to the DTW's input matrix on
the device, and the DTW (``dtw.py``, native) runs on the host.

On a mesh (``WhisperModel(device_index=[...])``, ``set_mesh``) the engine
holds one replica of the parameters per device of the data axis, as the
JAX engine's ``input_sharding`` splits the batch axis: a batch whose rows
divide the data size is split into equal contiguous shards, one per
replica, each run on its own host thread on the default stream of its
device, and ``encode`` hands back ``ShardedStates``, whose shards never
leave their devices; ``generate_dispatch``/``generate_collect``,
``detect_language`` and ``align_dispatch``/``align_collect`` run each
shard on its replica and return the rows in order.  Any other batch runs
whole on the first replica.

With a model axis (``tensor_parallel=N``) a replica is a group of N
shards (``parallel/mesh.py::ShardedParams``), all driven by the replica's
one host thread: every layer runs column/row-sharded, K1-K4 on each
shard's heads, one all-reduce after each row-parallel product
(``parallel/collectives.py``).  The beam and sampling bookkeeping runs on
the group's lead shard, whose device holds the encoder states that
``encode`` returns and every result.
"""

import concurrent.futures
import contextlib
import threading

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from faster_whisper_tpu_torch.generation.generate import (
    StepGraphs,
    WhisperGenerationResult,
    _row_seeds,
    generate_collect,
    generate_dispatch,
)
from faster_whisper_tpu_torch.dtw import dtw_path
from faster_whisper_tpu_torch.generation.processors import TokenMeta
from faster_whisper_tpu_torch.models import model as M
from faster_whisper_tpu_torch.models.config import WhisperConfig
from faster_whisper_tpu_torch.ops import _build
from faster_whisper_tpu_torch.ops.attention import mha
from faster_whisper_tpu_torch.ops.quant import QuantizedLinear
from faster_whisper_tpu_torch.parallel.collectives import ShardGroup
from faster_whisper_tpu_torch.parallel.mesh import ShardedParams, shard_params
from faster_whisper_tpu_torch.tokenizer import _LANGUAGE_CODES
from faster_whisper_tpu_torch.tracing import span
from faster_whisper_tpu_torch.utils import steady_float32


class AlignmentResult:
    """CT2's WhisperAlignmentResult: the text tokens' probabilities and the
    (text index, time index) pairs of the DTW path."""

    __slots__ = ("text_token_probs", "alignments")

    def __init__(self, text_token_probs, alignments):
        self.text_token_probs = text_token_probs
        self.alignments = alignments


# ---------------------------------------------------------------------------
# The teacher-forced alignment pass.  Returning every layer's cross-attention
# weights (L, B, H, S, T) would take gigabytes at large-v3 widths, so each
# layer hands its raw scores to a callback, which keeps only the alignment
# heads' share.
# ---------------------------------------------------------------------------


def _teacher_forced(params, config: WhisperConfig, tokens: torch.Tensor, xa: torch.Tensor, on_scores):
    """Decoder forward over the whole token buffer (B, S) on the encoder
    states ``xa`` (B, T, d), in plain PyTorch (no kernel of the decode
    loop).  Calls ``on_scores(layer, head_scores)`` once per layer, where
    ``head_scores(head)`` is head ``head``'s scaled cross-attention scores
    (B, S, T) in f32, on the device of the shard that holds the head
    (``head // (H / N)`` over a model-axis group), and returns the final
    layer-normed states (B, S, d) on the lead.  Cross K/V are computed
    from ``xa`` in the activation dtype (int8 trees through
    ``int8_dense``).  Counts its calls in ``_teacher_forced.calls``."""
    _build.count(_teacher_forced, "calls")
    trees, group = M.shards(params)
    dtype = trees[0]["decoder"]["token_embed"].dtype
    n_head = config.n_text_head // group.size
    scale = (config.n_text_state // config.n_text_head) ** -0.5

    xs, causal = M._prompt_inputs(trees, group, tokens)
    xas = group.replicated(lambda a: a.to(dtype), group.broadcast(xa))

    for li in range(config.n_text_layer):
        ps = M._layers(trees, "decoder", li)
        hs = M._norm(group, xs, ps, "ln1_g", "ln1_b")
        attn = [M._merge_heads(mha(*M._attn_qkv(p["self_attn"], h, n_head), mask=mask))
                for h, p, mask in zip(hs, ps, causal)]
        xs = M._residual(group, xs, M._out(group, attn, ps, "self_attn"))

        hs = M._norm(group, xs, ps, "ln2_g", "ln2_b")
        attn, scores = [], []
        for h, p, a in zip(hs, ps, xas):
            cp = p["cross_attn"]
            qx = M._split_heads(M._dense(h, cp["wq"], cp["bq"]), n_head)
            kx = M._split_heads(M._dense(a, cp["wk"]), n_head)
            vx = M._split_heads(M._dense(a, cp["wv"], cp["bv"]), n_head)
            sc = torch.einsum("bshd,bthd->bhst", qx.float(), kx.float()) * scale
            w = torch.softmax(sc, dim=-1)
            attn.append(M._merge_heads(
                torch.einsum("bhst,bthd->bshd", w.to(vx.dtype).float(), vx.float()).to(vx.dtype)
            ))
            del w
            scores.append(sc)
        xs = M._residual(group, xs, M._out(group, attn, ps, "cross_attn"))
        on_scores(li, lambda head: scores[head // n_head][:, head % n_head])
        del scores

        hs = M._norm(group, xs, ps, "ln3_g", "ln3_b")
        xs = M._residual(group, xs, M._mlp(group, hs, ps))

    dec = trees[0]["decoder"]
    return M.layer_norm(xs[0], dec["ln_g"], dec["ln_b"])


_teacher_forced.calls = 0


def _forward_with_alignment(params, config: WhisperConfig, head_select, tokens, xa):
    """(logits (B, S, V) f32, qk (B, K, S, T) f32): the logits over the
    whole vocabulary and the raw scaled cross-attention scores of the K
    (layer, head) pairs of ``head_select``.  The tests' view of the pass;
    ``_align_forward_post`` reduces each head as its layer runs instead of
    holding all K."""
    b, s = tokens.shape
    qk = torch.zeros((b, len(head_select), s, xa.shape[1]), dtype=torch.float32, device=xa.device)

    def keep(layer, head_scores):
        for k, (sel_layer, head) in enumerate(head_select):
            if sel_layer == layer:
                qk[:, k] += head_scores(head).to(qk.device)

    x = _teacher_forced(params, config, tokens, xa, keep)
    embed = M.lead(params)["decoder"]["token_embed"]
    return torch.matmul(x.float(), embed.float().t()), qk


def _median_filter_time(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis with mirror padding (the torch
    reflect-pad median filter of Whisper's timing code)."""
    if width <= 1:
        return x
    from scipy.ndimage import median_filter

    size = (1,) * (x.ndim - 1) + (width,)
    return median_filter(x, size=size, mode="mirror")


def alignment_matrix(qk: np.ndarray, t_frames: int, median_filter_width: int) -> np.ndarray:
    """The DTW input on the host, from a (K, S', T) raw-score slice: the
    plain version of ``_align_head_chain``, used by the tests.  Per-head
    softmax over the whole encoder time axis, then truncation to the
    content frames (truncating first would rescale each row by its tail
    mass), per-column standardisation over the tokens, the median filter
    along time, the mean over heads -> (S', t_frames)."""
    w = qk - qk.max(axis=-1, keepdims=True)
    w = np.exp(w)
    w /= w.sum(axis=-1, keepdims=True)
    w = w[..., :t_frames]
    mean = w.mean(axis=-2, keepdims=True)
    std = w.std(axis=-2, keepdims=True) + 1e-9
    w = (w - mean) / std
    w = _median_filter_time(w, median_filter_width)
    return w.mean(axis=0)


def _align_head_chain(xk, row_start, n_rows, t_frames, median_width: int) -> torch.Tensor:
    """The DTW-input recipe for one alignment head's raw scores (B, S, T),
    batched with per-item masks: softmax over the whole T, per-column
    standardisation over the item's text rows (population variance), and
    the median filter along time with the mirror at the item's content
    boundary ``t_frames`` (the host filters after truncating to it), not
    at T.  Columns >= t_frames are garbage; callers slice them off."""
    B, S, T = xk.shape
    w = torch.softmax(xk.float(), dim=-1)

    rows = torch.arange(S, device=xk.device)[None, :, None]
    rmask = (rows >= row_start[:, None, None]) & (rows < (row_start + n_rows)[:, None, None])
    cnt = n_rows.clamp(min=1).float()[:, None, None]
    mean = torch.where(rmask, w, 0.0).sum(dim=1, keepdim=True) / cnt
    var = torch.where(rmask, (w - mean) ** 2, 0.0).sum(dim=1, keepdim=True) / cnt
    w = (w - mean) / (torch.sqrt(var) + 1e-9)

    if median_width <= 1:
        return w

    # Column c >= t_frames reads reverse(w) rolled by 2 * t_frames - T - 1,
    # per item: x[2 * t_frames - 2 - c] where that index is in range.
    col = torch.arange(T, device=xk.device)[None, :]
    shift = (2 * t_frames - T - 1)[:, None]
    src = torch.where(col < t_frames[:, None], col, T - 1 - torch.remainder(col - shift, T))
    w = torch.gather(w, 2, src[:, None, :].expand(B, S, T))

    # median along time: reflect pad, then the middle of the sorted slices
    half = median_width // 2
    wp = F.pad(w, (half, half), mode="reflect")
    stack = torch.stack([wp[:, :, k : k + T] for k in range(median_width)], dim=0)
    return stack.sort(dim=0).values[half]


def _align_forward_post(
    params,
    config: WhisperConfig,
    head_select: Tuple[Tuple[int, int], ...],
    tokens: torch.Tensor,  # (B, S)
    xa: torch.Tensor,  # (B, T, d)
    row_start: torch.Tensor,  # (B,) first text row (len(prefix) - 1)
    n_rows: torch.Tensor,  # (B,) text rows, the eot row included
    t_frames: torch.Tensor,  # (B,) content frames on the encoder time axis
    *,
    eot: int,
    median_width: int,
):
    """The whole alignment pass on the device: the teacher-forced forward,
    each next token's probability over the text vocabulary (B, S), and the
    head-mean of the per-head DTW-input recipe (B, S, T) f32.  Each
    alignment head is reduced while its layer runs, so only one (B, S, T)
    sum is held beside the layer's scores."""
    b, s = tokens.shape
    matrix = torch.zeros((b, s, xa.shape[1]), dtype=torch.float32, device=xa.device)

    def reduce(layer, head_scores):
        # each head's recipe on its shard's device, summed on the lead in
        # head_select's order
        for sel_layer, head in head_select:
            if sel_layer == layer:
                xk = head_scores(head)
                dev = xk.device
                chain = _align_head_chain(xk, row_start.to(dev), n_rows.to(dev), t_frames.to(dev), median_width)
                matrix.add_(chain.to(matrix.device))

    x = _teacher_forced(params, config, tokens, xa, reduce)

    # Probabilities over the text vocabulary [0, eot).  The prompt rows and
    # the eot row predict specials, which are clamped into range; their
    # values are never read.
    embed = M.lead(params)["decoder"]["token_embed"][:eot]
    lg = torch.matmul(x.float(), embed.float().t())  # (B, S, eot)
    nxt = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).clamp(max=eot - 1)
    tok_lp = lg.gather(2, nxt[:, :, None])[:, :, 0]
    probs = torch.exp(tok_lp - torch.logsumexp(lg, dim=-1))
    return probs, matrix / len(head_select)


def _tensors(tree):
    """The tensors of a parameter tree or a result: dict values, the
    fields of ``QuantizedLinear``/``QuantKV`` and tuples, walked in order."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, ShardedParams):
        yield from _tensors(tree.trees)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def resolve_token_ids(hf_tokenizer) -> dict:
    """The Whisper special-token layout of a base tokenizer."""

    def tid(tok):
        return hf_tokenizer.token_to_id(tok)

    eot = tid("<|endoftext|>")
    no_timestamps = tid("<|notimestamps|>")
    no_speech = tid("<|nospeech|>")
    if no_speech is None:
        no_speech = tid("<|nocaptions|>")
    languages = []
    for code in _LANGUAGE_CODES:
        t = tid("<|%s|>" % code)
        if t is not None:
            languages.append((code, t))
    blank = hf_tokenizer.encode(" ", add_special_tokens=False).ids
    return {
        "eot": eot,
        "sot": tid("<|startoftranscript|>"),
        "no_timestamps": no_timestamps,
        "timestamp_begin": no_timestamps + 1,
        "no_speech": no_speech if no_speech is not None else eot,
        "blank": blank,
        "languages": languages,
    }


class ShardedStates:
    """Encoder states (B, T, d) as contiguous row shards, each on the
    device of the replica that encoded it (``replicas[i]`` holds
    ``shards[i]``).  Slicing rows with a step of 1 gives the shards'
    slices."""

    __slots__ = ("shards", "replicas")

    def __init__(self, shards: Sequence[torch.Tensor], replicas: Sequence[int]):
        self.shards, self.replicas = list(shards), list(replicas)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (sum(int(t.shape[0]) for t in self.shards),) + tuple(self.shards[0].shape[1:])

    def __len__(self) -> int:
        return self.shape[0]

    def row_slices(self) -> List[slice]:
        """Each shard's rows in the whole batch."""
        out, start = [], 0
        for t in self.shards:
            out.append(slice(start, start + int(t.shape[0])))
            start += int(t.shape[0])
        return out

    def jobs(self) -> List[Tuple[int, Tuple[torch.Tensor, slice]]]:
        """(replica, (shard, its rows)) of each shard, in row order."""
        return [(r, (t, sl)) for r, t, sl in zip(self.replicas, self.shards, self.row_slices())]

    def __getitem__(self, key) -> "ShardedStates":
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise TypeError("ShardedStates takes a slice of rows")
        start, stop, _ = key.indices(len(self))
        shards, replicas = [], []
        for t, r, sl in zip(self.shards, self.replicas, self.row_slices()):
            lo, hi = max(start, sl.start), min(stop, sl.stop)
            if lo < hi:
                shards.append(t[lo - sl.start : hi - sl.start])
                replicas.append(r)
        return ShardedStates(shards, replicas)


class ShardedPending(NamedTuple):
    """A dispatch's pending result per shard, in row order: the
    ``generate_dispatch`` or ``align_dispatch`` result of each shard."""

    parts: tuple


def _copy_tree(tree, device: torch.device):
    """A copy of a parameter tree (dicts, ``QuantizedLinear``, tensors) on
    ``device``: new tensors even on the tree's own device."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_copy_tree(v, device) for v in tree))
    return tree.to(device=device, copy=True)


class WhisperEngine:
    """Device-side Whisper inference engine on the parameters' device, or
    on the replicas of a mesh's data axis."""

    def __init__(
        self,
        params,
        config: WhisperConfig,
        hf_tokenizer=None,
        token_ids: Optional[dict] = None,
        kv_int8: bool = False,
        int4: bool = False,
    ):
        """``kv_int8`` decodes over int8 self and cross KV caches (the int8
        compute types; ``params`` is then an int8 tree from
        ``ops/quant.py::quantize_params``).  ``int4`` (``compute_type=
        "int4"``) wants a tree from ``quantize_params_int4`` and keeps the
        cross cache at 4-bit range; the self cache stays at int8 range."""
        self.params = params
        self.kv_int8 = kv_int8
        self.int4 = int4
        if int4:
            if not kv_int8:
                raise ValueError("int4=True requires kv_int8=True")
            lw = params["decoder"].get("logits_w")
            if not isinstance(lw, QuantizedLinear):
                raise ValueError(
                    "int4=True requires quantized params (decoder.logits_w "
                    "is missing or not a QuantizedLinear): quantize with "
                    "ops.quant.quantize_params_int4 (compute_type='int4')"
                )
            if int(lw.q.abs().max()) > 7:
                raise ValueError(
                    "int4=True but params are int8-range: quantize with "
                    "ops.quant.quantize_params_int4 (compute_type='int4')"
                )
        self.config = config
        self.device = params["decoder"]["token_embed"].device
        if token_ids is None:
            token_ids = resolve_token_ids(hf_tokenizer)
        self.meta = TokenMeta(
            eot=token_ids["eot"],
            timestamp_begin=token_ids["timestamp_begin"],
            no_timestamps=token_ids["no_timestamps"],
            no_speech=token_ids["no_speech"],
            blank=tuple(token_ids["blank"]),
            vocab_size=config.n_vocab,
        )
        self.sot_id = token_ids["sot"]
        # [(code, token_id)] for language detection
        self.language_tokens: List[Tuple[str, int]] = token_ids["languages"]
        # (device, parameters) of each replica; the first is ``params``
        self.replicas: List[Tuple[torch.device, dict]] = [(self.device, params)]
        self.replica_batches: List[int] = [0]  # shards each replica decoded
        self.mesh = None
        # the beam search's CUDA graphs, with their states and pools
        self.step_graphs = StepGraphs()
        # the seed of a sampling call that passes none; None draws fresh
        # entropy per call, as CT2 does (``validate --mock`` fixes it)
        self.rng_seed: Optional[int] = None
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()

    # -- the mesh's data axis ----------------------------------------------

    def set_mesh(self, mesh) -> None:
        """One replica of the parameters per row of ``mesh``
        (``parallel/mesh.py``).  With a model axis of 1 the first device
        keeps ``params`` (it must be their device), every other gets a
        copy, a device listed twice a second copy.  With a model axis of N
        each row holds one group: the row's devices get the Megatron
        shards of ``params`` (``shard_params``), ``params`` becomes the
        first row's ``ShardedParams``, and the original tree is no longer
        held.  int8 and int4 trees are copied or sliced as they are."""
        rows = [[torch.device(d) for d in row] for row in mesh.devices]
        if rows[0][0] != self.device:
            raise ValueError(f"the mesh's first device {rows[0][0]} is not the parameters' {self.device}")
        if isinstance(self.params, ShardedParams):
            raise ValueError("WhisperEngine.set_mesh: the parameters are sharded already")
        if mesh.shape["model"] == 1:
            self.replicas = [(rows[0][0], self.params)] + [
                (row[0], _copy_tree(self.params, row[0])) for row in rows[1:]
            ]
        else:
            self.replicas = [
                (row[0], ShardedParams(shard_params(self.params, mesh, row=i), ShardGroup(row)))
                for i, row in enumerate(rows)
            ]
            self.params = self.replicas[0][1]
        self.replica_batches = [0] * len(rows)
        self.mesh = mesh
        self.step_graphs = StepGraphs()

    def group_devices(self, replica: int = 0) -> List[torch.device]:
        """The devices of a replica's model-axis group, its lead's first
        (one device without a model axis)."""
        params = self.replicas[replica][1]
        return list(params.group.devices) if isinstance(params, ShardedParams) else [self.replicas[replica][0]]

    def _shards(self, rows: int) -> Optional[List[slice]]:
        """Equal contiguous row shards, one per replica, or None: one
        replica, or rows that the data size does not divide."""
        n = len(self.replicas)
        if n < 2 or rows % n:
            return None
        m = rows // n
        return [slice(i * m, (i + 1) * m) for i in range(n)]

    def _replica_of(self, device: torch.device) -> int:
        for i, (dev, _) in enumerate(self.replicas):
            if dev == device:
                return i
        raise ValueError(f"no replica of the model on {device}")

    def _count_batch(self, replica: int) -> None:
        with self._pool_lock:  # the batcher's thread and the callers' decode at once
            self.replica_batches[replica] += 1

    def _on_replicas(self, fn, jobs):
        """``fn(replica, job)`` for each (replica, job), one host thread per
        replica with the replica's card as its current device (a new
        thread's is card 0); the results in order."""
        with self._pool_lock:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    len(self.replicas), thread_name_prefix="fwt-replica"
                )

        def run(replica, job):
            dev = self.replicas[replica][0]
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                return fn(replica, job)

        futures = [self._pool.submit(run, r, job) for r, job in jobs]
        return [f.result() for f in futures]

    @property
    def is_multilingual(self) -> bool:
        return self.config.is_multilingual and bool(self.language_tokens)

    @property
    def n_mels(self) -> int:
        return self.config.n_mels

    def encode(self, features):
        """(B, n_mels, 3000) or (n_mels, 3000) mel, numpy or tensor ->
        encoder states (B, 1500, d) on the engine's device, or on a mesh
        ``ShardedStates`` when the data size divides B."""
        feats = torch.as_tensor(features, dtype=torch.float32)
        if feats.dim() == 2:
            feats = feats[None]
        shards = self._shards(feats.shape[0])
        if shards is None:
            return self._encode_on(0, feats)
        return ShardedStates(
            self._on_replicas(self._encode_on, [(i, feats[sl]) for i, sl in enumerate(shards)]),
            range(len(shards)),
        )

    def _encode_on(self, replica: int, feats: torch.Tensor) -> torch.Tensor:
        """The encoder on replica ``replica``: the span ``fwt.encode``."""
        dev, params = self.replicas[replica]
        # A float32 encoder's convolutions read the process's TF32 flags,
        # which another thread's VAD or log-mel turns off for its block.
        f32 = M.lead(params)["encoder"]["conv1_w"].dtype == torch.float32
        with span("fwt.encode"), torch.no_grad(), steady_float32() if f32 else contextlib.nullcontext():
            return M.encode(params, self.config, feats.to(device=dev, dtype=torch.float32))

    def generate(self, encoder_output, prompts, **kwargs) -> List[WhisperGenerationResult]:
        return generate_collect(self.generate_dispatch(encoder_output, prompts, **kwargs))

    @staticmethod
    def generate_collect(pending) -> List[WhisperGenerationResult]:
        """Unpack a ``generate_dispatch`` result on the host (a sharded one
        shard by shard, in row order)."""
        if isinstance(pending, ShardedPending):
            return [r for part in pending.parts for r in generate_collect(part)]
        return generate_collect(pending)

    def generate_dispatch(
        self,
        encoder_output: torch.Tensor,
        prompts: Sequence[Sequence[int]],
        *,
        beam_size: int = 5,
        patience: float = 1.0,
        num_hypotheses: int = 1,
        length_penalty: float = 1.0,
        repetition_penalty: float = 1.0,
        no_repeat_ngram_size: int = 0,
        max_length: int = 448,
        suppress_blank: bool = True,
        suppress_tokens: Optional[Sequence[int]] = (),
        max_initial_timestamp_index: int = 50,
        sampling_temperature=1.0,  # float or per-row Sequence[float]
        sampling_topk: int = 1,
        rng_seed=None,
    ):
        """Run the decode; ``generate_collect`` unpacks the result.  As in
        CT2, the timestamp rules are active unless the prompt carries
        <|notimestamps|>.  On ``ShardedStates`` each shard decodes on its
        replica, with its rows' temperatures and seeds: a sampling row
        draws from the seed of its row in the whole batch."""
        prompts = [list(p) for p in prompts]
        if rng_seed is None:
            rng_seed = self.rng_seed
        kwargs = dict(
            sot_id=self.sot_id,
            beam_size=beam_size,
            patience=patience,
            length_penalty=length_penalty,
            repetition_penalty=repetition_penalty,
            no_repeat_ngram_size=no_repeat_ngram_size,
            max_length=max_length,
            suppress_blank=suppress_blank,
            suppress_tokens=suppress_tokens,
            max_initial_timestamp_index=max_initial_timestamp_index,
            sampling_topk=sampling_topk,
            num_hypotheses=num_hypotheses,
            with_timestamps=self.meta.no_timestamps not in prompts[0],
            kv_int8=self.kv_int8,
            int4=self.int4,
            graphs=self.step_graphs,
        )
        if not isinstance(encoder_output, ShardedStates):
            replica = self._replica_of(encoder_output.device)
            self._count_batch(replica)
            return generate_dispatch(
                self.replicas[replica][1], self.config, self.meta, encoder_output, prompts,
                sampling_temperature=sampling_temperature, rng_seed=rng_seed, **kwargs,
            )
        if len(prompts) != len(encoder_output):
            raise ValueError(f"{len(prompts)} prompts for {len(encoder_output)} encoder rows")
        seeds = _row_seeds(rng_seed, len(prompts))
        per_row = isinstance(sampling_temperature, (list, tuple, np.ndarray))

        def shard(replica, job):
            states, sl = job
            self._count_batch(replica)
            temps = list(sampling_temperature[sl]) if per_row else sampling_temperature
            return generate_dispatch(
                self.replicas[replica][1], self.config, self.meta, states, prompts[sl],
                sampling_temperature=temps, rng_seed=seeds[sl], **kwargs,
            )

        return ShardedPending(tuple(self._on_replicas(shard, encoder_output.jobs())))

    def memory_report(
        self,
        batch_size: int = 8,
        beam_size: int = 5,
        max_new_tokens: int = 128,
        prompt_len: int = 4,
        sampling_temperature: float = 0.0,
    ) -> dict:
        """Device memory of the engine's two big programs, the encode and
        the decode loop, at the given shapes, with the JAX package's keys:
        ``weights_bytes``, then ``encode`` and ``decode``, each None or a
        dict of ``argument_bytes``, ``output_bytes``, ``temp_bytes``,
        ``code_bytes`` and ``peak_bytes``.

        The JAX package reads XLA's static analysis of the compiled
        programs, and nothing runs.  PyTorch has no such analysis, so on
        the card this one runs them: an encode of zeros (batch_size,
        n_mels, 3000), and a decode (``generate_dispatch`` and
        ``generate_collect``) of ``batch_size`` prompts of ``prompt_len``
        start tokens over zero encoder states with this engine's
        ``kv_int8`` and ``int4``, each after ``torch.cuda.synchronize`` and
        ``reset_peak_memory_stats``.  ``argument_bytes`` is the weights and
        the inputs; ``temp_bytes`` the peak of allocated memory during the
        run minus what was allocated before it, which holds the outputs as
        well as every temporary (caches, beam state, activations);
        ``peak_bytes`` is ``argument_bytes + temp_bytes``; ``code_bytes``
        is the size of the loaded kernel libraries.  On the CPU both
        programs are None, as on a JAX backend without the analysis; the
        weights are counted on either.  On a mesh: the first replica's.
        Over a model-axis group ``weights_bytes`` is the group's, each
        program's numbers are the lead device's (its weights and peak), and
        ``group_peak_bytes`` adds every device of the group."""
        from faster_whisper_tpu_torch.ops import _build

        weights_bytes = sum(t.numel() * t.element_size() for t in _tensors(self.params))
        if self.device.type != "cuda":
            return {"weights_bytes": int(weights_bytes), "encode": None, "decode": None}

        dev = self.device
        cfg = self.config
        devices = list(dict.fromkeys(self.group_devices()))
        on_dev = {
            d: sum(t.numel() * t.element_size() for t in _tensors(self.params) if t.device == d)
            for d in devices
        }

        def measure(run, input_bytes):
            before = {}
            for d in devices:
                torch.cuda.synchronize(d)
                torch.cuda.reset_peak_memory_stats(d)
                before[d] = torch.cuda.memory_allocated(d)
            out = run()
            temp = {}
            for d in devices:
                torch.cuda.synchronize(d)
                temp[d] = torch.cuda.max_memory_allocated(d) - before[d]
            report = {
                "argument_bytes": int(on_dev[dev] + input_bytes),
                "output_bytes": int(sum(t.numel() * t.element_size() for t in _tensors(out))),
                "temp_bytes": int(temp[dev]),
                "code_bytes": 0,  # below, once the runs have loaded the kernels
                "peak_bytes": int(on_dev[dev] + input_bytes + temp[dev]),
            }
            if len(devices) > 1:
                report["group_peak_bytes"] = int(weights_bytes + input_bytes + sum(temp.values()))
            return out, report

        mel = torch.zeros((batch_size, cfg.n_mels, 3000), dtype=torch.float32, device=dev)
        xa, enc = measure(lambda: self._encode_on(0, mel), mel.numel() * mel.element_size())
        del mel
        xa = torch.zeros_like(xa)
        prompt = [self.sot_id] * prompt_len

        def decode():
            pending = self.generate_dispatch(
                xa, [prompt] * batch_size, beam_size=beam_size,
                max_length=prompt_len + max_new_tokens,
                sampling_temperature=sampling_temperature,
            )
            self.generate_collect(pending)
            return pending.arrays

        _, dec = measure(decode, xa.numel() * xa.element_size() + batch_size * prompt_len * 8)
        code_bytes = sum(
            _build.library_path(src).stat().st_size for src in list(_build._libs)
            if src.endswith(".cu")
        )
        enc["code_bytes"] = dec["code_bytes"] = int(code_bytes)
        return {"weights_bytes": int(weights_bytes), "encode": enc, "decode": dec}

    def detect_language(self, encoder_output):
        """Per-row [(language token, probability)], most probable first
        (``ShardedStates``: each shard on its replica)."""
        b = encoder_output.shape[0]
        if not self.language_tokens:
            return [[("<|en|>", 1.0)] for _ in range(b)]
        if isinstance(encoder_output, ShardedStates):
            parts = self._on_replicas(lambda r, job: self._detect_on(r, job[0]), encoder_output.jobs())
            return [row for part in parts for row in part]
        return self._detect_on(self._replica_of(encoder_output.device), encoder_output)

    def _detect_on(self, replica: int, encoder_output: torch.Tensor):
        b = encoder_output.shape[0]
        dev = encoder_output.device
        with torch.no_grad():
            logits, _ = M.decoder_prefill(
                self.replicas[replica][1],
                self.config,
                torch.full((b, 1), self.sot_id, dtype=torch.long, device=dev),
                torch.ones((b,), dtype=torch.long, device=dev),
                encoder_output,
                torch.zeros((b, 1), dtype=torch.long, device=dev),
                ctx=1,
            )
        lang_ids = np.array([tid for _, tid in self.language_tokens])
        lang_logits = logits[:, 0].cpu().numpy()[:, lang_ids]
        lang_logits = lang_logits - lang_logits.max(axis=-1, keepdims=True)
        probs = np.exp(lang_logits)
        probs /= probs.sum(axis=-1, keepdims=True)

        results = []
        for row in probs:
            order = np.argsort(-row)
            results.append(
                [("<|%s|>" % self.language_tokens[i][0], float(row[i])) for i in order]
            )
        return results

    # -- alignment (word timestamps) -------------------------------------

    def _alignment_heads(self) -> Tuple[Tuple[int, int], ...]:
        if self.config.alignment_heads:
            return tuple(tuple(h) for h in self.config.alignment_heads)
        # openai's fallback: every head of the upper half of the decoder layers
        L, H = self.config.n_text_layer, self.config.n_text_head
        return tuple((layer, head) for layer in range(L // 2, L) for head in range(H))

    def align(
        self,
        encoder_output: torch.Tensor,
        start_sequence: Sequence[int],
        text_tokens: List[List[int]],
        num_frames,
        median_filter_width: int = 7,
    ) -> List[AlignmentResult]:
        """Teacher-forced pass and cross-attention DTW word alignment.
        ``num_frames`` is an int or a per-item list of content mel frames
        (the encoder states cover num_frames // 2)."""
        return self.align_collect(
            self.align_dispatch(
                encoder_output, start_sequence, text_tokens, num_frames,
                median_filter_width=median_filter_width,
            )
        )

    def align_dispatch(
        self,
        encoder_output: torch.Tensor,
        start_sequence: Sequence[int],
        text_tokens: List[List[int]],
        num_frames,
        median_filter_width: int = 7,
    ):
        """Queue the alignment pass on the current stream and start
        non-blocking copies of the probabilities and of the matrix's text
        rows into pinned host memory; ``align_collect`` waits for them.
        The caller can queue more device work in between.  On
        ``ShardedStates`` each shard's rows align on its replica."""
        b_real = len(text_tokens)
        if isinstance(num_frames, int):
            num_frames = [num_frames] * b_real
        if isinstance(encoder_output, ShardedStates):
            if len(encoder_output) != b_real:
                raise ValueError(f"align: {len(encoder_output)} encoder rows for {b_real} token lists")
            return ShardedPending(tuple(self._on_replicas(
                lambda r, job: self._align_dispatch_on(r, job[0], start_sequence, text_tokens[job[1]],
                                                       num_frames[job[1]], median_filter_width),
                encoder_output.jobs(),
            )))
        return self._align_dispatch_on(
            self._replica_of(encoder_output.device), encoder_output, start_sequence, text_tokens,
            num_frames, median_filter_width,
        )

    def _align_dispatch_on(self, replica, encoder_output, start_sequence, text_tokens, num_frames,
                           median_filter_width):
        b_real = len(text_tokens)
        if encoder_output.shape[0] != b_real:
            raise ValueError(
                f"align: {encoder_output.shape[0]} encoder rows for {b_real} token lists"
            )
        if b_real == 0:
            return (None, None, None, 0, [], [])

        # The batch axis is bucketed to the next power of two, as the
        # decode's is; the dummy rows repeat the last encoder row and have
        # no text.
        b = 1
        while b < b_real:
            b *= 2
        if b != b_real:
            pad = b - b_real
            encoder_output = torch.cat(
                [encoder_output, encoder_output[-1:].expand((pad,) + tuple(encoder_output.shape[1:]))]
            )
            text_tokens = list(text_tokens) + [[]] * pad
            num_frames = list(num_frames) + [num_frames[-1]] * pad

        prefix = list(start_sequence) + [self.meta.no_timestamps]
        seqs = [prefix + list(t) + [self.meta.eot] for t in text_tokens]
        max_len = max(len(s) for s in seqs)
        pad_to = min(self.config.n_text_ctx, -(-max_len // 64) * 64)
        tokens = np.zeros((b, pad_to), dtype=np.int64)
        for i, s in enumerate(seqs):
            s = s[:pad_to]
            tokens[i, : len(s)] = s

        start = len(prefix) - 1
        n_rows = [min(len(t) + 1, pad_to - start) for t in text_tokens]
        tfr = [max(1, int(nf) // 2) for nf in num_frames]
        dev = encoder_output.device
        with torch.no_grad():
            probs, matrix = _align_forward_post(
                self.replicas[replica][1],
                self.config,
                self._alignment_heads(),
                torch.as_tensor(tokens, device=dev),
                encoder_output,
                torch.full((b,), start, dtype=torch.long, device=dev),
                torch.as_tensor(n_rows, dtype=torch.long, device=dev),
                torch.as_tensor(tfr, dtype=torch.long, device=dev),
                eot=int(self.meta.eot),
                median_width=int(median_filter_width),
            )
        # Only rows [start, start + max(n_rows)) feed the DTW; the slice
        # is bucketed to 64 rows, clamped to the token buffer.
        max_rows = min(-(-max(max(n_rows), 1) // 64) * 64, pad_to - start)
        matrix = matrix[:, start : start + max_rows]
        event = None
        if dev.type == "cuda":
            host = []
            for t in (probs, matrix):
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            probs, matrix = host
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        return (probs, matrix, event, start, text_tokens[:b_real], tfr)

    def align_collect(self, pending) -> List[AlignmentResult]:
        """Wait for ``align_dispatch``'s copies, then run the DTW of each
        real row (the pow2 dummy rows are never iterated)."""
        if isinstance(pending, ShardedPending):
            return [r for part in pending.parts for r in self.align_collect(part)]
        probs, matrix, event, start, text_tokens, tfr = pending
        if not text_tokens:
            return []
        if event is not None:
            event.synchronize()
        probs = probs.numpy()
        matrix = matrix.numpy()

        results = []
        for i, text in enumerate(text_tokens):
            n_text = len(text)
            if n_text == 0:
                results.append(AlignmentResult([], []))
                continue
            text_token_probs = probs[i, start : start + n_text].tolist()
            m = matrix[i, : n_text + 1, : tfr[i]]
            text_idx, time_idx = dtw_path(-m.astype(np.float64))
            results.append(AlignmentResult(text_token_probs, list(zip(text_idx.tolist(), time_idx.tolist()))))
        return results
