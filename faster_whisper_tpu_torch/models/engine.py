"""WhisperEngine: the device-side inference surface.

Counterpart of ``faster_whisper_tpu/models/engine.py``: the
``ctranslate2.models.Whisper`` surface that the policy layer
(``transcribe.py``) drives -- ``encode``, ``generate``, ``align`` and
``detect_language`` plus ``is_multilingual``/``n_mels``.

``align`` (word timestamps) is a teacher-forced decoder pass in plain
PyTorch, as the JAX package computes it outside any Pallas kernel: it
reduces the alignment heads' cross-attention to the DTW's input matrix on
the device, and the DTW (``dtw.py``, native) runs on the host.
"""

import contextlib

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from faster_whisper_tpu_torch.generation.generate import (
    WhisperGenerationResult,
    generate_collect,
    generate_dispatch,
)
from faster_whisper_tpu_torch.dtw import dtw_path
from faster_whisper_tpu_torch.generation.processors import TokenMeta
from faster_whisper_tpu_torch.models import model as M
from faster_whisper_tpu_torch.models.config import WhisperConfig
from faster_whisper_tpu_torch.ops.attention import mha
from faster_whisper_tpu_torch.ops.quant import QuantizedLinear
from faster_whisper_tpu_torch.tokenizer import _LANGUAGE_CODES
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
    loop).  Calls ``on_scores(layer, scores)`` with each layer's scaled
    cross-attention scores (B, H, S, T) in f32, and returns the final
    layer-normed states (B, S, d).  Cross K/V are computed from ``xa`` in
    the activation dtype (int8 trees through ``int8_dense``)."""
    dec = params["decoder"]
    b, s = tokens.shape
    dtype = dec["token_embed"].dtype
    n_head = config.n_text_head
    scale = (config.n_text_state // n_head) ** -0.5

    x = (dec["token_embed"][tokens] + dec["pos_embed"][:s][None]).to(dtype)
    xa = xa.to(dtype)
    i = torch.arange(s, device=x.device)
    causal = (i[None, :] <= i[:, None])[None, None]  # (1, 1, S, S)

    for li in range(config.n_text_layer):
        p = M._layer(dec["layers"], li)
        h = M.layer_norm(x, p["ln1_g"], p["ln1_b"])
        q, k, v = M._attn_qkv(p["self_attn"], h, n_head)
        attn = mha(q, k, v, mask=causal)
        x = x + M._dense(M._merge_heads(attn), p["self_attn"]["wo"], p["self_attn"]["bo"])

        h = M.layer_norm(x, p["ln2_g"], p["ln2_b"])
        cp = p["cross_attn"]
        qx = M._split_heads(M._dense(h, cp["wq"], cp["bq"]), n_head)
        kx = M._split_heads(M._dense(xa, cp["wk"]), n_head)
        vx = M._split_heads(M._dense(xa, cp["wv"], cp["bv"]), n_head)
        scores = torch.einsum("bshd,bthd->bhst", qx.float(), kx.float()) * scale
        w = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bhst,bthd->bshd", w.to(vx.dtype).float(), vx.float()).to(vx.dtype)
        del w
        x = x + M._dense(M._merge_heads(attn), cp["wo"], cp["bo"])
        on_scores(li, scores)
        del scores

        h = M.layer_norm(x, p["ln3_g"], p["ln3_b"])
        x = x + M._mlp(p["mlp"], h)

    return M.layer_norm(x, dec["ln_g"], dec["ln_b"])


def _forward_with_alignment(params, config: WhisperConfig, head_select, tokens, xa):
    """(logits (B, S, V) f32, qk (B, K, S, T) f32): the logits over the
    whole vocabulary and the raw scaled cross-attention scores of the K
    (layer, head) pairs of ``head_select``.  The tests' view of the pass;
    ``_align_forward_post`` reduces each head as its layer runs instead of
    holding all K."""
    b, s = tokens.shape
    qk = torch.zeros((b, len(head_select), s, xa.shape[1]), dtype=torch.float32, device=xa.device)

    def keep(layer, scores):
        for k, (sel_layer, head) in enumerate(head_select):
            if sel_layer == layer:
                qk[:, k] += scores[:, head]

    x = _teacher_forced(params, config, tokens, xa, keep)
    embed = params["decoder"]["token_embed"]
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

    def reduce(layer, scores):
        for sel_layer, head in head_select:
            if sel_layer == layer:
                matrix.add_(_align_head_chain(scores[:, head], row_start, n_rows, t_frames, median_width))

    x = _teacher_forced(params, config, tokens, xa, reduce)

    # Probabilities over the text vocabulary [0, eot).  The prompt rows and
    # the eot row predict specials, which are clamped into range; their
    # values are never read.
    embed = params["decoder"]["token_embed"][:eot]
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


class WhisperEngine:
    """Device-side Whisper inference engine on the parameters' device."""

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

    @property
    def is_multilingual(self) -> bool:
        return self.config.is_multilingual and bool(self.language_tokens)

    @property
    def n_mels(self) -> int:
        return self.config.n_mels

    def encode(self, features) -> torch.Tensor:
        """(B, n_mels, 3000) or (n_mels, 3000) mel, numpy or tensor ->
        encoder states (B, 1500, d) on the engine's device."""
        feats = torch.as_tensor(features, dtype=torch.float32, device=self.device)
        if feats.dim() == 2:
            feats = feats[None]
        # A float32 encoder's convolutions read the process's TF32 flags,
        # which another thread's VAD or log-mel turns off for its block.
        f32 = self.params["encoder"]["conv1_w"].dtype == torch.float32
        with torch.no_grad(), steady_float32() if f32 else contextlib.nullcontext():
            return M.encode(self.params, self.config, feats)

    def generate(self, encoder_output, prompts, **kwargs) -> List[WhisperGenerationResult]:
        return generate_collect(self.generate_dispatch(encoder_output, prompts, **kwargs))

    @staticmethod
    def generate_collect(pending) -> List[WhisperGenerationResult]:
        """Unpack a ``generate_dispatch`` result on the host."""
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
        <|notimestamps|>."""
        prompts = [list(p) for p in prompts]
        return generate_dispatch(
            self.params,
            self.config,
            self.meta,
            encoder_output,
            prompts,
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
            sampling_temperature=sampling_temperature,
            sampling_topk=sampling_topk,
            num_hypotheses=num_hypotheses,
            with_timestamps=self.meta.no_timestamps not in prompts[0],
            rng_seed=rng_seed,
            kv_int8=self.kv_int8,
            int4=self.int4,
        )

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
        weights are counted on either."""
        from faster_whisper_tpu_torch.ops import _build

        weights_bytes = sum(t.numel() * t.element_size() for t in _tensors(self.params))
        if self.device.type != "cuda":
            return {"weights_bytes": int(weights_bytes), "encode": None, "decode": None}

        dev = self.device
        cfg = self.config

        def measure(run, input_bytes):
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            out = run()
            torch.cuda.synchronize(dev)
            temp = torch.cuda.max_memory_allocated(dev) - before
            return out, {
                "argument_bytes": int(weights_bytes + input_bytes),
                "output_bytes": int(sum(t.numel() * t.element_size() for t in _tensors(out))),
                "temp_bytes": int(temp),
                "code_bytes": 0,  # below, once the runs have loaded the kernels
                "peak_bytes": int(weights_bytes + input_bytes + temp),
            }

        mel = torch.zeros((batch_size, cfg.n_mels, 3000), dtype=torch.float32, device=dev)
        xa, enc = measure(lambda: self.encode(mel), mel.numel() * mel.element_size())
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

    def detect_language(self, encoder_output: torch.Tensor):
        """Per-row [(language token, probability)], most probable first."""
        b = encoder_output.shape[0]
        if not self.language_tokens:
            return [[("<|en|>", 1.0)] for _ in range(b)]
        dev = encoder_output.device
        with torch.no_grad():
            logits, _ = M.decoder_prefill(
                self.params,
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
        The caller can queue more device work in between."""
        b_real = len(text_tokens)
        if isinstance(num_frames, int):
            num_frames = [num_frames] * b_real
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
                self.params,
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
