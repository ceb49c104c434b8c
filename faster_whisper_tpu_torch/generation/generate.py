"""Whisper generation: beam search and temperature sampling.

Counterpart of ``faster_whisper_tpu/generation/generate.py``, with the same
decode policy and outputs.  Where the JAX package runs the whole loop in one
``lax.while_loop`` on the device, this loop is driven from the host: one
decoder step and one selection per iteration, on device tensors, with a
single device-to-host read per iteration (the stop test).  It is
single-phase: the JAX package's multi-phase ctx ladder is output-identical
and is not ported.

Score semantics: ``score = cum_logprob / (gen_len ** length_penalty)``,
where ``cum_logprob`` sums the T=1 log-probabilities of the chosen tokens
including the closing <|endoftext|> and ``gen_len`` excludes it.

Layout:
  * Beams live on a (B, K) grid.  The cross-attention K/V over the encoder
    states is computed once per window and shared across beams; each
    layer's cross-attention is kernel K4 on the card
    (``ops/cross_attention.py``).
  * The per-beam self-attention cache is head-major (L, B, H, K, ctx, D)
    and append-only per slot: beam re-parenting permutes a (B, K, ctx)
    ancestry table, never the cache.  Each layer's append+attend is kernel
    K1 on the card (``ops/beam_attention.py``), K2 on the int8 cache.
  * ``kv_int8`` (the int8 compute types) stores both caches as int8 codes
    with bf16 scales (``ops/quant.py::QuantKV``); ``int4`` quantizes the
    cross cache to 4-bit range (codes in [-7, 7], int8 storage), which K4's
    int8 form reads as it reads int8 codes.
  * Tokens are recorded per step in position-history tables and the
    hypotheses rebuilt on the host by walking back-pointers.

Since the loop runs inside the call, the JAX package's "right after the
decode is dispatched" is a point in it: ``after_first_launch`` runs a
callback once, after the prefill (and, in beam search, the first step) is
launched and before the host first waits for the device.  The sequential
path queues its speculative next-window encode there.
"""

import contextlib
import threading

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from faster_whisper_tpu_torch.generation.processors import (
    NEG_INF,
    ProcessorOptions,
    TokenMeta,
    apply_logits_rules_logprobs,
    apply_logits_rules_logprobs_carried,
)
from faster_whisper_tpu_torch.models.config import WhisperConfig
from faster_whisper_tpu_torch.models.model import (
    _dense,
    _layer,
    _logits,
    _mlp,
    decoder_prefill,
    layer_norm,
)
from faster_whisper_tpu_torch.ops.beam_attention import beam_attend_append
from faster_whisper_tpu_torch.ops.cross_attention import cross_attend
from faster_whisper_tpu_torch.ops.quant import QuantKV, quantize_kv


@dataclass(frozen=True)
class GenOptions:
    beam_size: int = 5  # active beams (or parallel samples when sampling)
    num_finished: int = 5  # finished-pool slots: round(beam_size * patience)
    length_penalty: float = 1.0
    sampling_topk: int = 0  # 0 = unrestricted
    # Cache and buffer length: a bucketed bound on max_length (<= 448).
    ctx_cap: int = 448
    kv_int8: bool = False  # int8 self and cross caches (QuantKV)
    # compute_type="int4": the cross cache at 4-bit range (cross qmax 7);
    # the weights arrive 4-bit from ops/quant.py::quantize_params_int4
    int4: bool = False

    def __post_init__(self):
        if self.int4 and not self.kv_int8:
            raise ValueError(_INT4_WITHOUT_KV_INT8)


_INT4_WITHOUT_KV_INT8 = (
    "int4=True requires kv_int8=True: the packed-int4 cross cache "
    "rides the QuantKV scale path (_expand_caches), so without "
    "kv_int8 the cross-KV half of int4 would silently not apply"
)


class WhisperGenerationResult:
    """Mirror of ctranslate2's WhisperGenerationResult surface."""

    __slots__ = ("sequences_ids", "scores", "no_speech_prob")

    def __init__(self, sequences_ids, scores, no_speech_prob):
        self.sequences_ids = sequences_ids
        self.scores = scores
        self.no_speech_prob = no_speech_prob

    def __repr__(self):
        return (
            f"WhisperGenerationResult(sequences={len(self.sequences_ids)}, "
            f"scores={self.scores}, no_speech_prob={self.no_speech_prob})"
        )


# ---------------------------------------------------------------------------
# Beam-grid decoder step (queries on a (B, K) grid, shared cross K/V)
# ---------------------------------------------------------------------------


def _gen_decoder_step(
    params,
    config: WhisperConfig,
    token: torch.Tensor,  # (B, K) token ids
    pos: torch.Tensor,  # (B, K) absolute positions
    pos_row: torch.Tensor,  # (B,) int32 per-row write position
    self_k,  # (L, B, H, K, ctx, D) or QuantKV, updated in place
    self_v,
    cross_k,  # (L, B, H, T, D) or QuantKV, shared across beams
    cross_v,
    anc: torch.Tensor,  # (B, K, ctx) int32 ancestry slot map
):
    """One decode step over the beam grid; returns (logits (B, K, V) f32,
    self_k, self_v).  Per layer, self-attention is one
    ``beam_attend_append`` (K1, or K2 on the int8 cache, on the card) and
    cross-attention one ``cross_attend`` (K4).  Counts its calls in
    ``_gen_decoder_step.calls``."""
    _gen_decoder_step.calls += 1
    dec = params["decoder"]
    b, k = token.shape
    n_head = config.n_text_head
    dh = config.n_text_state // n_head
    dtype = dec["token_embed"].dtype

    x = (dec["token_embed"][token] + dec["pos_embed"][pos]).to(dtype)  # (B, K, d)
    for i in range(config.n_text_layer):
        p = _layer(dec["layers"], i)

        h = layer_norm(x, p["ln1_g"], p["ln1_b"])
        sa = p["self_attn"]

        def heads(y):  # (B, K, d) -> (B, H, K, D)
            return y.reshape(b, k, n_head, dh).transpose(1, 2).contiguous()

        attn_h, self_k, self_v = beam_attend_append(
            i,
            pos_row,
            heads(_dense(h, sa["wq"], sa["bq"])),
            heads(_dense(h, sa["wk"])),
            heads(_dense(h, sa["wv"], sa["bv"])),
            self_k,
            self_v,
            anc,
            pos_bk=pos,
        )
        attn = attn_h.transpose(1, 2).reshape(b, k, -1)
        x = x + _dense(attn, sa["wo"], sa["bo"])

        h = layer_norm(x, p["ln2_g"], p["ln2_b"])
        cp = p["cross_attn"]
        attn_h = cross_attend(i, heads(_dense(h, cp["wq"], cp["bq"])), cross_k, cross_v)
        attn = attn_h.transpose(1, 2).reshape(b, k, -1)
        x = x + _dense(attn, cp["wo"], cp["bo"])

        h = layer_norm(x, p["ln3_g"], p["ln3_b"])
        x = x + _mlp(p["mlp"], h)

    x = layer_norm(x, dec["ln_g"], dec["ln_b"])
    return _logits(params, x), self_k, self_v


_gen_decoder_step.calls = 0


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx, axis=1)``: x (B, J, ...), idx (B, K)."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        idx.shape + x.shape[2:]
    )
    return torch.gather(x, 1, idx)


def _scatter_slots(cand: torch.Tensor, slot: torch.Tensor, k_out: int, fill):
    """out[b, s] = cand[b, j] where slot[b, j] == s for s < k_out; slots
    never hit keep ``fill``; slot value k_out is dropped (each slot below
    k_out is hit at most once)."""
    out = torch.full((cand.shape[0], k_out + 1), fill, dtype=cand.dtype, device=cand.device)
    return out.scatter_(1, slot, cand)[:, :k_out]


def _needs_history(opts: ProcessorOptions) -> bool:
    """Do the logits rules need the full sampled-token buffer?"""
    return opts.repetition_penalty != 1.0 or opts.no_repeat_ngram_size > 0


def _tokens_view(hist_tok: torch.Tensor, anc: torch.Tensor) -> torch.Tensor:
    """The (B, K, ctx) per-beam token view: the chain owned by beam k has
    at position c the token that slot ``anc[b, k, c]`` appended there."""
    return torch.gather(hist_tok.transpose(1, 2), 1, anc.long())


def _expand_caches(cache0, K: int, kv_int8: bool, cross_qmax: int = 127):
    """The prefill cache on the (B, K) beam grid: self K/V (L, B, H, ctx,
    D) -> (L, B, H, K, ctx, D), contiguous for K1/K2; the shared cross K/V
    (L, B, H, T, D) stay in the model dtype.

    With ``kv_int8`` both are quantized per (position, head) row over D:
    the self caches become QuantKV with scales (L, B, H, K, ctx), the cross
    caches QuantKV with scales (L, B, H, 1, T), their codes within
    ``cross_qmax`` (7 for int4).  The scales are stored in bf16, in
    float32 runs too, as the JAX package stores them."""

    def bcast(a):  # (L, B, H, ...) -> (L, B, H, K, ...)
        return a[:, :, :, None].expand(a.shape[:3] + (K,) + a.shape[3:]).contiguous()

    if not kv_int8:
        return (
            bcast(cache0.self_k), bcast(cache0.self_v), cache0.cross_k, cache0.cross_v,
        )
    sdt = torch.bfloat16
    skq, svq = quantize_kv(cache0.self_k), quantize_kv(cache0.self_v)
    ckq = quantize_kv(cache0.cross_k, qmax=cross_qmax)
    cvq = quantize_kv(cache0.cross_v, qmax=cross_qmax)
    return (
        QuantKV(bcast(skq.q), bcast(skq.s.to(sdt))),
        QuantKV(bcast(svq.q), bcast(svq.s.to(sdt))),
        QuantKV(ckq.q, ckq.s.to(sdt)[:, :, :, None].contiguous()),
        QuantKV(cvq.q, cvq.s.to(sdt)[:, :, :, None].contiguous()),
    )


# The callback of ``after_first_launch``, per thread: a serving process
# decodes on several threads.
_hook = threading.local()


@contextlib.contextmanager
def after_first_launch(fn):
    """Run ``fn`` once in the next decode loop that this thread runs inside
    the block, after its prefill (and, in beam search, its first step) is
    launched and before the host first reads a result back; at the end of
    the block if no loop got there.  Not at all if the block raises."""
    _hook.fn = fn
    try:
        yield
    except BaseException:
        _hook.fn = None
        raise
    _fire_after_first_launch()


def _fire_after_first_launch():
    fn = getattr(_hook, "fn", None)
    if fn is not None:
        _hook.fn = None
        fn()


def _prefill(params, config, meta, xa, prompt, prompt_len, sot_pos, ctx):
    gather_pos = torch.stack([prompt_len - 1, sot_pos], dim=1)
    first_logits, cache0 = decoder_prefill(
        params, config, prompt, prompt_len, xa, gather_pos, ctx=ctx
    )
    no_speech_prob = torch.softmax(first_logits[:, 1], dim=-1)[:, meta.no_speech]
    return first_logits[:, 0], cache0, no_speech_prob


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------


def beam_search(
    params,
    config: WhisperConfig,
    gen_opts: GenOptions,
    proc_opts: ProcessorOptions,
    meta: TokenMeta,
    xa: torch.Tensor,  # (B, T, d) encoder states
    prompt: torch.Tensor,  # (B, P) right-padded prompt
    prompt_len: torch.Tensor,  # (B,)
    sot_pos: torch.Tensor,  # (B,) index of <|startoftranscript|> in the prompt
    max_length: int,  # total length cap (prompt + generated)
):
    """Back-pointer beam search.  Each step records the token appended by
    each slot and the slot its prefix lived in (``hist_tok``/``hist_par``,
    (B, ctx, K)); end-of-text candidates go into step-indexed buffers and
    the finished pool is one top-F over them after the loop.  All beams of
    a row advance together, so lengths are one (B,) ``cur_len``.

    Returns (hist_tok, hist_par, fin_slot (B,F), fin_lens (B,F),
    fin_scores (B,F), cur_len (B,), active_score (B,), no_speech_prob (B,),
    prompt_len (B,))."""
    K = gen_opts.beam_size
    F = gen_opts.num_finished
    lp_pow = gen_opts.length_penalty
    b = prompt.shape[0]
    dev = xa.device
    ctx = min(gen_opts.ctx_cap, config.n_text_ctx)
    cap = min(max_length, ctx)
    V = meta.vocab_size
    needs_history = _needs_history(proc_opts)

    first_logits, cache0, no_speech_prob = _prefill(
        params, config, meta, xa, prompt, prompt_len, sot_pos, ctx
    )
    self_k, self_v, cross_k, cross_v = _expand_caches(
        cache0, K, gen_opts.kv_int8, cross_qmax=7 if gen_opts.int4 else 127
    )

    k_arange = torch.arange(K, device=dev)
    ctx_ids = torch.arange(ctx, device=dev)
    cur_len = prompt_len.clone()  # (B,) shared by all beams of a row
    sum_lp = torch.where(k_arange == 0, 0.0, NEG_INF)[None, :].expand(b, K).float()
    # anc[b, k, c]: the slot holding the K/V written at position c for the
    # chain now owned by beam k.
    anc = k_arange.int()[None, :, None].expand(b, K, ctx).contiguous()
    cur_logits = first_logits[:, None, :].expand(b, K, V)
    hist_tok = torch.zeros((b, ctx, K), dtype=torch.long, device=dev)
    hist_par = torch.zeros_like(hist_tok)
    last_tok = torch.zeros((b, K), dtype=torch.long, device=dev)
    penult_tok = torch.zeros_like(last_tok)
    ts_max = torch.full((b, K), -1, dtype=torch.long, device=dev)
    eot_buf_score = torch.full((b, ctx, 2 * K), NEG_INF, device=dev)
    eot_buf_slot = torch.zeros((b, ctx, 2 * K), dtype=torch.long, device=dev)
    len_buf = torch.zeros((b, ctx), dtype=torch.long, device=dev)
    nfin = torch.zeros((b,), dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)

    step_i = 0
    while True:
        live = ~done
        n_sampled = cur_len - prompt_len  # (B,)
        if needs_history:
            view = _tokens_view(hist_tok, anc)
            logprobs = apply_logits_rules_logprobs(
                cur_logits.reshape(b * K, V),
                view.reshape(b * K, ctx),
                cur_len[:, None].expand(b, K).reshape(-1),
                prompt_len[:, None].expand(b, K).reshape(-1),
                meta,
                proc_opts,
            ).reshape(b, K, V)
        else:
            logprobs = apply_logits_rules_logprobs_carried(
                cur_logits.reshape(b * K, V),
                n_sampled[:, None].expand(b, K).reshape(-1),
                last_tok.reshape(-1),
                penult_tok.reshape(-1),
                ts_max.reshape(-1),
                meta,
                proc_opts,
            ).reshape(b, K, V)

        total = sum_lp[:, :, None] + logprobs  # (B, K, V)
        cand_val, cand_idx = torch.topk(total.reshape(b, K * V), 2 * K)
        cand_beam = cand_idx // V  # (B, 2K)
        cand_tok = cand_idx % V
        is_eot = cand_tok == meta.eot

        # Record this step's end-of-text candidates; the pool is merged once
        # after the loop.  Until the pool holds F entries every valid
        # candidate takes a free place, so min(F, nfin + #valid) is its size.
        safe_len = n_sampled.clamp(min=1).float()[:, None]
        norm_score = cand_val / safe_len ** lp_pow
        eot_valid = is_eot & live[:, None]
        eot_scores = torch.where(eot_valid, norm_score, NEG_INF)
        eot_buf_score[:, step_i] = torch.where(live[:, None], eot_scores, eot_buf_score[:, step_i])
        eot_buf_slot[:, step_i] = torch.where(live[:, None], cand_beam, eot_buf_slot[:, step_i])
        len_buf[:, step_i] = torch.where(live, cur_len, len_buf[:, step_i])
        nfin = torch.clamp(nfin + eot_valid.sum(dim=1), max=F)

        # Refill the active beams with the best K non-eot candidates, in
        # score order.
        keep = ~is_eot
        rank = torch.cumsum(keep.long(), dim=1)  # 1-based among kept
        slot = torch.where(keep & (rank <= K), rank - 1, K)  # K = drop
        parent = _scatter_slots(cand_beam, slot, K, 0)
        new_tok = _scatter_slots(cand_tok, slot, K, 0)
        new_cum = _scatter_slots(cand_val, slot, K, NEG_INF)

        # History tables; finished rows must not overwrite theirs.
        write_pos = cur_len.clamp(0, ctx - 1)  # (B,)
        hit = (ctx_ids[None, :, None] == write_pos[:, None, None]) & live[:, None, None]
        hist_tok = torch.where(hit, new_tok[:, None, :], hist_tok)
        hist_par = torch.where(hit, parent[:, None, :], hist_par)

        # Carried rule scalars follow the re-parenting.
        penult_new = _gather_rows(last_tok, parent)
        ts_prev = _gather_rows(ts_max, parent)
        ts_new = torch.where(
            new_tok >= meta.timestamp_begin, torch.maximum(ts_prev, new_tok), ts_prev
        )

        # Virtual re-parenting: permute the ancestry table; the new token's
        # K/V go to each beam's own slot in the decoder step below.
        write_pos_bk = write_pos[:, None].expand(b, K)
        anc = _gather_rows(anc, parent)
        anc = torch.where(
            ctx_ids[None, None, :] == write_pos_bk[:, :, None],
            k_arange.int()[None, :, None],
            anc,
        ).contiguous()

        # Finished rows decode garbage at a frozen position: their slots
        # and logits are never read again.
        cur_logits, self_k, self_v = _gen_decoder_step(
            params, config, new_tok, write_pos_bk, write_pos.int(),
            self_k, self_v, cross_k, cross_v, anc,
        )

        cur_len_new = torch.clamp(cur_len + 1, max=ctx)
        done_new = done | (nfin >= F) | (cur_len_new >= cap)
        cur_len = torch.where(done, cur_len, cur_len_new)
        sum_lp = torch.where(done[:, None], sum_lp, new_cum)
        last_tok, penult_tok, ts_max = new_tok, penult_new, ts_new
        done = done_new
        step_i += 1
        _fire_after_first_launch()
        if bool(done.all()):
            break

    flat_scores = eot_buf_score.reshape(b, ctx * 2 * K)
    fin_scores, top_idx = torch.topk(flat_scores, F)
    fin_slot = torch.gather(eot_buf_slot.reshape(b, ctx * 2 * K), 1, top_idx)
    fin_lens = torch.gather(len_buf, 1, top_idx // (2 * K))

    # The best active beam is the fallback of rows whose pool stayed empty.
    gen_len = (cur_len - prompt_len).clamp(min=1).float()
    active_score = sum_lp[:, 0] / gen_len ** lp_pow

    return (
        hist_tok, hist_par, fin_slot, fin_lens, fin_scores, cur_len,
        active_score, no_speech_prob, prompt_len,
    )


# ---------------------------------------------------------------------------
# Temperature sampling (beam_size=1, num_hypotheses parallel samples)
# ---------------------------------------------------------------------------


def sample(
    params,
    config: WhisperConfig,
    gen_opts: GenOptions,
    proc_opts: ProcessorOptions,
    meta: TokenMeta,
    xa: torch.Tensor,
    prompt: torch.Tensor,
    prompt_len: torch.Tensor,
    sot_pos: torch.Tensor,
    max_length: int,
    temperature: torch.Tensor,  # (B,) per-row sampling temperature
    generators: Sequence[torch.Generator],  # one per row, on xa's device
):
    """K independent temperature samples per batch row.  Row i draws only
    from ``generators[i]`` at ``temperature[i]``, so a batched fallback
    ladder (rows = rungs) draws what each rung would draw alone.

    Returns (tokens (B,K,ctx), lens (B,K), cum_logprob (B,K),
    finished (B,K), no_speech_prob (B,))."""
    K = gen_opts.beam_size
    b, p = prompt.shape
    dev = xa.device
    ctx = min(gen_opts.ctx_cap, config.n_text_ctx)
    cap = min(max_length, ctx)
    V = meta.vocab_size
    needs_history = _needs_history(proc_opts)

    first_logits, cache0, no_speech_prob = _prefill(
        params, config, meta, xa, prompt, prompt_len, sot_pos, ctx
    )
    self_k, self_v, cross_k, cross_v = _expand_caches(
        cache0, K, gen_opts.kv_int8, cross_qmax=7 if gen_opts.int4 else 127
    )

    ctx_ids = torch.arange(ctx, device=dev)
    tokens = torch.zeros((b, K, ctx), dtype=torch.long, device=dev)
    tokens[:, :, :p] = prompt[:, None, :]
    lens = prompt_len[:, None].expand(b, K).clone()
    sum_lp = torch.zeros((b, K), device=dev)
    finished = torch.zeros((b, K), dtype=torch.bool, device=dev)
    last_tok = torch.zeros((b, K), dtype=torch.long, device=dev)
    penult_tok = torch.zeros_like(last_tok)
    ts_max = torch.full((b, K), -1, dtype=torch.long, device=dev)
    cur_logits = first_logits[:, None, :].expand(b, K, V)
    # Identity ancestry: each sample attends only its own cache slot.
    anc_id = torch.arange(K, dtype=torch.int32, device=dev)[None, :, None].expand(b, K, ctx).contiguous()

    while True:
        active = ~finished & (lens < cap)
        _fire_after_first_launch()
        if not bool(active.any()):
            break
        if needs_history:
            logprobs = apply_logits_rules_logprobs(
                cur_logits.reshape(b * K, V),
                tokens.reshape(b * K, ctx),
                lens.reshape(-1),
                prompt_len[:, None].expand(b, K).reshape(-1),
                meta,
                proc_opts,
            ).reshape(b, K, V)
        else:
            logprobs = apply_logits_rules_logprobs_carried(
                cur_logits.reshape(b * K, V),
                (lens - prompt_len[:, None]).reshape(-1),
                last_tok.reshape(-1),
                penult_tok.reshape(-1),
                ts_max.reshape(-1),
                meta,
                proc_opts,
            ).reshape(b, K, V)

        # Scores use the T=1 distribution; softmax(logprobs / T) equals
        # softmax(masked_logits / T), the log-normalizer being a shift.
        sample_logits = logprobs / temperature[:, None, None]
        if gen_opts.sampling_topk > 0:
            kth = torch.topk(sample_logits, gen_opts.sampling_topk).values[..., -1:]
            sample_logits = torch.where(sample_logits < kth, NEG_INF, sample_logits)
        probs = torch.softmax(sample_logits, dim=-1)
        next_tok = torch.stack(
            [
                torch.multinomial(probs[i], 1, generator=generators[i])[:, 0]
                for i in range(b)
            ]
        )  # (B, K)
        next_tok = torch.where(finished, meta.eot, next_tok)

        tok_lp = torch.gather(logprobs, 2, next_tok[:, :, None])[:, :, 0]
        sum_lp = sum_lp + torch.where(active, tok_lp, 0.0)

        write_pos = lens.clamp(0, ctx - 1)  # (B, K) position of the new token
        is_eot = next_tok == meta.eot
        # eot is recorded in the buffer but not counted in the length
        hit = ctx_ids[None, None, :] == write_pos[:, :, None]
        tokens = torch.where(hit & active[:, :, None], next_tok[:, :, None], tokens)
        adv = active & ~is_eot
        lens = torch.where(adv, lens + 1, lens)
        finished = finished | is_eot

        penult_tok = torch.where(adv, last_tok, penult_tok)
        last_tok = torch.where(adv, next_tok, last_tok)
        ts_max = torch.where(
            adv & (next_tok >= meta.timestamp_begin),
            torch.maximum(ts_max, next_tok),
            ts_max,
        )

        # Active samples of a row share one write position; finished ones
        # get ignored garbage at that position on the card (K1 writes every
        # slot at pos_row).
        cur_logits, self_k, self_v = _gen_decoder_step(
            params, config, torch.where(finished, 0, next_tok), write_pos,
            write_pos.max(dim=1).values.int(), self_k, self_v, cross_k,
            cross_v, anc_id,
        )

    return tokens, lens, sum_lp, finished, no_speech_prob


# ---------------------------------------------------------------------------
# Host-facing API (ctranslate2.models.Whisper.generate equivalent)
# ---------------------------------------------------------------------------


def _bucket(n: int, step: int = 32, cap: int = 448) -> int:
    return min(cap, max(step, -(-n // step) * step))


class PendingGeneration(NamedTuple):
    """A finished generation's device tensors plus what ``generate_collect``
    needs to unpack them on the host."""

    kind: str  # "sample" | "beam"
    arrays: tuple
    prompt_lens: np.ndarray
    length_penalty: float


def _row_seeds(rng_seed, b: int) -> List[int]:
    if rng_seed is None:  # fresh entropy, as CT2 sampling is per call
        return [int(np.random.SeedSequence().entropy % (2**63)) for _ in range(b)]
    if isinstance(rng_seed, (list, tuple, np.ndarray)):
        seeds = [int(s) for s in rng_seed]
        if len(seeds) != b:
            raise ValueError(f"per-row rng_seed has {len(seeds)} entries for batch size {b}")
        return seeds
    # one seed for the batch: a distinct stream per row
    return [
        int(np.random.SeedSequence((int(rng_seed), i)).generate_state(1, np.uint64)[0] % (2**63))
        for i in range(b)
    ]


def generate_dispatch(
    params,
    config: WhisperConfig,
    meta: TokenMeta,
    encoder_output: torch.Tensor,
    prompts: Sequence[Sequence[int]],
    *,
    sot_id: int,
    beam_size: int = 5,
    patience: float = 1.0,
    length_penalty: float = 1.0,
    repetition_penalty: float = 1.0,
    no_repeat_ngram_size: int = 0,
    max_length: int = 448,
    suppress_blank: bool = True,
    suppress_tokens: Optional[Sequence[int]] = (),
    max_initial_timestamp_index: int = 50,
    sampling_temperature: Union[float, Sequence[float]] = 1.0,
    sampling_topk: int = 1,
    num_hypotheses: int = 1,
    with_timestamps: bool = True,
    rng_seed: Optional[Union[int, Sequence[int]]] = None,
    kv_int8: bool = False,
    int4: bool = False,
) -> PendingGeneration:
    """Run a generation on ``encoder_output``'s device and return its
    tensors; ``generate_collect`` unpacks them.  A per-row sequence of
    temperatures runs one sampling row per temperature (the batched
    fallback ladder).  ``kv_int8`` decodes over int8 self and cross
    caches; ``int4`` (which needs ``kv_int8``: ``GenOptions`` raises
    otherwise) over a cross cache at 4-bit range."""
    b = len(prompts)
    if encoder_output.shape[0] != b:
        raise ValueError(f"{b} prompts for {encoder_output.shape[0]} encoder rows")
    dev = encoder_output.device

    prompt_lens = np.array([len(pr) for pr in prompts], dtype=np.int64)
    # Right-padding is masked by causality, so the prompt width only has to
    # hold the longest prompt.
    P = int(prompt_lens.max())
    prompt_arr = np.zeros((b, P), dtype=np.int64)
    sot_pos = np.zeros((b,), dtype=np.int64)
    for i, pr in enumerate(prompts):
        prompt_arr[i, : len(pr)] = pr
        sot_pos[i] = pr.index(sot_id) if sot_id in pr else len(pr) - 1

    proc_opts = ProcessorOptions(
        suppress_blank=suppress_blank,
        suppress_tokens=tuple(suppress_tokens or ()),
        with_timestamps=with_timestamps,
        max_initial_timestamp_index=max_initial_timestamp_index,
        repetition_penalty=repetition_penalty,
        no_repeat_ngram_size=no_repeat_ngram_size,
    )
    ctx_cap = min(448, _bucket(max(max_length, P + 1), step=64, cap=448))

    if isinstance(sampling_temperature, (list, tuple, np.ndarray)):
        temps = [float(t) for t in sampling_temperature]
        if len(temps) != b:
            raise ValueError(
                f"per-row sampling_temperature has {len(temps)} entries "
                f"for batch size {b}"
            )
    else:
        temps = [float(sampling_temperature)] * b

    is_sampling = beam_size == 1 and all(t > 0 for t in temps)
    if beam_size == 1 and any(t > 0 for t in temps) and not is_sampling:
        raise ValueError(
            "per-row sampling_temperature mixes zero and non-zero values; "
            "greedy (t=0) and sampling rows cannot share one call"
        )

    def t(a):
        return torch.as_tensor(a, device=dev)

    with torch.no_grad():
        if is_sampling:
            gen_opts = GenOptions(
                beam_size=num_hypotheses,
                num_finished=num_hypotheses,
                length_penalty=length_penalty,
                sampling_topk=sampling_topk,
                ctx_cap=ctx_cap,
                kv_int8=kv_int8,
                int4=int4,
            )
            generators = []
            for seed in _row_seeds(rng_seed, b):
                g = torch.Generator(device=dev)
                g.manual_seed(seed)
                generators.append(g)
            arrays = sample(
                params, config, gen_opts, proc_opts, meta, encoder_output,
                t(prompt_arr), t(prompt_lens), t(sot_pos), max_length,
                t(np.asarray(temps, np.float32)), generators,
            )
            return PendingGeneration("sample", arrays, prompt_lens, length_penalty)

        gen_opts = GenOptions(
            beam_size=beam_size,
            num_finished=max(1, round(beam_size * patience)),
            length_penalty=length_penalty,
            ctx_cap=ctx_cap,
            kv_int8=kv_int8,
            int4=int4,
        )
        arrays = beam_search(
            params, config, gen_opts, proc_opts, meta, encoder_output,
            t(prompt_arr), t(prompt_lens), t(sot_pos), max_length,
        )
    return PendingGeneration("beam", arrays, prompt_lens, length_penalty)


def generate_collect(pending: PendingGeneration) -> List[WhisperGenerationResult]:
    """Copy a generation's tensors to the host and unpack the hypotheses."""
    prompt_lens = pending.prompt_lens
    length_penalty = pending.length_penalty
    b = len(prompt_lens)
    arrays = [a.cpu().numpy() for a in pending.arrays]
    results: List[WhisperGenerationResult] = []

    if pending.kind == "sample":
        tokens, lens, sum_lp, _finished, nsp = arrays
        for i in range(b):
            gen_lens = lens[i] - prompt_lens[i]
            scores = sum_lp[i] / np.maximum(gen_lens, 1) ** length_penalty
            order = np.argsort(-scores)
            seqs = [tokens[i, j, prompt_lens[i] : lens[i, j]].tolist() for j in order]
            results.append(
                WhisperGenerationResult(
                    sequences_ids=seqs,
                    scores=[float(scores[j]) for j in order],
                    no_speech_prob=float(nsp[i]),
                )
            )
        return results

    (hist_tok, hist_par, fin_slot, fin_lens, fin_scores, cur_len,
     act_score, nsp, _pl) = arrays
    for i in range(b):
        begin = int(prompt_lens[i])
        have = fin_scores[i] > -1e29
        if have.any():
            seqs = [
                _backtrack(
                    hist_tok[i], hist_par[i], int(fin_slot[i, j]),
                    int(fin_lens[i, j]), begin,
                )
                for j in range(fin_scores.shape[1])
                if have[j]
            ]
            scores = [float(s) for s in fin_scores[i][have]]
        else:
            seqs = [_backtrack(hist_tok[i], hist_par[i], 0, int(cur_len[i]), begin)]
            scores = [float(act_score[i])]
        results.append(
            WhisperGenerationResult(
                sequences_ids=seqs, scores=scores, no_speech_prob=float(nsp[i])
            )
        )
    return results


def _backtrack(hist_tok, hist_par, slot: int, end_len: int, begin: int):
    """Rebuild one hypothesis from the (ctx, K) history tables: walk the
    back-pointers from (position end_len-1, slot) down to the prompt."""
    seq = []
    c = end_len - 1
    while c >= begin:
        seq.append(int(hist_tok[c, slot]))
        slot = int(hist_par[c, slot])
        c -= 1
    seq.reverse()
    return seq
