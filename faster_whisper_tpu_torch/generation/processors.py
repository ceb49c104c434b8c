"""Whisper logits rules, vectorized over rows.

Counterpart of ``faster_whisper_tpu/generation/processors.py``: the static
suppress list, blank suppression at the first sampled position, repetition
penalty and no-repeat-ngram over the sampled region, and the timestamp
rules (``<|notimestamps|>`` banned, timestamps in pairs, non-decreasing,
timestamp-only first position capped by ``max_initial_timestamp_index``,
and "if the timestamps' total probability beats every text token, sample a
timestamp").  Functions take logits (R, V) f32 and per-row integers, and
return log-probabilities.
"""

import functools

from dataclasses import dataclass
from typing import Tuple

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class TokenMeta:
    """Static vocabulary layout."""

    eot: int
    timestamp_begin: int
    no_timestamps: int
    no_speech: int
    blank: Tuple[int, ...]  # token ids of " " (plus eot added separately)
    vocab_size: int


@dataclass(frozen=True)
class ProcessorOptions:
    """Static decode-policy options."""

    suppress_blank: bool = True
    suppress_tokens: Tuple[int, ...] = ()
    with_timestamps: bool = True
    max_initial_timestamp_index: int = 50
    repetition_penalty: float = 1.0
    no_repeat_ngram_size: int = 0


@functools.lru_cache(maxsize=32)
def _id_mask(ids: Tuple[int, ...], v: int, device: torch.device) -> torch.Tensor:
    """(V,) bool mask of ``ids``, built once per (ids, V, device): the
    decode loops ask for the same few masks at every step.  Read-only."""
    mask = torch.zeros(v, dtype=torch.bool, device=device)
    mask[torch.as_tensor(ids, dtype=torch.long, device=device)] = True
    return mask


def _static_masks(logits, at_begin, meta: TokenMeta, opts: ProcessorOptions):
    v = logits.shape[1]
    if opts.suppress_tokens:
        mask = _id_mask(tuple(opts.suppress_tokens), v, logits.device)
        logits = torch.where(mask[None, :], NEG_INF, logits)
    if opts.suppress_blank and meta.blank:
        mask = _id_mask(tuple(meta.blank) + (meta.eot,), v, logits.device)
        logits = torch.where(at_begin & mask[None, :], NEG_INF, logits)
    return logits


def _timestamp_masks(logits, n_sampled, last, penult, ts_max, at_begin, meta, opts):
    """The pairing, monotonicity and first-position timestamp rules, from
    the last two sampled tokens and the largest sampled timestamp."""
    v = logits.shape[1]
    vocab_ids = torch.arange(v, device=logits.device)[None, :]
    tsb = meta.timestamp_begin
    is_ts = vocab_ids >= tsb
    last_was_ts = (n_sampled >= 1) & (last >= tsb)
    penult_was_ts = (n_sampled < 2) | (penult >= tsb)

    # <|notimestamps|> is never a valid output here.
    logits = torch.where(vocab_ids == meta.no_timestamps, NEG_INF, logits)
    # After a timestamp pair: text/eot.  After a lone timestamp: timestamp/eot.
    ban_ts = (last_was_ts & penult_was_ts)[:, None] & is_ts
    ban_text = (last_was_ts & ~penult_was_ts)[:, None] & (vocab_ids < meta.eot)
    logits = torch.where(ban_ts | ban_text, NEG_INF, logits)

    # Non-decreasing: strictly above the last timestamp after a completed
    # pair, at or above it mid-pair.
    have_ts = ts_max >= 0
    floor = torch.where(last_was_ts & ~penult_was_ts, ts_max, ts_max + 1)
    ban_low = have_ts[:, None] & is_ts & (vocab_ids < floor[:, None])
    logits = torch.where(ban_low, NEG_INF, logits)

    # First sampled position: timestamps only, capped.
    logits = torch.where(at_begin & ~is_ts, NEG_INF, logits)
    if opts.max_initial_timestamp_index is not None:
        cap = tsb + opts.max_initial_timestamp_index
        logits = torch.where(at_begin & (vocab_ids > cap), NEG_INF, logits)
    return logits


def _force_timestamps(lp, meta: TokenMeta):
    """If the timestamps' total probability beats every text token, only
    timestamps stay: a shift of the log-softmax, not a second softmax."""
    v = lp.shape[1]
    is_ts = torch.arange(v, device=lp.device)[None, :] >= meta.timestamp_begin
    ts_lse = torch.logsumexp(torch.where(is_ts, lp, NEG_INF), dim=-1)
    max_text = torch.where(is_ts, NEG_INF, lp).max(dim=-1).values
    force_ts = ts_lse > max_text
    return torch.where(
        force_ts[:, None],
        torch.where(is_ts, lp - ts_lse[:, None], NEG_INF),
        lp,
    )


def apply_logits_rules_logprobs(
    logits: torch.Tensor,  # (R, V) f32
    tokens: torch.Tensor,  # (R, ctx) full buffers (prompt + sampled)
    cur_len: torch.Tensor,  # (R,) absolute length so far
    sample_begin: torch.Tensor,  # (R,) prompt length
    meta: TokenMeta,
    opts: ProcessorOptions,
) -> torch.Tensor:
    """The full rule chain fused with the log-softmax, from token buffers."""
    r, v = logits.shape
    ctx = tokens.shape[1]
    dev = logits.device
    tokens = tokens.long()
    cur_len = cur_len.long()
    sample_begin = sample_begin.long()
    n_sampled = cur_len - sample_begin
    at_begin = (n_sampled == 0)[:, None]
    pos = torch.arange(ctx, device=dev)[None, :]
    in_window = (pos >= sample_begin[:, None]) & (pos < cur_len[:, None])

    logits = _static_masks(logits, at_begin, meta, opts)

    if opts.repetition_penalty != 1.0:
        seen = torch.zeros((r, v), dtype=torch.int32, device=dev).scatter_reduce(
            1, torch.where(in_window, tokens, 0), in_window.int(), "amax"
        ).bool()
        penalized = torch.where(
            logits > 0,
            logits / opts.repetition_penalty,
            logits * opts.repetition_penalty,
        )
        logits = torch.where(seen, penalized, logits)

    if opts.no_repeat_ngram_size > 0:
        n = opts.no_repeat_ngram_size
        starts = ctx - (n - 1)
        if n > 1:
            idx = (cur_len - (n - 1))[:, None] + torch.arange(n - 1, device=dev)[None, :]
            suffix = torch.gather(tokens, 1, idx.clamp(0, ctx - 1))
            windows = tokens.unfold(1, n - 1, 1)[:, :starts]  # (R, starts, n-1)
            matches = (windows == suffix[:, None, :]).all(dim=-1)
        else:
            matches = torch.ones((r, starts), dtype=torch.bool, device=dev)
        p = torch.arange(starts, device=dev)[None, :]
        valid = (p >= sample_begin[:, None]) & (p + n - 1 < cur_len[:, None])
        hit = matches & valid & (n_sampled >= n - 1)[:, None]
        banned = torch.zeros((r, v), dtype=torch.int32, device=dev).scatter_reduce(
            1, tokens[:, n - 1 : n - 1 + starts], hit.int(), "amax"
        ).bool()
        logits = torch.where(banned, NEG_INF, logits)

    if opts.with_timestamps:
        last = torch.gather(tokens, 1, (cur_len - 1).clamp(0, ctx - 1)[:, None])[:, 0]
        penult = torch.gather(tokens, 1, (cur_len - 2).clamp(0, ctx - 1)[:, None])[:, 0]
        ts_vals = torch.where(in_window & (tokens >= meta.timestamp_begin), tokens, -1)
        ts_max = ts_vals.max(dim=1).values
        logits = _timestamp_masks(
            logits, n_sampled, last, penult, ts_max, at_begin, meta, opts
        )

    lp = torch.log_softmax(logits, dim=-1)
    if opts.with_timestamps:
        lp = _force_timestamps(lp, meta)
    return lp


def apply_logits_rules_logprobs_carried(
    logits: torch.Tensor,  # (R, V) f32
    n_sampled: torch.Tensor,  # (R,) tokens sampled so far
    last: torch.Tensor,  # (R,) last sampled token (valid when n_sampled >= 1)
    penult: torch.Tensor,  # (R,) second-to-last (valid when n_sampled >= 2)
    ts_max: torch.Tensor,  # (R,) largest sampled timestamp token, -1 when none
    meta: TokenMeta,
    opts: ProcessorOptions,
) -> torch.Tensor:
    """``apply_logits_rules_logprobs`` from carried per-row integers, for
    the options that need no other history (no repetition penalty, no
    no-repeat-ngram)."""
    if opts.repetition_penalty != 1.0 or opts.no_repeat_ngram_size > 0:
        raise ValueError("the carried rule chain needs the token buffers for these options")
    at_begin = (n_sampled == 0)[:, None]
    logits = _static_masks(logits, at_begin, meta, opts)
    if opts.with_timestamps:
        logits = _timestamp_masks(
            logits, n_sampled, last, penult, ts_max, at_begin, meta, opts
        )
    lp = torch.log_softmax(logits, dim=-1)
    if opts.with_timestamps:
        lp = _force_timestamps(lp, meta)
    return lp
