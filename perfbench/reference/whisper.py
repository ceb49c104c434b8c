"""Whisper's encoder and a teacher-forced decoder in plain float32 PyTorch,
from the published architecture (Radford et al. 2022, openai/whisper
``model.py``): a conv stem (k3 s1, k3 s2, exact GELU) and fixed sinusoids,
pre-norm blocks (LayerNorm eps 1e-5, attention with no key bias, an MLP of
4d with exact GELU), a final LayerNorm and logits over the tied token
embedding.

``quant`` reruns the int8 rule of the configuration on the same float
weights (``quantize``): "int8" is W8A8 (each layer's matmul weights per
output channel at max|w| / 127, activations per row at max|x| / 127, the
logits head the transposed embedding quantized the same way) with int8 K/V
caches (codes per (position, head) row at max|x| / 127, the scale stored in
bfloat16), which the decode steps read and the prompt's pass does not;
"int4" puts the decoder's weights, the logits head and the cross K/V codes
at 4-bit range (max / 7), the encoder at int8; "fp8" rounds every matmul
weight (per output channel), activation (per row), K/V cache row and the
logits head to float8 e4m3 at max|x| / 448. Codes are dequantized and the
products taken in float32, TF32 off.

Rows are computed one sequence at a time, so the reference fits beside
nothing else it needs.
"""

import math

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F


class Dims(NamedTuple):
    n_mels: int
    d: int
    heads: int
    enc_layers: int
    dec_layers: int
    vocab: int


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


FP8_MAX = 448.0


def _codes(x: torch.Tensor, qmax) -> torch.Tensor:
    """x (already divided by its scale) as codes: integers rounded half to
    even and clipped at ``qmax``, or float8 e4m3 where ``qmax`` is "fp8"."""
    if qmax == "fp8":
        return x.to(torch.float8_e4m3fn).float()
    return torch.clamp(torch.round(x), -qmax, qmax)


def _qmax(qmax) -> float:
    return FP8_MAX if qmax == "fp8" else float(qmax)


def quantize(w: torch.Tensor, qmax, axis: int = -2) -> torch.Tensor:
    """Symmetric quantization over ``axis`` at max|w| / qmax (an integer
    range, or "fp8"), returned dequantized in float32."""
    wf = w.float()
    s = torch.clamp(wf.abs().amax(dim=axis, keepdim=True) * (1.0 / _qmax(qmax)), min=1e-10)
    return _codes(wf / s, qmax) * s


def quantize_kv(x: torch.Tensor, qmax=127) -> torch.Tensor:
    """A quantized cache row over the head dim; an integer code's scale is
    kept in bfloat16."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) * (1.0 / _qmax(qmax)), min=1e-10)
    q = _codes(xf / s, qmax)
    return q * (s if qmax == "fp8" else s.to(torch.bfloat16).float())


class Linear:
    """x @ w + b, with the weight and the activations quantized where the
    configuration's rule says so."""

    def __init__(self, w, b=None, w_qmax=None, act_qmax=None):
        self.w = w.float() if w_qmax is None else quantize(w, w_qmax)
        self.b = None if b is None else b.float()
        self.act_qmax = act_qmax

    def __call__(self, x):
        if self.act_qmax is not None:
            x = quantize(x, self.act_qmax, axis=-1)
        y = x @ self.w
        return y if self.b is None else y + self.b


def _ln(x, g, b):
    return F.layer_norm(x, (x.shape[-1],), g.float(), b.float(), eps=1e-5)


def _attend(q, k, v, heads, causal_offset=None):
    """q (S, d), k/v (T, d) -> (S, d); ``causal_offset``: query i sees keys
    up to i + offset."""
    s, d = q.shape
    t = k.shape[0]
    dh = d // heads
    qh = q.view(s, heads, dh).transpose(0, 1)
    kh = k.view(t, heads, dh).transpose(0, 1)
    vh = v.view(t, heads, dh).transpose(0, 1)
    scores = (qh @ kh.transpose(1, 2)) / math.sqrt(dh)
    if causal_offset is not None:
        i = torch.arange(s, device=q.device)[:, None] + causal_offset
        j = torch.arange(t, device=q.device)[None, :]
        scores = scores.masked_fill(j > i, float("-inf"))
    return (torch.softmax(scores, dim=-1) @ vh).transpose(0, 1).reshape(s, d)


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class Whisper:
    """The reference over a float parameter tree (the layout the harness
    draws: stacked layers, matmul weights stored (in, out))."""

    def __init__(self, params: dict, dims: Dims, quant: Optional[str] = None):
        if quant not in (None, "int8", "int4", "fp8"):
            raise ValueError(f"quant {quant!r}")
        no_tf32()
        self.p, self.dims, self.quant = params, dims, quant
        self.enc_q = {None: None, "int8": 127, "int4": 127, "fp8": "fp8"}[quant]
        self.dec_q = {None: None, "int8": 127, "int4": 7, "fp8": "fp8"}[quant]
        self.act_q = self.kv_q = self.enc_q
        self.cross_kv_q = self.dec_q
        emb = params["decoder"]["token_embed"]
        self.logits_w = emb.float().t() if quant is None else quantize(emb.t(), self.dec_q)

    def _lin(self, p, w, b=None, decoder=False):
        return Linear(p[w], None if b is None else p[b], self.dec_q if decoder else self.enc_q, self.act_q)

    def _mlp(self, p, x, decoder):
        h = F.gelu(self._lin(p, "w1", "b1", decoder)(x))
        return self._lin(p, "w2", "b2", decoder)(h)

    # -- encoder ----------------------------------------------------------

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(n_mels, 3000) -> (1500, d) for one window."""
        enc = self.p["encoder"]
        x = mel.float()[None]
        x = F.gelu(F.conv1d(x, enc["conv1_w"].float().permute(2, 1, 0), enc["conv1_b"].float(), padding=1))
        x = F.gelu(F.conv1d(x, enc["conv2_w"].float().permute(2, 1, 0), enc["conv2_b"].float(),
                            stride=2, padding=1))
        x = x[0].t() + enc["pos_embed"].float()
        for i in range(self.dims.enc_layers):
            p = _layer(enc["layers"], i)
            a = p["attn"]
            h = _ln(x, p["ln1_g"], p["ln1_b"])
            q = self._lin(a, "wq", "bq")(h)
            k = self._lin(a, "wk")(h)
            v = self._lin(a, "wv", "bv")(h)
            x = x + self._lin(a, "wo", "bo")(_attend(q, k, v, self.dims.heads))
            x = x + self._mlp(p["mlp"], _ln(x, p["ln2_g"], p["ln2_b"]), False)
        return _ln(x, enc["ln_post_g"], enc["ln_post_b"])

    # -- decoder ----------------------------------------------------------

    @torch.no_grad()
    def logits(self, xa: torch.Tensor, tokens: Sequence[int], n_prompt: int) -> torch.Tensor:
        """Teacher-forced logits (len(tokens), vocab) of one sequence over
        the encoder states ``xa`` (1500, d). The first ``n_prompt`` tokens
        are the prompt, run as one pass over raw K/V; the later positions
        are the decode steps, which read the caches (quantized under an int8
        rule, the prompt's rows too)."""
        dec = self.p["decoder"]
        dev = xa.device
        tok = torch.as_tensor(list(tokens), device=dev)
        s = tok.shape[0]
        x = dec["token_embed"][tok].float() + dec["pos_embed"][:s].float()
        kvq = self.kv_q
        split = n_prompt if kvq is not None else s
        for i in range(self.dims.dec_layers):
            p = _layer(dec["layers"], i)
            sa, ca = p["self_attn"], p["cross_attn"]
            h = _ln(x, p["ln1_g"], p["ln1_b"])
            q = self._lin(sa, "wq", "bq", True)(h)
            k = self._lin(sa, "wk", None, True)(h)
            v = self._lin(sa, "wv", "bv", True)(h)
            out = [_attend(q[:split], k[:split], v[:split], self.dims.heads, causal_offset=0)]
            if split < s:
                out.append(_attend(q[split:], quantize_kv(k.view(s, self.dims.heads, -1), kvq).view(s, -1),
                                   quantize_kv(v.view(s, self.dims.heads, -1), kvq).view(s, -1),
                                   self.dims.heads, causal_offset=split))
            x = x + self._lin(sa, "wo", "bo", True)(torch.cat(out))

            h = _ln(x, p["ln2_g"], p["ln2_b"])
            q = self._lin(ca, "wq", "bq", True)(h)
            ck = self._lin(ca, "wk", None, True)(xa)
            cv = self._lin(ca, "wv", "bv", True)(xa)
            out = [_attend(q[:split], ck, cv, self.dims.heads)]
            if split < s:
                t = ck.shape[0]
                cq = self.cross_kv_q
                out.append(_attend(q[split:], quantize_kv(ck.view(t, self.dims.heads, -1), cq).view(t, -1),
                                   quantize_kv(cv.view(t, self.dims.heads, -1), cq).view(t, -1),
                                   self.dims.heads))
            x = x + self._lin(ca, "wo", "bo", True)(torch.cat(out))
            x = x + self._mlp(p["mlp"], _ln(x, p["ln3_g"], p["ln3_b"]), True)
        x = _ln(x, dec["ln_g"], dec["ln_b"])
        if self.act_q is not None:
            x = quantize(x, self.act_q, axis=-1)
        return x @ self.logits_w


def masked_log_softmax(logits: torch.Tensor, suppressed: Sequence[int], blank: Sequence[int],
                       first: int) -> torch.Tensor:
    """Log-probabilities (S, V) after the decode's rules: the suppressed
    ids at every position, and the blank ids at position ``first`` (the
    first sampled token)."""
    lg = logits.clone()
    lg[:, list(suppressed)] = float("-inf")
    lg[first, list(blank)] = float("-inf")
    return torch.log_softmax(lg, dim=-1)


def kth_best(lp: torch.Tensor, k: int, exclude: int) -> torch.Tensor:
    """The k-th largest log-probability of each row, ``exclude`` left out."""
    x = lp.clone()
    x[:, exclude] = float("-inf")
    return torch.topk(x, k, dim=-1).values[:, -1]


def served_readings(lp: torch.Tensor, served: List[int], first: int, beam: int, eot: int,
                    finished: bool):
    """(the served hypothesis's log-probability, the largest amount by which
    a served token lies below the ``beam``-th best non-eot token of its
    position) from the reference's log-probs ``lp`` of the sequence prompt
    + served, whose first served token is predicted at ``first``. A beam
    search keeps a token only among the ``beam`` best non-eot extensions
    of its prefix. A hypothesis that ``finished`` ends with end-of-text,
    whose log-probability its score includes."""
    n = len(served)
    rows = lp[first : first + n]
    tok = torch.as_tensor(served, device=lp.device, dtype=torch.long)
    own = rows.gather(1, tok[:, None])[:, 0]
    total = float(own.double().sum())
    if finished:
        total += float(lp[first + n, eot])
    gap = float(torch.clamp(kth_best(rows, beam, eot) - own, min=0.0).max()) if n else 0.0
    return total, gap


def no_speech_logprob(logits_at_sot: torch.Tensor, no_speech: int) -> float:
    """log of the no-speech probability: the softmax of the raw logits at
    the <|startoftranscript|> position."""
    return float(torch.log_softmax(logits_at_sot.double(), dim=-1)[no_speech])


def first_tokens(lp: torch.Tensor, first: int, n: int, eot: int) -> List[int]:
    """The token that log-probs ``lp`` put first (end-of-text left out) at
    each of ``n`` positions from ``first``: what a decode at that precision
    would keep there."""
    rows = lp[first : first + n].clone()
    rows[:, eot] = float("-inf")
    return rows.argmax(dim=-1).tolist()
