"""Silero VAD v6 in PyTorch.

Counterpart of ``faster_whisper_tpu/models/silero.py``, on an explicit
device, with the weights of the port's own copy of
``assets/silero_vad_v6.npz`` (extracted from the ONNX release).  The graph:

    input (N, 576 = 64 context + 512 samples)
      -> reflect-pad 128 both sides                      (N, 832)
      -> four 256-sample STFT frames at stride 128 (the graph's first
         frame dropped) times the basis (258, 256)       (N, 4, 258)
      -> magnitude over 129 bins                         (N, 4, 129)
      -> Conv(129->128, k3 s1 p1) + ReLU                 (N, 128, 4)
      -> Conv(128->64,  k3 s2 p1) + ReLU                 (N, 64, 2)
      -> Conv(64->64,   k3 s2 p1) + ReLU                 (N, 64, 1)
      -> Conv(64->128,  k3 s1 p1) + ReLU                 (N, 128, 1)
      -> LSTM(128) scanned ACROSS WINDOWS: the window axis is the LSTM's
         time axis, so one ``nn.LSTM`` call runs the whole scan
      -> ReLU -> Linear(128->1) -> sigmoid               (N,)

The probabilities feed thresholds at 0.5 and 0.35, and TF32 products move
them by up to 0.4 over the recurrence (as bf16-rounded products do on the
TPU), so the forward runs in float32 with TF32 off for its own calls
(``utils.exact_float32``).  The audio goes through the int16 grid first,
as the JAX package's upload does, so the probabilities are the same
whether the samples arrive from the host or from the shared device copy.
"""

import os

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from torch import nn

from faster_whisper_tpu_torch.utils import exact_float32, resolve_device

_WINDOW = 512
_CONTEXT = 64
# One slice of the pipelined upload (vad.py::upload_with_vad): 2048
# windows, 65.5 s at 16 kHz, the JAX package's slice.
VAD_SLICE_SAMPLES = 2048 * _WINDOW

# ONNX stacks the LSTM gates as i, o, f, c; PyTorch as i, f, g(=c), o.
_ONNX_TO_TORCH_GATES = (0, 2, 3, 1)


def load_silero_weights(path: Optional[str] = None) -> dict:
    """The Silero v6 weights as float32 numpy arrays, from the package's
    ``assets/silero_vad_v6.npz`` unless ``path`` names another copy.

    Layout (that of the JAX package): ``stft_basis`` (258, 256); conv
    kernels ``conv{0..3}_w`` (3, in, out) with biases; ``lstm_w`` and
    ``lstm_r`` (512, 128) and ``lstm_b`` (1024,) = input bias + recurrent
    bias, gates in ONNX order; ``out_w`` (1, 128), ``out_b`` (1,)."""
    if path is None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "assets",
            "silero_vad_v6.npz",
        )
    data = np.load(path)
    return {k: np.asarray(data[k], dtype=np.float32) for k in data.files}


def _gates_to_torch(w: np.ndarray) -> np.ndarray:
    blocks = np.split(w, 4, axis=0)
    return np.concatenate([blocks[i] for i in _ONNX_TO_TORCH_GATES], axis=0)


class SileroVAD(nn.Module):
    """Audio (a multiple of 512 samples) -> per-window speech probability,
    with the 64-sample context carried from the previous window (the
    reference's SileroVADModel)."""

    def __init__(self, device="cuda", path: Optional[str] = None):
        super().__init__()
        w = load_silero_weights(path)

        def buf(name, a):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(a)))

        buf("stft_basis", w["stft_basis"])
        for i in range(4):
            # (k, in, out) -> PyTorch's (out, in, k)
            buf(f"conv{i}_w", w[f"conv{i}_w"].transpose(2, 1, 0))
            buf(f"conv{i}_b", w[f"conv{i}_b"])
        self.lstm = nn.LSTM(128, 128)
        with torch.no_grad():
            self.lstm.weight_ih_l0.copy_(torch.from_numpy(_gates_to_torch(w["lstm_w"])))
            self.lstm.weight_hh_l0.copy_(torch.from_numpy(_gates_to_torch(w["lstm_r"])))
            self.lstm.bias_ih_l0.copy_(torch.from_numpy(_gates_to_torch(w["lstm_b"][:512])))
            self.lstm.bias_hh_l0.copy_(torch.from_numpy(_gates_to_torch(w["lstm_b"][512:])))
        self.out = nn.Linear(128, 1)
        with torch.no_grad():
            self.out.weight.copy_(torch.from_numpy(w["out_w"]))
            self.out.bias.copy_(torch.from_numpy(w["out_b"]))
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.stft_basis.device

    def forward(self, audio) -> torch.Tensor:
        """audio: (N*512,) float samples, a tensor or numpy -> speech
        probabilities (N,) float32 on the model's device."""
        x = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        if x.dim() != 1 or x.shape[0] % _WINDOW:
            raise ValueError(f"audio must be 1-D with a multiple of {_WINDOW} samples")
        # the int16 grid of the shared upload (ops/mel.py::upload_audio)
        x = torch.clamp(torch.round(x * 32768.0), -32768, 32767) * (1.0 / 32768.0)
        windows = x.view(-1, _WINDOW)
        context = torch.cat([windows.new_zeros(1, _CONTEXT), windows[:-1, -_CONTEXT:]])
        with torch.no_grad(), exact_float32():
            return self._forward_windows(torch.cat([context, windows], dim=1))[0]

    def _forward_windows(self, windows: torch.Tensor, state=None):
        """(N, 576) windows and the LSTM's (h, c) before the first of
        them (None: zeros) -> (probabilities (N,), (h, c) after the last).
        The per-window arithmetic does not depend on N, so windows run in
        slices with the state carried give the whole-buffer forward's
        probabilities."""
        x = F.pad(windows[:, None, :], (128, 128), mode="reflect")[:, 0]  # (N, 832)
        frames = x.unfold(1, 256, 128)[:, 1:]  # (N, 4, 256) at offsets 128..512
        spec = frames @ self.stft_basis.T  # (N, 4, 258)
        real, imag = spec[..., :129], spec[..., 129:]
        h = torch.sqrt(real * real + imag * imag).transpose(1, 2)  # (N, 129, 4)
        for i, stride in enumerate((1, 2, 2, 1)):
            h = F.relu(F.conv1d(h, getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b"),
                                stride=stride, padding=1))
        hs, state = self.lstm(h[:, None, :, 0], state)  # (N, 1, 128): N time steps, batch 1
        # On the CPU a matmul and an elementwise loop take the last rows of
        # a buffer down other paths than the rest (a ragged GEMM tile, a
        # scalar remainder), which round differently; so the output layer
        # is a per-row product and sum, and the sigmoid runs over a length
        # padded to a multiple of 64.  A window's probability then does not
        # depend on where its buffer ends (the pipelined upload's slices
        # against the whole buffer).
        logits = (F.relu(hs[:, 0]) * self.out.weight[0]).sum(dim=-1) + self.out.bias[0]
        n = logits.shape[0]
        return torch.sigmoid(F.pad(logits, (0, -n % 64)))[:n], state


def _vad_slice_step(model: SileroVAD, q_slice: torch.Tensor, tail: torch.Tensor, state):
    """One slice of the pipelined upload's VAD forward, on the model's
    device: int16 samples (a multiple of 512), the last 64 samples of the
    previous slice (zeros before the first) and the LSTM state carried
    from it (None before the first).  Returns (probabilities, the new
    tail, the new state, the slice's float32 samples): the samples are
    ``ops/mel.py::upload_audio``'s own values for the slice (``q / 32768``
    in float32).  The caller holds ``torch.no_grad`` and
    ``utils.exact_float32``."""
    audio = q_slice.to(torch.float32) * (1.0 / 32768.0)
    windows = audio.view(-1, _WINDOW)
    context = torch.cat([tail[None], windows[:-1, -_CONTEXT:]])
    probs, state = model._forward_windows(torch.cat([context, windows], dim=1), state)
    return probs, windows[-1, -_CONTEXT:], state, audio


def _write_slice(buf: torch.Tensor, sl: torch.Tensor, off: int) -> None:
    """Write one slice's samples into the assembled device buffer at
    ``off``, in place; the zero padding of the last slice past the
    buffer's end is dropped."""
    n = min(sl.shape[0], buf.shape[0] - off)
    buf[off : off + n] = sl[:n]
