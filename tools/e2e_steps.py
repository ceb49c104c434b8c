#!/usr/bin/env python3
"""Decode-step time of the bf16 requests a-c of ``chip_smoke.py``, for the
package in a given checkout.

    python3 tools/e2e_steps.py CHECKOUT LABEL

Imports ``chip_smoke`` and ``faster_whisper_tpu_torch`` from CHECKOUT (for
example an unpacked parent commit), runs requests a-c at large-v3-turbo
width after a short warm-up, and prints one line: the label, the seconds,
the decode steps and ms per step.  Run parent, change, change, parent in one
call to compare two versions on one card.
"""

import os
import sys
import time

if len(sys.argv) != 3:
    sys.exit(__doc__)
root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from faster_whisper_tpu_torch.generation.generate import _gen_decoder_step  # noqa: E402
from faster_whisper_tpu_torch.models.config import CONFIGS  # noqa: E402
from faster_whisper_tpu_torch.models.load import random_params  # noqa: E402
from faster_whisper_tpu_torch.testing import build_synthetic_tokenizer  # noqa: E402
from faster_whisper_tpu_torch.transcribe import WhisperModel  # noqa: E402

cs.require_card()
cfg = CONFIGS["large-v3-turbo"]
params = random_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
model = WhisperModel.from_parts(params, cfg, build_synthetic_tokenizer(base_vocab=50257))
long_clip, short_clip = cs.synth_audio(45.0, seed=1), cs.synth_audio(20.0, seed=2)
requests = [
    (long_clip, dict(language=None, beam_size=5)),
    (long_clip, dict(language="en", beam_size=5, without_timestamps=True)),
    (short_clip, dict(beam_size=1, temperature=0.0)),
]
list(model.transcribe(short_clip, beam_size=1, temperature=0.0, max_new_tokens=4)[0])
_gen_decoder_step.calls = 0
torch.cuda.synchronize()
t0 = time.perf_counter()
for audio, kwargs in requests:
    list(model.transcribe(audio, **kwargs)[0])
torch.cuda.synchronize()
seconds = time.perf_counter() - t0
steps = _gen_decoder_step.calls
print(f"E2E {sys.argv[2]}: {seconds:.3f} s, {steps} steps, {1000 * seconds / steps:.3f} ms/step "
      f"on {cs.card_line()}")
