#!/usr/bin/env python3
"""Request j of ``chip_smoke.py`` (phase 9) repeated, to see how often its
sampled rungs change its output.

    python3 tools/sampling_repeats.py [--runs 10] [--seed N]

Writes the large-v3-turbo random weights (seed 0) as a CTranslate2
directory with a float16 ``model.bin`` under ``build/``, loads it with
``WhisperModel(directory)`` and builds ``WhisperModel.from_parts`` on the
same float16-rounded weights, checks that both compute bit-equal whole-file
features, then runs request j (20 s of ``chip_smoke.synth_audio``, the
defaults, beam 5: the temperature ladder) ``--runs`` times on each model
and prints how many distinct outputs each gave, with each output's count,
its segments' temperatures and tokens.  Without ``--seed`` every sampling
call draws fresh entropy, as CT2 does; with it, the engine's ``rng_seed``.
Needs the card; deletes the directory at the end.
"""

import argparse
import dataclasses
import os
import shutil
import sys
from collections import Counter

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    from faster_whisper_tpu_torch.bpe import BPETokenizer
    from faster_whisper_tpu_torch.models.config import CONFIGS
    from faster_whisper_tpu_torch.models.load import random_params
    from faster_whisper_tpu_torch.testing import tokenizer_json, word_merges, write_ct2_dir
    from faster_whisper_tpu_torch.transcribe import WhisperModel

    cs.require_card()
    cs.build_kernels()
    cfg = dataclasses.replace(CONFIGS["large-v3-turbo"], alignment_heads=cs.ALIGNMENT_HEADS)
    tok_text = tokenizer_json(50257, word_merges(cs.MERGED_WORDS))
    params = random_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    root = os.path.join("build", f"sampling_repeats_{os.getpid()}")
    os.makedirs(root)
    try:
        write_ct2_dir(root, params, cfg, tok_text, weights="float16")

        def rounded(tree):
            return {k: rounded(v) if isinstance(v, dict) else v.to(torch.float16).to(torch.bfloat16)
                    for k, v in tree.items()}

        models = {"loaded": WhisperModel(root)}
        models["from_parts"] = WhisperModel.from_parts(
            rounded(params), models["loaded"].model.config, BPETokenizer.from_str(tok_text)
        )
        del params
        clip = cs.synth_audio(20.0, seed=2)
        feats = [m.feature_extractor(clip, return_device=True) for m in models.values()]
        print(f"whole-file features of both models bit-equal: {torch.equal(*feats)}; "
              f"rng_seed {args.seed} on {cs.card_line()}")
        for label, model in models.items():
            model.model.rng_seed = args.seed
            outputs = Counter()
            for _ in range(args.runs):
                segments, _ = model.transcribe(clip, beam_size=5)
                outputs[tuple((s.start, s.end, s.temperature, tuple(s.tokens)) for s in segments)] += 1
            print(f"{label}: {len(outputs)} distinct outputs in {args.runs} runs")
            for out, n in outputs.most_common():
                print(f"  {n} x {out}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
