"""A tiny cell for the host: the harness's data directories copied into a
temporary directory, a configuration of widths 64 (2 heads, 2 layers) and a
traffic file of the batched driver at a few tokens, added as files only."""

import copy
import json
import os
import shutil

import run as bench_run

TINY = {"name": "tiny", "source": "test", "d_model": 64, "encoder_attention_heads": 2,
        "decoder_attention_heads": 2, "encoder_layers": 2, "decoder_layers": 2, "encoder_ffn_dim": 256,
        "decoder_ffn_dim": 256, "num_mel_bins": 80, "vocab_size": 51866, "max_source_positions": 1500,
        "max_target_positions": 448, "compute_type": "float32", "reduced": []}

OPTS = {"language": "en", "beam_size": 2, "max_new_tokens": 6}
TRAFFIC = {
    "batched": {"driver": "batched", "file_s": 45, "gap_s": [0.5, 3.0], "noise": 8, "batch_size": 2,
                "trace_files": 1, "pool_files": 2, "options": dict(OPTS, temperature=[0.0])},
}
E2E = {"batched": ["audio_s_per_s"]}
LIMITS = {"windows_differ": 0, "score_gap": 1e-4, "rank_gap": 1e-4, "nospeech_gap": 1e-4}


def make(tmp, kind: str, compute_type: str = "float32", limits=None, config=None):
    """(bench dict, cell name) of a tiny ``kind`` cell whose files live in
    ``tmp``; ``bench_run.HERE`` must point at ``tmp`` while it runs."""
    for sub in ("metrics", "traffic", "limits", "configs"):
        src = os.path.join(bench_run.HERE, sub)
        if not os.path.exists(os.path.join(tmp, sub)):
            shutil.copytree(src, os.path.join(tmp, sub))
    name = f"tiny-{compute_type}.{kind}"
    cfg_file = os.path.join(tmp, "configs", f"tiny-{compute_type}.json")
    with open(cfg_file, "w") as f:
        json.dump(dict(TINY if config is None else config, compute_type=compute_type), f)
    with open(os.path.join(tmp, "traffic", f"tiny-{kind}.json"), "w") as f:
        json.dump(TRAFFIC[kind], f)
    with open(os.path.join(tmp, "limits", name + ".json"), "w") as f:
        json.dump(LIMITS if limits is None else limits, f)
    with open(os.path.join(bench_run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": f"tiny-{compute_type}", "source": "test", "file": cfg_file,
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": f"tiny-{compute_type}", "traffic": f"tiny-{kind}",
                               "chips": 1, "why": "test"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for metric in E2E[kind]:
        e2e.setdefault(metric, {"name": metric, "unit": "s", "better": "lower", "bound": 0.25,
                                "source": "host_clock", "workloads": []})["workloads"].append(name)
    bench["end_to_end"] = list(e2e.values())
    layers = {m["name"]: m for m in bench["per_layer"]}
    for f in sorted(os.listdir(os.path.join(tmp, "metrics"))):
        metric = f[: -len(".py")]
        if metric.endswith("." + kind):
            layers.setdefault(metric, {"name": metric, "unit": "x", "better": "lower", "source": "device_trace",
                                       "layer": "test", "moves": E2E[kind][-1], "workloads": []})
            layers[metric]["workloads"].append(name)
    bench["per_layer"] = list(layers.values())
    return bench, name


def run(monkeypatch, tmp, kind, seed=7, seconds=0.5, trace=False, compute_type="float32", limits=None,
        config=None, program=None, **kw):
    """One run of the tiny cell of ``compute_type``; ``program`` runs the
    program at another compute type (a control)."""
    bench, name = make(str(tmp), kind, compute_type, limits, config)
    monkeypatch.setattr(bench_run, "HERE", str(tmp))
    return bench_run.run(name, seed, seconds, trace, device="cpu", bench=bench, check_chips=False,
                         log=lambda msg: None, compute_type=program, **kw)
