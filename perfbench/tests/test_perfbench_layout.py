"""The harness is driven by data: a cell and a per-layer metric are added by
adding files and entries only, and the harness finds them by name."""

import json
import os

import run as bench_run
import tiny

READER = '''"""Decode steps per decode call of the slice."""


def read(ctx):
    return sum(d["steps"] for d in ctx.decodes) / len(ctx.decodes) if ctx.decodes else None
'''


def test_a_cell_and_a_metric_added_as_files(monkeypatch, tmp_path):
    bench, name = tiny.make(str(tmp_path), "batched")
    with open(os.path.join(tmp_path, "metrics", "steps_per_decode.tiny.py"), "w") as f:
        f.write(READER)
    bench["per_layer"].append({"name": "steps_per_decode.tiny", "unit": "steps", "better": "lower",
                               "source": "program_counter", "layer": "decode loop",
                               "moves": "audio_s_per_s", "workloads": [name]})
    monkeypatch.setattr(bench_run, "HERE", str(tmp_path))
    res = bench_run.run(name, 5, 0.1, True, device="cpu", bench=bench, check_chips=False, log=lambda m: None)
    assert res["metrics"]["steps_per_decode.tiny"] == {"value": 6.0, "unit": "steps"}
    assert res["correct"]


def test_untraced_run_reports_its_end_to_end_metrics(monkeypatch, tmp_path):
    res = tiny.run(monkeypatch, tmp_path, "batched", seed=3, seconds=1.0)
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_benchmark_json_names_its_files():
    with open(os.path.join(bench_run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(bench_run.ROOT, c["file"]))
    for w in bench["workloads"]:
        spec = bench_run.load_cell(w["name"], bench)
        assert spec["e2e"] and spec["per_layer"]
        for m in spec["per_layer"]:
            assert os.path.exists(os.path.join(bench_run.HERE, "metrics", m["name"] + ".py"))


def test_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    assert "faster_whisper_tpu" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "faster_whisper_tpu_torch_extra", types.ModuleType("x"))
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert bench_run.forbidden_modules() == ["jax"]
