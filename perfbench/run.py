"""One run of one cell of the benchmark of ``faster_whisper_tpu_torch``.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from ``BENCHMARK.json``, its configuration from
``perfbench/configs/``, its traffic from ``perfbench/traffic/`` and its
limits from ``perfbench/limits/``; draws the weights on the card from the
seed and hands them, the synthetic vocabulary and the audio to the
program; warms up the cell's own shapes and makes the window's audio;
then measures for ``--seconds`` (``--trace 0``: the end-to-end metrics) or
runs a bounded slice untraced and again under the profiler (``--trace 1``:
the per-layer metrics, each read by its own file under
``perfbench/metrics/``). Once the window has closed it frees the program,
reruns the plain reference on a sample of what the program served, and
prints each number compared beside its limit, then the result as the last
line of standard output.

Exits 2 without enough cards, 3 if the process holds jax, jaxlib, flax or
faster_whisper_tpu after set-up, after the window or after the reference.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Every cache of the run lives at a fixed path inside the checkout.
_CACHE = os.path.join(ROOT, "build", "perfbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "faster_whisper_tpu")
HERE = os.path.join(ROOT, "perfbench")


class Refused(Exception):
    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


def forbidden_modules():
    """Top-level names in ``sys.modules`` that the run must not hold,
    compared whole (faster_whisper_tpu_torch is not faster_whisper_tpu)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def guard(where: str):
    found = forbidden_modules()
    if found:
        raise Refused(3, f"after {where} the process holds {', '.join(found)}")


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str, bench: dict = None) -> dict:
    """The cell, its configuration, traffic, limits and metrics, found by
    the names in ``BENCHMARK.json``."""
    bench = _json(ROOT, "BENCHMARK.json") if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(2, f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(ROOT, configs[cell["config"]]["file"])
    traffic = _json(HERE, "traffic", cell["traffic"] + ".json")
    limits = _json(HERE, "limits", name + ".json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if ((name in m["workloads"]) if "workloads" in m else (m["moves"] in moved))]
    return dict(cell=cell, config=config, traffic=traffic, limits=limits, e2e=e2e, per_layer=per_layer)


def reader(metric: str):
    """The ``read(ctx)`` of ``perfbench/metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference_rule(compute_type: str):
    """The quantization rule the reference reruns for a compute type."""
    if compute_type == "int4":
        return "int4"
    return "int8" if compute_type.startswith("int8") else None


def build_model(config: dict, seed: int, device, compute_type: str = None):
    import torch

    from faster_whisper_tpu_torch.bpe import BPETokenizer
    from faster_whisper_tpu_torch.models.config import config_from_dims
    from faster_whisper_tpu_torch.transcribe import WhisperModel
    from perfbench import inputs

    dm = inputs.dims_of(config)
    wcfg = config_from_dims(dm.n_mels, dm.d, dm.heads, dm.enc_layers, dm.d, dm.heads, dm.dec_layers,
                            dm.vocab, name=config["name"])
    tok = BPETokenizer.from_str(json.dumps(inputs.tokenizer_spec(dm.vocab)))
    params = inputs.draw_weights(dm, seed, device)
    model = WhisperModel.from_parts(params, wcfg, tok, compute_type=compute_type or config["compute_type"],
                                    device=device)
    del params
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return model, dm


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except Exception as e:  # the line is informative only
        return f"nvidia-smi: {e!r}"


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", bench: dict = None,
        check_chips: bool = True, hooks: dict = None, log=None, compute_type: str = None,
        controls=()) -> dict:
    """One run; returns the result object. ``device="cpu"`` with
    ``check_chips=False`` drives the whole run on the host (tests);
    ``hooks`` may break the program underneath (``after_build(model)``).
    The controls (``control.py``): ``compute_type`` runs the program at
    another compute type than the configuration's, judged as the
    configuration's; ``controls`` also reads the reference at each of these
    precisions in the program's place, into ``result["readings"]``."""
    import numpy as np
    import torch

    from perfbench import drivers, inputs, judge as judging

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = load_cell(workload, bench)
    cell, config, traffic = spec["cell"], spec["config"], spec["traffic"]
    chips = int(cell["chips"])
    if check_chips:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise Refused(2, f"{workload} needs {chips} CUDA device(s), this machine has {have}")
    dev = torch.device(device if device != "cuda" else "cuda:0")

    model, dm = build_model(config, seed, dev, compute_type)
    if hooks and "after_build" in hooks:
        hooks["after_build"](model)
    driver = drivers.DRIVERS[traffic["driver"]](model, traffic, seed)
    driver.warm()
    driver.prepare()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    guard("set-up")
    setup_s = time.perf_counter() - T_START
    log(f"# set-up {setup_s:.3f} s ({workload}, seed {seed})")

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}, "device": {}}
    if not trace:
        window = driver.window(seconds)
    else:
        window = traced(driver, model, dm, config, traffic, spec, result, dev, log)
    guard("the window")

    if dev.type == "cuda":
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        peak, kind, platform = 0, "cpu", "cpu"
    result["device"] = dict({"platform": platform, "kind": kind, "count": chips, "memory_peak_bytes": peak},
                            **result["device"])
    result["attempted"] = len(window.requests)
    result["failed"] = sum(not r.ok for r in window.requests)
    for r in window.requests:
        if r.error:
            log(f"# request {r.index} failed: {r.error}")
    if not trace:
        e2e = driver.end_to_end(window)
        e2e["setup_s"] = setup_s
        for m in spec["e2e"]:
            value = e2e[m["name"]]
            result["metrics"][m["name"]] = {"value": value if math.isfinite(value) else 1e9, "unit": m["unit"]}
    log(f"# window {window.wall:.3f} s, {result['attempted']} requests, {result['failed']} failed")

    # The reference, once the program is gone.
    sample = driver.sample(window, np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 9]))
    driver.close()
    del driver, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    params = inputs.draw_weights(dm, seed, dev)
    silero = dict(np.load(os.path.join(ROOT, "faster_whisper_tpu_torch", "assets", "silero_vad_v6.npz")))
    judge = judging.Judge(params, dm, inputs.tokenizer_spec(dm.vocab), traffic, silero,
                          reference_rule(config["compute_type"]), controls)
    readings = judge.judge(sample)
    log(f"# reference: {readings['windows']} windows, {readings['served_tokens']} served tokens of "
        f"{len(sample)} requests in {time.perf_counter() - t_ref:.3f} s; {card_line()}")
    limits = spec["limits"]
    for q in controls:
        ctl = {k[len(f"control.{q}."):]: x for k, x in readings.items() if k.startswith(f"control.{q}.")}
        readings[f"control.{q}.correct"] = judging.correct(ctl, limits)
    if controls:
        result["readings"] = readings
    log("# readings: " + ", ".join(f"{k} {readings[k]!r}" for k in sorted(readings)))
    checks = {k: {"value": float(readings[k]), "limit": limit} for k, limit in limits.items()}
    result["correct"] = bool(result["failed"] == 0 and judging.correct(readings, limits))
    result["checks"] = checks
    return result


def traced(driver, model, dm, config, traffic, spec, result, dev, log):
    """The per-layer metrics of one slice: the slice run untraced with the
    Recorder's host clock (the host times, and the wall that the profiler
    would stretch), then the same slice under the profiler (the device's
    side), each metric read by its own file."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import trace as tracing

    plain = tracing.Recorder(model, dm.dec_layers, profile=False)
    plain.install()
    try:
        untraced = driver.slice()
    finally:
        plain.remove()
    rec = tracing.Recorder(model, dm.dec_layers)
    rec.install()
    try:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function("bench.slice"):
                window = driver.slice()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
    finally:
        rec.remove()
    tr = tracing.Trace(tracing.events_of(prof))
    del prof
    ctx = tracing.Context(
        dims=dm, config=config, traffic=traffic, driver=traffic["driver"], trace=tr,
        decodes=plain.decodes, encodes=plain.encodes, range_wall=plain.wall, wall_s=untraced.wall,
        windows=sum(len({s[0] for s in r.segments}) for r in window.requests if r.ok),
        audio_s=sum(r.seconds for r in window.requests if r.ok),
        kv_int8=reference_rule(config["compute_type"]) is not None,
    )
    log(f"# traced slice: {len(window.requests)} requests, {window.wall:.3f} s traced, {untraced.wall:.3f} s "
        f"untraced; {tr.n_device_events} device operations ({tr.by_link} placed by their launch, "
        f"{tr.by_span} by the device's span), {len(tr.launches)} launches, decodes {plain.decodes}")
    for m in spec["per_layer"]:
        value = reader(m["name"])(ctx)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["device"]["busy_s"] = tr.busy_s
    result["device"]["window_s"] = tr.window_s
    result["breakdown"] = tr.breakdown()
    return window


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
        guard("the reference")
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr, flush=True)
        return e.code
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
