"""The controls of a cell's comparison, read on a short run of the cell at
its own size, one seed after another in one process. Each prints one JSON
line per seed: the program's numbers, whether they are ``correct``, and
each control's numbers (``control.<precision>.*``) with whether they come
out correct by the same limits.

    python3 perfbench/control.py --workload <name> --seeds 11,12,13 --seconds 5 \\
        [--compute-type int8] [--reference fp8,int8]

``--compute-type`` runs the program at its own lower-precision path in
place of the configuration's (judged as the configuration's: the control
that the program has itself); ``--reference`` puts the reference at each
precision named in the program's place, at the positions of the
program's own tokens. The benchmark's own runs do not run it; its
readings set the limits in ``perfbench/limits/`` (``PERF.md`` lists them).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--compute-type", default=None)
    ap.add_argument("--reference", default="")
    args = ap.parse_args(argv)
    controls = [q for q in args.reference.split(",") if q]
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            result = bench_run.run(args.workload, seed, args.seconds, False, compute_type=args.compute_type,
                                   controls=controls)
        except bench_run.Refused as e:
            print(f"control: {e}", file=sys.stderr)
            return e.code
        print(json.dumps({"workload": args.workload, "seed": seed, "compute_type": args.compute_type,
                          "correct": result["correct"], "audio_s_per_s": result["metrics"]["audio_s_per_s"],
                          "readings": result.get("readings"), "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
