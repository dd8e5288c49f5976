"""Readings for the limits of a cell's comparison, on the card, at the
cell's own size: the program's own, its control's, and those of planted
faults.  The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds <n>,<n>,... --seconds <s> \
        [--what program|control|float32|fault:<name>]

runs the cell once a seed in one process (set-up, a window of ``--seconds``
at the cell's own load, as ``run.py``; at least the checked frame) and
prints one JSON line a seed: each number compared with its committed limit
(``limits/<cell>.json``), and whether the run would be correct.

  * ``program``: the program, as the benchmark runs it (the lower readings);
  * ``control`` (the default): the plain reference at the precision below
    the configuration's in the program's place, from the same inputs and
    start states: bfloat16 for the scene cells, TF32 convolutions for the
    material cell (the upper readings); ``float32`` reads the reference's
    own float32 rounding beside it;
  * ``fault:<name>``: the program with the driver's fault of that name
    planted in the window (``drivers/<driver>.py`` FAULTS), which has to
    come out as not correct.
"""

import json
import os
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import argparse

    from benchmark import harness

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--what", default="control")
    args = ap.parse_args()
    os.environ.update(harness.cache_env())
    spec = harness.load_spec()
    driver = harness.resolve(spec, args.workload)["traffic"]["driver"]
    control = fault = None
    if args.what.startswith("fault:"):
        fault = args.what.split(":", 1)[1]
    elif args.what == "control":
        control = {"mpm_rollout": "bfloat16", "unet_material": "tf32"}[driver]
    elif args.what != "program":
        control = args.what
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(args.workload, seed, args.seconds, False, "cuda:0", t0, spec,
                               control=control, fault=fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "what": args.what,
                          "correct": res["correct"], "run_s": time.perf_counter() - t0,
                          "unit_s": res["unit_s"], "checks": res["checks"]}), flush=True)
