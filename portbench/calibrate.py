"""The readings a cell's limits are set from, for several seeds in one
process (on the card; not run by the benchmark's own runs).

    python portbench/calibrate.py --workload <name> --seeds 11,12,13 [--out file.json]

For each seed the driver's ``calibrate`` gives the program's reading of
every number the cell compares and the control's (the plain reference
computed in TF32, the precision below the configuration's float32 with
TF32 off, put in the program's place), and, for a training cell, the
readings of planted faults. ``PERF.md`` gives the limits set from them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.run import set_host_threads, set_precision  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload, cfg, traffic, limits = harness.cell_files(ROOT, bench, args.workload)
    set_host_threads(traffic["host_threads"])
    set_precision()
    readings = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(workload, cfg, traffic, limits, seed, 0.0, False, "cuda")
        readings[seed] = harness.driver(traffic).calibrate(run)
        print(json.dumps({"seed": seed, **readings[seed]}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
