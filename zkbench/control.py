"""The controls that show each cell's comparison can fail: a cell run with
its runner's control (runners/<runner>.py ``control``) in the program's
place, and its checks read; with --mode none, the program itself.  The
benchmark's own runs never run this.

  python3 -m zkbench.control --workload <cell> --mode <mode> \\
      --seeds <n> [<n> ...] --seconds <s>

One JSON line a seed: the mode, whether the run came out correct, and
each compared number beside its limit.  Exit 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import harness, manifest


def run_control(workload: str, mode: str, seed: int, seconds: float,
                runner_of=manifest.runner, **kw) -> dict:
    undo = []

    def patch(cell):
        if mode != "none":
            undo.append(runner_of(cell.traffic["runner"]).control(cell, mode))
    try:
        out = harness.run(workload, seed, seconds, False,
                          start=time.perf_counter(), patch=patch,
                          runner_of=runner_of, **kw)
    finally:
        for u in undo:
            u()
    return {"workload": workload, "mode": mode, "seed": seed,
            "correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "checks": out["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m zkbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        try:
            row = run_control(args.workload, args.mode, seed, args.seconds)
        except harness.NoCard as e:
            print(f"zkbench.control: {e}", file=sys.stderr)
            return 2
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
