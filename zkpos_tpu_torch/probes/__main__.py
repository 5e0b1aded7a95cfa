"""Run every probe on the card and print one JSON line per probe with the
card's name and power limit:

  python -m zkpos_tpu_torch.probes

Exits 2 without a CUDA device: the probes measure the card, and a CPU run
is no measurement of it.
"""

import json
import sys
import time

import torch

from . import PROBES, run_probe
from .common import smi


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    card = smi()
    ok = True
    for name, mod in PROBES:
        t0 = time.time()
        rows, _ = run_probe(mod, "cuda",
                            log=lambda *a: print(*a, file=sys.stderr))
        ok = ok and all(r["ok"] for r in rows)
        print(json.dumps({"probe": name, "card": card,
                          "seconds": round(time.time() - t0, 3),
                          "rows": rows}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
