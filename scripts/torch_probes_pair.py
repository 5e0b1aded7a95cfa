"""The probes path and the production scans of two checkouts, in turns on
one card: the parent commit (unpacked with ``git archive`` into a directory
that .gitignore lists), then this checkout twice, then the parent again.

    python scripts/torch_probes_pair.py --parent DIR [--log FILE]

1. Builds both checkouts' kernel libraries, one process each, side by side.
2. Each turn runs, in that checkout and with its own package:
   * ``python -m zkpos_tpu_torch.probes``: each probe's seconds (its timed
     launches and its checks) and their sum, the probes path's time;
   * this script with ``--scans``: ``ec.seg_sums`` and ``ec.seg_scan`` on
     G1 and G2 streams of the prove path's sizes and segment means (the
     probes' streams), each the mean of REPS launches by CUDA events after a
     warm-up, with its kernel's ptxas figures, a digest of its SASS
     (cuobjdump) and a digest of its output's affine values; and a digest
     of each weights-first chain's output (probe_dot, both routes, both
     kinds, on the probe's inputs).
3. Prints one JSON line a turn, then one line that pairs the two checkouts
   (the probes path's seconds and each scan's ms, by turn; whether the
   scans' SASS and values are the same; whether each chain's output is
   the same bit for bit, which is reported and not required), then the
   card's name and power limit.  The probes' own lines go to FILE (default probes_pair.jsonl
   in the working directory).

Exits 2 without a card, 1 if a probe of either checkout disagrees with its
plain version or the two checkouts' scans differ in SASS or in value.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5
# kernel: (object, mangled-name pattern, curve, seg_sums or seg_scan)
SCANS = {"seg_sums_g1": ("seg_scan.cu.o", "k_seg_sums_g1", "g1", "seg_sums"),
         "seg_scan_g1": ("seg_scan.cu.o", "k_seg_scan_g1", "g1", "seg_scan"),
         "seg_sums_g2": ("seg_scan_g2.cu.o", "k_seg_sums_g2", "g2",
                         "seg_sums"),
         "seg_scan_g2": ("seg_scan_g2.cu.o", "k_seg_scan_g2", "g2",
                         "seg_scan")}


def _sass(obj: str, pattern: str, tool: str) -> str:
    """sha256 of the SASS of the kernel in `obj` whose name holds
    `pattern`, its lines without their addresses."""
    text = subprocess.run([tool, "-sass", obj], capture_output=True,
                          text=True, check=True).stdout
    body, cur = [], False
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = pattern in m.group(1)
            continue
        if cur:
            body.append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    return hashlib.sha256("\n".join(body).encode()).hexdigest()[:16]


def scans() -> dict:
    """The production scans in this process's package (the --scans child)."""
    import torch
    from zkpos_tpu_torch.ops import ec
    from zkpos_tpu_torch.probes import probe_segscan as ps
    from zkpos_tpu_torch.probes.common import kernel_resources, time_ms
    from zkpos_tpu_torch.utils import build
    objs = build.cuda_objects_dir()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for curve in ("g1", "g2"):
        pts, heads = ps.stream(curve, ps.STREAMS[curve],
                               ps.SEGMENT_MEAN[curve], 21 + ps._na(curve),
                               "cuda")
        for name, (obj, pat, c, fn) in SCANS.items():
            if c != curve:
                continue
            f = getattr(ec, fn)
            ms = time_ms(lambda: f(pts, heads), "cuda", reps=REPS)
            h = hashlib.sha256()
            res = f(pts, heads)
            for i in range(0, res.shape[0], 1 << 22):
                for t in ec.canonical(res[i:i + (1 << 22)].contiguous()):
                    h.update(t.cpu().numpy().tobytes())
            del res
            out[name] = {"ms": round(ms, 4), "n": pts.shape[0],
                         "ptxas": next(iter(kernel_resources(pat).values()),
                                       None),
                         "sass": _sass(os.path.join(objs, obj), pat, tool),
                         "value": h.hexdigest()[:16]}
        del pts, heads
        torch.cuda.empty_cache()
    from zkpos_tpu_torch.probes import probe_dot as pd
    w, x = pd.inputs(pd.N, 0, "cuda")
    for kind in pd.KINDS:
        for route in pd.ROUTES:
            y = pd.chain(kind, route, w, x)
            out[f"dot_{kind}_{route}"] = {"value": hashlib.sha256(
                y.cpu().numpy().tobytes()).hexdigest()[:16]}
    return out


def _run(tree: str, args: list, timeout: int) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=tree)
    return subprocess.run([sys.executable, *args], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout of the parent commit")
    ap.add_argument("--scans", action="store_true",
                    help="child: time this checkout's production scans")
    ap.add_argument("--log", default="probes_pair.jsonl")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    if args.scans:
        print(json.dumps(scans()), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent DIR is required")
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    built = {}

    def build(name):
        t0 = time.time()
        p = _run(trees[name], ["-c", "from zkpos_tpu_torch.utils import "
                               "build; build.cuda_lib()"], 1200)
        built[name] = (p.returncode, round(time.time() - t0, 1), p.stdout
                       + p.stderr)
    threads = [threading.Thread(target=build, args=(n,)) for n in trees]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name, (rc, secs, text) in built.items():
        print(json.dumps({"build": name, "rc": rc, "seconds": secs}),
              flush=True)
        if rc:
            print(text[-4000:], file=sys.stderr)
            return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    ok, turns = True, []
    me = os.path.abspath(__file__)
    with open(args.log, "w") as log:
        for name in ("parent", "change", "change", "parent"):
            p = _run(trees[name], ["-m", "zkpos_tpu_torch.probes"], 1200)
            lines = [json.loads(x) for x in p.stdout.splitlines()
                     if x.startswith("{")]
            for x in lines:
                log.write(json.dumps(dict(x, tree=name)) + "\n")
            ok = ok and p.returncode == 0
            q = _run(trees[name], [me, "--scans"], 1200)
            ok = ok and q.returncode == 0
            sc = json.loads(q.stdout.splitlines()[-1]) if q.returncode == 0 \
                else {}
            if p.returncode or q.returncode:
                print((p.stderr + q.stderr)[-4000:], file=sys.stderr)
            turn = {"tree": name, "probes_rc": p.returncode,
                    "probes_path_s": round(sum(x["seconds"]
                                               for x in lines), 3),
                    "probe_s": {x["probe"]: x["seconds"] for x in lines},
                    "scans": sc}
            turns.append(turn)
            print(json.dumps(turn), flush=True)
    pair = {"probes_path_s": {t["tree"]: [] for t in turns}}
    for t in turns:
        pair["probes_path_s"][t["tree"]].append(t["probes_path_s"])
    for k in SCANS:
        got = [t["scans"].get(k, {}) for t in turns]
        pair[k] = {"ms": {t["tree"]: [g.get("ms") for g, u in zip(got, turns)
                                      if u["tree"] == t["tree"]]
                          for t in turns},
                   "same_sass": len({g.get("sass") for g in got}) == 1,
                   "same_value": len({g.get("value") for g in got}) == 1,
                   "ptxas": {t["tree"]: g.get("ptxas")
                             for g, t in zip(got, turns)}}
        ok = ok and pair[k]["same_sass"] and pair[k]["same_value"]
    for k in (f"dot_{kind}_{route}" for kind in ("dot", "mix")
              for route in ("ffma", "tf32")):
        pair[k] = {"same_value": len({t["scans"].get(k, {}).get("value")
                                      for t in turns}) == 1}
    print(json.dumps({"pair": pair}), flush=True)
    sys.path.insert(0, HERE)
    from zkpos_tpu_torch.probes.common import smi
    print(smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
