"""One traced run of a cell, with every span of the program laid out and
the span metrics checked against the profiler and the witness.

  python3 -m zkbench.spancheck --workload prove.tier50 --seed N
      [--seconds 30] [--out FILE]

Prints one JSON object (and writes it to FILE): the result line's
`correct`, metrics and device; for each span name, its count, host
seconds and device seconds a root (a prove or a build), which is where the
spans no metric reads (`plan`, `base_upload`, `chunk`, `sums`, `carry`,
`fold`, `horner`, `readback`, `csr_eval`, `ntt`, `dependent`, `root_read`)
are read; the host syncs a prove by site; each MSM stage's chunks and
columns; and the cross-checks, each with its reading and limit:

- `gather`: the `gather` spans' device seconds against the profiler's
  gather kernels inside the MSM stages, within 5 %;
- `host_syncs`: host_syncs.prove the same in every prove;
- `zero_entries`: each witness MSM's (A, B1, B2, K) non-zero entries equal
  to counts.py's non-zero digits of its scalars, and its entries W x Np;
- `level`: the `level` spans' device seconds against k_sparse3's, within
  2 %;
- `span_names`: no span name among the profiler's device operations.

Exits 1 when a check fails or the run is not correct.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import Dict, List

from zkbench import counts, harness, manifest, spans
from zkbench import trace as tr

PAD_QUANTUM = 32                 # ops/msm_device.py: the stream's columns
GATHER = ("gather", "indexSelect")
WITNESS_MSMS = {"msm_a": "g1", "msm_b1": "g1", "msm_b2": "g2", "msm_k": "g1"}


def by_name(groups: List[List[Dict]]) -> Dict[str, Dict]:
    """For each span name: its count, host seconds and device seconds (None
    when a span of the name has none), each a root."""
    out: Dict[str, Dict] = {}
    for g in groups:
        for r in g:
            e = out.setdefault(r["name"], {"n": 0, "host_s": 0.0,
                                           "device_s": 0.0})
            e["n"] += 1
            e["host_s"] += r["end"] - r["start"]
            if e["device_s"] is not None:
                e["device_s"] = (None if r["device_s"] is None
                                 else e["device_s"] + r["device_s"])
    for e in out.values():
        for k in e:
            if e[k] is not None:
                e[k] /= len(groups)
    return out


def syncs_by_site(groups: List[List[Dict]]) -> Dict[str, float]:
    """The host syncs a root by site (`trace` included)."""
    out: Dict[str, float] = {}
    for g in groups:
        for r in g:
            for w in r["waits"]:
                out[w[0]] = out.get(w[0], 0) + 1 / len(groups)
    return out


def stage_intervals(groups, stages=spans.MSM_STAGES) -> List[tuple]:
    return [(r["start"], r["end"]) for g in groups for r in g
            if r["parent"] == g[0]["id"] and r["name"] in stages]


def gather_check(groups, ops) -> Dict:
    """The gather spans' device seconds against the device seconds of the
    gather kernels that start inside the MSM stages."""
    iv = stage_intervals(groups)
    ops_s = sum(b - a for n, a, b in ops
                if any(p in n for p in GATHER)
                and any(x <= a <= y for x, y in iv))
    span_s = spans.device_seconds(spans.named(groups, "gather"))
    return _within("gather", span_s, ops_s, 0.05)


def level_check(groups, summary) -> Dict:
    return _within("level", spans.device_seconds(spans.named(groups,
                                                             "level")),
                   summary.seconds_of(["k_sparse3"]), 0.02)


def _within(name, got, want, limit) -> Dict:
    rel = None if got is None or not want else got / want - 1
    return {"check": name, "spans_s": got, "profiler_s": want,
            "relative": rel, "limit": limit,
            "ok": rel is not None and abs(rel) <= limit}


def syncs_check(groups) -> Dict:
    waits = manifest.reader("host_syncs.prove").waits
    each = [len(waits(g)) for g in groups]
    return {"check": "host_syncs", "each": sorted(set(each)),
            "ok": bool(each) and len(set(each)) == 1}


def zero_check(groups, batches, witness, npub) -> Dict:
    """Each witness MSM's counters against its scalars: entries - the zero
    entries = the non-zero digits (counts.py), entries = W x Np.
    `batches[k]`: the batch of the k-th prove, `witness[i]`: batch i's
    witness as (n, 4) uint64."""
    memo: Dict[tuple, tuple] = {}
    rows = []
    for g, batch in zip(groups, batches):
        by_id = {r["id"]: r for r in g}
        for r in g:
            stage = by_id.get(r["parent"], {}).get("name")
            if r["name"] != "msm" or stage not in WITNESS_MSMS:
                continue
            if (batch, stage) not in memo:
                z = witness[batch][npub:] if stage == "msm_k" \
                    else witness[batch]
                c = counts.WINDOW_BITS[WITNESS_MSMS[stage]]
                W = -(-counts.SCALAR_BITS // c)
                Np = -(-z.shape[0] // PAD_QUANTUM) * PAD_QUANTUM
                memo[batch, stage] = (counts.bucket_adds(z, c)["digits"],
                                      W * Np)
            digits, entries = memo[batch, stage]
            got = r["counts"]
            rows.append([batch, stage,
                         got["entries"] - got["zero_entries"], digits,
                         got["entries"], entries])
    wrong = [x for x in rows if x[2] != x[3] or x[4] != x[5]]
    return {"check": "zero_entries", "proves": len(groups),
            "batches": len(batches), "rows": len(rows), "wrong": wrong,
            "ok": len(groups) == len(batches) and bool(rows) and not wrong}


def names_check(groups, summary) -> Dict:
    names = {r["name"] for g in groups for r in g}
    found = sorted(names & {n for n, _, _ in summary.ops})
    return {"check": "span_names", "found": found, "ok": not found}


def traced_run(workload: str, seed: int, seconds: float):
    """harness.run traced, keeping its window's summary and its cell."""
    kept = {}

    class Keep(tr.Summary):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            kept["summary"] = self

    plain, tr.Summary = tr.Summary, Keep
    try:
        out = harness.run(workload, seed, seconds, True,
                          patch=lambda c: kept.update(cell=c))
    finally:
        tr.Summary = plain
    return out, kept["summary"], kept["cell"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m zkbench.spancheck")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    # the cache directories of `python3 -m zkbench`, set before PyTorch
    # loads
    importlib.import_module("zkbench.__main__")
    out, summary, cell = traced_run(a.workload, a.seed, a.seconds)
    ctx = harness.Context(summary, [], {})
    root = "prove" if hasattr(cell, "proofs") else "build"
    groups = spans.roots(ctx, root)
    res = {"workload": a.workload, "seed": a.seed, "card": harness.card_line(),
           "correct": out["correct"], "metrics": out["metrics"],
           "device": out["device"], "roots": len(groups),
           "spans": by_name(groups), "syncs_by_site": syncs_by_site(groups)}
    checks = [names_check(groups, summary)]
    if root == "prove":
        res["proofs"] = len(cell.proofs)
        res["msm_chunks"] = {
            st: sorted({(r["attrs"]["chunks"], r["attrs"]["columns"])
                        for g in groups for r in g if r["name"] == "msm"
                        and r["parent"] in {s["id"] for s in g
                                            if s["name"] == st}})
            for st in ("msm_a", "msm_b1", "msm_b2", "msm_k", "msm_z")}
        checks += [gather_check(groups, summary.ops), syncs_check(groups),
                   zero_check(groups, [p[0] for p in cell.proofs],
                              cell.z, cell.meta[2])]
    else:
        checks.append(level_check(groups, summary))
    res["checks"] = checks
    ok = out["correct"] and all(c["ok"] for c in checks)
    text = json.dumps(res, default=str)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
