"""The port's tracer (zkpos_tpu_torch/utils/trace.py) on the CPU: nothing
recorded while it is off, spans, parents, roots, counters and host syncs
while it is on, its switches (a profiler session, capture(), ZKPOS_TRACE),
the bound on its store, and the spans of a tree build and the counts of a
scalar plan."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from zkpos_tpu_torch.merkle.tree import AccountTree
from zkpos_tpu_torch.ops import msm_device as md
from zkpos_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _of_root(recs, root_id):
    return [r for r in recs if r["root"] == root_id]


def test_off_records_nothing_and_makes_no_event(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event while tracing is off")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    t = trace.Tracer()
    assert not t.enabled()
    with t.span("prove", device=torch.device("cuda"), n=1) as sp:
        assert sp is trace.OFF
        sp.set(x=2)
        t.count("entries", 5)
        with t.span("gather", device=torch.device("cuda")) as inner:
            assert inner is trace.OFF
        with t.wait("plan") as w:
            assert w is trace.OFF
    assert t.records() == []


def test_nesting_parents_and_roots():
    t = trace.Tracer()
    with t.capture():
        with t.span("prove") as a:
            with t.span("msm_a"):
                with t.span("gather", entries=7):
                    pass
            with t.span("msm_b1"):
                pass
        with t.span("build"):
            pass
    assert not t.enabled()
    recs = t.records()
    names = [r["name"] for r in recs]
    assert names == ["prove", "msm_a", "gather", "msm_b1", "build"]
    by = {r["name"]: r for r in recs}
    root = by["prove"]["id"]
    assert by["prove"]["parent"] is None and by["prove"]["root"] == root
    assert by["msm_a"]["parent"] == root
    assert by["gather"]["parent"] == by["msm_a"]["id"]
    assert by["msm_b1"]["parent"] == root
    assert {by[n]["root"] for n in ("msm_a", "gather", "msm_b1")} == {root}
    assert by["build"]["root"] == by["build"]["id"] != root
    assert by["gather"]["attrs"] == {"entries": 7}
    assert by["gather"]["device_s"] is None          # no card
    for r in recs:
        assert r["start"] <= r["end"]
    assert by["prove"]["start"] <= by["msm_a"]["start"]
    assert by["msm_b1"]["end"] <= by["prove"]["end"]
    assert a.seconds == by["prove"]["end"] - by["prove"]["start"]


def test_counters_and_waits():
    t = trace.Tracer()
    with t.capture(), t.span("msm") as sp:
        t.count("entries", 10)
        t.count("entries", 5)
        t.count("chunks")
        with t.span("chunk"):
            t.count("entries", 1)
            with t.wait("seg_sums"):
                pass
        with t.wait("readback"):
            pass
        sp.set(chunks=1, columns=32)
    msm, chunk = t.records()
    assert msm["counts"] == {"entries": 15, "chunks": 1}
    assert chunk["counts"] == {"entries": 1}
    assert [w[0] for w in msm["waits"]] == ["readback"]
    assert [w[0] for w in chunk["waits"]] == ["seg_sums"]
    site, blocked, at = msm["waits"][0]
    assert blocked >= 0 and msm["start"] <= at <= msm["end"]
    assert msm["attrs"] == {"chunks": 1, "columns": 32}
    # with no span open, a count or a wait goes nowhere
    t.count("entries")
    with t.wait("plan"):
        pass
    assert len(t.records()) == 2


def test_on_while_a_profiler_records():
    t = trace.Tracer()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        assert t.enabled()
        with t.span("build"):
            pass
    assert not t.enabled()
    with t.span("build"):
        pass
    assert [r["name"] for r in t.records()] == ["build"]


def test_env_export_to_a_file(tmp_path):
    path = tmp_path / "spans.jsonl"
    code = ("from zkpos_tpu_torch.utils import trace\n"
            "with trace.span('build', leaves=4):\n"
            "    with trace.span('level', hashes=2):\n"
            "        trace.count('n', 3)\n")
    env = dict(os.environ, ZKPOS_TRACE=str(path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["name"] for r in lines] == ["build", "level"]
    assert lines[1]["parent"] == lines[0]["id"] == lines[1]["root"]
    assert lines[1]["attrs"] == {"hashes": 2}
    assert lines[1]["counts"] == {"n": 3}


def test_store_keeps_the_last_roots():
    t = trace.Tracer()
    with t.capture():
        for i in range(trace.KEEP_ROOTS + 6):
            with t.span("build", i=i):
                with t.span("level"):
                    pass
    recs = t.records()
    roots = [r for r in recs if r["parent"] is None]
    assert len(roots) == trace.KEEP_ROOTS
    assert roots[0]["attrs"]["i"] == 6
    assert len(recs) == 2 * trace.KEEP_ROOTS


def test_tree_levels_carry_their_hashes():
    tree = AccountTree(depth=4, device="cpu")
    with trace.capture():
        tree.build_from_leaf_ints(list(range(1, 17)))
    recs = trace.records()
    build = [r for r in recs if r["name"] == "build"][-1]
    mine = _of_root(recs, build["id"])
    assert build["attrs"] == {}
    assert [r["attrs"]["hashes"] for r in mine
            if r["name"] == "level"] == [8, 4, 2, 1]
    assert [r["name"] for r in mine][-1] == "root_read"


def test_scalar_plan_zero_entries():
    rng = np.random.default_rng(5)
    n, c = 70, 8
    rows = rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint64)
    rows[:, 7] &= 0x0FFFFFFF                 # below 2^252 < r
    rows[::4] = 0                            # whole zero scalars
    rows[1::4, 1:] = 0                       # scalars of one limb
    sc = torch.from_numpy(rows.astype(np.uint32).view(np.int32))
    with trace.capture():
        plan = md.ScalarPlan(sc, c=c)
    W = md.windows_count(c)
    ints = [int.from_bytes(r.astype("<u4").tobytes(), "little")
            for r in rows]
    zero = sum(((v >> (c * w)) & ((1 << c) - 1)) == 0
               for v in ints for w in range(W))
    pad = (plan.Np - n) * W
    assert plan.entries == W * plan.Np
    assert plan.zero_entries == zero + pad
    assert sum(plan.nonzero) == W * n - zero
    assert plan.K == max(plan.nonzero)
    rec = [r for r in trace.records() if r["name"] == "plan"][-1]
    assert [w[0] for w in rec["waits"]] == ["plan"]
    assert rec["attrs"] == {}


def test_msm_spans_and_counts_on_the_cpu():
    """A two-chunk MSM: the msm span's counts and chunks, a gather and a
    sums span a chunk, a carry in the second, then fold, horner and
    readback; its host syncs by site."""
    from zkpos_tpu_torch.crypto import bn254 as bn
    pts = [bn.g1_mul(bn.G1_GEN, k + 2) for k in range(40)]
    base = md.device_base("g1", pts, "cpu")
    rng = np.random.default_rng(1)
    sc = torch.from_numpy(rng.integers(0, 2 ** 8, size=(40, 8))
                          .astype(np.int32))
    sc[:, 1:] = 0
    plan = md.ScalarPlan(sc, c=8, windows=2, chunk=32)
    with trace.capture(), trace.span("msm_a") as stage:
        got = md.msm("g1", base, plan=plan)
    want = None
    for p, k in zip(pts, sc[:, 0].tolist()):
        want = bn.g1_add(want, bn.g1_mul(p, k))
    assert got == want
    recs = _of_root(trace.records(), stage.record["id"])
    names = [r["name"] for r in recs]
    assert names == ["msm_a", "msm", "chunk", "gather", "sums", "chunk",
                     "gather", "sums", "carry", "fold", "horner",
                     "readback"]
    msm = recs[1]
    assert msm["attrs"] == {"chunks": 2, "columns": 32}
    assert msm["counts"] == {"entries": plan.entries,
                             "zero_entries": plan.zero_entries}
    assert [r["attrs"]["entries"] for r in recs
            if r["name"] == "gather"] == [32 * plan.W, 32 * plan.W]
    sites = [w[0] for r in recs for w in r["waits"]]
    assert sites == ["nonzero", "nonzero", "readback"]
