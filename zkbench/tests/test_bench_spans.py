"""The readers of the program's spans on synthetic records: each keeps the
roots that start inside the traced window, reports nothing without
records (a program without the tracer included), and msm_idle_s.prove
takes the device's gaps inside the MSM stages; zkbench.spancheck's
layout of every span and its cross-checks."""

import sys

import numpy as np
import pytest

from zkbench import counts, harness, manifest, spancheck, spans
from zkbench import trace as tr

NEW = ("gather_s.prove", "zero_digits.prove", "host_syncs.prove",
       "msm_idle_s.prove", "upload_s.prove", "assemble_fixed_s.prove",
       "narrow_levels.tree")


class Records:
    """Records as the program's tracer gives them."""

    def __init__(self):
        self.out, self.next = [], 1

    def add(self, name, start, end, parent=None, device_s=None, attrs=None,
            counts=None, waits=None):
        rid = self.next
        self.next += 1
        root = rid if parent is None else next(
            r["root"] for r in self.out if r["id"] == parent)
        self.out.append({"name": name, "id": rid, "parent": parent,
                         "root": root, "start": start, "end": end,
                         "attrs": attrs or {}, "counts": counts or {},
                         "waits": waits or [], "device_s": device_s})
        return rid


def prove(recs, t, gather=(0.25, 0.05), syncs=24):
    """One prove at host time t: 10 s long; plan_z at [t+2, t+3], msm_a at
    [t+3, t+5]; gathers of the given device seconds; an upload of 0.5 s,
    two fixed products of 0.25 s; two MSMs of 100 entries, 30 and 10 of
    them zero; `syncs` waits in the MSM stages, one of site trace, and one
    in compute_h."""
    root = recs.add("prove", t, t + 10)
    ch = recs.add("compute_h", t, t + 2, root, waits=[["h_degree", 0.1,
                                                      t + 1.9]])
    recs.add("upload", t, t + 0.5, ch)
    recs.add("plan_z", t + 2, t + 3, root,
             waits=[["plan", 0.1, t + 2.9]] * (syncs - 1))
    ma = recs.add("msm_a", t + 3, t + 5, root, waits=[["trace", 0.1, t + 5]])
    for zero in (30, 10):
        m = recs.add("msm", t + 3, t + 5, ma,
                     counts={"entries": 100, "zero_entries": zero})
        for g in gather:
            recs.add("gather", t + 3, t + 4, m, device_s=g / 2,
                     attrs={"entries": 50})
    asm = recs.add("assemble", t + 5, t + 10, root)
    recs.add("fixed", t + 5, t + 5.25, asm)
    recs.add("dependent", t + 5.25, t + 6, asm)
    recs.add("fixed", t + 6, t + 6.25, asm)


def ctx_of(ops, start, end):
    return harness.Context(tr.Summary(ops, start, end), [], {})


@pytest.fixture
def fake(monkeypatch):
    recs = Records()
    monkeypatch.setattr(spans, "program_records", lambda: recs.out)
    return recs


def read(name, ctx):
    return manifest.reader(name).read(ctx)


@pytest.mark.parametrize("name", NEW)
def test_nothing_without_records(fake, name):
    assert read(name, ctx_of([("k", 0.0, 1.0)], 0.0, 100.0)) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_from_a_program_without_the_tracer(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "zkpos_tpu_torch.utils.trace", None)
    assert spans.program_records() == []
    assert read(name, ctx_of([("k", 0.0, 1.0)], 0.0, 100.0)) is None


def test_prove_readers_keep_the_window(fake):
    prove(fake, 0.0, gather=(9.0, 9.0), syncs=3)     # before the window
    prove(fake, 20.0)
    prove(fake, 30.0)
    prove(fake, 95.0, gather=(9.0, 9.0), syncs=3)    # after it
    ctx = ctx_of([("k", 20.0, 21.0)], 20.0, 40.0)
    assert [g[0]["start"] for g in spans.roots(ctx, "prove")] == [20.0, 30.0]
    assert read("gather_s.prove", ctx) == pytest.approx(0.3)
    assert read("zero_digits.prove", ctx) == pytest.approx(20.0)
    # the site trace, and the H degree check outside the MSM stages, left
    # out
    assert read("host_syncs.prove", ctx) == 23
    assert read("upload_s.prove", ctx) == pytest.approx(0.5)
    assert read("assemble_fixed_s.prove", ctx) == pytest.approx(0.5)


def test_gather_without_device_seconds_is_nothing(fake):
    prove(fake, 1.0, gather=(0.1,))
    for r in fake.out:
        if r["name"] == "gather":
            r["device_s"] = None
    assert read("gather_s.prove", ctx_of([], 0.0, 20.0)) is None


def test_msm_idle_on_hand_made_intervals(fake):
    """plan_z [2, 3] and msm_a [3, 5] of each prove: device busy [2.5, 3.5]
    and [4, 4.2] in the first, nothing in the second; busy outside the
    stages does not count."""
    prove(fake, 0.0)
    prove(fake, 10.0)
    ops = [("k", 0.0, 2.2), ("k", 2.5, 3.5), ("k", 4.0, 4.2),
           ("k", 5.0, 9.0)]
    ctx = ctx_of(ops, 0.0, 20.0)
    # idle: [2.2, 2.5], [3.5, 4] and [4.2, 5] in the first prove, all 3 s
    # of the second
    assert read("msm_idle_s.prove", ctx) == pytest.approx((1.6 + 3.0) / 2)
    assert read("msm_idle_s.prove", ctx_of([], 0.0, 20.0)) is None


def test_narrow_levels(fake):
    for t in (0.0, 10.0, 50.0):
        b = fake.add("build", t, t + 5)
        for hashes, secs in ((1 << 20, 8.0), (135168, 1.0), (135167, 0.5),
                             (1, 0.5)):
            fake.add("level", t, t + 1, b, device_s=secs,
                     attrs={"hashes": hashes})
        fake.add("root_read", t + 4, t + 5, b)
    ctx = ctx_of([("k", 0.0, 1.0)], 0.0, 20.0)
    assert len(spans.roots(ctx, "build")) == 2
    assert read("narrow_levels.tree", ctx) == pytest.approx(10.0)


# -- zkbench.spancheck: every span laid out, the cross-checks -----------------

def test_spancheck_lays_out_every_span(fake):
    prove(fake, 0.0)
    prove(fake, 10.0)
    groups = spans.roots(ctx_of([], 0.0, 20.0), "prove")
    out = spancheck.by_name(groups)
    assert out["gather"]["n"] == 4
    assert out["gather"]["device_s"] == pytest.approx(0.3)
    assert out["upload"]["host_s"] == pytest.approx(0.5)
    assert out["upload"]["device_s"] is None
    assert out["dependent"]["host_s"] == pytest.approx(0.75)
    assert spancheck.syncs_by_site(groups) == pytest.approx(
        {"plan": 23, "trace": 1, "h_degree": 1})


def test_spancheck_gather_against_the_profiler(fake):
    """Each prove's gather spans hold 0.3 device seconds; the profiler's
    gather kernels inside the MSM stages ([t+2, t+5]) are compared, those
    outside them (the NTT's) are not."""
    prove(fake, 0.0)
    prove(fake, 10.0)
    groups = spans.roots(ctx_of([], 0.0, 20.0), "prove")
    ops = [("vectorized_gather_kernel", 3.5, 3.8),
           ("vectorized_gather_kernel", 13.5, 13.79),
           ("vectorized_gather_kernel", 0.5, 0.9),
           ("k_seg_sums_g1", 4.0, 4.5)]
    got = spancheck.gather_check(groups, ops)
    assert got["ok"] and got["profiler_s"] == pytest.approx(0.59)
    ops[1] = ("vectorized_gather_kernel", 13.5, 13.9)
    assert not spancheck.gather_check(groups, ops)["ok"]


def test_spancheck_syncs_and_names(fake):
    prove(fake, 0.0)
    prove(fake, 10.0)
    groups = spans.roots(ctx_of([], 0.0, 20.0), "prove")
    assert spancheck.syncs_check(groups) == {"check": "host_syncs",
                                             "each": [23], "ok": True}
    prove(fake, 20.0, syncs=3)
    groups = spans.roots(ctx_of([], 0.0, 30.0), "prove")
    assert spancheck.syncs_check(groups)["each"] == [2, 23]
    assert not spancheck.syncs_check(groups)["ok"]
    clean = tr.Summary([("k_sparse3", 1.0, 2.0)], 0.0, 30.0)
    assert spancheck.names_check(groups, clean)["ok"]
    named = tr.Summary([("gather", 1.0, 2.0)], 0.0, 30.0)
    assert spancheck.names_check(groups, named)["found"] == ["gather"]


def test_spancheck_zero_entries_against_the_witness(fake):
    """Two batches of 40 scalars: each witness MSM's non-zero entries are
    counts.py's non-zero digits (K without the 3 public inputs), its
    entries W x Np (16 x 64 at 16-bit windows, 22 x 64 at 12)."""
    rng = np.random.default_rng(3)
    witness = [rng.integers(0, 2 ** 63, size=(40, 4), dtype=np.uint64)
                for _ in range(2)]
    for z in witness:
        z[::3] = 0
        z[1::3, 1:] = 0
    npub = 3

    def msm_counts(z, c):
        entries = -(-254 // c) * 64
        return {"entries": entries,
                "zero_entries": entries - counts.bucket_adds(z, c)["digits"]}
    for t, batch in ((0.0, 1), (10.0, 0)):
        z = witness[batch]
        root = fake.add("prove", t, t + 10)
        for stage, zz, c in (("msm_a", z, 16), ("msm_b1", z, 16),
                             ("msm_b2", z, 12), ("msm_k", z[npub:], 16)):
            st = fake.add(stage, t, t + 1, root)
            fake.add("msm", t, t + 1, st, counts=msm_counts(zz, c))
    groups = spans.roots(ctx_of([], 0.0, 20.0), "prove")
    got = spancheck.zero_check(groups, [1, 0], witness, npub)
    assert got["ok"] and got["rows"] == 8 and got["wrong"] == []
    assert not spancheck.zero_check(groups, [0, 1], witness, npub)["ok"]
    assert not spancheck.zero_check(groups, [1], witness, npub)["ok"]
    fake.out[-1]["counts"]["zero_entries"] += 1
    assert not spancheck.zero_check(groups, [1, 0], witness, npub)["ok"]


def test_spancheck_levels_against_k_sparse3(fake):
    b = fake.add("build", 0.0, 5.0)
    for secs in (2.0, 1.0, 0.002):
        fake.add("level", 0.0, 1.0, b, device_s=secs)
    groups = spans.roots(ctx_of([], 0.0, 20.0), "build")
    ops = [("k_sparse3", 0.0, 3.01), ("k_binary", 3.5, 4.0)]
    assert spancheck.level_check(groups, tr.Summary(ops, 0.0, 20.0))["ok"]
    ops[0] = ("k_sparse3", 0.0, 3.2)
    assert not spancheck.level_check(groups, tr.Summary(ops, 0.0, 20.0))["ok"]


def test_spancheck_main_reports_a_prove(fake, monkeypatch, tmp_path, capsys):
    """main() over a run's summary and cell (here synthetic): the layout,
    the chunks of each MSM stage, the four checks, exit 0 when all pass."""
    import json
    import types
    prove(fake, 0.0)
    prove(fake, 10.0)
    for r in fake.out:
        if r["name"] == "msm":
            r["attrs"] = {"chunks": 2, "columns": 64}
    ops = [("vectorized_gather_kernel", 3.5, 3.8),
           ("vectorized_gather_kernel", 13.5, 13.8)]
    summary = tr.Summary(ops, 0.0, 20.0)
    cell = types.SimpleNamespace(proofs=[(0,), (0,)], z=[None], meta=(0, 0, 0))
    out = {"correct": True, "metrics": {}, "device": {}}
    monkeypatch.setattr(spancheck, "traced_run",
                        lambda *a: (out, summary, cell))
    monkeypatch.setattr(harness, "card_line", lambda: "card")
    # the cache directories `python3 -m zkbench` sets: left as they are
    monkeypatch.setitem(sys.modules, "zkbench.__main__",
                        types.ModuleType("zkbench.__main__"))
    monkeypatch.setattr(spancheck, "zero_check",
                        lambda *a: {"check": "zero_entries", "ok": True})
    path = tmp_path / "x.json"
    rc = spancheck.main(["--workload", "prove.tier50", "--seed", "1",
                         "--out", str(path)])
    res = json.loads(path.read_text())
    assert json.loads(capsys.readouterr().out) == res
    assert rc == 0 and res["roots"] == 2 and res["proofs"] == 2
    assert res["msm_chunks"]["msm_a"] == [[2, 64]]
    assert [c["check"] for c in res["checks"]] == [
        "span_names", "gather", "host_syncs", "zero_entries"]
    assert res["spans"]["fixed"]["n"] == 2
    out["correct"] = False
    assert spancheck.main(["--workload", "prove.tier50", "--seed", "1"]) == 1
