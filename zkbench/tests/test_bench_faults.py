"""A run of each cell, the harness's look for a card skipped, with the
timed path broken underneath: `correct` comes out false for each fault
the cell can have (a step that leaves its state unchanged, half of the
batch left out, an answer altered where it is produced; a one-chip cell
has no exchange between chips to leave out), and true without one.

The tree cell runs the program's own tree (its plain versions on the CPU)
at 64 leaves and depth 8.  The prove cell runs its runner on a small
circuit with a closed-form stand-in for the program's prove (the
program's CPU prove takes about 40 s a proof; test_bench_reference holds
that stand-in's points to the program's)."""

import pytest
import torch

import tinycells as T
from zkbench import harness

SEED = 2 ** 31 + 77


class SmallTree(T.TinyBench):
    def config(self, name):
        cfg = super().config(name)
        if name == "tree28":
            cfg.update({"leaves": 64, "tree_depth": 8})
        return cfg


def run_tree(patch=None):
    return harness.run("tree.tree28", SEED, 0.0, False, bench=SmallTree(),
                       device="cpu", require_card=False, patch=patch,
                       log=lambda s: None)


def run_prove(fault):
    def patch(cell):
        T.standin(cell)(fault)
    return harness.run("prove.tier50", SEED, 0.0, False,
                       bench=T.TinyBench(), device="cpu",
                       require_card=False, patch=patch, log=lambda s: None,
                       runner_of=T.tiny_runner)


def tree_fault(monkeypatch, fault):
    from zkpos_tpu_torch.merkle import tree as tm
    if fault == "stale":
        real = tm.AccountTree.build_from_leaves
        calls = {"n": 0}

        def build(self, leaves):
            calls["n"] += 1
            if calls["n"] <= 2:                 # the warm-up builds
                real(self, leaves)
        monkeypatch.setattr(tm.AccountTree, "build_from_leaves", build)
    elif fault == "half":
        real = tm.hash2_mont_sparse

        def half(a, b):
            out = real(a, b)
            out[out.shape[0] // 2:] = 0
            return out
        monkeypatch.setattr(tm, "hash2_mont_sparse", half)
    elif fault == "altered":
        real = tm.AccountTree.build_from_mont_leaves

        def altered(self, cur):
            real(self, cur)
            self.levels[-1] = self.levels[-1].clone()
            self.levels[-1][0, 0] += 1
        monkeypatch.setattr(tm.AccountTree, "build_from_mont_leaves", altered)


def test_tree_sound_run_is_correct():
    torch.set_num_threads(2)
    out = run_tree()
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_tree_fault_is_not_correct(monkeypatch, fault):
    torch.set_num_threads(2)
    tree_fault(monkeypatch, fault)
    out = run_tree()
    assert not out["correct"], out["checks"]


def test_prove_sound_run_is_correct():
    torch.set_num_threads(2)
    out = run_prove(None)
    assert out["correct"] and out["checks"]["proof_points_wrong"]["value"] == 0


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_prove_fault_is_not_correct(fault):
    torch.set_num_threads(2)
    out = run_prove(fault)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1
