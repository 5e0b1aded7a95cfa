"""Each cell's control comes out as not correct: the prove cell with the
reference in the program's place, its witness MSMs' scalars cut to 240
bits; the tree cell with the program's own probe path k_split in place of
its node hash (noreduce; nofinalsub is read and reported).  At a size the
CPU holds here; at the cell's own size on the card by
`python3 -m zkbench.control` (the card test below)."""

import json
import subprocess
import sys

import pytest
import torch

import tinycells as T
from zkbench import control, manifest

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


class SmallTree(T.TinyBench):
    def config(self, name):
        cfg = super().config(name)
        if name == "tree28":
            cfg.update({"leaves": 64, "tree_depth": 8})
        return cfg


@pytest.mark.parametrize("seed", SEEDS)
def test_prove_control_is_not_correct(seed):
    torch.set_num_threads(2)
    row = control.run_control("prove.tier50", "top_window", seed, 0.0,
                              bench=T.TinyBench(), device="cpu",
                              require_card=False, log=lambda s: None,
                              runner_of=T.tiny_runner)
    assert not row["correct"]
    assert row["checks"]["proof_points_wrong"]["value"] >= 1


def test_tree_control_is_not_correct():
    torch.set_num_threads(2)
    row = control.run_control("tree.tree28", "noreduce", SEEDS[0], 0.0,
                              bench=SmallTree(), device="cpu",
                              require_card=False, log=lambda s: None)
    assert not row["correct"]
    assert row["checks"]["nodes_wrong"]["value"] >= 1


def test_controls_leave_the_program_as_it_was():
    from zkpos_tpu_torch.merkle import tree as tm
    before = tm.hash2_mont_sparse
    control.run_control("tree.tree28", "noreduce", SEEDS[1], 0.0,
                        bench=SmallTree(), device="cpu", require_card=False,
                        log=lambda s: None)
    assert tm.hash2_mont_sparse is before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")


@pytest.mark.card
@pytest.mark.parametrize("cell,mode", [("tree.tree28", "noreduce"),
                                       ("prove.tier50", "top_window")])
def test_control_at_the_cells_size(card, cell, mode):
    p = subprocess.run([sys.executable, "-m", "zkbench.control",
                        "--workload", cell, "--mode", mode, "--seeds",
                        *map(str, SEEDS), "--seconds", "5"],
                       cwd=manifest.ROOT, capture_output=True, text=True,
                       timeout=3000)
    assert p.returncode == 0, p.stderr[-2000:]
    rows = [json.loads(x) for x in p.stdout.strip().splitlines()]
    assert len(rows) == 3 and not any(r["correct"] for r in rows)
