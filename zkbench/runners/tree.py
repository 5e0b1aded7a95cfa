"""Full rebuilds of the account tree, back to back: the program's
zkpos_tpu_torch.merkle.tree.AccountTree.build_from_leaves.

Set-up: `leaf_sets` sets of seeded leaves made on the card, and `trees`
tree objects, each built once (the warm-up).  A step of the window
rebuilds every tree object, each over another set than it holds, and
reads each build's root, so a build that left a tree as it was shows.
Then every tree is checked level by level and every root of the window
against the checked root of its leaves (reference/tree_check.py).
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from .. import counts, gen
from ..reference import tree_check


def root_int(tree) -> int:
    return int.from_bytes(tree.root(), "big")


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 cache_dir: str, traced: bool = False):
        from zkpos_tpu_torch.merkle import tree as tree_mod
        self.tree_mod = tree_mod
        self.config, self.traffic = config, traffic
        self.seed, self.dev = seed, torch.device(device)
        self.on_card = self.dev.type == "cuda"
        self.n = config["leaves"]
        self.depth = config["tree_depth"]
        self.builds: List[tuple] = []          # (set, root)
        self.log: List[tuple] = []

    def setup(self) -> Dict[str, float]:
        parts = {}
        t = time.perf_counter()
        self.leaves = [gen.leaves(self.n, gen.sub_seed(self.seed, f"leaves{j}"),
                                  self.dev)
                       for j in range(self.traffic["leaf_sets"])]
        if self.on_card:
            torch.cuda.synchronize(self.dev)
        parts["leaves_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.trees = [self.tree_mod.AccountTree(depth=self.depth,
                                                device=self.dev)
                      for _ in range(self.traffic["trees"])]
        self.holds = []
        for k, tree in enumerate(self.trees):
            j = (k + 1) % len(self.leaves)
            tree.build_from_leaves(self.leaves[j])
            root_int(tree)
            self.holds.append(j)
        if self.on_card:
            torch.cuda.synchronize(self.dev)
        parts["warmup_s"] = time.perf_counter() - t
        return parts

    def step(self) -> None:
        for k, tree in enumerate(self.trees):
            j = (self.holds[k] + 1) % len(self.leaves)
            t = time.perf_counter()
            tree.build_from_leaves(self.leaves[j])
            mid = time.perf_counter()
            root = root_int(tree)
            self.holds[k] = j
            self.builds.append((j, root))
            self.log.append((t, mid, time.perf_counter()))
        if self.on_card:
            torch.cuda.synchronize(self.dev)

    def stage_peak(self) -> int:
        return 0

    def hashes(self) -> int:
        return len(self.builds) * tree_check.hashes_a_build(self.n, self.depth)

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"tree_hashes_per_s": self.hashes() / window_s}

    def spans(self):
        return []

    def host_label(self, t: float) -> str:
        for start, mid, end in self.log:
            if start <= t <= mid:
                return "build"
            if mid < t <= end:
                return "root read"
        return "between builds"

    def work(self) -> Dict[str, dict]:
        device_hashes = sum(tree_check.level_sizes(self.n, self.depth)[1:]
                            [:max(1, (self.n - 1).bit_length())])
        return {"poseidon": counts.poseidon_work(device_hashes
                                                 * len(self.builds))}

    def release(self) -> None:
        pass

    def check(self) -> Dict[str, object]:
        rng = random.Random(gen.sub_seed(self.seed, "sample"))
        sample = self.traffic["sample"]
        leaves_wrong = nodes_wrong = 0
        roots = {}
        notes = {"nodes_checked": 0, "leaves_checked": 0}
        for tree, j in zip(self.trees, self.holds):
            def read(level, pos, tree=tree):
                return [int.from_bytes(b, "big") for b in
                        tree.read_nodes([(level, pos)])[0]]

            def leaf_at(pos, j=j):
                idx = torch.tensor(pos, dtype=torch.long, device=self.dev)
                return gen.leaf_ints(self.leaves[j].index_select(0, idx))
            got = tree_check.check_tree(read, leaf_at, self.n, self.depth,
                                        rng, sample)
            leaves_wrong += got["leaves_wrong"]
            nodes_wrong += got["nodes_wrong"]
            notes["nodes_checked"] += got["nodes_checked"]
            notes["leaves_checked"] += got["leaves_checked"]
            roots[j] = got["root"]
        roots_wrong = sum(root != roots.get(j) for j, root in self.builds)
        return {"numbers": [("leaves_wrong", leaves_wrong, 0),
                            ("nodes_wrong", nodes_wrong, 0),
                            ("roots_wrong", roots_wrong, 0)],
                "attempted": len(self.builds), "failed": roots_wrong,
                "notes": {**notes, "builds": len(self.builds),
                          "leaves": self.n, "depth": self.depth}}


def control(cell: Cell, mode: str):
    """The program with a path of its own switched on: the tree's node
    hash run by the probe kernel k_split in `mode` (probes/
    probe_kernel_split.py: "nofinalsub", the Montgomery product without its
    final conditional subtraction; "noreduce", the product's high half).
    Returns what undoes it."""
    from zkpos_tpu_torch.probes.probe_kernel_split import MODES, split_hash
    if mode not in MODES or mode == "full":
        raise ValueError(f"no control {mode!r} for the tree cell")
    mod, kept = cell.tree_mod, cell.tree_mod.hash2_mont_sparse
    mod.hash2_mont_sparse = lambda a, b: split_hash(mode, a, b)

    def undo():
        mod.hash2_mont_sparse = kept
    return undo
