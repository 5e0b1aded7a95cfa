"""The tree cell's reference: a depth-D Poseidon tree over the benchmark's
leaves, checked level by level.

A full plain rebuild of 2^27 leaves would take minutes, so the check
follows the program's own levels: the leaves it holds against the
benchmark's, and at every level up to the root a sample of nodes (every
node where a level has no more than `sample`), each against the host
Poseidon of its two children as the program holds them, positions past
the populated ones read as the reference's own empty-subtree hashes.  The
sample is drawn from the run's seed.  The root of every build in the
window is then held against the checked root of its leaves.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List

from .host import R, hash2, permutation


def nil_hashes(depth: int) -> List[int]:
    """nil[k]: the hash of an empty subtree of 2^k leaves; the empty leaf
    is Poseidon(0, 0, 0, 0, 0)."""
    out = [permutation([0] * 6)[1]]
    for _ in range(depth):
        out.append(hash2(out[-1], out[-1]))
    return out


def level_sizes(n: int, depth: int) -> List[int]:
    """Populated nodes a level, leaves first, root last."""
    sizes = [n]
    for _ in range(depth):
        sizes.append(-(-sizes[-1] // 2))
    return sizes


def hashes_a_build(n: int, depth: int) -> int:
    """Node hashes a build computes: every node above the leaves that has
    a populated leaf below it."""
    return sum(level_sizes(n, depth)[1:])


def check_tree(read: Callable, leaf_at: Callable, n: int, depth: int,
               rng: random.Random, sample: int) -> Dict[str, object]:
    """`read(level, positions)` -> the program's nodes as ints (standard
    form); `leaf_at(positions)` -> the benchmark's leaves there.  Returns
    the wrong leaves, the wrong nodes, the nodes checked and the root."""
    sizes = level_sizes(n, depth)
    nil = nil_hashes(depth)

    def pick(k: int) -> List[int]:
        if sizes[k] <= sample:
            return list(range(sizes[k]))
        return sorted({0, sizes[k] - 1,
                       *rng.sample(range(sizes[k]), sample - 2)})

    pos0 = pick(0)
    leaves_wrong = sum(a != b % R for a, b in zip(read(0, pos0),
                                                  leaf_at(pos0)))
    nodes_wrong = checked = 0
    for k in range(1, depth + 1):
        pos = pick(k)
        kids = [q for p in pos for q in (2 * p, 2 * p + 1)]
        have = [q for q in kids if q < sizes[k - 1]]
        got = dict(zip(have, read(k - 1, have)))
        nodes = read(k, pos)
        for i, p in enumerate(pos):
            left = got.get(2 * p, nil[k - 1])
            right = got.get(2 * p + 1, nil[k - 1])
            nodes_wrong += nodes[i] != hash2(left, right)
            checked += 1
    return {"leaves_wrong": leaves_wrong, "nodes_wrong": nodes_wrong,
            "nodes_checked": checked, "leaves_checked": len(pos0),
            "root": read(depth, [0])[0]}
