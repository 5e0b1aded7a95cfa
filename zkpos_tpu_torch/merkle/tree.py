"""Fixed-depth Poseidon Merkle account tree, built level by level on the
card.

Reference parity: src/utils/merkletree/merkletree.go (FixedDepthMerkleTree);
counterpart of zkpos_tpu/merkle/tree.py.  The reference builds dirty nodes
bottom-up with NumCPU goroutines (merkletree.go:199-270); here each level
is one launch of the sparse Poseidon(2) kernel over all node pairs
(ops/poseidon_sparse.py), reading the level below in place.  Levels stay
on the device in Montgomery form.

Only ceil(log2(N)) levels carry real nodes; levels above the populated
subtree are the nil-hash chain (merkletree.go:159-170), folded on the host.

Proof conventions (bit i of key selects sibling order, LSB-first) match
merkletree.go:297-308 and :334-355.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..crypto.bn254 import R as MOD, fr_from_bytes, fr_to_bytes
from ..crypto.poseidon_ref import poseidon
from ..ops import field as F
from ..ops.poseidon_sparse import hash2_mont_sparse
from ..utils import constants as C
from ..utils import trace
from ..utils.constants import nil_account_hash_int
from ..utils.device import resolve


def nil_hashes(depth: int | None = None,
               nil_leaf: int | None = None) -> List[int]:
    """nil_hashes[k] = hash of an empty subtree with 2^k leaves."""
    if depth is None:
        depth = C.ACCOUNT_TREE_DEPTH
    h = nil_account_hash_int() if nil_leaf is None else nil_leaf
    out = [h]
    for _ in range(depth):
        h = poseidon([h, h])
        out.append(h)
    return out


def _rows_to_bytes(rows: torch.Tensor) -> List[bytes]:
    """(K, 8) standard-form limb rows -> 32-byte big-endian encodings."""
    le = rows.contiguous().numpy().view(np.uint8).reshape(-1, 32)
    raw = np.ascontiguousarray(le[:, ::-1]).tobytes()
    return [raw[32 * i:32 * i + 32] for i in range(le.shape[0])]


class AccountTree:
    """Two-phase tree: stage leaves, build (device), read proofs."""

    def __init__(self, depth: int | None = None, capacity: int = 0,
                 nil_leaf: int | None = None, device=None):
        if depth is None:
            depth = C.ACCOUNT_TREE_DEPTH
        if depth > 32 or depth <= 0:
            raise ValueError("depth out of range")
        if capacity > (1 << depth):
            raise ValueError("capacity exceeds maximum for given depth")
        self.depth = depth
        self.capacity = capacity
        self.device = resolve(device)
        self.nils = nil_hashes(depth, nil_leaf)
        # levels[k]: (n_k, 8) int32 Montgomery rows of the populated nodes
        self.levels: List[torch.Tensor] = []

    # -- building -------------------------------------------------------------

    def build_from_leaf_ints(self, leaves: List[int]) -> None:
        self.build_from_leaves(F.ints_to_tensor(leaves, self.device))

    def build_from_leaves(self, leaves: torch.Tensor) -> None:
        """leaves: (N, 8) int32 standard-form rows for leaves 0..N-1."""
        if leaves.shape[0] > (1 << self.depth):
            raise ValueError("too many leaves")
        if leaves.shape[0] == 0:
            self.levels = []
            return
        self.build_from_mont_leaves(
            F.to_mont(leaves.to(self.device).contiguous()))

    def _nil_mont(self, level: int) -> torch.Tensor:
        return F.ints_to_tensor([self.nils[level] * F.RMONT % MOD],
                                self.device)

    def build_from_mont_leaves(self, cur: torch.Tensor) -> None:
        """cur: (N, 8) Montgomery rows on the tree's device; kept as the
        leaf level.  One node-hash launch per populated level.  Traced,
        the root span `build` holds a device span `level` a launch (its
        `hashes`) and `root_read`, the read of the populated root."""
        n = cur.shape[0]
        if n > (1 << self.depth):
            raise ValueError("too many leaves")
        if n == 0:
            self.levels = []
            return
        with trace.span("build"):
            self.levels = [cur]
            level = 0
            while cur.shape[0] > 1:
                if cur.shape[0] % 2:
                    cur = torch.cat([cur, self._nil_mont(level)])
                with trace.span("level", device=self.device,
                                hashes=cur.shape[0] // 2):
                    cur = hash2_mont_sparse(cur[0::2], cur[1::2])
                level += 1
                self.levels.append(cur)
            # fold the populated-subtree root with nil siblings to full depth
            with trace.span("root_read"):
                node = fr_from_bytes(self._read(level, [0])[0])
            for k in range(level, self.depth):
                node = poseidon([node, self.nils[k]])
                self.levels.append(F.ints_to_tensor([node * F.RMONT % MOD],
                                                    self.device))

    # -- reading --------------------------------------------------------------

    def _read(self, level: int, positions) -> List[bytes]:
        return self.read_nodes([(level, positions)])[0]

    def read_nodes(self, wanted) -> List[List[bytes]]:
        """wanted: (level, positions) pairs -> the nodes' encodings, one
        list per pair.  Positions past a level's populated nodes read its
        nil hash.  One gather per level, one conversion out of Montgomery
        form and one device-to-host copy for all of them."""
        parts, inside = [], []
        for level, pos in wanted:
            pos = np.asarray(pos, dtype=np.int64)
            n_l = (self.levels[level].shape[0]
                   if level < len(self.levels) else 0)
            ok = pos < n_l
            inside.append(ok)
            if ok.any():
                idx = torch.from_numpy(pos[ok]).to(self.device)
                parts.append(self.levels[level].index_select(0, idx))
        vals: List[bytes] = []
        if parts:
            vals = _rows_to_bytes(F.from_mont(torch.cat(parts)).cpu())
        out, k = [], 0
        for (level, pos), ok in zip(wanted, inside):
            nil = fr_to_bytes(self.nils[level])
            row = []
            for flag in ok:
                if flag:
                    row.append(vals[k])
                    k += 1
                else:
                    row.append(nil)
            out.append(row)
        return out

    def root(self) -> bytes:
        return self._read(self.depth, [0])[0]

    def get(self, key: int) -> bytes:
        return self._read(0, [key])[0]

    def get_batch(self, keys: List[int]) -> List[bytes]:
        """Leaves of many keys, read in one gather."""
        return self._read(0, list(keys))

    def get_proof(self, key: int) -> List[bytes]:
        """Sibling hashes leaf->root (merkletree.go:297-308)."""
        if key >= (1 << self.depth):
            raise ValueError("key out of range")
        return self.get_proofs_batch([key])[0]

    def get_proofs_batch(self, keys: List[int]) -> List[List[bytes]]:
        """Proofs for many keys: per level, the deduplicated sibling
        positions of all keys (level l of a k-key batch touches ~k/2^l
        nodes), gathered on the device and read back in one copy."""
        ka = np.asarray(list(keys), dtype=np.int64)
        if ka.size == 0:
            return []
        wanted, inverse = [], []
        for level in range(self.depth):
            uniq, inv = np.unique((ka >> level) ^ 1, return_inverse=True)
            wanted.append((level, uniq))
            inverse.append(inv)
        nodes = self.read_nodes(wanted)
        return [[nodes[level][inverse[level][i]]
                 for level in range(self.depth)] for i in range(ka.size)]


def verify_proof(root: bytes, key: int, proof: List[bytes], leaf: bytes,
                 depth: int | None = None) -> bool:
    """merkletree.go:334-355 — LSB-first sibling-order selection."""
    if depth is None:
        depth = C.ACCOUNT_TREE_DEPTH
    if len(proof) != depth or key >= (1 << depth):
        return False
    node = fr_from_bytes(leaf)
    for i in range(depth):
        sib = fr_from_bytes(proof[i])
        if (key >> i) & 1:
            node = poseidon([sib, node])
        else:
            node = poseidon([node, sib])
    return fr_to_bytes(node) == root
