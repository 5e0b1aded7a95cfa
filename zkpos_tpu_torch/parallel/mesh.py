"""The account tree's root and the MSMs across ranks of a torch.distributed
group, each rank holding a contiguous shard.

Counterpart of zkpos_tpu/parallel/mesh.py.  The JAX package runs one
program over a device mesh (shard_map) and all-gathers over ICI; here each
rank is a process and the partials are all-gathered over the group:

  * the Merkle root: each rank folds its leaf range to its subtree root
    (`merkle_fold`: log2 L launches of the tree's node hash,
    ops/poseidon_sparse), the roots are gathered in rank order and folded
    again on every rank;
  * the MSMs: each rank reduces its slice to one projective partial (the
    sorted-stream engine, `msm_device.msm_point`, or double-and-add through
    the complete add), the partials are gathered and summed by one
    segment-sums launch (`point_fold`, ops/ec.seg_sums).

Every result is replicated on all ranks.  The JAX folds hash all L lanes
at every level, so that one traced body serves every depth; the port's
halve the level at each step, L - 1 hashes in all.

The caller starts the ranks and the group (`run_ranks` does both) and
chooses the backend: nccl when each rank has a card of its own, gloo when
ranks share a card or run on the CPU.  Over gloo the gathers pass their
few bytes through the host; nothing else leaves the rank's device.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..ops import ec
from ..ops import msm_device as md
from ..ops.poseidon_sparse import hash2_mont_sparse

# how long a rank waits at a collective for the others
TIMEOUT_S = 600


@dataclass(frozen=True)
class Mesh:
    """A rank's view of its group: the group (None for the default one),
    this rank, the world size and this rank's device."""
    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    device: torch.device


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of an initialised group.  The device is cuda:{rank %
    device_count} unless the caller passes one (device='cpu' runs the plain
    versions); with no card and no device given this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch versions on the host")
        device = torch.device("cuda", dist.get_rank()
                              % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                device)


def _log2(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two, got {n}")
    return n.bit_length() - 1


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """(k, ...) on every rank -> (world * k, ...), in rank order, on this
    rank's device."""
    x = x.contiguous()
    via_host = (dist.get_backend(mesh.group) == "gloo"
                and x.device.type != "cpu")
    src = x.cpu() if via_host else x
    out = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(out, src, group=mesh.group)
    return torch.cat(out).to(x.device)


# --- the Merkle root ----------------------------------------------------------

def merkle_fold(level: torch.Tensor) -> torch.Tensor:
    """The root (1, 8) of (L, 8) Montgomery rows, L a power of two: log2 L
    halving launches of the node hash."""
    for _ in range(_log2(level.shape[0], "merkle_fold: the row count")):
        level = hash2_mont_sparse(level[0::2], level[1::2])
    return level


def sharded_tree_root(mesh: Mesh, leaves_shard: torch.Tensor):
    """The Merkle root (1, 8) of the leaves of all ranks in rank order,
    replicated: each rank's (L, 8) Montgomery rows, L the same power of two
    on every rank, the world size a power of two."""
    _log2(mesh.world, "the world size")
    n = leaves_shard.shape[0]
    _log2(n, "the shard length")
    sizes = all_gather(mesh, torch.tensor([n], device=leaves_shard.device))
    if bool((sizes != n).any()):
        raise ValueError(f"shard lengths differ: {sizes.tolist()}")
    return merkle_fold(all_gather(mesh, merkle_fold(leaves_shard)))


# --- the MSMs -----------------------------------------------------------------

def point_fold(pts: torch.Tensor) -> torch.Tensor:
    """The sum (1, na, 8) of (D, na, 8) projective points: one
    segment-sums launch over one segment."""
    if pts.shape[0] == 0:
        return ec.identity(pts.shape[1], 1, pts.device)
    heads = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    heads[0] = True
    return ec.seg_sums(pts.contiguous(), heads)


def sharded_point_fold(mesh: Mesh, pts_shard: torch.Tensor) -> torch.Tensor:
    """The sum of the points of all ranks, replicated: each rank folds its
    own, the partials are gathered and folded again."""
    return point_fold(all_gather(mesh, point_fold(pts_shard)))


def scalar_bits(scalars: torch.Tensor) -> torch.Tensor:
    """(nbits, N) bool bits of (N, 8) standard-form scalar rows, most
    significant first, nbits the bit length of the largest."""
    bits = md.windows_of(scalars, 1).flip(0).bool()
    top = bits.any(dim=1).nonzero()
    return bits[int(top[0]):] if top.numel() else bits[:0]


def scalar_mul(pts: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """pts[i] times the scalar whose MSB-first bits are bits[:, i]:
    double-and-add through the complete add, two launches a bit."""
    acc = ec.identity(pts.shape[1], pts.shape[0], pts.device)
    for bit in bits:
        dbl = ec.point_add(acc, acc)
        acc = torch.where(bit[:, None, None], ec.point_add(dbl, pts), dbl)
    return acc


def sharded_msm(mesh: Mesh, pts_shard: torch.Tensor, scalars_shard):
    """sum_i s_i * P_i over the points of all ranks by double-and-add,
    replicated (1, na, 8).  pts_shard: (N, na, 8) projective; scalars as
    msm_device.scalars_tensor takes them."""
    sc = md.scalars_tensor(scalars_shard, pts_shard.device)
    part = point_fold(scalar_mul(pts_shard.contiguous(), scalar_bits(sc)))
    return point_fold(all_gather(mesh, part))


def sharded_stream_msm(mesh: Mesh, curve: str, base_shard: torch.Tensor,
                       scalars_shard=None, c: Optional[int] = None,
                       plan: Optional[md.ScalarPlan] = None):
    """The production MSM over the bases of all ranks, replicated (1, na,
    8): each rank runs msm_device.msm_point on its slice (a base from
    msm_device.device_base and the matching scalars, or a plan prebuilt
    from them), the projective partials are gathered and folded."""
    if plan is None:
        plan = md.ScalarPlan(scalars_shard, c=c, device=base_shard.device)
    part = md.msm_point(curve, base_shard, plan=plan)
    return point_fold(all_gather(mesh, part))


def training_step(mesh: Mesh, leaves_shard, pts_shard, scalars_shard):
    """One sharded pipeline step: the tree's root and a double-and-add MSM,
    each over the shards of all ranks.  Returns (root, acc)."""
    root = sharded_tree_root(mesh, leaves_shard)
    return root, sharded_msm(mesh, pts_shard, scalars_shard)


# --- starting ranks -----------------------------------------------------------

def _rank_main(rank, fn, world, backend, device, store_dir, args):
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = make_mesh(device=device)
        if mesh.device.type == "cpu":
            # the plain versions make many small ops: more threads than one
            # a rank only contend for the host's cores
            torch.set_num_threads(1)
        out = fn(mesh, *args)
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, backend: str, device=None, args=(),
              store_dir: Optional[str] = None) -> list:
    """fn(mesh, *args) on `world` ranks, started by
    torch.multiprocessing.spawn and joined through a FileStore in
    `store_dir` (a new temporary directory when None).  fn must be a
    module-level function; its picklable results come back in rank order.
    A rank that raises ends the others, and the error is raised here."""
    import torch.multiprocessing as mp

    def go(d):
        mp.spawn(_rank_main, args=(fn, world, backend, device, d, args),
                  nprocs=world, join=True)
        out = []
        for r in range(world):
            # written by the ranks just started
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out

    if store_dir is not None:
        return go(store_dir)
    with tempfile.TemporaryDirectory() as d:
        return go(d)
