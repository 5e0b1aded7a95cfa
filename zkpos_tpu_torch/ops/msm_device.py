"""Sorted-stream Pippenger MSM (G1 and G2 over BN254) on the device.

Counterpart of zkpos_tpu/ops/msm_device.py, the engine of the five proof
MSMs and the two commitment MSMs:

  1. window digits of the scalars (c-bit, c <= 16), front-padded with
     digit 0 to a multiple of PAD_QUANTUM and sorted per window, one
     window at a time (`ScalarPlan`; the sort is torch.sort); a padding
     column reads base row 0, which lands in bucket 0, and bucket 0 has
     weight 0, so the base needs no identity row;
  2. the stream walked in chunks of Cn columns of every window: a chunk's
     base points gathered in sorted order (its windows back to back) with
     a head wherever the digit changes and at every window start, and ONE
     segmented EC sum over it (ops/ec.seg_sums); each segment's sum is
     placed at (window, digit of its head) in the (W, 2^c) bucket grid.
     After the first chunk, each window's first segment may continue a
     bucket of the chunk before: its sum is added to what the grid holds
     there (ops/ec.point_add over the W first segments, the identity where
     the bucket is new), so every bucket ends with its whole sum;
  3. the bucket fold: the suffix sums T_j = sum_{b >= j} S_b as a
     reversed segmented scan over the bucket grid (ops/ec.seg_scan), T_0
     replaced by the identity, then each window's sum_{j >= 1} T_j
     (ops/ec.seg_sums, one segment a window);
  4. a Horner over the W window sums, c doublings (the dedicated
     doubling) and an add a window, in one launch of one warp
     (ops/ec.horner).

`msm_point` returns the sum as a projective point on the device (what
the sharded MSM gathers, parallel/mesh.py); `msm` reads it back as an
affine host point.

The chunk is decided before any launch, from byte counts: the plan's
`chunk` columns when given (as the JAX package's ScalarPlan(chunk=)),
else ZKPOS_MSM_CHUNK stream entries a chunk (read as the JAX package
reads it, `env_chunk_columns`), else as many columns as the device's free
memory holds (`chunk_columns` over `transient_budget`): one chunk, the
whole stream, whenever it fits, as every MSM of the repo-size prove does
on an H100 (the largest, G2 at c = 12 over 1.92 M scalars, is 42 M points,
8 GB), and as many chunks as the memory needs when it does not (an MSM
of 2^26 G2 points at c = 12 would need 283 GB in one pass).  On the CPU
there is no budget: one chunk unless asked.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..utils import trace
from ..utils.device import resolve
from . import ec
from . import field as F

PAD_QUANTUM = 32     # the stream is front-padded to a multiple of this
# device bytes kept free of an MSM's chunk: a quarter of what is free,
# and this much beside it (the allocator's rounding of the chunk's blocks,
# the seg_sums scratch, the sort's workspace)
HEADROOM_BYTES = 1 << 30


def scalars_tensor(scalars, device) -> torch.Tensor:
    """Scalars as (N, 8) int32 standard-form rows on `device`: from ints,
    from (N, 4) uint64 rows (native solver output) or from a tensor."""
    if isinstance(scalars, torch.Tensor):
        return scalars.to(device)
    if isinstance(scalars, np.ndarray):
        return F.u64_to_tensor(scalars, device)
    return F.ints_to_tensor([int(s) % F.FR_MOD for s in scalars], device)


def window_digits(scalars: torch.Tensor, c: int, w: int) -> torch.Tensor:
    """(N,) int32 c-bit digit w (little-endian windows, c <= 16) of (N, 8)
    standard-form scalar rows."""
    lo = w * c
    limb, sh = lo // 32, lo % 32
    v = (scalars[:, limb].long() & 0xFFFFFFFF) >> sh
    if sh + c > 32 and limb + 1 < 8:
        v = v | ((scalars[:, limb + 1].long() & 0xFFFFFFFF) << (32 - sh))
    return (v & ((1 << c) - 1)).to(torch.int32)


def windows_count(c: int) -> int:
    """W = ceil(254 / c), the c-bit windows of a scalar below r."""
    return -(-254 // c)


def windows_of(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(W, N) int32 c-bit little-endian window digits (c <= 16) of (N, 8)
    standard-form scalar rows, W = windows_count(c)."""
    if c > 16:
        raise ValueError("window width capped at 16")
    return torch.stack([window_digits(scalars, c, w)
                        for w in range(windows_count(c))])


def pick_c(n: int) -> int:
    """Window width quantized to {8, 12, 16}, as the reference engine."""
    raw = n.bit_length() - 3
    if raw <= 9:
        return 8
    if raw <= 13:
        return 12
    return 16


class ScalarPlan:
    """Window digits of one scalar vector, sorted per window on the device
    and shared by every MSM over the same scalars (A/B1 in groth16.prove).
    `dig` / `idx`: (W, Np) int32, idx the base row of each sorted digit
    (row 0 in the padding columns, whose digit is 0).  `nonzero`: each
    window's non-zero digits, K the most of them.  `chunk`: columns of the
    stream a chunk walks, 0 to decide at each MSM."""

    __slots__ = ("n", "c", "W", "K", "Np", "chunk", "dig", "idx", "device",
                 "nonzero")

    def __init__(self, scalars, c: Optional[int] = None, device=None,
                 windows: Optional[int] = None, chunk: int = 0):
        """`windows` keeps only the low window rows, for scalars below
        2^(c * windows) (a small multi-rank check, as the JAX dryrun feeds
        two rows); a non-zero digit above them raises.  The windows are
        sorted one at a time, so the plan's transients are a window's."""
        if chunk < 0:
            raise ValueError("chunk must be 0 (decided at each MSM) or a "
                             "number of columns")
        dev = (scalars.device if isinstance(scalars, torch.Tensor)
               and device is None else resolve(device))
        self.device = dev
        sc = scalars_tensor(scalars, dev)
        self.n = sc.shape[0]
        self.c = c if c is not None else pick_c(max(self.n, 2))
        if self.c > 16:
            raise ValueError("window width capped at 16")
        W_all = windows_count(self.c)
        self.W = W_all if windows is None else min(windows, W_all)
        self.chunk = chunk
        self.Np = -(-max(self.n, 1) // PAD_QUANTUM) * PAD_QUANTUM
        self.K = 0
        self.nonzero = []
        self.dig = self.idx = None
        if self.n == 0:
            return
        with trace.span("plan"):
            self._sort(sc, W_all)

    def _sort(self, sc: torch.Tensor, W_all: int) -> None:
        dev, pad = self.device, self.Np - self.n
        dig = torch.empty((self.W, self.Np), dtype=torch.int32, device=dev)
        idx = torch.empty((self.W, self.Np), dtype=torch.int32, device=dev)
        nonzero = []
        for w in range(W_all):
            d = window_digits(sc, self.c, w)
            if w >= self.W:
                with trace.wait("plan"):
                    above = bool((d != 0).any())
                if above:
                    raise ValueError(
                        f"a scalar is not below 2^{self.c * self.W}")
                continue
            nonzero.append((d != 0).sum())
            dig[w], order = torch.sort(torch.nn.functional.pad(d, (pad, 0)),
                                       stable=True)
            idx[w] = (order - pad).clamp_(min=0)
            del d, order
        with trace.wait("plan"):
            self.nonzero = torch.stack(nonzero).tolist()
        self.K = max(self.nonzero)
        if self.K:
            self.dig, self.idx = dig, idx

    @property
    def entries(self) -> int:
        """Stream entries an MSM over this plan walks: W x Np, or none
        when every scalar is zero."""
        return self.W * self.Np if self.K else 0

    @property
    def zero_entries(self) -> int:
        """Walked entries whose digit is 0 (the padding's included): each
        is gathered and summed into bucket 0, whose weight is 0."""
        return self.entries - sum(self.nonzero) if self.K else 0


def device_base(curve: str, points, device=None) -> torch.Tensor:
    """An MSM base as (N, na, 8) projective points: a tensor as it is, on
    its own device, or host affine points put on `device` (the card unless
    the caller asks for the CPU).  No identity row: the plan's padding
    reads row 0 into bucket 0, which the fold weights 0."""
    if isinstance(points, torch.Tensor):
        return points.contiguous()
    return ec.from_affine(points, curve, resolve(device))


def sorted_stream(plan: ScalarPlan, base: torch.Tensor, lo: int = 0,
                  hi: Optional[int] = None):
    """The stream the bucket sums run over, columns [lo, hi) of every
    window (all of them by default): (W * (hi - lo), na, 8) base points in
    sorted digit order, and heads where the digit changes and at every
    window start."""
    hi = plan.Np if hi is None else hi
    idx = plan.idx[:, lo:hi].reshape(-1).long()
    with trace.span("gather", device=base.device, entries=idx.shape[0]):
        pts = base.index_select(0, idx)
    del idx                 # freed before the heads, as a temporary would be
    dig = plan.dig[:, lo:hi]
    heads = torch.ones(dig.shape, dtype=torch.bool, device=base.device)
    heads[:, 1:] = dig[:, 1:] != dig[:, :-1]
    return pts, heads.reshape(-1)


# --- the chunk, from byte counts ---------------------------------------------

def chunk_bytes(W: int, Cn: int, na: int, c: int) -> int:
    """Device bytes an MSM holds at once for a chunk of Cn columns of W
    windows: each entry's gathered point, its int32 and int64 index and
    its head; each segment's sum, slot and position (a window's chunk has
    at most min(Cn, 2^c) segments, one a distinct digit); and the bucket
    grid with the fold's three copies of it."""
    pb = 32 * na
    grid = W * (1 << c) * pb
    return W * Cn * (pb + 16) + W * min(Cn, 1 << c) * (pb + 32) + 4 * grid


def chunk_columns(W: int, Np: int, na: int, c: int,
                  budget: Optional[int]) -> int:
    """Columns a chunk for a budget of device bytes (None: no budget): all
    Np, one chunk, when the whole stream fits; else the fewest chunks of
    columns that fit, as even as multiples of PAD_QUANTUM allow (the last
    may be shorter).  Raises when not even PAD_QUANTUM columns fit."""
    if budget is None or chunk_bytes(W, Np, na, c) <= budget:
        return Np
    lo, hi = 0, Np // PAD_QUANTUM          # quanta: lo fits, hi does not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if chunk_bytes(W, mid * PAD_QUANTUM, na, c) <= budget:
            lo = mid
        else:
            hi = mid
    if lo == 0:
        raise RuntimeError(
            f"an MSM chunk of {PAD_QUANTUM} columns needs "
            f"{chunk_bytes(W, PAD_QUANTUM, na, c)} device bytes, "
            f"{budget} are free")
    per = -(-Np // -(-Np // (lo * PAD_QUANTUM)))    # Np over the chunks
    return -(-per // PAD_QUANTUM) * PAD_QUANTUM


def env_chunk_columns(W: int) -> Optional[int]:
    """ZKPOS_MSM_CHUNK, stream entries a chunk (read as the JAX package's
    _chunk_cols reads it), as columns: entries / W, at least 256, rounded
    down to a power of two.  None when it is not set."""
    v = os.environ.get("ZKPOS_MSM_CHUNK")
    if v is None:
        return None
    per_row = max(int(v) // max(W, 1), 256)
    return 1 << (per_row.bit_length() - 1)


def free_bytes(device) -> Optional[int]:
    """Bytes the caching allocator can still hand out on a CUDA device:
    the free memory cudaMemGetInfo reports and the blocks PyTorch holds
    unused.  None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def transient_budget(device) -> Optional[int]:
    """Device bytes an MSM's chunk may take: three quarters of free_bytes
    less HEADROOM_BYTES (at least 0); None on the CPU."""
    free = free_bytes(device)
    return None if free is None else max(free * 3 // 4 - HEADROOM_BYTES, 0)


def plan_columns(plan: ScalarPlan, na: int, device) -> int:
    """The columns a chunk of this MSM walks: the plan's own, else
    ZKPOS_MSM_CHUNK's, else chunk_columns over the device's budget now."""
    Cn = (plan.chunk or env_chunk_columns(plan.W)
          or chunk_columns(plan.W, plan.Np, na, plan.c,
                           transient_budget(device)))
    return min(Cn, plan.Np)


# --- the MSM -------------------------------------------------------------------

def _bucket_sums(na: int, plan: ScalarPlan, base: torch.Tensor, Cn: int):
    """(W, 2^c, na, 8) bucket grid: the sum of the base points whose digit
    is b in window w (identity where none), over chunks of Cn columns."""
    W, Np, nb = plan.W, plan.Np, 1 << plan.c
    dense = ec.identity(na, W * nb, base.device)
    for lo in range(0, Np, Cn):
        hi = min(lo + Cn, Np)
        with trace.span("chunk"):
            _chunk(plan, base, dense, lo, hi)
    return dense.reshape(W, nb, na, 8)


def _chunk(plan: ScalarPlan, base: torch.Tensor, dense: torch.Tensor,
           lo: int, hi: int) -> None:
    """Columns [lo, hi) of the stream summed into the bucket grid."""
    W, m, nb, dev = plan.W, hi - lo, 1 << plan.c, base.device
    pts, heads = sorted_stream(plan, base, lo, hi)
    with trace.span("sums", device=dev):
        sums = ec.seg_sums(pts, heads)
        del pts
        with trace.wait("nonzero"):
            at = heads.nonzero().flatten()    # each segment's head
        w = at // m
        slot = w * nb + plan.dig[w, lo + at % m].long()
        del at, w
        if lo == 0:
            dense[slot] = sums
            return
    # each window's first segment: the rest of a bucket of the chunks
    # before when its digit continues (the grid holds their part), a new
    # bucket (the grid holds the identity) when it does not
    with trace.span("carry", device=dev):
        count = heads.reshape(W, m).sum(dim=1)
        first = torch.cumsum(count, 0) - count
        part = ec.point_add(dense[slot[first]], sums[first])
        dense[slot] = sums
        dense[slot[first]] = part


def _fold(na: int, W: int, c: int, dense: torch.Tensor) -> torch.Tensor:
    """Per-window sum_b b * S_b: suffix sums by a reversed segmented scan,
    then their total by a segmented sum.  Returns (W, na, 8)."""
    nb = 1 << c
    dev = dense.device
    heads = torch.zeros((W, nb), dtype=torch.bool, device=dev)
    heads[:, 0] = True
    heads = heads.reshape(-1)
    rev = dense.flip(1).reshape(W * nb, na, 8).contiguous()
    suf = ec.seg_scan(rev, heads).reshape(W, nb, na, 8).flip(1)
    suf = suf.clone()
    suf[:, 0] = ec.identity(na, 1, dev)       # bucket 0 has weight 0
    return ec.seg_sums(suf.reshape(W * nb, na, 8).contiguous(), heads)


def msm_point(curve: str, base: torch.Tensor, scalars=None,
              plan: Optional[ScalarPlan] = None,
              stats: Optional[dict] = None) -> torch.Tensor:
    """sum_i s_i * P_i over a base from `device_base`, as a (1, na, 8)
    projective point on the base's device (the identity when every scalar
    is zero).  Either `scalars` or a prebuilt `plan` must be given.  With
    a `stats` dict, the chunks walked and their columns are recorded in
    it ("chunks", "columns"; 0 and 0 when every scalar is zero).  Traced,
    the span `msm` holds the same, and counts the stream's `entries` and
    its `zero_entries`."""
    na = 3 if curve == "g1" else 6
    dev = base.device
    with trace.span("msm") as sp:
        if plan is None:
            plan = ScalarPlan(scalars, device=dev)
        Cn = plan_columns(plan, na, dev) if plan.K else 0
        chunks = -(-plan.Np // Cn) if Cn else 0
        if stats is not None:
            stats["columns"] = Cn
            stats["chunks"] = chunks
        sp.set(chunks=chunks, columns=Cn)
        trace.count("entries", plan.entries)
        trace.count("zero_entries", plan.zero_entries)
        if plan.K == 0:
            return ec.identity(na, 1, dev)
        dense = _bucket_sums(na, plan, base, Cn)
        with trace.span("fold", device=dev):
            rw = _fold(na, plan.W, plan.c, dense)
        del dense
        with trace.span("horner", device=dev):
            return ec.horner(rw, plan.c)


def msm(curve: str, base: torch.Tensor, scalars=None,
        plan: Optional[ScalarPlan] = None, stats: Optional[dict] = None):
    """msm_point as an affine host point, or None when the sum is the
    identity (every scalar zero included)."""
    pt = msm_point(curve, base, scalars, plan, stats)
    with trace.span("readback"):
        return ec.to_affine(pt)[0]
