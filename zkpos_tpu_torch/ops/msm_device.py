"""Sorted-stream Pippenger MSM (G1 and G2 over BN254) on the device.

Counterpart of zkpos_tpu/ops/msm_device.py, the engine of the five proof
MSMs and the two commitment MSMs:

  1. window digits of the scalars (c-bit, c <= 16), front-padded with
     digit 0 pointing at the identity in base row 0, and sorted per window
     (`ScalarPlan`; the sort is torch.sort);
  2. the bases gathered in sorted order into one flat stream (all windows
     back to back) with a head wherever the digit changes and at every
     window start, and ONE segmented EC sum over it (ops/ec.seg_sums):
     each segment's sum is its bucket's, placed at (window, digit of its
     head) in the (W, 2^c) bucket grid;
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

The TPU engine cut the stream into 2^21-entry chunks with a per-window
carry to fit a v5e's 16 GB.  The H100's 80 GB hold a whole MSM's stream
(the largest, G2 at c = 12 over 1.92 M scalars, is 42 M points, 8 GB), so
the port scans it in one pass.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve
from . import ec
from . import field as F

PAD_QUANTUM = 32     # the stream is front-padded to a multiple of this


def scalars_tensor(scalars, device) -> torch.Tensor:
    """Scalars as (N, 8) int32 standard-form rows on `device`: from ints,
    from (N, 4) uint64 rows (native solver output) or from a tensor."""
    if isinstance(scalars, torch.Tensor):
        return scalars.to(device)
    if isinstance(scalars, np.ndarray):
        return F.u64_to_tensor(scalars, device)
    return F.ints_to_tensor([int(s) % F.FR_MOD for s in scalars], device)


def windows_of(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(W, N) int32 c-bit little-endian window digits (c <= 16) of (N, 8)
    standard-form scalar rows, W = ceil(254 / c)."""
    if c > 16:
        raise ValueError("window width capped at 16")
    u = scalars.long() & 0xFFFFFFFF                       # (N, 8)
    W = -(-254 // c)
    rows = []
    for w in range(W):
        lo = w * c
        limb, sh = lo // 32, lo % 32
        v = u[:, limb] >> sh
        if sh + c > 32 and limb + 1 < 8:
            v = v | (u[:, limb + 1] << (32 - sh))
        rows.append(v & ((1 << c) - 1))
    return torch.stack(rows).to(torch.int32)


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
    `dig` / `idx`: (W, Np) int32, idx 0 is the identity row of the base."""

    __slots__ = ("n", "c", "W", "K", "Np", "dig", "idx", "device")

    def __init__(self, scalars, c: Optional[int] = None, device=None,
                 windows: Optional[int] = None):
        """`windows` keeps only the low window rows, for scalars below
        2^(c * windows) (a small multi-rank check, as the JAX dryrun feeds
        two rows); a non-zero digit above them raises."""
        dev = (scalars.device if isinstance(scalars, torch.Tensor)
               and device is None else resolve(device))
        self.device = dev
        sc = scalars_tensor(scalars, dev)
        self.n = sc.shape[0]
        self.c = c if c is not None else pick_c(max(self.n, 2))
        win = windows_of(sc, self.c)                       # (W, n)
        if windows is not None:
            if bool((win[windows:] != 0).any()):
                raise ValueError(
                    f"a scalar is not below 2^{self.c * windows}")
            win = win[:windows]
        self.W = win.shape[0]
        self.K = int((win != 0).sum(dim=1).max()) if self.n else 0
        self.Np = -(-max(self.n, 1) // PAD_QUANTUM) * PAD_QUANTUM
        if self.K == 0:
            self.dig = self.idx = None
            return
        pad = self.Np - self.n
        dig = torch.nn.functional.pad(win, (pad, 0))
        idx = torch.nn.functional.pad(
            torch.arange(1, self.n + 1, dtype=torch.int32,
                         device=dev).expand(self.W, self.n), (pad, 0))
        self.dig, order = torch.sort(dig, dim=1, stable=True)
        self.idx = torch.gather(idx, 1, order)


def device_base(curve: str, points, device=None) -> torch.Tensor:
    """An MSM base as (N + 1, na, 8) with the identity at row 0: from a
    device tensor of projective points or from host affine points (put on
    `device`, the card unless the caller asks for the CPU)."""
    if isinstance(points, torch.Tensor):
        dev = points.device
        pts = points
    else:
        dev = resolve(device)
        pts = ec.from_affine(points, curve, dev)
    na = 3 if curve == "g1" else 6
    return torch.cat([ec.identity(na, 1, dev), pts.to(dev)]).contiguous()


def sorted_stream(plan: ScalarPlan, base: torch.Tensor):
    """The flat stream the bucket scan runs over: (W * Np, na, 8) base
    points in sorted digit order, and (W * Np,) heads where the digit
    changes and at every window start."""
    pts = base.index_select(0, plan.idx.reshape(-1).long())
    heads = torch.ones((plan.W, plan.Np), dtype=torch.bool,
                       device=base.device)
    heads[:, 1:] = plan.dig[:, 1:] != plan.dig[:, :-1]
    return pts, heads.reshape(-1)


def _bucket_sums(na: int, plan: ScalarPlan, base: torch.Tensor):
    """(W, 2^c, na, 8) bucket grid: the sum of the base points whose digit
    is b in window w (identity where none)."""
    W, Np, nb = plan.W, plan.Np, 1 << plan.c
    pts, heads = sorted_stream(plan, base)
    sums = ec.seg_sums(pts, heads)
    del pts
    at = heads.nonzero().flatten()            # each segment's head
    del heads
    slot = (at // Np) * nb + plan.dig.reshape(-1)[at].long()
    dense = ec.identity(na, W * nb, base.device)
    dense[slot] = sums
    return dense.reshape(W, nb, na, 8)


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
              plan: Optional[ScalarPlan] = None) -> torch.Tensor:
    """sum_i s_i * P_i over a base from `device_base`, as a (1, na, 8)
    projective point on the base's device (the identity when every scalar
    is zero).  Either `scalars` or a prebuilt `plan` must be given."""
    na = 3 if curve == "g1" else 6
    if plan is None:
        plan = ScalarPlan(scalars, device=base.device)
    if plan.K == 0:
        return ec.identity(na, 1, base.device)
    dense = _bucket_sums(na, plan, base)
    rw = _fold(na, plan.W, plan.c, dense)
    del dense
    return ec.horner(rw, plan.c)


def msm(curve: str, base: torch.Tensor, scalars=None,
        plan: Optional[ScalarPlan] = None):
    """msm_point as an affine host point, or None when the sum is the
    identity (every scalar zero included)."""
    return ec.to_affine(msm_point(curve, base, scalars, plan))[0]
