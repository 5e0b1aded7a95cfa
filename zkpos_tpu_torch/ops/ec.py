"""G1 / G2 point arithmetic on tensors: the complete add (csrc/ec_add.cu),
the dedicated doubling's plain version (`plain_point_double`, the formula
of csrc/ec.cuh's pdbl), the MSM's Horner over its window sums in one
launch of one warp (csrc/ec_add.cu, `horner`) and the inclusive
segmented EC-sum scan (csrc/seg_scan.cu: every position, `seg_scan`, or
each segment's sum, `seg_sums`), with their plain PyTorch versions.

Counterpart of zkpos_tpu/ops/ec_pallas.py (point_add_pallas,
point_add2_pallas, seg_scan_pallas).  A batch of points is an int32
tensor of shape (N, 3, 8) for G1 (X, Y, Z over Fp) or (N, 6, 8) for G2
(x.c0, x.c1, y.c0, y.c1, z.c0, z.c1 over Fp2 = Fp[u]/(u^2 + 1)):
homogeneous projective coordinates in Montgomery form, identity
(0 : 1 : 0).  Canonical values are compared through affine host points
(`to_affine`, or `canonical` on the card), never raw limbs: two
association orders of the same sum give different projective
representatives of the same point.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..crypto import bn254 as bn
from ..utils import build, trace
from . import field as F
from .field import count_launch

PLAIN_K = 4          # elements per serial step in the plain scan


# --- host points <-> tensors ------------------------------------------------------

def _na(curve: str) -> int:
    return 3 if curve == "g1" else 6


def identity(na: int, n: int = 1, device="cpu") -> torch.Tensor:
    out = torch.zeros((n, na, 8), dtype=torch.int32, device=device)
    out[:, 1 if na == 3 else 2] = F.const(1, F.FP, device)
    return out


def from_affine(points, curve: str, device="cpu") -> torch.Tensor:
    """Host affine points (None for the identity) -> (N, na, 8)."""
    vals = []
    for p in points:
        if curve == "g1":
            vals += [0, 1, 0] if p is None else [p[0], p[1], 1]
        else:
            vals += ([0, 0, 1, 0, 0, 0] if p is None else
                     [p[0].c0, p[0].c1, p[1].c0, p[1].c1, 1, 0])
    m = F.FP_MOD
    t = F.ints_to_tensor([v * F.RMONT % m for v in vals], device)
    return t.reshape(len(points), _na(curve), 8)


def to_affine(pts: torch.Tensor) -> List[Optional[tuple]]:
    """(N, na, 8) projective -> host affine points (None at the identity).
    Inversions run in Python: meant for the few points read back."""
    na = pts.shape[1]
    rinv = pow(F.RMONT, -1, F.FP_MOD)
    with trace.wait("readback"):
        rows = pts.reshape(-1, 8).cpu()
    vals = [v * rinv % F.FP_MOD for v in F.tensor_to_ints(rows)]
    out = []
    for i in range(pts.shape[0]):
        c = vals[na * i:na * (i + 1)]
        if na == 3:
            if c[2] == 0:
                out.append(None)
                continue
            zi = bn.fp_inv(c[2])
            out.append((c[0] * zi % bn.P, c[1] * zi % bn.P))
        else:
            z = bn.Fp2(c[4], c[5])
            if c[4] == 0 and c[5] == 0:
                out.append(None)
                continue
            zi = z.inv()
            out.append((bn.Fp2(c[0], c[1]) * zi, bn.Fp2(c[2], c[3]) * zi))
    return out


def canonical(pts: torch.Tensor) -> List[torch.Tensor]:
    """Affine coordinates in Montgomery form (the identity -> zeros), one
    (N, 8) tensor a coordinate (x, y in G1; x.c0, x.c1, y.c0, y.c1 in G2),
    by the Fp kernels on the card or their plain versions on the CPU: the
    canonical value of each projective point, for many points at once."""
    na = pts.shape[1]
    c = lambda k: pts[:, k].contiguous()
    if na == 3:
        zi = F.inverse(c(2), F.FP)
        return [F.mul(c(0), zi, F.FP), F.mul(c(1), zi, F.FP)]
    z0, z1 = c(4), c(5)
    norm = F.add(F.mul(z0, z0, F.FP), F.mul(z1, z1, F.FP), F.FP)
    ni = F.inverse(norm, F.FP)
    zero = F.const(0, F.FP, pts.device, mont=False)
    a0, a1 = F.mul(z0, ni, F.FP), F.sub(zero, F.mul(z1, ni, F.FP), F.FP)
    out = []
    for x0, x1 in ((c(0), c(1)), (c(2), c(3))):
        out.append(F.sub(F.mul(x0, a0, F.FP), F.mul(x1, a1, F.FP), F.FP))
        out.append(F.add(F.mul(x0, a1, F.FP), F.mul(x1, a0, F.FP), F.FP))
    return out


# --- plain versions -----------------------------------------------------------------
#
# The formulas of csrc/ec.cuh on 16-bit limb rows, with each stage's
# independent products stacked into one batched Montgomery product (the
# add: six variable products, then the two 3b products, then six more; the
# doubling: four, the 3b product, four): the same field values, so the
# same canonical outputs.

def _b3_16(na: int, device) -> torch.Tensor:
    if na == 3:
        return F._to16(F.const(9, F.FP, device))                 # (1, 16)
    inv82 = pow(82, F.FP_MOD - 2, F.FP_MOD)
    k = [81 * inv82 % F.FP_MOD, -9 * inv82 % F.FP_MOD]
    return F._to16(F.ints_to_tensor([v * F.RMONT % F.FP_MOD for v in k],
                                    device)).reshape(1, 2, 16)


class _Base:
    """Fp ops on stacked (..., 16) limb rows."""

    @staticmethod
    def add(a, b):
        return F._add16(a.reshape(-1, 16), b.reshape(-1, 16),
                        F.FP).reshape(a.shape)

    @staticmethod
    def sub(a, b):
        return F._sub16(a.reshape(-1, 16), b.reshape(-1, 16),
                        F.FP).reshape(a.shape)

    @staticmethod
    def mul(a, b):
        a, b = torch.broadcast_tensors(a, b)
        a2, b2 = a.reshape(-1, 16), b.reshape(-1, 16)
        n, ch = a2.shape[0], F._PLAIN_CHUNK
        out = torch.cat([F._mul16(a2[i:i + ch], b2[i:i + ch], F.FP)
                         for i in range(0, n, ch)])
        return out.reshape(a.shape)


class _Quad(_Base):
    """Fp2 ops on stacked (..., 2, 16) rows: Karatsuba products."""

    @staticmethod
    def mul(a, b):
        a, b = torch.broadcast_tensors(a, b)
        a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
        s = _Base.add(torch.stack([a0, b0]), torch.stack([a1, b1]))
        t = _Base.mul(torch.stack([a0, a1, s[0]]), torch.stack([b0, b1, s[1]]))
        t01 = _Base.add(t[0], t[1])
        c = _Base.sub(torch.stack([t[0], t[2]]), torch.stack([t[1], t01]))
        return torch.stack([c[0], c[1]], dim=-2)


def _padd16(E, p, q, b3):
    """Complete add on stacked coordinates: p, q = (X, Y, Z)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    s = E.add(torch.stack([X1, Y1, X1, X2, Y2, X2]),
              torch.stack([Y1, Z1, Z1, Y2, Z2, Z2]))
    t = E.mul(torch.stack([X1, Y1, Z1, s[0], s[1], s[2]]),
              torch.stack([X2, Y2, Z2, s[3], s[4], s[5]]))
    t0, t1, t2 = t[0], t[1], t[2]
    pair = E.add(torch.stack([t0, t1, t0]), torch.stack([t1, t2, t2]))
    txy, tyz, txz = E.sub(t[3:6], pair)
    bt2, w = E.mul(torch.stack([t2, txz]), b3)
    u = E.sub(t1, bt2)
    v, t02 = E.add(torch.stack([t1, t0]), torch.stack([bt2, t0]))
    t0p = E.add(t02, t0)
    m = E.mul(torch.stack([txy, tyz, u, t0p, tyz, t0p]),
              torch.stack([u, w, v, w, v, txy]))
    X3 = E.sub(m[0], m[1])
    Y3, Z3 = E.add(torch.stack([m[2], m[4]]), torch.stack([m[3], m[5]]))
    return X3, Y3, Z3


def _pdbl16(E, p, b3):
    """The dedicated doubling on stacked coordinates, Renes-Costello-Batina
    2015 Algorithm 9 (a = 0): X3 = 2 (Y^2 - 3 b3 Z^2) X Y, Y3 = 8 Y^2 b3
    Z^2 + (Y^2 - 3 b3 Z^2)(Y^2 + b3 Z^2), Z3 = 8 Y^3 Z."""
    X, Y, Z = p
    t0, t1, t2, xy = E.mul(torch.stack([Y, Y, Z, X]),
                           torch.stack([Y, Z, Z, Y]))
    bz = E.mul(t2, b3)
    y2, bz2 = E.add(torch.stack([t0, bz]), torch.stack([t0, bz]))
    y4, bz3 = E.add(torch.stack([y2, bz2]), torch.stack([y2, bz]))
    y8, v = E.add(torch.stack([y4, t0]), torch.stack([y4, bz]))
    u = E.sub(t0, bz3)
    m = E.mul(torch.stack([bz, t1, u, u]), torch.stack([y8, y8, v, xy]))
    X3, Y3 = E.add(torch.stack([m[3], m[0]]), torch.stack([m[3], m[2]]))
    return X3, Y3, m[1]


def _on_points(fn, *pts):
    """fn(E, coordinates of each operand, b3) on (N, na, 8) points, as
    stacked 16-bit rows; the result back as (N, na, 8)."""
    na = pts[0].shape[1]
    P = [F._to16(t) for t in pts]                   # (N, na, 16)
    if na == 3:
        E, split = _Base, lambda Q: (Q[:, 0], Q[:, 1], Q[:, 2])
    else:
        E, split = _Quad, lambda Q: (Q[:, 0:2], Q[:, 2:4], Q[:, 4:6])
    X3, Y3, Z3 = fn(E, *[split(Q) for Q in P], _b3_16(na, pts[0].device))
    if na == 3:
        out = torch.stack([X3, Y3, Z3], dim=1)
    else:
        out = torch.cat([X3, Y3, Z3], dim=1)
    return F._from16(out)


def plain_point_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b pointwise; b may be a single point."""
    return _on_points(_padd16, a, b.expand(a.shape[0], a.shape[1], 8))


def plain_point_double(a: torch.Tensor) -> torch.Tensor:
    """2 a pointwise by the dedicated doubling (Algorithm 9): the identity
    to the identity, and the same projective point as csrc/ec.cuh's pdbl
    and the Horner kernels' doublings."""
    return _on_points(_pdbl16, a)


# --- the add kernel ---------------------------------------------------------------

def _check_pts(*ts):
    for t in ts:
        if (t.dtype != torch.int32 or t.dim() != 3 or t.shape[1] not in (3, 6)
                or t.shape[2] != 8 or not t.is_contiguous()):
            raise ValueError("points must be contiguous int32 (N, 3|6, 8)")


def point_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complete projective add, G1 or G2 by the coordinate count; b may be
    one point added to every row of a."""
    _check_pts(a, b)
    if a.shape[1] != b.shape[1] or b.shape[0] not in (1, a.shape[0]):
        raise ValueError("point_add: mismatched shapes")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain_point_add(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("operands must share one CUDA device")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("point_add: points must be 16-byte aligned")
    g1 = a.shape[1] == 3
    out = torch.empty_like(a)
    L = build.cuda_lib()
    fn = L.zk_g1_add if g1 else L.zk_g2_add
    name = "g1_add" if g1 else "g2_add"
    build.check(fn(build.ptr(out), build.ptr(a), build.ptr(b), a.shape[0],
                   int(b.shape[0] == a.shape[0]), build.stream_ptr(a)), name)
    count_launch(name, a.shape[0])
    return out


# --- the MSM's Horner ----------------------------------------------------------------

def plain_horner(rw: torch.Tensor, c: int) -> torch.Tensor:
    """sum_w 2^(c w) rw[w] by Horner: acc = rw[W - 1]; for w = W - 2 .. 0,
    c doublings (plain_point_double), then acc + rw[w] (the complete add).
    Returns (1, na, 8)."""
    W = rw.shape[0]
    acc = rw[W - 1:W]
    for w in range(W - 2, -1, -1):
        for _ in range(c):
            acc = plain_point_double(acc)
        acc = plain_point_add(acc, rw[w:w + 1])
    return acc.contiguous()


def horner_levels(W: int, c: int) -> int:
    """Product levels on the Horner kernel's critical path (csrc/ec.cuh
    horner): b3 Z of the first sum, then each window's doublings (two
    levels each), its add (two) and b3 Z of the sum (one; not after the
    last), and the window sum's own level when c = 0."""
    return (W > 1) + (W - 1) * (2 * c + 2 + (c == 0)) + max(W - 2, 0)


def horner(rw: torch.Tensor, c: int) -> torch.Tensor:
    """plain_horner's doublings and adds, in its order, in one launch of
    one warp (csrc/ec_add.cu zk_g1_horner / zk_g2_horner: ec.cuh's
    schedule of levels, a level's products on their own lanes), counted as
    g1_horner / g2_horner.  rw: (W, na, 8) window sums, W >= 1."""
    _check_pts(rw)
    W = rw.shape[0]
    if W == 0:
        raise ValueError("horner: no window sums")
    if c < 0:
        raise ValueError("horner: c must be at least 0")
    if rw.device.type == "cpu":
        return plain_horner(rw, c)
    if rw.device.type != "cuda":
        raise ValueError("horner: window sums must lie on the CPU or a "
                         "CUDA device")
    g1 = rw.shape[1] == 3
    out = torch.empty((1, rw.shape[1], 8), dtype=torch.int32,
                      device=rw.device)
    L = build.cuda_lib()
    fn = L.zk_g1_horner if g1 else L.zk_g2_horner
    name = "g1_horner" if g1 else "g2_horner"
    build.check(fn(build.ptr(out), build.ptr(rw), W, c,
                   build.stream_ptr(rw)), name)
    count_launch(name, (W - 1) * (c + 1))   # its doublings and adds
    return out


# --- segmented scan -----------------------------------------------------------------

def plain_seg_scan(pts: torch.Tensor, heads: torch.Tensor,
                   K: int = PLAIN_K) -> torch.Tensor:
    """Inclusive segmented EC-sum scan in PyTorch: K-element serial scans
    side by side, a recursive scan of the per-block aggregates, and the
    fix-up of each block's elements before its first head."""
    n, na = pts.shape[0], pts.shape[1]
    if n <= 1:
        return pts.clone()
    T = -(-n // K)
    pad = T * K - n
    X = torch.cat([pts, identity(na, pad, pts.device)]).reshape(T, K, na, 8)
    H = torch.cat([heads.bool(), torch.ones(pad, dtype=torch.bool,
                                            device=pts.device)]).reshape(T, K)
    out = torch.empty_like(X)
    acc = X[:, 0]
    out[:, 0] = acc
    for i in range(1, K):
        s = plain_point_add(acc.contiguous(), X[:, i].contiguous())
        acc = torch.where(H[:, i, None, None], X[:, i], s)
        out[:, i] = acc
    if T > 1:
        carry = plain_seg_scan(acc.contiguous(), H.any(dim=1), K)
        before = torch.cumsum(H.int(), dim=1) == 0
        before[0] = False
        tb, ib = before.nonzero(as_tuple=True)
        if tb.numel():
            out[tb, ib] = plain_point_add(carry[tb - 1].contiguous(),
                                          out[tb, ib].contiguous())
    return out.reshape(T * K, na, 8)[:n].contiguous()


def plain_seg_sums(pts: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """Each segment's sum, in stream order: plain_seg_scan at the last
    element of each segment."""
    end = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    end[:-1] = heads[1:].bool()
    return plain_seg_scan(pts, heads)[end].contiguous()


def _seg_launch(mode: str, pts: torch.Tensor, heads: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """One launch of the single-pass kernel (csrc/seg_scan.cu), counted as
    seg_<mode>_<g1|g2>."""
    na, n = pts.shape[1], pts.shape[0]
    if pts.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"seg_{mode}: points must be 16-byte aligned")
    h = (heads.view(torch.uint8) if heads.dtype == torch.bool
         else heads.to(torch.uint8)).contiguous()
    L = build.cuda_lib()
    scratch = torch.empty(L.zk_seg_scratch_bytes(na, int(mode == "sums"), n),
                          dtype=torch.uint8, device=pts.device)
    fn = L.zk_seg_scan if mode == "scan" else L.zk_seg_sums
    name = f"seg_{mode}_{'g1' if na == 3 else 'g2'}"
    build.check(fn(na, build.ptr(pts), build.ptr(h), build.ptr(out),
                   build.ptr(scratch), n, build.stream_ptr(pts)), name)
    count_launch(name, n)
    return out


def _check_scan_args(pts: torch.Tensor, heads: torch.Tensor, what: str):
    _check_pts(pts)
    if heads.shape != (pts.shape[0],):
        raise ValueError("heads must be (N,)")
    if pts.device.type == "cpu" and heads.device.type == "cpu":
        return "cpu"
    if pts.device.type != "cuda" or heads.device != pts.device:
        raise ValueError(f"{what}: operands must share one CUDA device")
    return "cuda"


def seg_scan(pts: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """out[i] = sum of pts[h..i], h the last head at or before i (the
    stream start counts as a head).  heads: (N,) bool or uint8."""
    if _check_scan_args(pts, heads, "seg_scan") == "cpu":
        return plain_seg_scan(pts, heads)
    out = torch.empty_like(pts)
    return _seg_launch("scan", pts, heads, out) if pts.shape[0] else out


def seg_sums(pts: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """The sum of each segment, in stream order: (S, na, 8), S the number
    of heads with the stream start counted as one -- seg_scan read at the
    segment ends, without the N-point scan."""
    if _check_scan_args(pts, heads, "seg_sums") == "cpu":
        return plain_seg_sums(pts, heads)
    n = pts.shape[0]
    with trace.wait("seg_sums"):
        S = 1 + int(heads[1:].sum()) if n else 0
    out = torch.empty((S, pts.shape[1], 8), dtype=torch.int32,
                      device=pts.device)
    return _seg_launch("sums", pts, heads, out) if n else out
