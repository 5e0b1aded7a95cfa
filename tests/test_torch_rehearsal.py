"""CPU rehearsal of the port's device arithmetic: csrc/field.cuh,
csrc/ec.cuh, csrc/poseidon.cuh and csrc/csr.cuh, the headers the CUDA
kernels include,
compiled by g++ into a small harness (tests/torch_rehearsal.cpp) and
checked against the host oracles -- Montgomery products in Fr, Fp and
Fp2, the EC core of csrc/fp_ec.cuh (its carry-chain primitives against
exact integer arithmetic, its lazy Fp / Fp2 operations against an integer
model of the same steps, edge operands and the range [p, 2p) included),
complete G1 / G2 adds with the identity on each side, P + P, P + (-P) and
representatives scaled so that a coordinate's limbs are p - 1 or 1, the
MSM's Horner (ec.cuh horner) against ops/ec.plain_horner, and the Poseidon permutations (the tree's sparse schedule, the
plain schedule, the one-thread sparse schedule at t = 4..17, and the warp
schedule of the chain kernel -- one
permutation of width t and whole chains -- run on 32 host threads standing
for the lanes) against crypto/poseidon_ref, with the constant tables the
port's wrappers upload;
and the probes' device functions (csrc/probes.cuh: instruction-rate
bodies, the digit convolutions, the product's stages, the Poseidon
ablations, the three-pass scan's passes; and the scan's structure, the
single pass on the wrapping add, and its copy's walk) against their plain
versions in zkpos_tpu_torch/probes; and the single-pass scan of
csrc/seg_scan.cuh (its lane pass, lane scan, carries and count look-back,
run tile by tile at a few lanes a tile) against ops/ec.plain_seg_scan /
plain_seg_sums on the streams that stress its tiles; and the QAP row
evaluation of csrc/csr.cuh (the lanes' runs, their segmented scan, the
carries and their fix-up, chunk by chunk at a few lanes) against
ops/field.plain_csr_eval.  Skips without g++."""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from zkpos_tpu.crypto import bn254 as bn
from zkpos_tpu.crypto.poseidon_ref import permutation, poseidon
from zkpos_tpu_torch.ops import ec as tec
from zkpos_tpu_torch.ops import poseidon as tpos
from zkpos_tpu_torch.ops import poseidon_sparse as tsparse
from zkpos_tpu_torch.probes import common as C
from zkpos_tpu_torch.probes import debug_product as pprod
from zkpos_tpu_torch.probes import latency as platency
from zkpos_tpu_torch.probes import probe_conv as pconv
from zkpos_tpu_torch.probes import probe_dot as pdot
from zkpos_tpu_torch.probes import probe_kernel_split as psplit
from zkpos_tpu_torch.probes import probe_segscan as pscan
from zkpos_tpu_torch.probes import rates as prates

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "zkpos_tpu_torch", "csrc")
RM = 1 << 256


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    so = str(tmp_path_factory.mktemp("rehearsal") / "rehearsal.so")
    subprocess.run(["g++", "-O1", "-std=c++17", "-pthread", "-shared",
                    "-fPIC", "-I", CSRC, "-o", so,
                    os.path.join(HERE, "torch_rehearsal.cpp")],
                   check=True, capture_output=True)
    L = ctypes.CDLL(so)
    V = ctypes.c_void_p
    L.rh_mont_mul.argtypes = [ctypes.c_int, V, V, V, ctypes.c_long]
    for fn in (L.rh_fp2_mul, L.rh_g1_add, L.rh_g2_add):
        fn.argtypes = [V, V, V, ctypes.c_long]
    I, LG = ctypes.c_int, ctypes.c_long
    L.rh_poseidon_sparse3.argtypes = [V, V, V, V, LG]
    L.rh_poseidon_sparse_warp.argtypes = [I, V, V, V, LG]
    L.rh_poseidon_plain.argtypes = [I, V, V, V, V, LG]
    L.rh_poseidon_chain.argtypes = [V, I, V, V, V]
    L.rh_poseidon_wide.argtypes = [I, V, V, V, LG]
    L.rh_csr.argtypes = [I, I, V, V, V, V, V, ctypes.c_longlong,
                         ctypes.c_longlong, V]
    L.rh_probe_rate.argtypes = [I, V, V, LG, I]
    L.rh_probe_conv.argtypes = [I, V, V, V, LG]
    L.rh_probe_conv_ring.argtypes = [V, V, V, ctypes.c_longlong,
                                     ctypes.c_longlong, V, V]
    L.rh_probe_conv_ring.restype = ctypes.c_longlong
    L.rh_probe_product.argtypes = [I, V, V, V, LG]
    L.rh_probe_latency.argtypes = [V, V, V, LG, I]
    L.rh_probe_split.argtypes = [I, V, V, V, V, LG]
    L.rh_probe_scan.argtypes = [I, I, V, V, V, LG, I]
    L.rh_probe_scan_copy.argtypes = [I, I, I, I, V, V, V, V, LG]
    L.rh_seg.argtypes = [I, I, I, I, I, I, I, V, V, V, LG]
    L.rh_seg_stage.argtypes = [I, I, I, I, I, I, V, V, V, V, LG]
    L.rh_probe_dot_slab.argtypes = [I, I, V, V]
    L.rh_fold_counts.argtypes = [V, I, V]
    L.rh_fold_points.argtypes = [V, V, V, I, V]
    L.rh_cc.argtypes = [I, V, V, V, V, V, V, LG]
    L.rh_fp_lazy.argtypes = [I, V, V, V, LG]
    L.rh_horner.argtypes = [I, V, I, I, V]
    L.rh_point_double.argtypes = [I, V, V, LG]
    L.rh_horner_schedule.argtypes = [I, V]
    return L


def _limbs(vals):
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype=np.uint32).reshape(-1, 8).copy()


def _ints(a):
    return [int.from_bytes(r.tobytes(), "little") for r in a]


def _rand(n, mod, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % mod for _ in range(n)]


@pytest.mark.parametrize("which,mod", [(0, bn.R), (1, bn.P)])
def test_mont_mul(harness, which, mod):
    xs = [0, 1, mod - 1] + _rand(50, mod, which)
    ys = [mod - 1, 1, mod - 1] + _rand(50, mod, which + 7)
    a, b = _limbs([x * RM % mod for x in xs]), _limbs([y * RM % mod
                                                       for y in ys])
    out = np.zeros_like(a)
    harness.rh_mont_mul(which, a.ctypes.data, b.ctypes.data, out.ctypes.data,
                        len(xs))
    assert _ints(out) == [x * y * RM % mod for x, y in zip(xs, ys)]


def test_fp2_mul(harness):
    xs = _rand(20, bn.P, 3)
    ys = _rand(20, bn.P, 4)
    a = _limbs([v * RM % bn.P for v in xs])       # pairs (c0, c1) per row
    b = _limbs([v * RM % bn.P for v in ys])
    out = np.zeros_like(a)
    harness.rh_fp2_mul(a.ctypes.data, b.ctypes.data, out.ctypes.data, 10)
    got = _ints(out)
    rinv = pow(RM, -1, bn.P)
    for i in range(10):
        want = bn.Fp2(xs[2 * i], xs[2 * i + 1]) * bn.Fp2(ys[2 * i],
                                                         ys[2 * i + 1])
        assert (got[2 * i] * rinv % bn.P, got[2 * i + 1] * rinv % bn.P) == \
            (want.c0, want.c1)


def _proj(curve, p):
    if curve == "g1":
        vals = [0, 1, 0] if p is None else [p[0], p[1], 1]
    else:
        vals = ([0, 0, 1, 0, 0, 0] if p is None else
                [p[0].c0, p[0].c1, p[1].c0, p[1].c1, 1, 0])
    return [v * RM % bn.P for v in vals]


def _affine(curve, vals):
    v = [x * pow(RM, -1, bn.P) % bn.P for x in vals]
    if curve == "g1":
        return None if v[2] == 0 else (v[0] * bn.fp_inv(v[2]) % bn.P,
                                       v[1] * bn.fp_inv(v[2]) % bn.P)
    if v[4] == 0 and v[5] == 0:
        return None
    zi = bn.Fp2(v[4], v[5]).inv()
    return (bn.Fp2(v[0], v[1]) * zi, bn.Fp2(v[2], v[3]) * zi)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_complete_add(harness, curve):
    gen, mul, add, neg = ((bn.G1_GEN, bn.g1_mul, bn.g1_add, bn.g1_neg)
                          if curve == "g1" else
                          (bn.G2_GEN, bn.g2_mul, bn.g2_add, bn.g2_neg))
    P, Q = mul(gen, 12345), mul(gen, 67890)
    pairs = [(None, P), (P, None), (None, None), (P, P), (P, neg(P)), (P, Q)]
    a = _limbs([v for x, _ in pairs for v in _proj(curve, x)])
    b = _limbs([v for _, y in pairs for v in _proj(curve, y)])
    fn = harness.rh_g1_add if curve == "g1" else harness.rh_g2_add
    out = np.zeros_like(a)
    fn(a.ctypes.data, b.ctypes.data, out.ctypes.data, len(pairs))
    na = 3 if curve == "g1" else 6
    vals = _ints(out)
    got = [_affine(curve, vals[na * i:na * (i + 1)])
           for i in range(len(pairs))]
    assert got == [add(x, y) for x, y in pairs]


# --- the EC core (csrc/fp_ec.cuh) ---------------------------------------------

M32 = (1 << 32) - 1
P, P2 = bn.P, 2 * bn.P


def _cc_want(op, a, b, c, cin):
    """(d, carry flag after) of primitive `op` of rh_cc in exact integers;
    the ops that write no flag leave it as it came in."""
    lo, hi = (a * b) & M32, (a * b) >> 32
    s = [a + b, a + b + cin, a + b + cin, a - b, a - b - cin, a - b - cin,
         lo + c, lo + c + cin, hi + c + cin, hi + c + cin, hi][op]
    if op in (0, 1, 6, 7, 8):
        flag = s >> 32
    elif op in (3, 4):
        flag = int(s < 0)
    else:
        flag = cin
    return s & M32, flag


@pytest.mark.parametrize("op", range(11))
def test_ec_core_carry_primitives(harness, op):
    """Each carry-chain primitive's C++ form against exact arithmetic, on
    all-zero, all-ones and random limbs, with the carry in at 0 and 1."""
    rng = np.random.default_rng(300 + op)
    edge = [0, 1, M32, M32 - 1]
    rows = [(x, y, z, k) for x in edge for y in edge for z in edge
            for k in (0, 1)]
    rows += [tuple(int(v) for v in rng.integers(0, 1 << 32, 3)) + (k,)
             for k in (0, 1) for _ in range(100)]
    a, b, c, cin = (np.array(col, dtype=np.uint32) for col in zip(*rows))
    d, cout = np.zeros_like(a), np.zeros_like(a)
    assert harness.rh_cc(op, a.ctypes.data, b.ctypes.data, c.ctypes.data,
                         cin.ctypes.data, d.ctypes.data, cout.ctypes.data,
                         len(rows)) == 0
    got = list(zip((int(v) for v in d), (int(v) for v in cout)))
    assert got == [_cc_want(op, *r) for r in rows]


def _mont(a, b):
    """The lazy product exactly: (a b + M p) / R with M the one word-serial
    CIOS finds, a b (-p^-1) mod R; no final subtraction."""
    m = -a * b * pow(P, -1, RM) % RM
    return (a * b + m * P) // RM


def _ladd(a, b):
    s = a + b
    return s - P2 if s >= P2 else s


def _lsub(a, b):
    d = a - b
    return d + P2 if d < 0 else d


def _reduce(a):
    return a - P if a >= P else a


def _b3_g1(a):
    a4 = _ladd(*(_ladd(a, a),) * 2)
    return _ladd(_ladd(a4, a4), a)


def _mul2(a, b):
    t0, t1 = _mont(a[0], b[0]), _mont(a[1], b[1])
    t2 = _mont(_ladd(a[0], a[1]), _ladd(b[0], b[1]))
    return _lsub(t0, t1), _lsub(t2, _ladd(t0, t1))


def _b3_g2(a):
    inv82 = pow(82, -1, P)
    k0, k1 = (v * inv82 % P * RM % P for v in (81, P - 9))
    t0, t1 = _mont(k0, a[0]), _mont(k1, a[1])
    t2 = _mont((k0 + k1) % P, _ladd(a[0], a[1]))
    return _lsub(t0, t1), _lsub(t2, _ladd(t0, t1))


# lazy operands: 0, 1, p - 1, p - 2, and [p, 2p) -- the range values take
# inside an add -- then random values below 2p
CORE_EDGE = [0, 1, P - 1, P - 2, P, P + 1, P2 - 2, P2 - 1]
CORE_OPS = {                      # op: (model, Fp2?, operands below p only)
    0: (_mont, False, False), 1: (_ladd, False, False),
    2: (_lsub, False, False), 3: (lambda a, b: a + b, False, True),
    4: (lambda a, b: _reduce(a), False, False),
    5: (lambda a, b: _b3_g1(a), False, False),
    6: (_mul2, True, False),
    7: (lambda a, b: (_ladd(a[0], b[0]), _ladd(a[1], b[1])), True, False),
    8: (lambda a, b: (_lsub(a[0], b[0]), _lsub(a[1], b[1])), True, False),
    9: (lambda a, b: (_reduce(a[0]), _reduce(a[1])), True, False),
    10: (lambda a, b: _b3_g2(a), True, False),
}


@pytest.mark.parametrize("op", sorted(CORE_OPS))
def test_ec_core_lazy_ops(harness, op):
    """fp_ec.cuh's lazy operations, limb for limb, against an integer model
    of the same steps on every pair of edge operands and on random ones;
    and the model's values against crypto/bn254 (the product and 3b in
    Montgomery form, the sums and differences mod p, every result below 2p
    and reduce's below p)."""
    model, quad, reduced = CORE_OPS[op]
    edge = [v for v in CORE_EDGE if v < P] if reduced else CORE_EDGE
    top = P if reduced else P2
    rand = [v % top for v in _rand(40, 1 << 256, 400 + op)]
    if quad:
        xs = [(x, y) for x in edge for y in edge[::3]] + list(
            zip(rand[:20], rand[20:]))
        ys = xs[::-1]
    else:
        xs = [x for x in edge for _ in edge] + rand
        ys = [y for _ in edge for y in edge] + rand[::-1]
    flat = (lambda v: [c for e in v for c in e]) if quad else list
    a, b = _limbs(flat(xs)), _limbs(flat(ys))
    out = np.zeros_like(a)
    assert harness.rh_fp_lazy(op, a.ctypes.data, b.ctypes.data,
                              out.ctypes.data, len(xs)) == 0
    got = _ints(out)
    want = flat([model(x, y) for x, y in zip(xs, ys)])
    assert got == want
    assert max(want) < (P if op in (4, 9) else P2)
    rinv = pow(RM, -1, P)
    for x, y, r in zip(xs, ys, [model(x, y) for x, y in zip(xs, ys)]):
        if op == 0:
            assert r % P == x * y * rinv % P
        elif op == 5:
            assert r % P == 9 * x % P
        elif op == 6:
            w = bn.Fp2(x[0] * rinv % P, x[1] * rinv % P) * bn.Fp2(
                y[0] * rinv % P, y[1] * rinv % P)
            assert (r[0] % P, r[1] % P) == (w.c0 * RM % P, w.c1 * RM % P)
        elif op == 10:
            b3 = bn.Fp2(81, P - 9) * bn.Fp2(pow(82, -1, P), 0)
            w = b3 * bn.Fp2(x[0], x[1])
            assert (r[0] % P, r[1] % P) == (w.c0, w.c1)


def _scaled(curve, p, k, target):
    """Montgomery limbs of p's projective representative scaled by the
    element that makes coordinate k's limbs (its c0 in G2) equal `target`;
    the identity (0 : 1 : 0) scales by its y."""
    vals = _proj(curve, p)
    j = k * (2 if curve == "g2" else 1)
    if vals[j] == 0:
        j = 1 if curve == "g1" else 2
    lam = target * pow(vals[j], -1, P) % P
    return [v * lam % P for v in vals]


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_complete_add_scaled(harness, curve):
    """The add on representatives whose limbs sit at the edges of the lazy
    core's ranges: a coordinate (x, y or z) of p - 1 or 1, on each side, for
    the identity, P + P, P + (-P) and P + Q, against bn254 by affine
    value."""
    gen, mul, add, neg = ((bn.G1_GEN, bn.g1_mul, bn.g1_add, bn.g1_neg)
                          if curve == "g1" else
                          (bn.G2_GEN, bn.g2_mul, bn.g2_add, bn.g2_neg))
    Pt, Q = mul(gen, 4242), mul(gen, 777)
    pairs, a_rows, b_rows = [], [], []
    for x, y in [(None, Pt), (Pt, None), (None, None), (Pt, Pt),
                 (Pt, neg(Pt)), (Pt, Q)]:
        for k in range(3):
            for target in (P - 1, 1):
                pairs.append((x, y))
                a_rows.append(_scaled(curve, x, k, target))
                b_rows.append(_scaled(curve, y, (k + 1) % 3, P - target))
    a = _limbs([v for r in a_rows for v in r])
    b = _limbs([v for r in b_rows for v in r])
    fn = harness.rh_g1_add if curve == "g1" else harness.rh_g2_add
    out = np.zeros_like(a)
    fn(a.ctypes.data, b.ctypes.data, out.ctypes.data, len(pairs))
    na = 3 if curve == "g1" else 6
    vals = _ints(out)
    assert max(vals) < P
    got = [_affine(curve, vals[na * i:na * (i + 1)])
           for i in range(len(pairs))]
    assert got == [add(x, y) for x, y in pairs]


@pytest.mark.parametrize("curve,W,c", [("g1", 3, 4), ("g2", 3, 4),
                                       ("g1", 1, 16), ("g2", 2, 1)])
def test_horner(harness, curve, W, c):
    """ec.cuh's horner (the Horner kernels' body: its schedule of levels,
    the 32 lanes stepped in order) against ops/ec.plain_horner, limb for
    limb: the same doublings and adds in the same order, with the identity
    among the window sums; every slot below 2p at every level's end."""
    pts = [None] + _points_g(curve, W - 1, 500 + W)
    rw = tec.from_affine(pts[::-1], curve)
    out = torch.zeros((1, rw.shape[1], 8), dtype=torch.int32)
    assert harness.rh_horner(rw.shape[1], rw.data_ptr(), W, c,
                             out.data_ptr()) == 0
    assert torch.equal(out, tec.plain_horner(rw, c))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_horner_schedule(harness, curve):
    """The Horner's job table: built whole, its levels where the kernel
    runs them, each level's jobs independent (none reads a slot the level
    writes, no two write one slot: so the lanes may run them in any
    order), at most 32 jobs a level (one pass of the warp); and the kernel
    on c = 0 (the window sum's own level) and on edge representatives
    (a coordinate's limbs at p - 1 or 1) with every slot below 2p."""
    counts = np.zeros(6, dtype=np.int32)
    assert harness.rh_horner_schedule(3 if curve == "g1" else 6,
                                      counts.ctypes.data) == 0
    assert 0 < counts.min() and counts.max() <= 32
    gen = bn.G1_GEN if curve == "g1" else bn.G2_GEN
    mul = bn.g1_mul if curve == "g1" else bn.g2_mul
    rows = [_scaled(curve, p, k, t) for p, k, t in
            [(mul(gen, 5), 0, P - 1), (None, 1, 1), (mul(gen, 7), 2, P - 1),
             (mul(gen, 9), 1, 1)]]
    rw = torch.from_numpy(_limbs([v for r in rows for v in r]).view(
        np.int32)).reshape(4, -1, 8)
    for c in (0, 2):
        out = torch.zeros((1, rw.shape[1], 8), dtype=torch.int32)
        assert harness.rh_horner(rw.shape[1], rw.data_ptr(), 4, c,
                                 out.data_ptr()) == 0
        assert torch.equal(out, tec.plain_horner(rw, c))


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_point_double(harness, curve):
    """ec.cuh's pdbl (the doubling's schedule on one lane) limb for limb
    against ops/ec.plain_point_double, and by affine value against bn254's
    P + P: the identity, random subgroup points, and representatives with
    a coordinate's limbs at p - 1 or 1."""
    add = bn.g1_add if curve == "g1" else bn.g2_add
    pts = [None] + _points_g(curve, 3, 600)
    rows = [_proj(curve, p) for p in pts]
    rows += [_scaled(curve, p, k, t) for p in pts for k in range(3)
             for t in (P - 1, 1)]
    a = _limbs([v for r in rows for v in r])
    out = np.zeros_like(a)
    na = 3 if curve == "g1" else 6
    harness.rh_point_double(na, a.ctypes.data, out.ctypes.data, len(rows))
    got = torch.from_numpy(out.view(np.int32)).reshape(len(rows), na, 8)
    ta = torch.from_numpy(a.view(np.int32)).reshape(len(rows), na, 8)
    assert torch.equal(got, tec.plain_point_double(ta))
    vals = _ints(out)
    assert max(vals) < P
    aff = [_affine(curve, vals[na * i:na * (i + 1)]) for i in range(len(rows))]
    want = [add(p, p) for p in pts]
    assert aff == want + [w for w in want for _ in range(6)]


def _points_g(curve, k, seed):
    gen, mul = ((bn.G1_GEN, bn.g1_mul) if curve == "g1"
                else (bn.G2_GEN, bn.g2_mul))
    return [mul(gen, v) for v in _rand(k, bn.R, seed)]


def _np(t):
    return t.numpy().view(np.uint32)


def _from_mont(rows):
    rinv = pow(RM, -1, bn.R)
    return [v * rinv % bn.R for v in _ints(rows)]


def test_poseidon_sparse3(harness):
    a = [0, bn.R - 1, 0, bn.R - 1] + _rand(12, bn.R, 21)
    b = [0, 0, bn.R - 1, bn.R - 1] + _rand(12, bn.R, 22)
    am = _limbs([v * RM % bn.R for v in a])
    bm = _limbs([v * RM % bn.R for v in b])
    out = np.zeros_like(am)
    k = _np(tsparse.table("cpu"))
    harness.rh_poseidon_sparse3(am.ctypes.data, bm.ctypes.data, k.ctypes.data,
                                out.ctypes.data, len(a))
    assert _from_mont(out) == [poseidon([x, y]) for x, y in zip(a, b)]


@pytest.mark.parametrize("t", [3, 11, 17])
def test_poseidon_sparse_warp(harness, t):
    """One permutation of width t by the chain kernel's warp schedule (the
    tables of ops/poseidon_sparse.table), lane by lane on host threads."""
    states = [[0] * t, [0] + [bn.R - 1] * (t - 1), _rand(t, bn.R, 50 + t)]
    st = _limbs([v * RM % bn.R for s in states for v in s])
    k = _np(tsparse.table("cpu", t))
    out = np.zeros((len(states), 8), dtype=np.uint32)
    harness.rh_poseidon_sparse_warp(t, st.ctypes.data, k.ctypes.data,
                                    out.ctypes.data, len(states))
    assert _from_mont(out) == [permutation(s)[1] for s in states]


@pytest.mark.parametrize("t", [3, 6, 17])
def test_poseidon_plain(harness, t):
    n = 6
    states = [_rand(t, bn.R, 30 + t + i) for i in range(n)]
    states[0] = [0] * t
    states[1] = [0] + [bn.R - 1] * (t - 1)
    st = _limbs([v * RM % bn.R for s in states for v in s])
    c, m = (_np(x) for x in tpos.tables(t, "cpu"))
    out = np.zeros((n, 8), dtype=np.uint32)
    assert harness.rh_poseidon_plain(t, st.ctypes.data, c.ctypes.data,
                                     m.ctypes.data, out.ctypes.data, n) == 0
    assert _from_mont(out) == [permutation(s)[1] for s in states]


@pytest.mark.parametrize("t", [4, 6, 11, 17])
def test_poseidon_wide(harness, t):
    """The one-thread sparse schedule of k_wide (poseidon.cuh
    permute_wide) on the tables of ops/poseidon_sparse.table."""
    states = [[0] * t, [0] + [bn.R - 1] * (t - 1), [bn.R - 1] * t,
              _rand(t, bn.R, 70 + t)]
    st = _limbs([v * RM % bn.R for s in states for v in s])
    k = _np(tsparse.table("cpu", t))
    out = np.zeros((len(states), 8), dtype=np.uint32)
    assert harness.rh_poseidon_wide(t, st.ctypes.data, k.ctypes.data,
                                    out.ctypes.data, len(states)) == 0
    assert _from_mont(out) == [permutation(s)[1] for s in states]


@pytest.mark.parametrize("n", [16, 17, 31, 46, 80])
def test_poseidon_chain_rule(harness, n):
    """The chain kernel's whole schedule (chain_warp: blocks of width 17
    and one narrower tail on the sparse tables) on a host warp."""
    vals = _rand(n, bn.R, 100 + n)
    vals[-1] = bn.R - 1
    x = _limbs([v * RM % bn.R for v in vals])
    k17 = _np(tsparse.table("cpu", 17))
    kt = _np(tsparse.table("cpu", tpos._tail_width(n)))
    out = np.zeros((1, 8), dtype=np.uint32)
    harness.rh_poseidon_chain(x.ctypes.data, n, k17.ctypes.data,
                              kt.ctypes.data, out.ctypes.data)
    assert _from_mont(out) == [poseidon(vals)]


# --- the probes (csrc/probes.cuh) against their plain versions --------------

@pytest.mark.parametrize("body", range(6))
def test_probe_rate_bodies(harness, body):
    x, b = prates.inputs(body, 40, 200 + body, "cpu")
    want = prates.plain_rate(body, x, b, 2)
    got = x.clone()
    assert harness.rh_probe_rate(body, got.data_ptr(), b.data_ptr(), 40,
                                 2) == 0
    if x.dtype.is_floating_point:
        # g++ may contract x*b + b into an FMA where PyTorch rounds twice
        torch.testing.assert_close(got, want, rtol=prates.F32_TOL, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("form", pconv.FORMS)
def test_probe_conv_forms(harness, form):
    a, b = pconv.inputs(12, 3, "cpu")
    out = torch.empty_like(a)
    harness.rh_probe_conv(pconv.FORMS.index(form), a.data_ptr(),
                          b.data_ptr(), out.data_ptr(), 12)
    torch.testing.assert_close(out, pconv.plain_rounds(form, a, b),
                               rtol=pconv.TOL, atol=0)


# (columns, blocks resident): 3 slabs and 17 columns over 1, 2 and 3
# blocks (a block walks several slabs, the last one ragged), a whole slab,
# one column short of it, less than one slab, and probe_conv's ragged
# check's shape over 2 blocks (every thread refills each stage)
CONV_WALKS = [(3 * 128 + 17, 1), (3 * 128 + 17, 2), (3 * 128 + 17, 3),
              (128, 5), (127, 1), (50, 4), (pconv.ring_check_n(2)[0], 2)]


@pytest.mark.parametrize("n,resident", CONV_WALKS)
def test_probe_conv_ring(harness, n, resident):
    """k_conv_ring's walk (probes.cuh conv_walk: persistent blocks over
    slabs of 128 columns, each thread's columns fetched ahead into its
    slots of the ring): every output word written exactly once, no fetch
    outside the inputs, each thread's columns as probe_conv.ring_walks
    counts them, the grouped form's rounds within TOL."""
    a, b = pconv.inputs(n, 40 + n, "cpu")
    out = torch.full_like(a, float("nan"))
    writes = torch.zeros((pconv.ND, n), dtype=torch.int32)
    blocks = min(resident, -(-n // pconv.SLAB))
    walks = torch.full((blocks * pconv.SLAB,), -1, dtype=torch.int32)
    stray = harness.rh_probe_conv_ring(a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), n, resident,
                                       writes.data_ptr(), walks.data_ptr())
    assert stray == 0
    assert torch.equal(writes, torch.ones_like(writes))
    assert (int(walks.min()), int(walks.max())) == pconv.ring_walks(n, blocks)
    torch.testing.assert_close(out, pconv.plain_rounds("grouped", a, b),
                               rtol=pconv.TOL, atol=0)


def test_probe_conv_ring_constants():
    """probe_conv's copy of k_conv_ring's slab and ring (the ragged check's
    size and walks) is the header's; that check's shape makes every thread
    walk past its ring's stages, its last slab ragged."""
    with open(os.path.join(CSRC, "probes.cuh")) as f:
        text = f.read()
    for name, want in (("kConvSlab", pconv.SLAB),
                       ("kConvStages", pconv.STAGES)):
        assert re.search(rf"const int {name} = (\d+);", text).group(1) \
            == str(want)
    for resident in (1, 3, 396):
        n, blocks = pconv.ring_check_n(resident)
        assert blocks == resident and n % pconv.SLAB != 0
        assert pconv.ring_walks(n, blocks)[0] >= pconv.STAGES + 1


def test_probe_product_stages(harness):
    gen = torch.Generator().manual_seed(4)
    a, b = (pprod.random_fr(24, gen, "cpu") for _ in range(2))
    t = torch.empty((24, 16), dtype=torch.int32)
    harness.rh_probe_product(0, a.data_ptr(), b.data_ptr(), t.data_ptr(), 24)
    assert torch.equal(t, pprod.plain_product(a, b))
    r, m = (torch.empty((24, 8), dtype=torch.int32) for _ in range(2))
    harness.rh_probe_product(1, t.data_ptr(), None, r.data_ptr(), 24)
    assert torch.equal(r, pprod.plain_reduce(t))
    harness.rh_probe_product(2, a.data_ptr(), b.data_ptr(), m.data_ptr(), 24)
    assert torch.equal(m, pprod.plain_cios(a, b))
    assert torch.equal(m, r)


def test_probe_latency(harness):
    gen = torch.Generator().manual_seed(8)
    a, b = (pprod.random_fr(5, gen, "cpu") for _ in range(2))
    out = torch.empty_like(a)
    harness.rh_probe_latency(a.data_ptr(), b.data_ptr(), out.data_ptr(), 5,
                             37)
    assert torch.equal(out, platency.plain_mont_chain(a, b, 37))


@pytest.mark.parametrize("mode", psplit.MODES)
def test_probe_split_variants(harness, mode):
    """Each variant on an odd count of pairs (hashes2 / hashes4 leave a
    tail that runs on zeros and is not stored)."""
    lvl = psplit.random_level(10, 31, "cpu")
    a, b = lvl[0::2].contiguous(), lvl[1::2].contiguous()
    out = torch.empty_like(a)
    k = tsparse.table("cpu")
    assert harness.rh_probe_split(psplit.MODES.index(mode), a.data_ptr(),
                                  b.data_ptr(), k.data_ptr(), out.data_ptr(),
                                  5) == 0
    assert torch.equal(out, psplit.plain_split(mode, a, b))
    if mode == "full":
        assert torch.equal(out, tsparse.plain_hash2_mont_sparse(a, b))


@pytest.mark.parametrize("curve,stage", [
    ("g1", "copy"), ("g1", "structure"), ("g1", "local"), ("g1", "full"),
    ("g2", "copy"), ("g2", "structure"), ("g2", "full"),
    ("g1", "local_agg"), ("g2", "local"), ("g2", "local_agg"),
    ("g1", "three_pass"), ("g2", "three_pass")])
def test_probe_scan_passes(harness, curve, stage):
    """three_pass: the three passes (two levels of K = 16 blocks); the
    others: the single pass's walk at SEG_LANES x SEG_K elements a tile, in
    chunks of one and of two tiles -- structure being seg_scan.cuh with
    every add the wrapping add, local / local_agg / full seg_scan.cuh's
    stages (_check_stage).  No head in 17..79: a segment across blocks,
    tiles and chunks."""
    n = 300 if curve == "g1" else 140
    pts, heads = pscan.stream(curve, n, 6.0, 41, "cpu")
    heads[17:80] = 0
    if stage == "three_pass":
        out = torch.empty_like(pts)
        harness.rh_probe_scan(pts.shape[1], 1, pts.data_ptr(),
                              heads.data_ptr(), out.data_ptr(), n, pscan.K)
        assert torch.equal(out, pscan.plain_stage(stage, pts, heads)[0])
        return
    if stage in STAGE_PHASES:
        _check_stage(harness, stage, pts, heads)
        return
    for tpc in (1, 2):
        out = torch.zeros_like(pts)
        if stage == "structure":
            assert harness.rh_seg(pts.shape[1], 0, 1, SEG_LANES, SEG_K, tpc,
                                  2, pts.data_ptr(), heads.data_ptr(),
                                  out.data_ptr(), n) == 0
            assert torch.equal(out, pscan.plain_stage(stage, pts, heads)[0])
            continue
        chunk = SEG_TILE * tpc
        scratch = torch.zeros(16 + 8 * -(-n // chunk), dtype=torch.uint8)
        harness.rh_probe_scan_copy(pts.shape[1], SEG_LANES, SEG_K, tpc,
                                   pts.data_ptr(), heads.data_ptr(),
                                   out.data_ptr(), scratch.data_ptr(), n)
        want = heads.clone()
        want[0] = 1
        counts = [int(want[i:i + chunk].sum()) for i in range(0, n, chunk)]
        assert torch.equal(out, pts)
        assert pscan.chunk_counts(scratch, len(counts)).tolist() == counts


@pytest.mark.parametrize("tc", [4, 8])
@pytest.mark.parametrize("kind", ["dot", "mix"])
def test_probe_dot_ffma_slab(harness, kind, tc):
    """The FFMA route's register tile (probes.cuh dot_tile, 8 rows x tc
    columns a thread, W transposed) over one slab's chain against the
    plain chain, within the route's tolerance."""
    w, x = pdot.inputs(64, 19, "cpu")
    out = x.clone()
    harness.rh_probe_dot_slab(int(kind == "mix"), tc, w.data_ptr(),
                              out.data_ptr())
    err = C.max_rel_err(out, pdot.plain_chain(kind, w, x))
    assert err <= pdot.TOL[kind, "ffma"]


# --- the single-pass scan (csrc/seg_scan.cuh) -------------------------------

SEG_LANES, SEG_K = 3, 4                    # a tile of 12 elements here
SEG_TILE = SEG_LANES * SEG_K
STAGE_PHASES = {**pscan.PHASES, "full": 2}      # scan::Phase
SEG_STREAMS = {                            # kind: (n, head positions)
    "one_segment": (61, []),
    "all_heads": (30, "all"),
    "tile_starts": (36, list(range(0, 36, SEG_TILE))),
    "last_element": (29, [7, 28]),
    "single_element": (1, []),
    "ragged": (43, [3, 4, 11, 13, 24, 25, 26, 35]),
}


def _seg_stream(curve, kind):
    n, at = SEG_STREAMS[kind]
    gen, mul = ((bn.G1_GEN, bn.g1_mul) if curve == "g1"
                else (bn.G2_GEN, bn.g2_mul))
    rng = np.random.default_rng(len(kind) + n)
    pool = [mul(gen, int(k)) for k in rng.integers(1, 1 << 30, 4)] + [None]
    pts = tec.from_affine([pool[i] for i in rng.integers(0, len(pool), n)],
                          curve)
    heads = torch.zeros(n, dtype=torch.uint8)
    heads[list(range(n)) if at == "all" else at] = 1
    return pts, heads


@pytest.mark.parametrize("curve", ["g1", "g2"])
@pytest.mark.parametrize("kind", list(SEG_STREAMS))
def test_seg_scan_tiles(harness, curve, kind):
    """Both outputs against the plain versions, by affine value: the
    kernel adds in another order, so projective limbs differ."""
    pts, heads = _seg_stream(curve, kind)
    n = pts.shape[0]
    for sums, plain in ((0, tec.plain_seg_scan), (1, tec.plain_seg_sums)):
        want = plain(pts, heads)
        for tpc in (1, 2):                 # tiles a chunk
            out = torch.zeros_like(want)
            assert harness.rh_seg(pts.shape[1], sums, 0, SEG_LANES, SEG_K,
                                  tpc, 2, pts.data_ptr(), heads.data_ptr(),
                                  out.data_ptr(), n) == 0
            assert tec.to_affine(out) == tec.to_affine(want)


def _check_stage(harness, stage, pts, heads):
    """A stage of seg_scan.cuh (rh_seg_stage) in chunks of one and of two
    tiles of SEG_LANES x SEG_K: local bit for bit against
    plain_stage("local") (the plain scan with every lane start a head),
    local_agg's elements the same and its carries by affine value against
    the plain full scan at the element before each open lane (zero rows
    elsewhere), full by affine value against the plain full scan."""
    n, na = pts.shape[0], pts.shape[1]
    if stage == "full":
        want = tec.to_affine(tec.plain_seg_scan(pts, heads))
    else:
        local, carries = pscan.plain_stage(stage, pts, heads, lane_k=SEG_K)
    for tpc in (1, 2):
        out = torch.zeros_like(pts)
        lanes = -(-n // SEG_TILE) * SEG_LANES
        carry = torch.zeros((lanes, na, 8), dtype=torch.int32)
        assert harness.rh_seg_stage(na, STAGE_PHASES[stage], SEG_LANES,
                                    SEG_K, tpc, 2, pts.data_ptr(),
                                    heads.data_ptr(), out.data_ptr(),
                                    carry.data_ptr(), n) == 0
        if stage == "full":
            assert tec.to_affine(out) == want
            continue
        assert torch.equal(out, local)
        if stage == "local_agg":
            m = carries.shape[0]
            assert not carry[m:].any()
            assert tec.to_affine(carry[:m]) == tec.to_affine(carries)


@pytest.mark.parametrize("curve", ["g1", "g2"])
@pytest.mark.parametrize("kind", list(SEG_STREAMS))
@pytest.mark.parametrize("stage", list(STAGE_PHASES))
def test_seg_scan_stages(harness, curve, kind, stage):
    """seg_scan.cuh's stages (the probes' local, local_agg and full) on
    the streams that stress its tiles."""
    _check_stage(harness, stage, *_seg_stream(curve, kind))


@pytest.mark.parametrize("words,excl,done", [
    ([(1, 3), (1, 5), (2, 100), (1, 7)], 108, 1),   # stops at the prefix
    ([(2, 9), (1, 5)], 9, 1),
    ([(1, 1), (1, 2), (1, 4)], 7, 0),               # aggregates only
])
def test_seg_fold_counts(harness, words, excl, done):
    """The count look-back's fold over tiles that have published their own
    count only (1) or their inclusive count (2), nearest first."""
    w = np.array([(k << 62) | c for k, c in words], dtype=np.uint64)
    out = np.zeros(1, dtype=np.uint64)
    assert harness.rh_fold_counts(w.ctypes.data, len(words),
                                  out.ctypes.data) == done
    assert int(out[0]) == excl


@pytest.mark.parametrize("status,done", [
    ([1, 1, 3, 1], True),      # two aggregates, then an inclusive prefix
    ([1, 2], True),            # an aggregate, then a prefix with a head
    ([3], True),
    ([1, 1], False),           # aggregates only
])
def test_seg_fold_points(harness, status, done):
    """The point look-back's fold over chunks that have published their
    aggregate (1), their aggregate with a head (2) or their inclusive
    prefix (3), nearest first: the prefix is the first non-aggregate's
    point plus the aggregates after it, in stream order."""
    rng = np.random.default_rng(len(status))
    m = len(status)
    agg = [bn.g1_mul(bn.G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, m)]
    inc = [bn.g1_mul(bn.G1_GEN, int(k)) for k in rng.integers(1, 1 << 30, m)]
    x = torch.zeros((1, 3, 8), dtype=torch.int32)
    a, b = tec.from_affine(agg, "g1"), tec.from_affine(inc, "g1")
    st = np.array(status, dtype=np.uint32)
    assert harness.rh_fold_points(st.ctypes.data, a.data_ptr(), b.data_ptr(),
                                  m, x.data_ptr()) == int(done)
    if done:
        k = next(i for i, s in enumerate(status) if s != 1)
        want = inc[k] if status[k] == 3 else agg[k]
        for i in range(k - 1, -1, -1):
            want = bn.g1_add(want, agg[i])
        assert tec.to_affine(x) == [want]



# --- the row evaluation (csrc/csr.cuh) ---------------------------------------

# chunks of 3 lanes x 4 terms (and 2 x 5) here; the card's are 32 x 8
CSR_CHUNKS = ((3, 4), (2, 5))
CSR_SHAPES = {                      # kind: (row lengths, rows)
    "one_row": ([211], 1),             # 18 chunks: 36 slots to walk
    "empty_runs": ([0, 0, 3, 0, 0, 0, 5, 1, 0, 0, 13, 0, 2, 0, 0], 15),
    "row_one_chunk": ([5, 7, 12, 12, 3], 5),
    "row_on_chunk_last_term": ([11, 9, 3, 13, 1], 5),
    "padding_past_last_row": ([4, 9, 2], 16),
    "no_terms": ([0] * 10, 10),
    "random_long_rows": (None, 40),
}


def _csr_case(kind):
    """Terms sorted by row (int32 row ids, columns, coefficient ids), a
    pool of 5 and an x of 23 Montgomery elements with 0 and r - 1 among
    them, from a seed."""
    from zkpos_tpu_torch.ops import field as F
    lens, nrows = CSR_SHAPES[kind]
    rng = np.random.default_rng(len(kind))
    if lens is None:
        lens = list(rng.integers(0, 6, nrows))
        lens[5], lens[23] = 50, 29
    T = int(sum(lens))
    row = np.repeat(np.arange(len(lens)), lens).astype(np.int32)
    col = rng.integers(0, 23, T).astype(np.int32)
    cid = rng.integers(0, 5, T).astype(np.int32)
    pool = F.to_mont(F.ints_to_tensor([1, bn.R - 1, 0] + _rand(2, bn.R, 5)))
    x = F.to_mont(F.ints_to_tensor([bn.R - 1, 0] + _rand(21, bn.R, 6)))
    return row, col, cid, pool, x, nrows


@pytest.mark.parametrize("kind", list(CSR_SHAPES))
def test_csr_chunks(harness, kind):
    """The row evaluation's chunk logic (lane runs, the lanes' segmented
    scan, the carries and their fix-up) at a few lanes and terms a lane,
    bit for bit against ops/field.plain_csr_eval."""
    from zkpos_tpu_torch.ops import field as F
    row, col, cid, pool, x, nrows = _csr_case(kind)
    want = F.plain_csr_eval(*(torch.from_numpy(a) for a in (row, col, cid)),
                            pool, x, nrows)
    pn, xn = _np(pool), _np(x)
    for lanes, K in CSR_CHUNKS:
        out = np.full((nrows, 8), 0x5A5A5A5A, dtype=np.uint32)
        assert harness.rh_csr(lanes, K, row.ctypes.data, col.ctypes.data,
                              cid.ctypes.data, pn.ctypes.data, xn.ctypes.data,
                              len(row), nrows, out.ctypes.data) == 0
        assert np.array_equal(out, _np(want)), (lanes, K)
