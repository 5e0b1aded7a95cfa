"""The port's point add, doubling, Horner and segmented scan
(zkpos_tpu_torch/ops/ec.py, the plain versions of csrc/ec_add.cu --
point_add, plain_point_double, horner -- and
csrc/seg_scan.cu: seg_scan and seg_sums) against the JAX package's CPU path
(zkpos_tpu/ops/msm_device.py: _padd, _padd of a point and itself,
_horner_windows, _seg_scan_hs) and
the bn254 host oracle.  Exact: affine points
compared with ==.
"""
import numpy as np
import pytest
import torch

from zkpos_tpu.crypto import bn254 as bn
from zkpos_tpu.ops import ec_f32 as ecf
from zkpos_tpu.ops import msm_device as jmd

from zkpos_tpu_torch.ops import ec
from zkpos_tpu_torch.groth16.groth16 import arrays_to_points, points_to_arrays

# the plain versions run many small ops: one thread per worker process
# keeps them from oversubscribing the cores next to the other workers
torch.set_num_threads(1)

CURVES = {
    "g1": (bn.G1_GEN, bn.g1_mul, bn.g1_add, bn.g1_neg, 3,
           ecf.g1_to_device, ecf.g1_from_device),
    "g2": (bn.G2_GEN, bn.g2_mul, bn.g2_add, bn.g2_neg, 6,
           ecf.g2_to_device, ecf.g2_from_device),
}


def _points(curve, k, seed):
    gen, mul = CURVES[curve][0], CURVES[curve][1]
    rng = np.random.default_rng(seed)
    return [mul(gen, int.from_bytes(rng.bytes(32), "little") % bn.R)
            for _ in range(k)]


def _to_port(curve, pts):
    """Reference points -> the port's tensors, through the array bridge."""
    return ec.from_affine(arrays_to_points(*points_to_arrays(pts)), curve)


def _jax_arrs(curve, pts):
    na, to_dev = CURVES[curve][4], CURVES[curve][5]
    return jmd._unwrap(na, to_dev(pts))


def _jax_affine(curve, raw):
    na, from_dev = CURVES[curve][4], CURVES[curve][6]
    return from_dev(jmd._wrap(na, jmd._finalize_pt(raw)))


def _same(a, b):
    ca, ma = points_to_arrays(a)
    cb, mb = points_to_arrays(b)
    return np.array_equal(ma, mb) and np.array_equal(ca[ma], cb[mb])


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_point_add_matches_jax_and_oracle(curve):
    _, _, add, neg, na, _, _ = CURVES[curve]
    P = _points(curve, 6, 11 if curve == "g1" else 12)
    pairs = [(None, P[0]), (P[1], None), (None, None), (P[2], P[2]),
             (P[3], neg(P[3])), (P[4], P[5]), (P[5], P[0])]
    xs, ys = [a for a, _ in pairs], [b for _, b in pairs]
    port = ec.to_affine(ec.point_add(_to_port(curve, xs), _to_port(curve, ys)))
    jax_out = _jax_affine(curve, jmd._padd(na, _jax_arrs(curve, xs),
                                           _jax_arrs(curve, ys)))
    oracle = [add(a, b) for a, b in pairs]
    assert _same(port, oracle)
    assert _same(jax_out, oracle)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_point_double_matches_jax_and_oracle(curve):
    """The dedicated doubling's plain version (ops/ec.plain_point_double,
    Algorithm 9) against the JAX package's complete add of a point to
    itself, _padd(na, a, a), and the oracle, by affine value: the identity,
    a point and its negation among them."""
    _, _, add, neg, na, _, _ = CURVES[curve]
    P = _points(curve, 3, 21 if curve == "g1" else 22)
    pts = [None, P[0], neg(P[0]), P[1], P[2]]
    port = ec.to_affine(ec.plain_point_double(_to_port(curve, pts)))
    arrs = _jax_arrs(curve, pts)
    jax_out = _jax_affine(curve, jmd._padd(na, arrs, arrs))
    oracle = [add(p, p) for p in pts]
    assert _same(port, oracle)
    assert _same(jax_out, oracle)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_point_add_broadcasts_one_point(curve):
    add = CURVES[curve][2]
    P = _points(curve, 3, 13)
    out = ec.to_affine(ec.point_add(_to_port(curve, P),
                                    _to_port(curve, [P[0]])))
    assert _same(out, [add(p, P[0]) for p in P])


@pytest.mark.parametrize("curve,L", [("g1", 48), ("g2", 24)])
def test_seg_scan_matches_jax_hs(curve, L):
    """A segment longer than one scan block, heads on block edges, and
    identity points inside segments."""
    import jax.numpy as jnp
    _, _, add, _, na, _, _ = CURVES[curve]
    P = _points(curve, 5, 14) + [None]
    rng = np.random.default_rng(15)
    pts = [P[i] for i in rng.integers(0, len(P), L)]
    heads = np.zeros(L, dtype=bool)
    heads[[4, 8, 16, L - 3]] = True        # block edges of the plain scan
    heads[5] = True
    # 16..L-3 is one segment spanning several blocks
    port = ec.to_affine(ec.seg_scan(_to_port(curve, pts),
                                    torch.from_numpy(heads)))
    arrs = tuple(a.reshape(34, L) for a in _jax_arrs(curve, pts))
    _, jout = jmd._seg_scan_hs(na, jnp.asarray(heads), arrs, axis=1)
    jax_out = _jax_affine(curve, jout)
    want, acc = [], None
    for i, (p, h) in enumerate(zip(pts, heads)):
        acc = p if (h or i == 0) else add(acc, p)
        want.append(acc)
    assert _same(port, want)
    assert _same(jax_out, want)


@pytest.mark.parametrize("curve,L", [("g1", 40), ("g2", 20)])
def test_seg_sums_matches_jax_hs_at_ends(curve, L):
    """Each segment's sum, in stream order: the JAX scan read at the
    segment ends.  Identity points inside segments, a segment of one
    element, a head on the last element, and no head at position 0 (the
    stream start counts as one)."""
    import jax.numpy as jnp
    _, _, add, _, na, _, _ = CURVES[curve]
    P = _points(curve, 4, 16) + [None, None]
    rng = np.random.default_rng(17)
    pts = [P[i] for i in rng.integers(0, len(P), L)]
    heads = np.zeros(L, dtype=bool)
    heads[[3, 4, 9, L - 1]] = True
    port = ec.to_affine(ec.seg_sums(_to_port(curve, pts),
                                    torch.from_numpy(heads)))
    arrs = tuple(a.reshape(34, L) for a in _jax_arrs(curve, pts))
    _, jout = jmd._seg_scan_hs(na, jnp.asarray(heads), arrs, axis=1)
    ends = [i for i in range(L) if i == L - 1 or heads[i + 1]]
    jax_out = [_jax_affine(curve, jout)[i] for i in ends]
    want, acc = [], None
    for i, (p, h) in enumerate(zip(pts, heads)):
        acc = p if (h or i == 0) else add(acc, p)
        if i in ends:
            want.append(acc)
    assert len(port) == 5
    assert _same(port, want)
    assert _same(jax_out, want)



@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_plain_horner_matches_jax_horner_windows(curve):
    """The MSM's Horner (ops/ec.horner, its plain version on the CPU)
    against the JAX package's _horner_windows and the oracle
    sum_w 2^(c w) rw[w], by affine value: the JAX loop starts from the
    identity, one add more, so its projective limbs differ.  The identity
    and a repeated point are among the window sums."""
    W, c = 3, 4
    _, mul, add, _, na, _, _ = CURVES[curve]
    P = _points(curve, 1, 18)
    pts = [P[0], None, P[0]]
    port = ec.to_affine(ec.horner(_to_port(curve, pts), c))
    assert _same(port, ec.to_affine(ec.plain_horner(_to_port(curve, pts), c)))
    arrs = tuple(a.reshape(34, W) for a in _jax_arrs(curve, pts))
    jax_out = _jax_affine(curve, jmd._horner_windows(na, W, c, arrs))
    want = None
    for w, p in enumerate(pts):
        if p is not None:
            want = add(want, mul(p, 1 << (c * w)))
    assert _same(port, [want])
    assert _same(jax_out, [want])
