"""The port's sorted-stream MSM (zkpos_tpu_torch/ops/msm_device.py) against
the JAX package's engine (zkpos_tpu/ops/msm_device.msm, on its CPU path)
and the bn254 host oracle; the window decomposition against the JAX
package's at every width the prove uses.

The MSMs run at c = 8: on the CPU one JAX MSM at c = 12 already takes
most of a minute (its bucket fold scans a 22 x 4096 grid), so c = 12
(G2) and c = 16 (G1) are checked on the card by chip_smoke.py.
"""
import zlib

import numpy as np
import pytest
import torch

from zkpos_tpu.crypto import bn254 as bn
from zkpos_tpu.ops import msm_device as jmd

from zkpos_tpu_torch.ops import msm_device as tmd
from zkpos_tpu_torch.groth16.groth16 import arrays_to_points, points_to_arrays

# the plain versions run many small ops: one thread per worker process
# keeps them from oversubscribing the cores next to the other workers
torch.set_num_threads(1)

N = 37          # not a multiple of the stream padding quantum


def _rand(rng):
    return int.from_bytes(rng.bytes(32), "little") % bn.R


def _points(curve, n, rng):
    gen, mul = ((bn.G1_GEN, bn.g1_mul) if curve == "g1"
                else (bn.G2_GEN, bn.g2_mul))
    return [mul(gen, _rand(rng)) for _ in range(n)]


def _oracle(curve, pts, sc):
    add, mul = ((bn.g1_add, bn.g1_mul) if curve == "g1"
                else (bn.g2_add, bn.g2_mul))
    acc = None
    for p, s in zip(pts, sc):
        if p is not None and s % bn.R:
            acc = add(acc, mul(p, s % bn.R))
    return acc


def _port(curve, pts, sc, c):
    base = tmd.device_base(curve, arrays_to_points(*points_to_arrays(pts)),
                           device="cpu")
    return tmd.msm(curve, base, plan=tmd.ScalarPlan(sc, c=c, device="cpu"))


def _jax(curve, pts, sc, c):
    return jmd.msm(curve, jmd.device_base(curve, pts),
                   plan=jmd.ScalarPlan(sc, c=c))


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    ca, _ = points_to_arrays([a])
    cb, _ = points_to_arrays([b])
    return np.array_equal(ca, cb)


def _scalars(kind, rng):
    if kind == "random":
        return [_rand(rng) for _ in range(N)]
    if kind == "duplicate_heavy":            # witness-like: 0s, 1s, repeats
        return [int(rng.choice([0, 0, 0, 1, 1, 2, 5])) if i % 5 else
                _rand(rng) for i in range(N)]
    if kind == "all_equal_digits":           # every window digit the same
        d = 0x5A
        return [sum(d << (8 * w) for w in range(31)) % bn.R] * N
    if kind == "boundary":
        return [1, bn.R - 1, (1 << 253) % bn.R, 2 ** 64, 2 ** 128 - 1,
                bn.R - 2] + [_rand(rng) for _ in range(N - 6)]
    raise ValueError(kind)


@pytest.mark.parametrize("curve,kind", [
    ("g1", "random"), ("g1", "duplicate_heavy"), ("g1", "all_equal_digits"),
    ("g1", "boundary"), ("g2", "random")])
def test_msm_matches_jax_engine(curve, kind):
    rng = np.random.default_rng(zlib.crc32(f"{curve}-{kind}".encode()))
    pts = _points(curve, N, rng)
    pts[3] = None                            # an unused key slot
    sc = _scalars(kind, rng)
    want = _oracle(curve, pts, sc)
    assert _same(_port(curve, pts, sc, 8), want)
    assert _same(_jax(curve, pts, sc, 8), want)


def test_msm_of_zero_scalars_is_none():
    rng = np.random.default_rng(21)
    pts = _points("g1", 5, rng)
    assert _port("g1", pts, [0] * 5, 8) is None
    assert _jax("g1", pts, [0] * 5, 8) is None


@pytest.mark.parametrize("c", [8, 12, 16])
def test_windows_match_jax(c):
    rng = np.random.default_rng(c)
    sc = [0, 1, bn.R - 1] + [_rand(rng) for _ in range(50)]
    port = tmd.windows_of(tmd.scalars_tensor(sc, "cpu"), c).numpy()
    assert np.array_equal(port, jmd.windows_of(sc, c).astype(np.int32))
    rows = np.frombuffer(b"".join(s.to_bytes(32, "little") for s in sc),
                         dtype=np.uint64).reshape(-1, 4)
    assert np.array_equal(
        tmd.windows_of(tmd.scalars_tensor(rows, "cpu"), c).numpy(), port)


@pytest.mark.parametrize("n", [1, 600, 1 << 12, 1 << 17, 1 << 21])
def test_pick_c_matches_jax(n):
    assert tmd.pick_c(n) == jmd.pick_c(n)


def test_plan_pads_front_with_identity_index():
    """The front padding carries digit 0 and reads base row 0, so it lands
    in bucket 0, which the fold weights 0 (the base has no identity row);
    each scalar's row follows in stable digit order."""
    plan = tmd.ScalarPlan([3, 0, 7], c=8, device="cpu")
    assert plan.Np % tmd.PAD_QUANTUM == 0 and plan.Np >= 3
    pad = plan.Np - 3
    assert plan.dig[0].tolist() == [0] * (pad + 1) + [3, 7]
    assert plan.idx[0].tolist() == [0] * pad + [1, 0, 2]
    assert plan.dig[1:].eq(0).all()
    assert plan.idx[1:].tolist() == [[0] * pad + [0, 1, 2]] * (plan.W - 1)
    assert bool((plan.dig[:, 1:] >= plan.dig[:, :-1]).all())


@pytest.mark.parametrize("curve,kind", [
    ("g1", "small"), ("g2", "small"), ("g1", "zero"), ("g2", "zero")])
def test_msm_point_is_msm(curve, kind):
    """msm_point's projective sum, read as an affine point, is msm's and
    the oracle's at c = 8.  The small scalars (below 2^20) go through a
    plan that keeps the 3 low windows they fill, which raises on a scalar
    above them (full-width plans: test_msm_matches_jax_engine); the zero
    ones through a full plan."""
    rng = np.random.default_rng(zlib.crc32(f"point-{curve}-{kind}".encode()))
    pts = _points(curve, 9, rng)
    base = tmd.device_base(curve, arrays_to_points(*points_to_arrays(pts)),
                           device="cpu")
    if kind == "small":
        sc = [int(v) for v in rng.integers(0, 1 << 20, 9)]
        plan = tmd.ScalarPlan(sc, c=8, device="cpu", windows=3)
        assert plan.W == 3
        with pytest.raises(ValueError, match="not below 2\\^24"):
            tmd.ScalarPlan(sc[:-1] + [1 << 24], c=8, device="cpu",
                           windows=3)
    else:
        sc = [0] * 9
        plan = tmd.ScalarPlan(sc, c=8, device="cpu")
        assert plan.W == 32 and plan.K == 0
    p = tmd.msm_point(curve, base, plan=plan)
    assert p.shape == (1, 3 if curve == "g1" else 6, 8)
    got = tmd.ec.to_affine(p)[0]
    want = _oracle(curve, pts, sc)
    assert (got is None) == (kind == "zero")
    assert _same(got, want) and _same(tmd.msm(curve, base, plan=plan), want)
