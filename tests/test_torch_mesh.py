"""The port's multi-device paths (zkpos_tpu_torch/parallel/mesh.py, driven
by graft.dryrun_multichip) on CPU ranks over gloo, against the JAX
package's host oracles: the root by crypto/poseidon_ref level by level,
the sums by crypto/bn254, and the port's single-process MSM
(msm_device.msm).

The ranks run the plain versions at the JAX dryrun's sizes
(__graft_entry__.py:73-108): 32 leaves a rank; 4 G1 and 4 G2 bases a rank
at c = 4 with scalars below 2^8; 16 points a rank for the double-and-add
and the point fold.  They are spawned once a world size, joined through a
FileStore under the test's tmp_path.

The JAX package's own mesh functions take minutes to compile cold on the
CPU (sharded_tree_root at 2 devices x 32 leaves about 78 s, the dryrun's
sharded_stream_msm about 90 s, again at every world size), so the test
that feeds them the same inputs on the 8-device virtual mesh of
conftest.py is marked slow.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from zkpos_tpu.crypto import bn254 as jbn
from zkpos_tpu.crypto.poseidon_ref import poseidon as jposeidon

from zkpos_tpu_torch import graft
from zkpos_tpu_torch.ops import ec, field as F, msm_device as md
from zkpos_tpu_torch.parallel import mesh as pm

WORLDS = (1, 2, 4)
SUMS = ("stream_msm_g1", "stream_msm_g2", "dbl_msm", "point_fold")


def _ints(p):
    """An affine point of either package as ints (None: the identity)."""
    if p is None:
        return None
    out = []
    for c in p:
        out += [c] if isinstance(c, int) else [c.c0, c.c1]
    return tuple(out)


def _jax_sum(curve, pts, scalars):
    add, mul = ((jbn.g1_add, jbn.g1_mul) if curve == "g1"
                else (jbn.g2_add, jbn.g2_mul))
    acc = None
    for p, s in zip(pts, scalars):
        if s:
            acc = add(acc, mul(_jax_point(curve, p), s))
    return acc


def _jax_point(curve, p):
    if curve == "g1":
        return p
    return tuple(jbn.Fp2(c.c0, c.c1) for c in p)


def _jax_oracle(world):
    inp = graft.dryrun_inputs(world)
    level = inp["leaves"]
    while len(level) > 1:
        level = [jposeidon([level[i], level[i + 1]])
                 for i in range(0, len(level), 2)]
    return inp, {
        "root": level[0],
        "stream_msm_g1": _jax_sum("g1", inp["g1"], inp["msm_scalars"]),
        "stream_msm_g2": _jax_sum("g2", inp["g2"], inp["msm_scalars"]),
        "dbl_msm": _jax_sum("g1", inp["dbl"], inp["dbl_scalars"]),
        "point_fold": _jax_sum("g1", inp["dbl"], [1] * len(inp["dbl"])),
    }


def _single(curve, pts, scalars):
    """The port's MSM in one process, on the CPU, over the dryrun's two
    window rows."""
    base = md.device_base(curve, pts, device="cpu")
    return md.msm(curve, base, plan=md.ScalarPlan(
        scalars, c=graft.MSM_C, device="cpu", windows=graft.MSM_WINDOWS))


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_matches_jax_oracle(world, tmp_path):
    results = graft.dryrun_multichip(world, backend="gloo", device="cpu",
                                     store_dir=str(tmp_path))
    inp, want = _jax_oracle(world)
    single = {
        "stream_msm_g1": _single("g1", inp["g1"], inp["msm_scalars"]),
        "stream_msm_g2": _single("g2", inp["g2"], inp["msm_scalars"]),
        "dbl_msm": _single("g1", inp["dbl"], inp["dbl_scalars"]),
        "point_fold": _single("g1", inp["dbl"], [1] * len(inp["dbl"])),
    }
    assert len(results) == world
    for rank in results:
        assert rank["device"] == "cpu"
        assert rank["shard"] == graft.LEAVES
        res = rank["results"]
        assert res["root"] == want["root"]
        for k in SUMS:
            assert want[k] is not None
            assert _ints(res[k]) == _ints(want[k]) == _ints(single[k]), k


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, and its CPU mesh."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield pm.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _mont_rows(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % jbn.R
            for _ in range(n)]
    return vals, F.to_mont(F.ints_to_tensor(vals))


@pytest.mark.parametrize("n", [3, 6, 0])
def test_shard_not_power_of_two_raises(one_rank, n):
    leaves = torch.zeros((n, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        pm.sharded_tree_root(one_rank, leaves)
    with pytest.raises(ValueError, match="power of two"):
        pm.merkle_fold(leaves)


def test_one_rank_mesh_functions(one_rank):
    """The mesh functions on one rank: the root of 8 leaves, and the point
    fold and double-and-add of 5 points with one scalar 0."""
    vals, leaves = _mont_rows(8, 1)
    level = vals
    while len(level) > 1:
        level = [jposeidon([level[i], level[i + 1]])
                 for i in range(0, len(level), 2)]
    root = pm.sharded_tree_root(one_rank, leaves)
    assert F.tensor_to_ints(F.from_mont(root)) == level
    pts = [jbn.g1_mul(jbn.G1_GEN, 11 * i + 1) for i in range(5)]
    sc = [0, 1, 2, 300, (1 << 40) + 3]
    t = ec.from_affine(pts, "g1")
    acc = pm.sharded_msm(one_rank, t, sc)
    assert ec.to_affine(acc)[0] == _jax_sum("g1", pts, sc)
    fold = pm.sharded_point_fold(one_rank, t)
    assert ec.to_affine(fold)[0] == _jax_sum("g1", pts, [1] * 5)
    assert pm.scalar_bits(md.scalars_tensor([0, 0], "cpu")).shape == (0, 2)


@pytest.mark.slow
@pytest.mark.parametrize("world", WORLDS)
def test_jax_mesh_matches_port(world, tmp_path):
    """The JAX package's sharded_tree_root and sharded_stream_msm (G1, G2)
    on `world` devices of the virtual CPU mesh, on the dryrun's inputs,
    equal the port's sharded results."""
    import jax
    import jax.numpy as jnp
    from zkpos_tpu.ops import ec_f32 as ecf, fr
    from zkpos_tpu.ops import msm_device as jmd
    from zkpos_tpu.parallel import mesh as jmesh

    port = graft.dryrun_multichip(world, backend="gloo", device="cpu",
                                  store_dir=str(tmp_path))[0]["results"]
    inp = graft.dryrun_inputs(world)
    mesh = jmesh.make_mesh(world)
    leaves = fr.to_mont(jnp.asarray(fr.ints_to_limbs(inp["leaves"])))
    root = jmesh.sharded_tree_root(mesh, leaves)
    assert fr.limbs_to_ints(fr.from_mont(root)) == [port["root"]]

    k, c = graft.MSM_POINTS, graft.MSM_C
    digs = np.stack([jmd.windows_of(inp["msm_scalars"][d * k:(d + 1) * k],
                                    c)[:2] for d in range(world)])
    idxs = np.broadcast_to(np.arange(1, k + 1, dtype=np.int32),
                           digs.shape).copy()
    for curve in ("g1", "g2"):
        pts = [_jax_point(curve, p) for p in inp[curve]]
        na = 3 if curve == "g1" else 6
        bases = [jmd.device_base(curve, pts[d * k:(d + 1) * k], quantum=8)
                 for d in range(world)]
        bases_u8 = tuple(jnp.stack([np.asarray(b[i]) for b in bases])
                         for i in range(na))
        acc = jmesh.sharded_stream_msm(
            mesh, bases_u8, jnp.asarray(digs.astype(np.int32)),
            jnp.asarray(idxs), c)
        fe = [ecf.F1.wrap(jnp.asarray(np.asarray(a)), 10.0) for a in acc]
        if curve == "g1":
            got = ecf.g1_from_device(tuple(fe))[0]
        else:
            got = ecf.g2_from_device(tuple(zip(fe[0::2], fe[1::2])))[0]
        assert _ints(got) == _ints(port[f"stream_msm_{curve}"]), curve
    jax.clear_caches()
