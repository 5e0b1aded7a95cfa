"""The whole slice on the CPU: a proof from the port equals the JAX
package's proof point for point and byte for byte (serialize), and keys
cross between the packages through their artifacts.

The lookup-plus-commitment circuit of tests/test_groth16.py is set up and
proved by the JAX package on its own CPU path with a fixed rng.  (Its
ZKPOS_HOST_ONLY=1 path gives the same keys and proof, but its pure-Python
scalar multiplications take minutes for this circuit.)  Groth16's proof is a deterministic function of (cs, pk, r, s),
so the port, given the same keys (carried across with keys_from_arrays)
and the same r and s, must produce the same points; and the JAX package's
verifier must accept the port's proof.

The setup and the two proofs run once (a module fixture); the tests on
them hold, exactly: proof_to_bytes and vk_to_bytes against the JAX
package's; a pk written by the port (its bases in projective
representatives with Z != 1) read by zkpos_tpu.groth16.artifact as the JAX
keys' points, and the JAX package's artifacts read by the port as
keys_from_arrays of the same keys, limb for limb; keygen.run's three
artifacts; and a compile_tier(3, 2) r1cs artifact with its solver program
through both packages' loaders.
"""
import dataclasses
import gzip
import os
import pickle
import weakref

import numpy as np
import pytest
import torch

from zkpos_tpu.crypto import bn254 as jbn
from zkpos_tpu.circuit.cs import ConstraintSystem as JCS
from zkpos_tpu.circuit.gadgets import LookupTable as JLookup
from zkpos_tpu.groth16 import artifact as jaf
from zkpos_tpu.groth16 import groth16 as jg16
from zkpos_tpu.groth16 import serialize as jser

from zkpos_tpu_torch.circuit.cs import ConstraintSystem as TCS
from zkpos_tpu_torch.circuit.gadgets import LookupTable as TLookup
from zkpos_tpu_torch.groth16 import artifact as taf
from zkpos_tpu_torch.groth16 import groth16 as tg16
from zkpos_tpu_torch.groth16 import serialize as tser
from zkpos_tpu_torch.ops import field as F
from zkpos_tpu_torch.services import keygen as tkeygen
from zkpos_tpu_torch.utils import trace as ttrace

# the plain versions run many small ops: one thread per worker process
# keeps them from oversubscribing the cores next to the other workers
torch.set_num_threads(1)

TABLE = (7, 9)
IDXS = [1, 1, 0]
WANT = sum(TABLE[i] for i in IDXS)


def build_lookup(cs, lookup_cls, pub_out=None, idxs=None):
    """tests/test_groth16.py:build_lookup, for either package."""
    pub = cs.new_public(pub_out)
    if idxs is None:
        idxs = [None] * 3
    qs = [cs.new_witness(i) for i in idxs]
    t = lookup_cls(cs)
    for v in TABLE:
        t.insert(v)
    outs = t.lookup(*qs)
    cs.assert_is_equal(cs.add(*outs), pub)


def fixed_rng(seed, n):
    vals = [int.from_bytes(np.random.default_rng(seed + i).bytes(32),
                           "little") % (jbn.R - 1) + 1 for i in range(n)]
    it = iter(vals)
    return lambda: next(it)


def key_arrays(pk, vk):
    """The JAX keys as the arrays keys_from_arrays takes."""
    arr = tg16.points_to_arrays
    pk_a = {}
    for name in ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2"):
        pk_a[name] = arr([getattr(pk, name)])
    for name in ("a_g1", "b1_g1", "k_g1", "z_g1", "b_g2", "ck_bases",
                 "ck_sigma_bases"):
        pts = getattr(pk, name)
        pk_a[name] = None if pts is None else arr(pts)
    for name in ("num_public", "domain_size", "commit_wires",
                 "challenge_wire"):
        pk_a[name] = getattr(pk, name)
    vk_a = {}
    for name in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "kc_g1",
                 "sigma_g2", "beta_g1", "delta_g1"):
        p = getattr(vk, name)
        vk_a[name] = None if p is None else arr([p])
    vk_a["k_gamma_g1"] = arr(vk.k_gamma_g1)
    vk_a["num_public"] = vk.num_public
    vk_a["public_and_commitment_committed"] = \
        vk.public_and_commitment_committed
    return pk_a, vk_a


def jax_points(coords, mask):
    out = []
    for row, present in zip(coords, mask):
        v = [int.from_bytes(c.tobytes(), "little") for c in row]
        out.append(None if not present else (v[0], v[1]) if len(v) == 2
                   else (jbn.Fp2(v[0], v[1]), jbn.Fp2(v[2], v[3])))
    return out


@pytest.fixture(scope="module")
def proved():
    """The JAX package's keys and proof, and the port's proof under those
    keys with the same r and s."""
    compile_cs = JCS(solve=False)
    build_lookup(compile_cs, JLookup)
    jpk, jvk = jg16.setup(compile_cs, rng=fixed_rng(100, 6))
    jcs = JCS(solve=True)
    build_lookup(jcs, JLookup, WANT, IDXS)
    jproof = jg16.prove(jcs, jpk, rng=fixed_rng(200, 2))
    tpk, tvk = tg16.keys_from_arrays(*key_arrays(jpk, jvk), device="cpu")
    tcs = TCS(solve=True)
    build_lookup(tcs, TLookup, WANT, IDXS)
    tproof = tg16.prove(tcs, tpk, rng=fixed_rng(200, 2))
    return {"jpk": jpk, "jvk": jvk, "jproof": jproof, "tpk": tpk,
            "tvk": tvk, "tproof": tproof}


def test_port_proof_equals_jax_proof(proved):
    jproof, jvk = proved["jproof"], proved["jvk"]
    tproof, tvk = proved["tproof"], proved["tvk"]
    assert jg16.verify(jproof, jvk, [WANT])
    got = tg16.proof_to_arrays(tproof)
    for name in ("ar", "bs", "krs", "d", "pok"):
        want = tg16.points_to_arrays([getattr(jproof, name)])
        assert np.array_equal(got[name][0], want[0]), name
        assert np.array_equal(got[name][1], want[1]), name

    carried = jg16.Proof(**{name: jax_points(*got[name])[0]
                            for name in got})
    assert jg16.verify(carried, jvk, [WANT])
    assert not jg16.verify(carried, jvk, [WANT + 1])
    assert tg16.verify(tproof, tvk, [WANT])


def test_streamed_bases_prove_the_same_bytes(proved, monkeypatch):
    """A key budget of 0 (groth16.place_bases): every MSM base lives in
    host memory, and each prove MSM gets a copy of it, freed after the
    MSM (on the CPU the copy is a clone); with the streams cut into two
    chunks as well (ZKPOS_MSM_CHUNK: 256 columns of 480 or 512), the proof
    bytes equal the resident key's under the same r and s."""
    tpk = proved["tpk"]
    assert tpk.streamed == frozenset()
    pk = tg16.place_bases(dataclasses.replace(tpk), budget=0)
    assert pk.streamed == {name for name, _ in tg16.MSM_BASES}
    copies = []
    msm = tg16.md.msm

    def spy(curve, base, **kw):
        copies.append((base.data_ptr(), weakref.ref(base)))
        return msm(curve, base, **kw)
    monkeypatch.setattr(tg16.md, "msm", spy)
    monkeypatch.setenv("ZKPOS_MSM_CHUNK", str(256 * 32))
    tcs = TCS(solve=True)
    build_lookup(tcs, TLookup, WANT, IDXS)
    spans = {}
    proof = tg16.prove(tcs, pk, rng=fixed_rng(200, 2), spans=spans)
    assert tser.proof_to_bytes(proof) == tser.proof_to_bytes(proved["tproof"])
    assert spans["chunks"] == {"msm_a": 2, "msm_b1": 2, "msm_b2": 2,
                               "msm_k": 2, "msm_z": 2}
    # the prove traced (prove(spans=) runs inside trace.capture()): its
    # stages under the root, each MSM's base copied in its own span, two
    # chunks of a gather each, and the stage seconds from the spans
    recs = ttrace.records()
    root = [r for r in recs if r["name"] == "prove"][-1]
    mine = [r for r in recs if r["root"] == root["id"] and r is not root]
    by_id = {r["id"]: r for r in mine}

    def stage_of(r):
        while r["parent"] != root["id"]:
            r = by_id[r["parent"]]
        return r["name"]
    stages = [r["name"] for r in mine if r["parent"] == root["id"]]
    assert stages == ["compute_h", "plan_z", "msm_a", "msm_b1", "msm_b2",
                      "msm_k", "msm_z", "assemble"]
    for r in mine:
        if r["parent"] == root["id"]:
            assert spans[r["name"]] == r["end"] - r["start"]
    for st in ("msm_a", "msm_b1", "msm_b2", "msm_k", "msm_z"):
        kids = [r["name"] for r in mine if stage_of(r) == st]
        assert kids.count("chunk") == 2 and kids.count("gather") == 2, st
        assert kids.count("base_upload") == 1 and kids.count("msm") == 1
    assert [r["name"] for r in mine if stage_of(r) == "assemble"
            and r["name"] != "assemble"] == ["fixed"] * 3 + \
        ["dependent"] * 2 + ["fixed"]
    assert [r["name"] for r in mine if stage_of(r) == "compute_h"
            and r["name"] != "compute_h"] == ["upload", "csr_eval", "ntt"]
    homes = {getattr(pk, name).data_ptr() for name, _ in tg16.MSM_BASES}
    prove_msms = copies[-5:]
    assert not homes & {ptr for ptr, _ in prove_msms}
    assert all(ref() is None for _, ref in prove_msms)


# --- proof and key bytes, and the artifacts both packages read ---------------

def test_proof_bytes_equal_jax(proved):
    """serialize.proof_to_bytes of the port's proof equals the JAX
    package's, byte for byte, and reads back as the same points."""
    want = jser.proof_to_bytes(proved["jproof"])
    got = tser.proof_to_bytes(proved["tproof"])
    assert got == want
    assert tser.proof_to_base64(proved["tproof"]) == \
        jser.proof_to_base64(proved["jproof"])
    back = tser.proof_from_base64(tser.proof_to_base64(proved["tproof"]))
    assert back == proved["tproof"]
    assert tg16.verify(back, proved["tvk"], [WANT])


def test_vk_bytes_equal_jax(proved):
    want = jser.vk_to_bytes(proved["jvk"])
    assert tser.vk_to_bytes(proved["tvk"]) == want
    back = tser.vk_from_bytes(want)
    for name in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "k_gamma_g1",
                 "num_public", "kc_g1", "sigma_g2", "beta_g1", "delta_g1",
                 "public_and_commitment_committed"):
        assert getattr(back, name) == getattr(proved["tvk"], name), name


def _rescaled(pts, seed):
    """The same points in another projective representative: every
    coordinate times a random nonzero lambda of Fp (one per point)."""
    n, na = pts.shape[0], pts.shape[1]
    raw = torch.zeros((n, 8), dtype=torch.int32)
    raw[:, 0] = torch.randint(1, 1 << 30, (n,), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(seed))
    lam = F.to_mont(raw, F.FP).repeat_interleave(na, 0)
    return F.mul(pts.reshape(-1, 8).contiguous(), lam, F.FP).reshape(
        pts.shape)


def test_pk_written_by_port_loads_in_jax(proved, tmp_path):
    """A pk whose bases are in other projective representatives than
    affine (Z != 1) is normalised on save: the JAX package's loader reads
    the JAX keys' points back; the vk file is the gnark bytes."""
    tpk = proved["tpk"]
    scaled = dataclasses.replace(tpk, **{
        name: _rescaled(getattr(tpk, name), i)
        for i, name in enumerate(("a_g1", "b1_g1", "k_g1", "z_g1", "b_g2",
                                  "ck_bases", "ck_sigma_bases"))})
    assert not torch.equal(scaled.a_g1, tpk.a_g1)
    taf.save(str(tmp_path / "t.pk"), scaled)
    taf.save(str(tmp_path / "t.vk"), proved["tvk"])
    back = jaf.load(str(tmp_path / "t.pk"))
    jpk = proved["jpk"]
    for name in ("a_g1", "b1_g1", "k_g1", "z_g1", "b_g2", "ck_bases",
                 "ck_sigma_bases"):
        assert list(getattr(back, name)) == list(getattr(jpk, name)), name
    for name in ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2",
                 "num_public", "domain_size", "commit_wires",
                 "challenge_wire"):
        assert getattr(back, name) == getattr(jpk, name), name
    with open(tmp_path / "t.vk", "rb") as f:
        assert f.read() == jser.vk_to_bytes(proved["jvk"])
    assert jaf.load(str(tmp_path / "t.vk")).k_gamma_g1 == \
        proved["jvk"].k_gamma_g1


def test_pk_written_by_jax_loads_in_port(proved, tmp_path):
    """The JAX package's artifacts load into the port as keys_from_arrays
    of the same keys: every base tensor equal, limb for limb."""
    jaf.save(str(tmp_path / "j.pk"), proved["jpk"])
    jaf.save(str(tmp_path / "j.vk"), proved["jvk"])
    pk = taf.load(str(tmp_path / "j.pk"), device="cpu")
    want = proved["tpk"]
    for name in ("a_g1", "b1_g1", "k_g1", "z_g1", "b_g2", "ck_bases",
                 "ck_sigma_bases"):
        assert torch.equal(getattr(pk, name), getattr(want, name)), name
    for name in ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2",
                 "num_public", "domain_size", "commit_wires",
                 "challenge_wire"):
        assert getattr(pk, name) == getattr(want, name), name
    vk = taf.load(str(tmp_path / "j.vk"))
    assert tser.vk_to_bytes(vk) == tser.vk_to_bytes(proved["tvk"])
    # not a container; and the JAX package's legacy gzip-pickle, which the
    # port does not read
    with pytest.raises(ValueError, match="not a ZKPOS artifact"):
        taf.load_pk(str(tmp_path / "j.vk"), device="cpu")
    with gzip.open(tmp_path / "old.pk", "wb") as f:
        pickle.dump({"legacy": 1}, f)
    with pytest.raises(ValueError, match="gzip-pickle"):
        taf.load(str(tmp_path / "old.pk"))


def test_keygen_run_writes_artifacts(proved, tmp_path, monkeypatch):
    """keygen.run on the CPU, with the lookup circuit in place of the
    BatchCreateUser tier (whose setup needs the card) and setup returning
    the fixture's keys: the three artifacts, the recorded solver program,
    the keys read back, and a second run that skips."""
    def compile_lookup(assets, batch, range_bits=8):
        cs = TCS(solve=False, range_bits=range_bits)
        build_lookup(cs, TLookup)
        cs.finalize()
        return cs
    monkeypatch.setattr(tkeygen, "compile_tier", compile_lookup)
    monkeypatch.setattr(tkeygen.g16, "setup",
                        lambda cs, device=None: (proved["tpk"], proved["tvk"]))
    prefix = str(tmp_path / "keys" / "zkpor")
    spans = {}
    made = tkeygen.run(prefix, tiers={3: 2}, device="cpu", spans=spans)
    assert made == {3: (proved["tpk"], proved["tvk"])}
    pk_f, vk_f, r1cs_f = tkeygen.key_file_names(prefix, 3, 2)
    assert set(spans[3]["bytes"]) == {os.path.basename(f)
                                      for f in (pk_f, vk_f, r1cs_f)}
    r1cs = tkeygen.load_artifact(r1cs_f)
    assert r1cs["solver_program"] is not None
    assert r1cs["commitment"]["wires"] == proved["tpk"].commit_wires
    pk = tkeygen.load_artifact(pk_f, device="cpu")
    for name in ("a_g1", "z_g1", "b_g2", "ck_bases"):
        assert torch.equal(getattr(pk, name), getattr(proved["tpk"], name))
    assert tser.vk_to_bytes(tkeygen.load_artifact(vk_f)) == \
        jser.vk_to_bytes(proved["jvk"])
    assert tkeygen.run(prefix, tiers={3: 2}, device="cpu") == {}


def test_r1cs_artifact_round_trip_both_packages(tmp_path):
    """compile_tier(3, 2) at universe 4, tier count 2, depth 8, with its
    solver program: written by the port, read by the JAX package, written
    again by it and read back by the port, every array equal."""
    from zkpos_tpu_torch.circuit import solver_native as tsn
    from zkpos_tpu_torch.utils import constants as TC
    saved = (TC.ASSET_COUNTS, TC.TIER_COUNT, TC.ACCOUNT_TREE_DEPTH)
    TC.configure(asset_counts=4, tier_count=2, tree_depth=8)
    try:
        cs = tkeygen.compile_tier(3, 2)
        meta = {"num_vars": cs.num_vars, "num_public": cs.num_public,
                "num_constraints": len(cs.constraints),
                "range_bits": cs.range_bits, "commitment": cs.commitment,
                "constraints": cs.constraints,
                "solver_program": tsn.program_to_dict(
                    tsn.record_program(cs))}
    finally:
        TC.configure(*saved)
    taf.save(str(tmp_path / "t.r1cs"), meta)
    jmeta = jaf.load(str(tmp_path / "t.r1cs"))
    jaf.save(str(tmp_path / "j.r1cs"), jmeta)
    back = taf.load(str(tmp_path / "j.r1cs"))
    for got in (jmeta, back):
        for key in ("num_vars", "num_public", "num_constraints",
                    "range_bits", "commitment"):
            assert got[key] == meta[key], key
        fc, want = got["constraints"], meta["constraints"]
        for attr in ("vars", "coeffs", "lens"):
            assert bytes(getattr(fc, attr)) == bytes(getattr(want, attr))
        assert list(fc.pool) == list(want.pool)
        sp, wp = got["solver_program"], meta["solver_program"]
        for key in ("n_cons", "n_vars", "boundary", "hint_boundary",
                    "commit_wires", "challenge_wire"):
            assert sp[key] == wp[key], key
        assert sorted(sp["arrays"]) == sorted(wp["arrays"])
        for k, arr in wp["arrays"].items():
            assert np.array_equal(sp["arrays"][k], arr), k
