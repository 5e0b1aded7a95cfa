"""The port's setup and H(X) on the CPU against the JAX package: with the
same toxic waste, every key point of the port's setup equals the JAX
package's (on its CPU path); H(X) from the port's QAP
evaluation and NTT pipeline equals groth16._compute_h; and the QAP rows of
a circuit with a 603-term lookup row equal the JAX package's
eval_matrix_device."""
import numpy as np
import torch

from zkpos_tpu.circuit.cs import ConstraintSystem as JCS
from zkpos_tpu.circuit.gadgets import LookupTable as JLookup
from zkpos_tpu.groth16 import groth16 as jg16
from zkpos_tpu.groth16 import qap_device as jqd
from zkpos_tpu.ops.fd32 import FR as JFR

from zkpos_tpu_torch.circuit.cs import ConstraintSystem as TCS
from zkpos_tpu_torch.circuit.gadgets import LookupTable as TLookup
from zkpos_tpu_torch.groth16 import groth16 as tg16
from zkpos_tpu_torch.groth16 import qap_device as tqd
from zkpos_tpu_torch.groth16.qap_device import compute_h_device
from zkpos_tpu_torch.ops import ec
from zkpos_tpu_torch.ops import field as F
from zkpos_tpu_torch.ops.msm_device import scalars_tensor

from tests.test_torch_groth16 import IDXS, WANT, build_lookup, fixed_rng

# the plain versions run many small ops: one thread per worker process
# keeps them from oversubscribing the cores next to the other workers
torch.set_num_threads(1)


def _arrays(points):
    return tg16.points_to_arrays(points)


def _same(a, b):
    (ca, ma), (cb, mb) = _arrays(a), _arrays(b)
    return np.array_equal(ma, mb) and np.array_equal(ca[ma], cb[mb])


def test_port_setup_matches_jax_keys():
    jcs = JCS(solve=False)
    build_lookup(jcs, JLookup)
    jpk, jvk = jg16.setup(jcs, rng=fixed_rng(300, 6))
    tcs = TCS(solve=False)
    build_lookup(tcs, TLookup)
    tpk, tvk = tg16.setup(tcs, rng=fixed_rng(300, 6), device="cpu")

    assert tpk.domain_size == jpk.domain_size
    assert tpk.num_public == jpk.num_public
    assert tpk.commit_wires == jpk.commit_wires
    assert tpk.challenge_wire == jpk.challenge_wire
    for name in ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2"):
        assert _same([getattr(tpk, name)], [getattr(jpk, name)]), name
    for name in ("a_g1", "b1_g1", "k_g1", "z_g1", "b_g2", "ck_bases",
                 "ck_sigma_bases"):
        assert _same(ec.to_affine(getattr(tpk, name)),
                     getattr(jpk, name)), name
    for name in ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "kc_g1",
                 "sigma_g2"):
        assert _same([getattr(tvk, name)], [getattr(jvk, name)]), name
    assert _same(tvk.k_gamma_g1, jvk.k_gamma_g1)


def test_compute_h_matches_reference():
    """Unkeyed solve (challenge from the host hash): the same witness in
    both packages, then H from each."""
    jcs = JCS(solve=True)
    build_lookup(jcs, JLookup, WANT, IDXS)
    z = jcs.witness_vector()
    d = 1
    while d < len(jcs.constraints):
        d *= 2
    want = jg16._compute_h(jcs, z, d)
    tcs = TCS(solve=True)
    build_lookup(tcs, TLookup, WANT, IDXS)
    assert tcs.witness_vector() == z
    h = compute_h_device(tcs, scalars_tensor(z, "cpu"), d)
    assert F.tensor_to_ints(h) == want


def test_eval_matrix_matches_jax_on_a_long_lookup_row():
    """A lookup table of 600 entries, three queries: its logUp sum row of
    A holds 603 terms.  Each matrix's rows from the port's
    eval_matrix_device against the JAX package's (its XLA CPU path), by
    canonical value."""
    entries, queries = 600, (3, 17, 599)

    def build(cs, lookup_cls):
        pub = cs.new_public(sum(i * i + 1 for i in queries))
        qs = [cs.new_witness(i) for i in queries]
        t = lookup_cls(cs)
        for v in range(entries):
            t.insert(v * v + 1)
        cs.assert_is_equal(cs.add(*t.lookup(*qs)), pub)
    jcs, tcs = JCS(solve=True), TCS(solve=True)
    build(jcs, JLookup)
    build(tcs, TLookup)
    z = jcs.witness_vector()
    assert tcs.witness_vector() == z
    d = 1
    while d < len(jcs.constraints):
        d *= 2
    assert np.bincount(tqd._matrix_arrays(tcs, 0)[0]).max() == 603
    zt = F.to_mont(scalars_tensor(z, "cpu"))
    r272 = 1 << 272
    zd = JFR.ints_to_digits([v * r272 % JFR.modulus for v in z])
    rinv = pow(r272, -1, JFR.modulus)
    for which in range(3):
        port = F.tensor_to_ints(F.from_mont(
            tqd.eval_matrix_device(tcs, zt, which, d)))
        out = jqd.eval_matrix_device(jcs, zd, which, d)
        assert port == [v * rinv % JFR.modulus
                        for v in JFR.digits_to_ints(np.asarray(out))]
