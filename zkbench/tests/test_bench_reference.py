"""The reference against the program's own host oracles and its CPU
prove: exact agreement.  (The reference imports nothing of the program;
these tests may.)"""

import random

import numpy as np
import torch

import tinycells as T
from zkbench import gen
from zkbench.runners.prove import g2_pair, truncated
from zkbench.reference import fr, host, tree_check
from zkbench.reference.prove_check import ProveReference, matrix_terms

R = host.R
RNG = random.Random(11)
A = [RNG.randrange(R) for _ in range(40)] + [0, 1, R - 1]
B = [RNG.randrange(R) for _ in range(40)] + [R - 1, 0, R - 1]


def test_field_products_and_inverses():
    a, b = fr.limbs_of(A, "cpu"), fr.limbs_of(B, "cpu")
    rinv = pow(1 << 256, -1, R)
    assert fr.ints_of(fr.mont_mul(a, b)) == [x * y * rinv % R
                                             for x, y in zip(A, B)]
    assert fr.ints_of(fr.from_mont(fr.to_mont(a))) == A
    assert fr.ints_of(fr.sub_mod(a, b)) == [(x - y) % R for x, y in zip(A, B)]
    nz = fr.limbs_of(A[:40], "cpu")
    inv = fr.from_mont(fr.batch_inverse_mont(fr.to_mont(nz)))
    assert fr.ints_of(inv) == [pow(x, -1, R) for x in A[:40]]
    assert fr.ints_of(fr.from_mont(fr.powers_mont(7, 37, "cpu"))) == \
        [pow(7, i, R) for i in range(37)]


def test_wide_integers_are_exact():
    a, b = fr.limbs_of(A, "cpu"), fr.limbs_of(B, "cpu")
    assert fr.ints_of(fr.normalize(fr.wide(a, b), 1)) == \
        [x * y for x, y in zip(A, B)]
    assert fr.dot_int(a, b, block=7) == sum(x * y for x, y in zip(A, B))


def test_host_against_the_program_oracles():
    from zkpos_tpu_torch.crypto import bn254 as bn
    from zkpos_tpu_torch.crypto.poseidon_ref import poseidon
    from zkpos_tpu_torch.groth16.ntt import root_of_unity
    from zkpos_tpu_torch.merkle.tree import nil_hashes
    assert host.hash2(5, 9) == poseidon([5, 9])
    assert tree_check.nil_hashes(3) == nil_hashes(3)
    assert host.g1_mul(host.G1_GEN, R - 5) == bn.g1_mul(bn.G1_GEN, R - 5)
    assert host.g2_mul(host.G2_GEN, 98765) == g2_pair(
        bn.g2_mul(bn.G2_GEN, 98765))
    assert host.root_of_unity(12) == root_of_unity(12)


def test_matrix_terms_match_the_program_flattening():
    from zkpos_tpu_torch.groth16.qap_device import _matrix_arrays
    cs = T.product_circuit()
    for which in range(3):
        got = matrix_terms(cs.constraints, which)
        want = _matrix_arrays(cs, which)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_closed_form_equals_the_program_prove():
    """The port's own CPU prove (about 40 s) against the closed form, and
    the control's points (top window cut) differ from both."""
    from zkpos_tpu_torch.circuit import solver_native as sn
    from zkpos_tpu_torch.groth16 import groth16 as g16
    torch.set_num_threads(2)
    cs = T.product_circuit()
    draws = random.Random(3)
    waste = [draws.randrange(1, R) for _ in range(6)]
    pk, vk = g16.setup(cs, rng=iter(waste).__next__, device="cpu")
    big = R - 12345                      # a witness value above 2^240
    solved = sn.solve(cs, [T.product_value(big, 5), big, 5], None)
    toxic = dict(zip(("alpha", "beta", "gamma", "delta", "tau"), waste))
    ref = ProveReference(cs.constraints, cs.num_vars, cs.num_public,
                         cs.commitment, toxic, "cpu")
    r, s = 1234567, 7654321
    it = iter((r, s))
    proof = g16.prove(solved, pk, rng=it.__next__)
    ev = ref.evaluate(solved.values_u64)
    want = ref.points(*ref.scalars(ev, r, s))
    assert (proof.ar, g2_pair(proof.bs), proof.krs) == want
    assert g16.verify(proof, vk, solved.public_values())
    cut = ref.evaluate(truncated(solved.values_u64, 240))
    ctl = ref.points(*ref.scalars(cut, r, s, hz=ev["a"] * ev["b"] - ev["c"]))
    assert all(c != w for c, w in zip(ctl, want))


def test_tree_check_finds_a_wrong_node():
    from zkpos_tpu_torch.merkle.tree import AccountTree
    leaves = gen.leaves(16, 5, "cpu")
    tree = AccountTree(depth=6, device="cpu")
    tree.build_from_leaves(leaves)

    def read(level, pos):
        return [int.from_bytes(b, "big")
                for b in tree.read_nodes([(level, pos)])[0]]

    def leaf_at(pos):
        return gen.leaf_ints(leaves[torch.tensor(pos)])
    ok = tree_check.check_tree(read, leaf_at, 16, 6, random.Random(1), 4)
    assert ok["leaves_wrong"] == ok["nodes_wrong"] == 0
    tree.levels[2] = tree.levels[2].clone()
    tree.levels[2][1, 0] += 1
    bad = tree_check.check_tree(read, leaf_at, 16, 6, random.Random(1), 64)
    assert bad["nodes_wrong"] >= 1


def test_generators_repeat_for_a_seed():
    a = gen.leaves(32, 2 ** 31 + 5, "cpu")
    assert torch.equal(a, gen.leaves(32, 2 ** 31 + 5, "cpu"))
    assert not torch.equal(a, gen.leaves(32, 2 ** 31 + 6, "cpu"))
    assert all(v < R for v in gen.leaf_ints(a))
    assert gen.sub_seed(7, "x") == gen.sub_seed(7, "x") != gen.sub_seed(8, "x")
