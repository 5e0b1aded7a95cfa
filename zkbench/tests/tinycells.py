"""Cells of the benchmark at sizes the CPU runs in seconds, for the tests:
the tree cell over 256 leaves at depth 10, and the prove cell's runner on
a small circuit of products (no commitment) in place of the
BatchCreateUser statement, its two batches two assignments of it with
full-width field values, as the statement's hashes are."""

from __future__ import annotations

from zkbench import manifest
from zkbench.runners import prove as prove_runner
from zkbench.reference.host import R

TREE = {"leaves": 256, "tree_depth": 10}


class TinyBench(manifest.Bench):
    """BENCHMARK.json as it is, with the tree configuration cut."""

    def config(self, name):
        cfg = super().config(name)
        if name == "tree28":
            cfg.update(TREE)
        return cfg


def product_circuit():
    from zkpos_tpu_torch.circuit.cs import ConstraintSystem
    cs = ConstraintSystem(solve=False, range_bits=8)
    out, a, b = cs.new_public(), cs.new_witness(), cs.new_witness()
    q = cs.mul(cs.mul(a, b), a)
    for k in range(5):
        q = cs.mul(q, cs.add(b, k))
    cs.assert_is_equal(cs.add(q, b), out)
    cs.finalize()
    return cs


def product_value(a: int, b: int) -> int:
    q = a * b * a
    for k in range(5):
        q = q * (b + k)
    return (q + b) % R


class TinyProve(prove_runner.Cell):
    """The prove runner on product_circuit: its set-up, window and check
    as they are, the statement and the batches' inputs small."""

    def configure(self):
        pass

    def statement(self):
        return product_circuit()

    def batch_inputs(self):
        return [[product_value(a, b), a, b]
                for a, b in ((R - 3, 5), (R - 7, 11))[:self.traffic["batches"]]]


def tiny_runner(name):
    mod = manifest.runner(name)
    if name != "prove":
        return mod

    class Mod:
        Cell = TinyProve
        control = staticmethod(mod.control)
    return Mod


def standin(cell):
    """The prove cell's program replaced by a correct closed-form prover
    (the reference's points from the toxic waste), so that the CPU tests
    drive many proves in seconds; `fault` plants one fault in it:
      "stale": every prove after the first returns the first proof;
      "half": the witness MSMs over half of the batch's wires (the
              second half zeroed);
      "altered": the proof's C altered where it is produced."""
    from zkpos_tpu_torch.crypto import bn254 as bn
    from zkpos_tpu_torch.groth16.groth16 import Proof
    from zkbench.reference.prove_check import ProveReference, hz_of

    def install(fault=None):
        state = {}

        def prove_fn(solved, pk, rng, spans=None):
            if "ref" not in state:
                state["ref"] = ProveReference(
                    solved.constraints, solved.num_vars, solved.num_public,
                    solved.commitment, cell.toxic, cell.dev)
            ref = state["ref"]
            z = solved.values_u64
            r, s = rng(), rng()
            if fault == "stale" and "first" in state:
                return state["first"]
            ev = ref.evaluate(z)
            hz = hz_of(ev)
            if fault == "half":
                cut = z.copy()
                cut[len(z) // 2:] = 0
                ev = ref.evaluate(cut)
            a, b, c = ref.points(*ref.scalars(ev, r, s, hz=hz))
            if fault == "altered":
                c = bn.g1_add(c, bn.G1_GEN)
            proof = Proof(ar=a, bs=(bn.Fp2(*b[0]), bn.Fp2(*b[1])), krs=c)
            state.setdefault("first", proof)
            return proof
        cell.prove_fn = prove_fn
    return install
