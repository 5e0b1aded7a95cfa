"""The port's batch circuit and witness pipeline at the tiny test tier
(universe 4, tier 3:2, depth-8 tree, as tests/test_integration.py) against
the JAX package: the compiled constraint system is identical array for
array; the port's witness pipeline (leaves and account tree on the plain
versions of the Poseidon kernels) agrees with the JAX package's host
oracles (leaf hashes, Merkle proof check, CEX commitment) and satisfies
the circuit it was built for.

The port's keygen -> prove -> verify of a BatchCreateUser circuit runs on
the card (chip_smoke.py, at full size): on the CPU the plain EC versions
would need many minutes for even the smallest tier's 8,000 constraints.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from zkpos_tpu.utils import constants as JC
from zkpos_tpu_torch.utils import constants as TC

# the plain versions run many small ops: one thread per worker process
# keeps them from oversubscribing the cores next to the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _sizes():
    saved = [(C, C.ASSET_COUNTS, C.TIER_COUNT, C.ACCOUNT_TREE_DEPTH)
             for C in (JC, TC)]
    env = os.environ.get("ZKPOR_TEST_TIERS")
    for C in (JC, TC):
        C.configure(asset_counts=4, tier_count=2, tree_depth=8)
    os.environ["ZKPOR_TEST_TIERS"] = "3:2"
    yield
    for C, *vals in saved:
        C.configure(*vals)
    if env is None:
        os.environ.pop("ZKPOR_TEST_TIERS", None)
    else:
        os.environ["ZKPOR_TEST_TIERS"] = env


def _pkg(name):
    import importlib
    mods = {m: importlib.import_module(f"{name}.{m}") for m in (
        "utils.constants", "utils.types", "utils.commitments",
        "witness.core", "circuit.batch_create_user", "services.keygen")}
    return mods


@pytest.fixture(scope="module")
def port_witness(_sizes):
    """The port's witness pipeline, run once for the module's tests."""
    m = _pkg("zkpos_tpu_torch")
    C, T, cm = m["utils.constants"], m["utils.types"], m["utils.commitments"]
    cex = chip_smoke.make_cex_assets(
        C, T.TierRatio, T.CexAssetInfo, cm.calculate_precomputed_value,
        cm.padding_tier_ratios)
    before = [cm.cex_asset_elements(a) for a in cex]
    accounts = chip_smoke.make_accounts(
        C, cex, 2, 3, T.AccountAsset, T.AccountInfo,
        cm.calculate_asset_value_for_collateral)
    wcore = m["witness.core"]
    by_tier, capacity = wcore.prepare_accounts({3: accounts})
    tree = wcore.build_account_tree(by_tier, capacity, device="cpu")
    wits = list(wcore.generate_batch_witnesses(tree, by_tier, cex))
    assert len(wits) == 1
    _, wit = wits[0]
    wcore.densify_ops_assets(wit)
    return by_tier[3], before, tree, wit


def test_compile_tier_matches_jax():
    jcs = _pkg("zkpos_tpu")["services.keygen"].compile_tier(3, 2)
    tcs = _pkg("zkpos_tpu_torch")["services.keygen"].compile_tier(3, 2)
    assert (tcs.num_vars, tcs.num_public) == (jcs.num_vars, jcs.num_public)
    assert tcs.commitment == jcs.commitment
    a, b = jcs.constraints, tcs.constraints
    for field in ("lens", "vars", "coeffs"):
        assert np.array_equal(np.frombuffer(getattr(a, field), np.uint32),
                              np.frombuffer(getattr(b, field), np.uint32))
    assert a.pool == b.pool


def test_witness_pipeline_matches_jax_host_oracles(port_witness):
    from zkpos_tpu.crypto.bn254 import fr_from_bytes, fr_to_bytes
    from zkpos_tpu.crypto.poseidon_ref import poseidon
    from zkpos_tpu.merkle.tree import verify_proof
    from zkpos_tpu.utils import commitments as jcm
    from zkpos_tpu.utils import types as jtypes
    accounts, before, tree, wit = port_witness
    root = tree.root()
    assert wit.account_tree_root == root
    for acc, op in zip(accounts, wit.create_user_ops):
        jacc = jtypes.AccountInfo(
            account_id=acc.account_id, total_equity=acc.total_equity,
            total_debt=acc.total_debt, total_collateral=acc.total_collateral,
            assets=[jtypes.AccountAsset(
                index=a.index, equity=a.equity, debt=a.debt, loan=a.loan,
                margin=a.margin, portfolio_margin=a.portfolio_margin)
                for a in acc.assets])
        leaf = jcm.account_info_to_hash(jacc)
        assert tree.get(acc.account_index) == leaf
        assert verify_proof(root, acc.account_index, op.account_proof, leaf,
                            depth=8)
    flat = [e for elems in before for e in elems]
    assert wit.before_cex_assets_commitment == fr_to_bytes(poseidon(flat))
    assert fr_from_bytes(wit.batch_commitment) == poseidon([
        fr_from_bytes(root), fr_from_bytes(wit.before_cex_assets_commitment),
        fr_from_bytes(wit.after_cex_assets_commitment),
        wit.min_account_index, wit.max_account_index])


def test_port_witness_satisfies_circuit(port_witness):
    m = _pkg("zkpos_tpu_torch")
    from zkpos_tpu_torch.circuit.cs import ConstraintSystem
    bcu = m["circuit.batch_create_user"]
    _, _, _, wit = port_witness
    w = bcu.set_batch_create_user_circuit_witness(wit)
    cs = ConstraintSystem(solve=True)
    bcu.define(cs, w)
    assert cs.is_satisfied()
    assert cs.num_public == 2
