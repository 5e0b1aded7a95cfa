"""The port's device account tree and witness service on the CPU (the plain
versions of the Poseidon kernels), against the JAX package:

* AccountTree at depth 10 over 37 leaves (odd counts on several levels)
  against zkpos_tpu.merkle.tree.AccountTree: every level, the root and
  get_proofs_batch for every key; and the port's plain-schedule
  hash2_mont on each level's pairs against the JAX tree's next level,
  which zkpos_tpu.ops.poseidon.hash2_mont (the jnp body of the Pallas
  _hash2_kernel) computed;
* WitnessService prepare -> run_witness -> run_userproof on sqlite at
  asset universe 4, depth 12, tier 4:8 with 8 accounts: the row counts, a
  second run that writes nothing, and userproof rows whose leaves equal
  the JAX host leaf hash and whose proofs verify with
  zkpos_tpu.merkle.tree.verify_proof;
* generate_batch_witnesses over three batches, whole and resumed: every
  CEX commitment (computed ahead in one chain launch) against the JAX
  package's host Poseidon over the running totals.
"""
import base64
import json
import os
import random

import pytest
import torch

import chip_smoke
from zkpos_tpu.crypto.bn254 import R
from zkpos_tpu.merkle import tree as jtree
from zkpos_tpu.ops import fr as jfr
from zkpos_tpu.utils import commitments as jcm
from zkpos_tpu.utils import constants as JC
from zkpos_tpu.utils import types as jtypes
from zkpos_tpu_torch.ops import field as F
from zkpos_tpu_torch.ops import poseidon as tpos
from zkpos_tpu_torch.merkle.tree import AccountTree
from zkpos_tpu_torch.utils import constants as TC

torch.set_num_threads(1)
RINV = pow(1 << 256, -1, R)


@pytest.fixture
def _sizes():
    saved = [(C, C.ASSET_COUNTS, C.TIER_COUNT, C.ACCOUNT_TREE_DEPTH)
             for C in (JC, TC)]
    env = os.environ.get("ZKPOR_TEST_TIERS")
    for C in (JC, TC):
        C.configure(asset_counts=4, tier_count=12, tree_depth=12)
    os.environ["ZKPOR_TEST_TIERS"] = "4:8"
    yield
    for C, *vals in saved:
        C.configure(*vals)
    if env is None:
        os.environ.pop("ZKPOR_TEST_TIERS", None)
    else:
        os.environ["ZKPOR_TEST_TIERS"] = env


def _canon(mont_ints):
    return [v * RINV % R for v in mont_ints]


def test_tree_matches_jax():
    rng = random.Random(5)
    leaves = [0, R - 1] + [rng.randrange(R) for _ in range(35)]
    ref = jtree.AccountTree(depth=10)
    ref.build_chunk = 64      # one small compiled shape for every level
    ref.build_from_leaf_ints(leaves)
    got = AccountTree(depth=10, device="cpu")
    got.build_from_leaf_ints(leaves)
    assert len(got.levels) == len(ref.levels) == 11
    for k, (a, b) in enumerate(zip(got.levels, ref.levels)):
        assert _canon(F.tensor_to_ints(a)) == _canon(
            jfr.limbs_to_ints(b)), f"level {k}"
    assert got.root() == ref.root()
    keys = list(range(40)) + [1023]
    assert got.get_proofs_batch(keys) == ref.get_proofs_batch(keys)
    assert got.get_proof(36) == ref.get_proof(36)
    assert got.get(5) == ref.get(5)
    # the plain schedule at t = 3 against the jnp hash2_mont that built
    # the JAX tree's populated levels
    for k in range(6):
        cur = got.levels[k]
        if cur.shape[0] % 2:
            cur = torch.cat([cur, got._nil_mont(k)])
        nxt = tpos.hash2_mont(cur[0::2].contiguous(), cur[1::2].contiguous())
        assert _canon(F.tensor_to_ints(nxt)) == _canon(
            jfr.limbs_to_ints(ref.levels[k + 1])), f"level {k + 1}"


def test_witness_service(_sizes, tmp_path):
    from zkpos_tpu_torch.services.config import ServiceConfig
    from zkpos_tpu_torch.services.witness import WitnessService
    from zkpos_tpu_torch.utils import commitments as cm
    from zkpos_tpu_torch.utils import types as T
    cex = chip_smoke.make_cex_assets(
        TC, T.TierRatio, T.CexAssetInfo, cm.calculate_precomputed_value,
        cm.padding_tier_ratios)
    accounts = chip_smoke.make_accounts(
        TC, cex, 8, 3, T.AccountAsset, T.AccountInfo,
        cm.calculate_asset_value_for_collateral)
    svc = WitnessService(ServiceConfig(db_path=str(tmp_path / "w.db")),
                         device="cpu")
    svc.prepare({4: accounts}, cex)
    assert svc.run_witness() == 1
    assert svc.run_userproof() == 8
    assert svc.run_witness() == 0
    assert svc.run_userproof() == 0
    root = svc.tree.root()
    for idx in range(8):
        row = svc.userproof_model.get_by_index(idx)
        config = json.loads(row.config)
        acc = jtypes.AccountInfo(
            account_id=bytes.fromhex(config["AccountIdHash"]),
            total_equity=config["TotalEquity"],
            total_debt=config["TotalDebt"],
            total_collateral=config["TotalCollateral"],
            assets=[jtypes.AccountAsset(
                index=a["Index"], equity=a["Equity"], debt=a["Debt"],
                loan=a["Loan"], margin=a["Margin"],
                portfolio_margin=a["PortfolioMargin"])
                for a in config["Assets"]])
        leaf = base64.b64decode(row.account_leaf)
        assert leaf == jcm.account_info_to_hash(acc)
        assert config["Root"] == root.hex()
        proof = [base64.b64decode(p) for p in config["Proof"]]
        assert jtree.verify_proof(root, idx, proof, leaf, depth=12)


def test_batched_cex_commitments(_sizes):
    """generate_batch_witnesses over three batches (asset universe 4, tier
    4:8): every before- and after-commitment, computed ahead in one chain
    launch, against the JAX package's host Poseidon over
    cex_asset_elements of the running totals (80 elements a commitment),
    in a whole run and in one resumed from start_height = 1; the running
    totals the generator leaves in its cex_assets argument are the final
    ones."""
    from zkpos_tpu.crypto.bn254 import fr_to_bytes
    from zkpos_tpu.crypto.poseidon_ref import poseidon
    from zkpos_tpu_torch.utils import commitments as cm
    from zkpos_tpu_torch.utils import types as T
    from zkpos_tpu_torch.witness import core as wcore
    cex = chip_smoke.make_cex_assets(
        TC, T.TierRatio, T.CexAssetInfo, cm.calculate_precomputed_value,
        cm.padding_tier_ratios)
    accounts = chip_smoke.make_accounts(
        TC, cex, 24, 3, T.AccountAsset, T.AccountInfo,
        cm.calculate_asset_value_for_collateral)
    by_tier, capacity = wcore.prepare_accounts({4: accounts})
    tree = wcore.build_account_tree(by_tier, capacity, device="cpu")

    def commit(state):
        elements = [e for a in state for e in jcm.cex_asset_elements(a)]
        assert len(elements) == 80
        return fr_to_bytes(poseidon(elements))

    totals = wcore._copy_cex(cex)
    expected = [commit(totals)]
    for b in range(3):
        for acc in by_tier[4][8 * b:8 * (b + 1)]:
            wcore._accumulate(totals, acc)
        expected.append(commit(totals))
    for start in (-1, 1):
        running = wcore._copy_cex(cex)
        wits = list(wcore.generate_batch_witnesses(tree, by_tier, running,
                                                   start_height=start))
        assert [h for h, _ in wits] == list(range(start + 1, 3))
        for h, wit in wits:
            assert wit.before_cex_assets_commitment == expected[h]
            assert wit.after_cex_assets_commitment == expected[h + 1]
            assert commit(wit.before_cex_assets) == expected[h]
        assert commit(running) == expected[3]
