"""Witness-generation core — parity with reference src/witness.

Pure functions (no storage): account padding/index assignment
(witness main.go:58-90), the device-built account tree over leaves hashed
in batches on the device (main.go:130-199), and per-batch
BatchCreateUserWitness construction with running CEX totals
(witness.go:138-212, fillCreateUserOp :319-340).  The service wrapper with
DB persistence/resume lives in services/witness.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Tuple

import torch

from ..crypto.bn254 import fr_from_bytes, fr_to_bytes
from ..crypto.poseidon_ref import poseidon
from ..merkle.tree import AccountTree
from ..ops import poseidon as pos
from ..utils import constants as C
from ..utils.commitments import cex_asset_elements, user_assets_elements
from ..utils.csv_ingest import padding_accounts
from ..utils.device import resolve
from ..utils.types import (AccountInfo, BatchCreateUserWitness, CexAssetInfo,
                           CreateUserOperation, TierRatio)


def prepare_accounts(accounts_by_tier: Dict[int, List[AccountInfo]],
                     tiers: Dict[int, int] | None = None
                     ) -> Tuple[Dict[int, List[AccountInfo]], int]:
    """Pad each tier to a batch multiple, assign sequential AccountIndex,
    give padding accounts AccountId = fr(sha256(index)) (main.go:58-90).
    Returns (padded accounts, capacity)."""
    tiers = tiers or C.get_tiers()
    out: Dict[int, List[AccountInfo]] = {}
    global_index = 0
    for k in sorted(accounts_by_tier):
        padded = padding_accounts(accounts_by_tier[k], k, tiers[k])
        for acc in padded:
            acc.account_index = global_index
            if not acc.account_id:
                h = hashlib.sha256(global_index.to_bytes(4, "big")).digest()
                acc.account_id = fr_to_bytes(fr_from_bytes(h))
            global_index += 1
        out[k] = padded
    return out, global_index


def account_leaves(accounts: List[AccountInfo], device=None) -> torch.Tensor:
    """Leaf hashes of one tier's accounts as (B, 8) Montgomery rows on the
    device (AccountInfoToHash per account, reference main.go:163-192): one
    batched chain hash for the asset commitments, then one 5-input hash
    for the leaves."""
    dev = resolve(device)
    rows = [user_assets_elements(a.assets) for a in accounts]
    n = len(rows[0])
    if any(len(r) != n for r in rows):
        raise ValueError("accounts of one tier must pad to one asset count")
    x = pos.mont_tensor([v for r in rows for v in r], dev)
    commitments = pos.hash_chain_mont(x.reshape(len(accounts), n, 8))
    head = pos.mont_tensor([v for a in accounts for v in (
        fr_from_bytes(a.account_id), a.total_equity, a.total_debt,
        a.total_collateral)], dev).reshape(len(accounts), 4, 8)
    return pos.hash_n_mont(torch.cat([head, commitments[:, None]], 1))


def build_account_tree(accounts_by_tier: Dict[int, List[AccountInfo]],
                       capacity: int, depth: int | None = None,
                       device=None) -> AccountTree:
    tree = AccountTree(depth=depth, capacity=capacity, device=device)
    leaves = torch.zeros((capacity, 8), dtype=torch.int32,
                         device=tree.device)
    for k in sorted(accounts_by_tier):
        accs = accounts_by_tier[k]
        if accs:
            idx = torch.tensor([a.account_index for a in accs],
                               device=tree.device)
            leaves[idx] = account_leaves(accs, tree.device)
    tree.build_from_mont_leaves(leaves)
    return tree


def _copy_cex(cex: List[CexAssetInfo]) -> List[CexAssetInfo]:
    return [CexAssetInfo(
        total_equity=a.total_equity, total_debt=a.total_debt,
        base_price=a.base_price, symbol=a.symbol, index=a.index,
        loan_collateral=a.loan_collateral,
        margin_collateral=a.margin_collateral,
        portfolio_margin_collateral=a.portfolio_margin_collateral,
        loan_ratios=[TierRatio(r.boundary_value, r.ratio, r.precomputed_value)
                     for r in a.loan_ratios],
        margin_ratios=[TierRatio(r.boundary_value, r.ratio,
                                 r.precomputed_value)
                       for r in a.margin_ratios],
        portfolio_margin_ratios=[TierRatio(r.boundary_value, r.ratio,
                                           r.precomputed_value)
                                 for r in a.portfolio_margin_ratios],
    ) for a in cex]


def _cex_elements(cex: List[CexAssetInfo]) -> List[int]:
    """The 20 x AssetCounts elements of a CEX commitment
    (witness.go:158-176)."""
    return [e for a in cex for e in cex_asset_elements(a)]


# batches whose CEX commitments go to the card in one launch: at the
# production 500 assets, 256 chains of 10,000 inputs are 82 MB of input
CHAIN_GROUP = 256


def _accumulate(cex_assets: List[CexAssetInfo], acc: AccountInfo) -> None:
    for asset in acc.assets:
        cx = cex_assets[asset.index]
        cx.total_equity += asset.equity
        cx.total_debt += asset.debt
        cx.loan_collateral += asset.loan
        cx.margin_collateral += asset.margin
        cx.portfolio_margin_collateral += asset.portfolio_margin


def generate_batch_witnesses(tree: AccountTree,
                             accounts_by_tier: Dict[int, List[AccountInfo]],
                             cex_assets: List[CexAssetInfo],
                             tiers: Dict[int, int] | None = None,
                             start_height: int = -1,
                             ) -> Iterator[Tuple[int, BatchCreateUserWitness]]:
    """Yields (height, witness) per batch, maintaining running CEX totals.
    All proofs are against the FINAL tree root (witness.go:138,169-171).
    `cex_assets` is mutated (running totals), matching the reference:
    batch by batch, as each witness is made.

    The CEX commitments are computed ahead, CHAIN_GROUP batches at a time,
    on a copy of the running totals (plain integer sums of the accounts):
    the group's after-commitments, and the before-commitment of the first
    batch made, are one ``hash_chains_fast`` launch.  The state a batch
    starts from is the one the batch before it ended with, so its
    before-commitment is that batch's after-commitment."""
    tiers = tiers or C.get_tiers()
    dev = tree.device
    root = tree.root()
    batches = []
    for k in sorted(accounts_by_tier):
        accs = accounts_by_tier[k]
        per = tiers[k]
        batches += [accs[b * per:(b + 1) * per]
                    for b in range(len(accs) // per)]
    # replay only: carry the running totals past the batches already made
    for batch in batches[:start_height + 1]:
        for acc in batch:
            _accumulate(cex_assets, acc)
    last_after = None
    for g0 in range(start_height + 1, len(batches), CHAIN_GROUP):
        group = batches[g0:g0 + CHAIN_GROUP]
        ahead = _copy_cex(cex_assets)
        states = [] if last_after else [_cex_elements(ahead)]
        for batch in group:
            for acc in batch:
                _accumulate(ahead, acc)
            states.append(_cex_elements(ahead))
        commitments = [fr_to_bytes(v)
                       for v in pos.hash_chains_fast(states, dev)]
        if last_after is None:
            last_after = commitments.pop(0)
        for height, batch, after in zip(range(g0, g0 + len(group)), group,
                                        commitments):
            wit = BatchCreateUserWitness(
                account_tree_root=root,
                before_cex_assets_commitment=last_after,
                before_cex_assets=_copy_cex(cex_assets))
            proofs = tree.get_proofs_batch([a.account_index for a in batch])
            for acc, proof in zip(batch, proofs):
                _accumulate(cex_assets, acc)
                wit.create_user_ops.append(CreateUserOperation(
                    assets=list(acc.assets),
                    account_index=acc.account_index,
                    account_id_hash=acc.account_id,
                    account_proof=proof))
            wit.min_account_index = wit.create_user_ops[0].account_index
            wit.max_account_index = wit.create_user_ops[-1].account_index
            wit.after_cex_assets_commitment = last_after = after
            wit.batch_commitment = fr_to_bytes(poseidon([
                fr_from_bytes(wit.account_tree_root),
                fr_from_bytes(wit.before_cex_assets_commitment),
                fr_from_bytes(wit.after_cex_assets_commitment),
                wit.min_account_index, wit.max_account_index]))
            yield height, wit


def densify_ops_assets(wit: BatchCreateUserWitness,
                       asset_counts: int | None = None) -> None:
    """Expand each op's sparse asset list to a dense asset_counts-slot list
    (DecodeBatchWitness tail, utils.go:723-740)."""
    from ..utils.types import AccountAsset
    n = asset_counts or C.ASSET_COUNTS
    for op in wit.create_user_ops:
        dense = [AccountAsset(index=p) for p in range(n)]
        for a in op.assets:
            dense[a.index] = a
        op.assets = dense
