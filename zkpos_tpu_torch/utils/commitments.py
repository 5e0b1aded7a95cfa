"""Packing rules and commitment hashes — parity with reference src/utils/utils.go.

These are the host-side implementations (wide hashes on the host Poseidon
with the chaining rule of crypto/poseidon_ref.poseidon), except the CEX
commitment, which runs as one chained hash on the device.  Packing
layouts (utils.go:26-88, 188-221):

  * user assets: flatten 6 fields/asset, pack 3 uint64 per field element
    with weights 2^128 / 2^64 / 1;
  * CEX asset: 2 aggregate elements + TierCount/2 elements per ratio list
    (2 tiers per element: ratio + boundary*2^8 + ratio2*2^126 + boundary2*2^134).
"""

from __future__ import annotations

from typing import List

from ..crypto.bn254 import R as MOD, fr_from_bytes, fr_to_bytes
from ..crypto.poseidon_ref import poseidon
from . import constants as C
from .constants import (MAX_TIER_BOUNDARY_VALUE, PERCENTAGE_MULTIPLIER,
                        get_asset_counts_tiers)
from .types import (AccountAsset, AccountInfo, CexAssetInfo, TierRatio,
                    empty_tier_ratios, is_asset_empty)


def get_assets_count_of_user(assets: List[AccountAsset]) -> int:
    """Tier for len(assets) (utils.go:135-145)."""
    count = len(assets)
    for v in get_asset_counts_tiers():
        if count <= v:
            return v
    return 0


def get_non_empty_assets_count_of_user(assets: List[AccountAsset]) -> int:
    """Tier for the count of non-empty assets (utils.go:118-133)."""
    count = sum(0 if is_asset_empty(a) else 1 for a in assets)
    for v in get_asset_counts_tiers():
        if count <= v:
            return v
    return 0


def padding_account_assets(assets: List[AccountAsset]) -> List[int]:
    """Pad the asset list to its tier size, filling index gaps with empty
    assets whose indices continue the sequence (utils.go:147-186).
    Returns the flattened [index, equity, debt, loan, margin, pm] * tier."""
    target = get_assets_count_of_user(assets)
    if target < len(assets):
        raise ValueError("target tier smaller than asset list")
    n_fields = 6
    flat = [0] * (target * n_fields)
    padding_counts = target - len(assets)
    current_padding = 0
    current_index = 0
    idx = 0
    for a in assets:
        if current_padding < padding_counts:
            for j in range(current_index, a.index):
                current_padding += 1
                flat[idx * n_fields] = j
                idx += 1
                if current_padding >= padding_counts:
                    break
        flat[idx * n_fields + 0] = a.index
        flat[idx * n_fields + 1] = a.equity
        flat[idx * n_fields + 2] = a.debt
        flat[idx * n_fields + 3] = a.loan
        flat[idx * n_fields + 4] = a.margin
        flat[idx * n_fields + 5] = a.portfolio_margin
        idx += 1
        current_index = a.index + 1
    for i in range(idx, target):
        flat[i * n_fields] = current_index
        current_index += 1
    return flat


def user_assets_elements(assets: List[AccountAsset]) -> List[int]:
    """Packed field elements for the user-assets commitment (utils.go:188-218)."""
    flat = padding_account_assets(assets)
    target = get_assets_count_of_user(assets)
    n_eles = (target * 6 + 2) // 3
    out = []
    for i in range(n_eles):
        a = flat[3 * i] if 3 * i < len(flat) else 0
        b = flat[3 * i + 1] if 3 * i + 1 < len(flat) else 0
        c = flat[3 * i + 2] if 3 * i + 2 < len(flat) else 0
        out.append(((a << 128) + (b << 64) + c) % MOD)
    return out


def compute_user_assets_commitment(assets: List[AccountAsset]) -> bytes:
    return fr_to_bytes(poseidon(user_assets_elements(assets)))


def account_info_to_hash(account: AccountInfo) -> bytes:
    """Leaf hash (utils.go:744-750)."""
    commitment = compute_user_assets_commitment(account.assets)
    return fr_to_bytes(poseidon([
        fr_from_bytes(account.account_id),
        account.total_equity % MOD,
        account.total_debt % MOD,
        account.total_collateral % MOD,
        fr_from_bytes(commitment),
    ]))


def tier_ratios_elements(ratios: List[TierRatio]) -> List[int]:
    """Two tiers per element (utils.go:26-51)."""
    out = []
    for i in range(0, len(ratios), 2):
        v = (ratios[i].ratio + (ratios[i].boundary_value << 8)
             + (ratios[i + 1].ratio << 126)
             + (ratios[i + 1].boundary_value << 134))
        out.append(v % MOD)
    return out


def cex_asset_elements(asset: CexAssetInfo) -> List[int]:
    """20 field elements per CEX asset (utils.go:53-88)."""
    out = [
        ((asset.total_equity << 128) + (asset.total_debt << 64)
         + asset.base_price) % MOD,
        ((asset.loan_collateral << 128) + (asset.margin_collateral << 64)
         + asset.portfolio_margin_collateral) % MOD,
    ]
    out += tier_ratios_elements(asset.loan_ratios)
    out += tier_ratios_elements(asset.margin_ratios)
    out += tier_ratios_elements(asset.portfolio_margin_ratios)
    return out


def _pad_cex_assets(cex_assets: List[CexAssetInfo]) -> List[CexAssetInfo]:
    padded = list(cex_assets)
    for i in range(len(cex_assets), C.ASSET_COUNTS):
        padded.append(CexAssetInfo(
            symbol="reserved", index=i,
            loan_ratios=empty_tier_ratios(),
            margin_ratios=empty_tier_ratios(),
            portfolio_margin_ratios=empty_tier_ratios()))
    return padded


def compute_cex_assets_commitment(cex_assets: List[CexAssetInfo],
                                  device=None) -> bytes:
    """utils.go:779-800 — pads to ASSET_COUNTS then hashes all elements,
    as one chained hash on the device (ops/poseidon.hash_chain_fast)."""
    from ..ops.poseidon import hash_chain_fast
    elements = []
    for asset in _pad_cex_assets(cex_assets):
        elements += cex_asset_elements(asset)
    return fr_to_bytes(hash_chain_fast(elements, device))


def calculate_precomputed_value(ratios: List[TierRatio]) -> None:
    """utils.go:422-434 — running haircut value per tier boundary."""
    acc = 0
    prev_boundary = 0
    for t in ratios:
        diff = t.boundary_value - prev_boundary
        acc += (diff * t.ratio) // PERCENTAGE_MULTIPLIER
        t.precomputed_value = acc
        prev_boundary = t.boundary_value


def calculate_asset_value_via_tiers_ratio(collateral_value: int,
                                          ratios: List[TierRatio]) -> int:
    """utils.go:664-685 — piecewise-linear haircut."""
    if not ratios:
        return 0
    for i, t in enumerate(ratios):
        if collateral_value <= t.boundary_value:
            base = ratios[i - 1].boundary_value if i else 0
            res = ((collateral_value - base) * t.ratio) // PERCENTAGE_MULTIPLIER
            if i:
                res += ratios[i - 1].precomputed_value
            return res
    return ratios[-1].precomputed_value


def calculate_asset_value_for_collateral(loan: int, margin: int,
                                         portfolio_margin: int,
                                         asset: CexAssetInfo) -> int:
    """utils.go:648-662."""
    price = asset.base_price
    return (calculate_asset_value_via_tiers_ratio(loan * price, asset.loan_ratios)
            + calculate_asset_value_via_tiers_ratio(margin * price,
                                                    asset.margin_ratios)
            + calculate_asset_value_via_tiers_ratio(portfolio_margin * price,
                                                    asset.portfolio_margin_ratios))


def padding_tier_ratios(ratios: List[TierRatio]) -> List[TierRatio]:
    """utils.go:348-369."""
    if len(ratios) > C.TIER_COUNT:
        raise ValueError("too many tier ratios")
    out = list(ratios)
    last_pre = ratios[-1].precomputed_value if ratios else 0
    for _ in range(len(ratios), C.TIER_COUNT):
        out.append(TierRatio(boundary_value=MAX_TIER_BOUNDARY_VALUE,
                             ratio=0, precomputed_value=last_pre))
    return out
