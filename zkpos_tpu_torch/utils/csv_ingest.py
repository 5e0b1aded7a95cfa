"""CSV ingestion — parity with reference src/utils/utils.go:223-702.

Parses per-user balance-sheet CSVs and cex_assets_info.csv with the exact
scaling/validation semantics:
  * decimal -> uint64 with 10^8 multiplier (10^2 for two-digit tokens;
    prices get 10^8 / 10^14 respectively) — utils.go:457-462, 541-545;
  * per-asset validity: loan+margin+pm <= equity (utils.go:599-606);
  * per-account validity: total collateral value >= total debt
    (utils.go:620-633); invalid accounts counted and excluded;
  * accounts bucketed by asset-count tier (utils.go:621-629).

Files are parsed by a process pool at the service layer; this module is the
sequential core.
"""

from __future__ import annotations

import csv
import os
from decimal import Decimal, InvalidOperation
from typing import Dict, List, Tuple

from ..crypto.bn254 import fr_to_bytes, fr_from_bytes
from . import constants as C
from .constants import (ASSET_TYPE_FOR_TWO_DIGITS, MAX_TIER_BOUNDARY_VALUE,
                        get_asset_counts_tiers)
from .commitments import (calculate_asset_value_for_collateral,
                          calculate_precomputed_value, padding_tier_ratios)
from .types import AccountAsset, AccountInfo, CexAssetInfo, TierRatio

CEX_ASSET_INFO_FILE = "cex_assets_info.csv"
_U64_MAX = (1 << 64) - 1


class InvalidAccountData(Exception):
    pass


def convert_float_str_to_uint64(s: str, multiplier: int) -> int:
    """utils.go:687-702."""
    if s == "0.0":
        return 0
    try:
        num = Decimal(s)
    except InvalidOperation as e:
        raise ValueError(f"bad decimal {s!r}") from e
    v = int(num * multiplier)
    if not (0 <= v <= _U64_MAX):
        raise ValueError("overflow uint64")
    return v


def parse_asset_index_from_user_file(path: str) -> List[str]:
    """Asset symbol order from a user CSV header (utils.go:326-346)."""
    with open(path, newline="") as f:
        header = next(csv.reader(f))
    asset_counts = (len(header) - 3) // 6
    return [header[i * 6 + 4].lower() for i in range(asset_counts)]


def parse_tiers_ratio_from_str(enc: str) -> List[TierRatio]:
    """utils.go:371-420.  Boundaries scaled by 1e16 (usdt value at 1e8
    price precision x 1e8 amount precision)."""
    enc = enc.strip("[]")
    if not enc:
        return padding_tier_ratios([])
    value_multiplier = 10_000_000_000_000_000
    tiers: List[TierRatio] = []
    for part in enc.split(","):
        rng, _, ratio_s = part.strip().partition(":")
        lo_s, _, hi_s = rng.partition("-")
        if not ratio_s or not hi_s:
            raise ValueError("tiers ratio data wrong")
        lo = convert_float_str_to_uint64(lo_s.strip(), 1) * value_multiplier
        hi = convert_float_str_to_uint64(hi_s.strip(), 1) * value_multiplier
        ratio = convert_float_str_to_uint64(ratio_s.strip(), 1)
        if hi < lo or hi > MAX_TIER_BOUNDARY_VALUE:
            raise ValueError("tiers boundary value data wrong")
        tiers.append(TierRatio(boundary_value=hi, ratio=ratio))
        if len(tiers) > 1 and tiers[-1].boundary_value <= tiers[-2].boundary_value:
            raise ValueError("tiers boundary value data wrong")
    calculate_precomputed_value(tiers)
    return padding_tier_ratios(tiers)


def parse_cex_asset_info_from_file(path: str,
                                   asset_indexes: List[str]) -> List[CexAssetInfo]:
    """utils.go:436-507 — order assets by the user-file header order, pad
    to ASSET_COUNTS with reserved entries."""
    by_symbol: Dict[str, CexAssetInfo] = {}
    with open(path, newline="") as f:
        rows = list(csv.reader(f))[1:]
    for row in rows:
        if len(row) != 5:
            raise ValueError(f"cex asset data wrong: {row}")
        symbol = row[0].lower()
        multiplier = 100_000_000_000_000 if symbol in ASSET_TYPE_FOR_TWO_DIGITS \
            else 100_000_000
        by_symbol[symbol] = CexAssetInfo(
            symbol=symbol,
            base_price=convert_float_str_to_uint64(row[1], multiplier),
            loan_ratios=parse_tiers_ratio_from_str(row[2]),
            margin_ratios=parse_tiers_ratio_from_str(row[3]),
            portfolio_margin_ratios=parse_tiers_ratio_from_str(row[4]),
        )
    if len(asset_indexes) != len(by_symbol):
        raise ValueError("asset indexes do not match cex assets info")
    out = []
    for i, sym in enumerate(asset_indexes):
        a = by_symbol[sym]
        a.index = i
        out.append(a)
    for i in range(len(asset_indexes), C.ASSET_COUNTS):
        out.append(CexAssetInfo(
            symbol="reserved", index=i,
            loan_ratios=padding_tier_ratios([]),
            margin_ratios=padding_tier_ratios([]),
            portfolio_margin_ratios=padding_tier_ratios([])))
    return out


def read_user_data_from_csv_file(path: str, cex_assets: List[CexAssetInfo]
                                 ) -> Tuple[Dict[int, List[AccountInfo]], int]:
    """utils.go:509-646.  Returns ({tier: accounts}, invalid_count)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, rows = rows[0], rows[1:]
    asset_counts = (len(header) - 3) // 6
    tiers = get_asset_counts_tiers()
    accounts: Dict[int, List[AccountInfo]] = {}
    invalid = 0

    for row in rows:
        account_id = bytes.fromhex(row[1])
        if len(account_id) != 32:
            raise InvalidAccountData(f"accountId is invalid: {row[1]}")
        acc = AccountInfo(
            account_id=fr_to_bytes(fr_from_bytes(account_id)))
        assets: List[AccountAsset] = []
        bad = False
        total_equity = total_debt = total_collateral = 0
        for j in range(asset_counts):
            sym = cex_assets[j].symbol
            mult = 100 if sym in ASSET_TYPE_FOR_TWO_DIGITS else 100_000_000
            try:
                equity = convert_float_str_to_uint64(row[j * 6 + 2], mult)
                debt = convert_float_str_to_uint64(row[j * 6 + 3], mult)
                loan = convert_float_str_to_uint64(row[j * 6 + 5], mult)
                margin = convert_float_str_to_uint64(row[j * 6 + 6], mult)
                pm = convert_float_str_to_uint64(row[j * 6 + 7], mult)
            except ValueError:
                invalid += 1
                bad = True
                break
            if equity != 0 or debt != 0:
                a = AccountAsset(index=j, equity=equity, debt=debt,
                                 loan=loan, margin=margin, portfolio_margin=pm)
                assets.append(a)
                asset_collateral = loan + margin + pm
                if asset_collateral > _U64_MAX:
                    raise InvalidAccountData("overflow for balance")
                if asset_collateral > equity:
                    invalid += 1
                    bad = True
                    break
                price = cex_assets[j].base_price
                total_equity += equity * price
                total_debt += debt * price
                total_collateral += calculate_asset_value_for_collateral(
                    loan, margin, pm, cex_assets[j])
        if bad:
            continue
        acc.assets = assets
        acc.total_equity = total_equity
        acc.total_debt = total_debt
        acc.total_collateral = total_collateral
        if total_collateral >= total_debt:
            for t in tiers:
                if len(assets) <= t:
                    accounts.setdefault(t, []).append(acc)
                    break
        else:
            invalid += 1
    return accounts, invalid


def parse_user_data_set(dirname: str
                        ) -> Tuple[Dict[int, List[AccountInfo]],
                                   List[CexAssetInfo], int]:
    """utils.go:223-316.  Returns (accounts_by_tier, cex_assets, invalid)."""
    names = sorted(
        os.path.join(dirname, n) for n in os.listdir(dirname)
        if ".csv" in n and n != CEX_ASSET_INFO_FILE)
    if not names:
        raise FileNotFoundError("no user csv files")
    asset_indexes = parse_asset_index_from_user_file(names[0])
    cex_assets = parse_cex_asset_info_from_file(
        os.path.join(dirname, CEX_ASSET_INFO_FILE), asset_indexes)
    accounts: Dict[int, List[AccountInfo]] = {}
    total_invalid = 0
    for name in names:
        got, invalid = read_user_data_from_csv_file(name, cex_assets)
        total_invalid += invalid
        for k, v in got.items():
            accounts.setdefault(k, []).extend(v)
    return accounts, cex_assets, total_invalid


def padding_accounts(accounts: List[AccountInfo], asset_key: int,
                     ops_per_batch: int) -> List[AccountInfo]:
    """Pad a tier to a multiple of batch size with zero accounts
    (utils.go:802-826); account ids are assigned by the witness service."""
    batch_counts = (len(accounts) + ops_per_batch - 1) // ops_per_batch
    padding = batch_counts * ops_per_batch - len(accounts)
    out = list(accounts)
    for _ in range(padding):
        assets = [AccountAsset(index=j) for j in range(asset_key)]
        out.append(AccountInfo(assets=assets))
    return out
