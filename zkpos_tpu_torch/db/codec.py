"""Batch-witness blob codec.

Reference protocol: gob encode -> s2 compress -> base64
(witness.go:219-228), decoded by DecodeBatchWitness (utils.go:704-742)
which re-expands each op's sparse asset list into a dense
AssetCounts-slot array.

This module speaks BOTH wire formats:

  * the reference's own base64(s2(gob(...))) — via the pure-Python gob
    and snappy/S2 codecs in gob_codec.py / s2py.py (default for encode,
    so witness rows interchange with the Go services), and
  * a JSON+zlib+base64 equivalent kept for rows written by earlier
    rounds; `decode_batch_witness` detects the format.

Both share the sparse-assets storage convention and the densify-on-decode
step of the reference.
"""

from __future__ import annotations

import base64
import json
import zlib
from typing import List

from ..utils import constants as C
from ..utils.types import (AccountAsset, BatchCreateUserWitness, CexAssetInfo,
                           CreateUserOperation, TierRatio, is_asset_empty)

_B64 = "ascii"


def _tier_list(ratios: List[TierRatio]) -> list:
    return [[str(t.boundary_value), t.ratio, str(t.precomputed_value)]
            for t in ratios]


def _tier_parse(data: list) -> List[TierRatio]:
    return [TierRatio(boundary_value=int(b), ratio=r,
                      precomputed_value=int(p)) for b, r, p in data]


def _tiers_go(ratios: List[TierRatio]) -> list:
    return [{"BoundaryValue": t.boundary_value, "Ratio": t.ratio,
             "PrecomputedValue": t.precomputed_value} for t in ratios]


def _tiers_from_go(data: list) -> List[TierRatio]:
    return [TierRatio(boundary_value=t.get("BoundaryValue", 0),
                      ratio=t.get("Ratio", 0),
                      precomputed_value=t.get("PrecomputedValue", 0))
            for t in (data or [])]


def encode_batch_witness_gob(w: BatchCreateUserWitness) -> str:
    """Reference wire format: base64(s2(gob(...))) (witness.go:219-228).
    Assets are stored sparsely, exactly like the Go witness service."""
    from . import gob_codec, s2py
    obj = {
        "BatchCommitment": w.batch_commitment,
        "AccountTreeRoot": w.account_tree_root,
        "BeforeCEXAssetsCommitment": w.before_cex_assets_commitment,
        "AfterCEXAssetsCommitment": w.after_cex_assets_commitment,
        "MinAccountIndex": w.min_account_index,
        "MaxAccountIndex": w.max_account_index,
        "BeforeCexAssets": [{
            "TotalEquity": a.total_equity, "TotalDebt": a.total_debt,
            "BasePrice": a.base_price, "Symbol": a.symbol,
            "Index": a.index, "LoanCollateral": a.loan_collateral,
            "MarginCollateral": a.margin_collateral,
            "PortfolioMarginCollateral": a.portfolio_margin_collateral,
            "LoanRatios": _tiers_go(a.loan_ratios),
            "MarginRatios": _tiers_go(a.margin_ratios),
            "PortfolioMarginRatios": _tiers_go(a.portfolio_margin_ratios),
        } for a in w.before_cex_assets],
        "CreateUserOps": [{
            "Assets": [{"Index": a.index, "Equity": a.equity,
                        "Debt": a.debt, "Loan": a.loan,
                        "Margin": a.margin,
                        "PortfolioMargin": a.portfolio_margin}
                       for a in op.assets if not is_asset_empty(a)],
            "AccountIndex": op.account_index,
            "AccountIdHash": op.account_id_hash,
            "AccountProof": list(op.account_proof),
        } for op in w.create_user_ops],
    }
    tier_count = max((len(a.loan_ratios) for a in w.before_cex_assets),
                     default=C.TIER_COUNT)
    depth = max((len(op.account_proof) for op in w.create_user_ops),
                default=C.ACCOUNT_TREE_DEPTH)
    raw = gob_codec.encode_stream(obj, tier_count, depth)
    return base64.b64encode(s2py.compress(raw)).decode(_B64)


def decode_batch_witness_gob(data: str,
                             asset_counts: int | None = None,
                             _decompressed: bytes | None = None
                             ) -> BatchCreateUserWitness:
    """Decode a reference-produced (or our own gob-encoded) blob and
    densify assets (utils.go:723-741)."""
    from . import gob_codec, s2py
    n_assets = asset_counts or C.ASSET_COUNTS
    raw = (_decompressed if _decompressed is not None
           else s2py.decompress(base64.b64decode(data)))
    obj = gob_codec.decode_stream(raw)
    w = BatchCreateUserWitness(
        batch_commitment=bytes(obj.get("BatchCommitment", b"")),
        account_tree_root=bytes(obj.get("AccountTreeRoot", b"")),
        before_cex_assets_commitment=bytes(
            obj.get("BeforeCEXAssetsCommitment", b"")),
        after_cex_assets_commitment=bytes(
            obj.get("AfterCEXAssetsCommitment", b"")),
        min_account_index=obj.get("MinAccountIndex", 0),
        max_account_index=obj.get("MaxAccountIndex", 0))
    for a in obj.get("BeforeCexAssets", []):
        w.before_cex_assets.append(CexAssetInfo(
            total_equity=a.get("TotalEquity", 0),
            total_debt=a.get("TotalDebt", 0),
            base_price=a.get("BasePrice", 0),
            symbol=a.get("Symbol", ""), index=a.get("Index", 0),
            loan_collateral=a.get("LoanCollateral", 0),
            margin_collateral=a.get("MarginCollateral", 0),
            portfolio_margin_collateral=a.get(
                "PortfolioMarginCollateral", 0),
            loan_ratios=_tiers_from_go(a.get("LoanRatios")),
            margin_ratios=_tiers_from_go(a.get("MarginRatios")),
            portfolio_margin_ratios=_tiers_from_go(
                a.get("PortfolioMarginRatios"))))
    for o in obj.get("CreateUserOps", []):
        dense = [AccountAsset(index=p) for p in range(n_assets)]
        for a in o.get("Assets", []):
            ix = a.get("Index", 0)
            dense[ix] = AccountAsset(
                index=ix, equity=a.get("Equity", 0),
                debt=a.get("Debt", 0), loan=a.get("Loan", 0),
                margin=a.get("Margin", 0),
                portfolio_margin=a.get("PortfolioMargin", 0))
        w.create_user_ops.append(CreateUserOperation(
            assets=dense,
            account_index=o.get("AccountIndex", 0),
            account_id_hash=bytes(o.get("AccountIdHash", b"")),
            account_proof=[bytes(p) for p in o.get("AccountProof", [])]))
    return w


def encode_batch_witness(w: BatchCreateUserWitness) -> str:
    """Default encoder: the reference gob+s2 wire format."""
    return encode_batch_witness_gob(w)


def encode_batch_witness_json(w: BatchCreateUserWitness) -> str:
    obj = {
        "bc": base64.b64encode(w.batch_commitment).decode(_B64),
        "rt": base64.b64encode(w.account_tree_root).decode(_B64),
        "b4": base64.b64encode(w.before_cex_assets_commitment).decode(_B64),
        "af": base64.b64encode(w.after_cex_assets_commitment).decode(_B64),
        "mn": w.min_account_index,
        "mx": w.max_account_index,
        "cex": [{
            "te": a.total_equity, "td": a.total_debt, "bp": a.base_price,
            "sy": a.symbol, "ix": a.index, "lc": a.loan_collateral,
            "mc": a.margin_collateral, "pc": a.portfolio_margin_collateral,
            "lr": _tier_list(a.loan_ratios), "mr": _tier_list(a.margin_ratios),
            "pr": _tier_list(a.portfolio_margin_ratios),
        } for a in w.before_cex_assets],
        "ops": [{
            "ai": op.account_index,
            "id": base64.b64encode(op.account_id_hash).decode(_B64),
            "pf": [base64.b64encode(p).decode(_B64)
                   for p in op.account_proof],
            # sparse: only non-empty assets stored (utils.go:735-739)
            "as": [[a.index, a.equity, a.debt, a.loan, a.margin,
                    a.portfolio_margin]
                   for a in op.assets if not is_asset_empty(a)],
        } for op in w.create_user_ops],
    }
    raw = json.dumps(obj, separators=(",", ":")).encode()
    return base64.b64encode(zlib.compress(raw, 6)).decode(_B64)


def decode_batch_witness(data: str,
                         asset_counts: int | None = None
                         ) -> BatchCreateUserWitness:
    """Decode + densify (utils.go:704-742).  Tries the reference gob+s2
    format first, then the legacy JSON+zlib rows.  Format detection and
    mid-decode failure are distinguished (ADVICE r3): if the blob IS
    s2-framed but the gob payload is corrupt, the gob error propagates
    instead of surfacing as an unrelated JSON/zlib error."""
    import base64 as _b64
    from . import s2py as _s2
    try:
        raw = _s2.decompress(_b64.b64decode(data))
    except Exception:
        return decode_batch_witness_json(data, asset_counts)
    try:
        return decode_batch_witness_gob(data, asset_counts,
                                        _decompressed=raw)
    except Exception as e:
        # a zlib stream can coincidentally parse as an s2 block; only
        # fall through when the payload is recognizably not gob
        try:
            return decode_batch_witness_json(data, asset_counts)
        except Exception:
            raise e from None


def decode_batch_witness_json(data: str,
                              asset_counts: int | None = None
                              ) -> BatchCreateUserWitness:
    n_assets = asset_counts or C.ASSET_COUNTS
    obj = json.loads(zlib.decompress(base64.b64decode(data)))
    w = BatchCreateUserWitness(
        batch_commitment=base64.b64decode(obj["bc"]),
        account_tree_root=base64.b64decode(obj["rt"]),
        before_cex_assets_commitment=base64.b64decode(obj["b4"]),
        after_cex_assets_commitment=base64.b64decode(obj["af"]),
        min_account_index=obj["mn"],
        max_account_index=obj["mx"])
    for a in obj["cex"]:
        w.before_cex_assets.append(CexAssetInfo(
            total_equity=a["te"], total_debt=a["td"], base_price=a["bp"],
            symbol=a["sy"], index=a["ix"], loan_collateral=a["lc"],
            margin_collateral=a["mc"], portfolio_margin_collateral=a["pc"],
            loan_ratios=_tier_parse(a["lr"]),
            margin_ratios=_tier_parse(a["mr"]),
            portfolio_margin_ratios=_tier_parse(a["pr"])))
    for o in obj["ops"]:
        dense = [AccountAsset(index=p) for p in range(n_assets)]
        for (ix, eq, de, lo, ma, pm) in o["as"]:
            dense[ix] = AccountAsset(index=ix, equity=eq, debt=de, loan=lo,
                                     margin=ma, portfolio_margin=pm)
        w.create_user_ops.append(CreateUserOperation(
            assets=dense,
            account_index=o["ai"],
            account_id_hash=base64.b64decode(o["id"]),
            account_proof=[base64.b64decode(p) for p in o["pf"]]))
    return w
