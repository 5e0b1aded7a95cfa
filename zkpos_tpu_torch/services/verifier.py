"""verifier service — parity with reference src/verifier/main.go;
counterpart of zkpos_tpu/services/verifier.py.  It runs on the host (the
pairing check, the host Poseidon) and never touches the card; its pool's
workers are spawned.

Batch mode (:108-338): load the dbtool-exported proof CSV; per proof:
deserialize, recompute BatchCommitment = Poseidon(root, beforeCEX,
afterCEX, min, max) and compare, Groth16-verify against the per-tier vk;
then the serial chain checks: batch 0 starts at index 0 with the zero-CEX
commitment, one shared tree root, CEX commitment chaining
before[i] == after[i-1], index continuity min[i] == max[i-1]+1, final CEX
commitment matches the published CexAssetsInfo.

User mode (:43-87): recompute the assets commitment + leaf hash from
user_config.json and verify the Merkle path.  `-hash` computes one
Poseidon(2) (:88-107).  The command exits 1 when a check fails.
"""

from __future__ import annotations

import base64
import csv
import json
import os
import sys
from typing import Dict, List, Optional

from ..crypto.bn254 import fr_from_bytes, fr_to_bytes
from ..crypto.poseidon_ref import poseidon, PoseidonHasher
from ..groth16 import groth16 as g16
from ..groth16.serialize import proof_from_base64
from ..merkle.tree import verify_proof as merkle_verify
from ..utils import constants as C
from ..utils.commitments import (_pad_cex_assets, cex_asset_elements,
                                 compute_user_assets_commitment)
from ..utils.types import AccountAsset, CexAssetInfo, TierRatio
from .keygen import key_file_names, load_artifact


class VerificationError(Exception):
    pass


def _batch_commitment(root: bytes, before: bytes, after: bytes,
                      mn: int, mx: int) -> bytes:
    return fr_to_bytes(poseidon([
        fr_from_bytes(root), fr_from_bytes(before), fr_from_bytes(after),
        mn, mx]))


def _cex_commitment(cex_assets: List[CexAssetInfo]) -> bytes:
    """compute_cex_assets_commitment (utils.go:779-800) on the host
    Poseidon."""
    return fr_to_bytes(poseidon([e for a in _pad_cex_assets(cex_assets)
                                 for e in cex_asset_elements(a)]))


def _verify_one_row(args) -> Optional[str]:
    """Worker body for one proof row (reference verifier main.go:194-304
    runs >=16 such workers); returns an error string or None.  Plain data
    in/out so it runs in a worker process."""
    row, vk_path = args
    vk = _vk_cached(vk_path)
    proof = proof_from_base64(row["proof_info"])
    comms = [base64.b64decode(c)
             for c in json.loads(row["cex_asset_list_commitments"])]
    roots = [base64.b64decode(r)
             for r in json.loads(row["account_tree_roots"])]
    mn, mx = int(row["account_min_index"]), int(row["account_max_index"])
    stored = base64.b64decode(row["batch_commitment"])
    expect = _batch_commitment(roots[0], comms[0], comms[1], mn, mx)
    if stored != expect:
        return f"batch {row['batch_number']}: commitment mismatch"
    if not g16.verify(proof, vk, [fr_from_bytes(stored)]):
        return f"batch {row['batch_number']}: groth16 verify failed"
    return None


_VK_CACHE: Dict[str, object] = {}


def _vk_cached(path: str):
    vk = _VK_CACHE.get(path)
    if vk is None:
        vk = _VK_CACHE[path] = load_artifact(path)
    return vk


def verify_batch_proofs(proof_rows: List[dict], cex_assets: List[CexAssetInfo],
                        zk_key_prefix: str, tiers=None,
                        workers: Optional[int] = None) -> None:
    """proof_rows: dicts with keys matching the exported CSV columns.

    Per-proof checks (commitment recompute + pairing verify) run on a
    process pool (reference main.go:176-180 uses >= 16 workers); the chain
    validation stays serial by design (:305-334).
    ZKPOS_VERIFY_WORKERS=0 forces the serial path."""
    tiers = tiers or C.get_tiers()
    rows = sorted(proof_rows, key=lambda r: int(r["batch_number"]))
    jobs = []
    for row in rows:
        assets = int(row["assets_count"])
        _, vk_f, _ = key_file_names(zk_key_prefix, assets, tiers[assets])
        jobs.append((row, vk_f))
    if workers is None:
        workers = int(os.environ.get("ZKPOS_VERIFY_WORKERS",
                                     str(max(1, os.cpu_count() or 2))))
    if workers > 1 and len(jobs) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(max_workers=min(workers, len(jobs)),
                                 mp_context=mp.get_context("spawn")) as pool:
            errors = list(pool.map(_verify_one_row, jobs))
    else:
        errors = map(_verify_one_row, jobs)
    for err in errors:
        if err is not None:
            raise VerificationError(err)

    # serial chain validation (:305-334)
    zero_cex = [CexAssetInfo(symbol=a.symbol, index=a.index,
                             base_price=a.base_price,
                             loan_ratios=a.loan_ratios,
                             margin_ratios=a.margin_ratios,
                             portfolio_margin_ratios=a.portfolio_margin_ratios)
                for a in cex_assets]
    expect_before = _cex_commitment(zero_cex)
    root0 = json.loads(rows[0]["account_tree_roots"])[0]
    prev_max = -1
    for row in rows:
        comms = [base64.b64decode(c)
                 for c in json.loads(row["cex_asset_list_commitments"])]
        if json.loads(row["account_tree_roots"])[0] != root0:
            raise VerificationError("tree root mismatch across batches")
        if comms[0] != expect_before:
            raise VerificationError(
                f"batch {row['batch_number']}: cex commitment chain broken")
        if int(row["account_min_index"]) != prev_max + 1:
            raise VerificationError(
                f"batch {row['batch_number']}: index continuity broken")
        prev_max = int(row["account_max_index"])
        expect_before = comms[1]
    if expect_before != _cex_commitment(cex_assets):
        raise VerificationError("final cex commitment mismatch")


def verify_user(config: dict) -> bool:
    """verifier -user (:46-87)."""
    root = bytes.fromhex(config["Root"])
    proof = [base64.b64decode(p) for p in config["Proof"]]
    assets = [AccountAsset(index=a["Index"], equity=a["Equity"],
                           debt=a["Debt"], loan=a["Loan"], margin=a["Margin"],
                           portfolio_margin=a["PortfolioMargin"])
              for a in config["Assets"]]
    commitment = compute_user_assets_commitment(assets)
    leaf = fr_to_bytes(poseidon([
        int(config["AccountIdHash"], 16),
        config["TotalEquity"], config["TotalDebt"],
        config["TotalCollateral"], fr_from_bytes(commitment)]))
    return merkle_verify(root, config["AccountIndex"], proof, leaf)


def hash_two(a_b64: str, b_b64: str) -> str:
    """verifier -hash (:88-107)."""
    h = PoseidonHasher()
    h.write(base64.b64decode(a_b64))
    h.write(base64.b64decode(b_b64))
    return base64.b64encode(h.sum()).decode()


def load_proof_csv(path: str) -> List[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def main(argv=None) -> int:
    import argparse
    from .config import load_config
    ap = argparse.ArgumentParser("zkpos-verifier")
    ap.add_argument("-config", "--config", default="config/config.json")
    ap.add_argument("-user", "--user", action="store_true")
    ap.add_argument("-hash", "--hash", nargs=2, metavar=("A", "B"))
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    if args.hash:
        print("hash result base64 encode:", hash_two(*args.hash))
        return 0
    if args.user:
        with open("config/user_config.json") as f:
            ok = verify_user(json.load(f))
        print("verify pass!!!" if ok else "verify failed...")
        return 0 if ok else 1
    rows = load_proof_csv(cfg.proof_table)
    with open(cfg.cex_assets_info) as f:
        cex_assets = _cex_from_json(json.load(f))
    verify_batch_proofs(rows, cex_assets, cfg.zk_key_name)
    print("All proofs verified!!!")
    return 0


def _cex_from_json(data: list) -> List[CexAssetInfo]:
    out = []
    for a in data:
        out.append(CexAssetInfo(
            total_equity=a["TotalEquity"], total_debt=a["TotalDebt"],
            base_price=a["BasePrice"], symbol=a.get("Symbol", ""),
            index=a["Index"], loan_collateral=a["LoanCollateral"],
            margin_collateral=a["MarginCollateral"],
            portfolio_margin_collateral=a["PortfolioMarginCollateral"],
            loan_ratios=_ratios(a["LoanRatios"]),
            margin_ratios=_ratios(a["MarginRatios"]),
            portfolio_margin_ratios=_ratios(a["PortfolioMarginRatios"])))
    return out


def _ratios(data: list) -> List[TierRatio]:
    return [TierRatio(boundary_value=int(t["BoundaryValue"]),
                      ratio=t["Ratio"],
                      precomputed_value=int(t["PrecomputedValue"]))
            for t in data]


if __name__ == "__main__":
    sys.exit(main())
