"""witness service — parity with reference src/witness (main.go + witness.go
+ userproof.go); counterpart of zkpos_tpu/services/witness.py.

Pipeline: parse CSVs -> pad/index accounts -> device-built account tree ->
per-batch witness rows (resume by height with CEX-state replay,
witness.go:88-113) -> userproof rows for every account (resume by max
account_index, userproof.go:48-64).

The tree and every Poseidon hash run on the card (or on the CPU when the
service is given device="cpu").  The worker processes serialize rows only:
they are started with the spawn method and never touch the device.
"""

from __future__ import annotations

import base64
import collections
import concurrent.futures as cf
import json
import multiprocessing as mp
import os
import time
from typing import Dict, List

from ..crypto.bn254 import fr_to_bytes
from ..db.codec import decode_batch_witness, encode_batch_witness
from ..db.storage import (STATUS_PUBLISHED, BatchWitnessRow, DbErrNotFound,
                          UserProofModel, UserProofRow, WitnessModel,
                          open_database)
from ..ops.poseidon import hash_chain_fast
from ..utils import constants as C
from ..utils import csv_ingest
from ..utils.commitments import cex_asset_elements
from ..utils.device import resolve
from ..utils.types import AccountInfo, CexAssetInfo, is_asset_empty
from ..witness import core as wcore

MAX_PAYLOAD = 16 << 20          # batched DB writes stay under 16 MB
SEGMENT = 10_000                # accounts per userproof segment


def recover_after_cex_assets(wit, device=None) -> List[CexAssetInfo]:
    """RecoverAfterCexAssets (utils.go:752-777): replay ops onto the
    decoded BeforeCexAssets and sanity-check the after-commitment."""
    cex = wit.before_cex_assets
    for op in wit.create_user_ops:
        for a in op.assets:
            cx = cex[a.index]
            cx.total_equity += a.equity
            cx.total_debt += a.debt
            cx.loan_collateral += a.loan
            cx.margin_collateral += a.margin
            cx.portfolio_margin_collateral += a.portfolio_margin
    elements = []
    for a in cex:
        elements += cex_asset_elements(a)
    if (fr_to_bytes(hash_chain_fast(elements, device))
            != wit.after_cex_assets_commitment):
        raise ValueError("after cex commitment verify failed")
    return cex


def _pool(workers: int) -> cf.ProcessPoolExecutor:
    return cf.ProcessPoolExecutor(max_workers=workers,
                                  mp_context=mp.get_context("spawn"))


class WitnessService:
    def __init__(self, cfg, tiers=None, device=None):
        self.cfg = cfg
        self.tiers = tiers or C.get_tiers()
        self.device = resolve(device)
        self.db = open_database(cfg.db_path)
        self.witness_model = WitnessModel(self.db, cfg.db_suffix)
        self.userproof_model = UserProofModel(self.db, cfg.db_suffix)

    # -- data prep ------------------------------------------------------------

    def load_accounts(self):
        accounts, cex_assets, invalid = csv_ingest.parse_user_data_set(
            self.cfg.user_data_file)
        if invalid:
            raise csv_ingest.InvalidAccountData(
                f"{invalid} invalid accounts")
        return accounts, cex_assets

    def prepare(self, accounts_by_tier, cex_assets):
        self.accounts, self.capacity = wcore.prepare_accounts(
            accounts_by_tier, self.tiers)
        self.cex_assets = cex_assets
        t0 = time.time()
        self.tree = wcore.build_account_tree(self.accounts, self.capacity,
                                             device=self.device)
        print(f"witness: account tree built over {self.capacity} leaves "
              f"in {time.time()-t0:.1f}s, root "
              f"{self.tree.root().hex()}")

    # -- witness generation ---------------------------------------------------

    def run_witness(self, batch_flush: int = 25) -> int:
        """Generate + persist all batch witness rows.  Returns count."""
        self.witness_model.create_table()
        try:
            latest = self.witness_model.get_latest_batch_witness()
            height = latest.height
            wit = decode_batch_witness(latest.witness_data)
            self.cex_assets = recover_after_cex_assets(wit, self.device)
            print(f"witness: resuming after height {height}")
        except DbErrNotFound:
            height = -1
        total = sum((len(self.accounts[k]) // self.tiers[k])
                    for k in self.accounts)
        if height == total - 1:
            print("witness: already generated all witnesses")
            return 0
        # pipeline shape of the reference (witness.go:116-135, 244-316):
        # generation -> PARALLEL serialize workers -> ORDER-PRESERVING
        # collector -> batched DB writes with a 16 MB payload cap.
        workers = max(1, (os.cpu_count() or 2) - 1)
        try:
            pool = _pool(workers)
        except Exception:
            pool = None         # no pool: the serial path, same writes
        pending: List[BatchWitnessRow] = []
        pending_bytes = 0
        written = 0

        def flush():
            nonlocal pending, pending_bytes, written
            if pending:
                self.witness_model.create_batch_witness(pending)
                written += len(pending)
                pending = []
                pending_bytes = 0

        def collect(h, data):
            nonlocal pending_bytes, written
            if len(data) > MAX_PAYLOAD:
                # oversize row: flush the batch, insert solo
                flush()
                self.witness_model.create_batch_witness([BatchWitnessRow(
                    height=h, witness_data=data,
                    status=STATUS_PUBLISHED)])
                written += 1
                return
            pending.append(BatchWitnessRow(
                height=h, witness_data=data, status=STATUS_PUBLISHED))
            pending_bytes += len(data)
            if len(pending) >= batch_flush or pending_bytes >= MAX_PAYLOAD:
                flush()

        gen = wcore.generate_batch_witnesses(
            self.tree, self.accounts, self.cex_assets, self.tiers,
            start_height=height)
        if pool is None:
            for h, wit in gen:
                collect(h, encode_batch_witness(wit))
        else:
            with pool:
                inflight = collections.deque()
                for h, wit in gen:
                    inflight.append(
                        (h, pool.submit(encode_batch_witness, wit)))
                    while len(inflight) > 2 * workers:
                        hh, fut = inflight.popleft()
                        collect(hh, fut.result())
                while inflight:
                    hh, fut = inflight.popleft()
                    collect(hh, fut.result())
        flush()
        print(f"witness: wrote {written} batch witnesses "
              f"({workers if pool else 0} serialize workers)")
        return written

    # -- user proofs ----------------------------------------------------------

    def run_userproof(self, flush: int = 500) -> int:
        """Generate + persist per-account inclusion proofs
        (userproof.go:38-175)."""
        self.userproof_model.create_table()
        try:
            start = self.userproof_model.max_account_index() + 1
        except DbErrNotFound:
            start = 0
        all_accounts: Dict[int, AccountInfo] = {}
        for k in self.accounts:
            for acc in self.accounts[k]:
                all_accounts[acc.account_index] = acc
        # segment-parallel row building (reference userproof.go:87-149:
        # 10k-account segments over NumCPU workers) with ORDERED writes:
        # resume-by-max-index stays sound because segment k+1 is only
        # written after segment k.  Leaves and proofs are read from the
        # device tree, one batched read per segment.
        # ZKPOS_USERPROOF_WORKERS=0 (or 1) forces the serial path.
        root_hex = self.tree.root().hex()
        n_workers = int(os.environ.get(
            "ZKPOS_USERPROOF_WORKERS", str(max(1, os.cpu_count() or 2))))
        written = 0
        segments = list(range(start, self.capacity, SEGMENT))

        def seg_payload(lo):
            idxs = list(range(lo, min(lo + SEGMENT, self.capacity)))
            proofs = self.tree.get_proofs_batch(idxs)
            leaves = self.tree.get_batch(idxs)
            plain = []
            for i, leaf in zip(idxs, leaves):
                acc = all_accounts[i]
                plain.append((
                    i, acc.account_id.hex(), acc.total_equity,
                    acc.total_debt, acc.total_collateral,
                    [(a.index, a.equity, a.debt, a.loan, a.margin,
                      a.portfolio_margin)
                     for a in acc.assets if not is_asset_empty(a)],
                    leaf))
            return (plain, proofs, root_hex)

        def write_rows(tuples):
            nonlocal written
            for lo2 in range(0, len(tuples), flush):
                rows = [UserProofRow(*t) for t in tuples[lo2:lo2 + flush]]
                self.userproof_model.create_user_proofs(rows)
                written += len(rows)

        pool = None
        if n_workers > 1 and len(segments) > 1:
            try:
                pool = _pool(n_workers)
            except (ImportError, ValueError, OSError):
                pool = None     # no pool: the serial path, same writes
        if pool is not None:
            with pool:
                pending = []
                for lo in segments:
                    pending.append(pool.submit(_userproof_rows_segment,
                                               seg_payload(lo)))
                    # bounded in-flight window; collect IN ORDER
                    while len(pending) > n_workers + 1:
                        write_rows(pending.pop(0).result())
                for fut in pending:
                    write_rows(fut.result())
        else:
            for lo in segments:
                write_rows(_userproof_rows_segment(seg_payload(lo)))
        self.userproof_model.add_account_id_index()
        print(f"witness: wrote {written} user proofs "
              f"({n_workers if pool else 0} segment workers)")
        return written

    def run(self):
        accounts, cex_assets = self.load_accounts()
        self.prepare(accounts, cex_assets)
        self.run_witness()
        self.run_userproof()


def _userproof_rows_segment(payload):
    """Worker body for one userproof segment (userproof.go:87-149 analog):
    plain tuples in, UserProofRow constructor tuples out (json and base64
    only)."""
    plain, proofs, root_hex = payload
    out = []
    for (idx, acc_id_hex, te, td, tc, assets, leaf), proof in zip(
            plain, proofs):
        config = {
            "AccountIndex": idx,
            "AccountIdHash": acc_id_hex,
            "TotalEquity": te,
            "TotalDebt": td,
            "TotalCollateral": tc,
            "Assets": [{
                "Index": a[0], "Equity": a[1], "Debt": a[2],
                "Loan": a[3], "Margin": a[4], "PortfolioMargin": a[5],
            } for a in assets],
            "Root": root_hex,
            "Proof": [base64.b64encode(p).decode() for p in proof],
        }
        out.append((idx, acc_id_hex, base64.b64encode(leaf).decode(),
                    str(te), str(td), str(tc), json.dumps(config)))
    return out


def main(argv=None):
    import argparse
    from .config import load_config
    ap = argparse.ArgumentParser("zkpos-witness")
    ap.add_argument("--config", default="config/config.json")
    ap.add_argument("--witness_done_marker", default="")
    args = ap.parse_args(argv)
    svc = WitnessService(load_config(args.config))
    svc.run()
    if args.witness_done_marker:
        open(args.witness_done_marker, "w").close()


if __name__ == "__main__":
    main()
