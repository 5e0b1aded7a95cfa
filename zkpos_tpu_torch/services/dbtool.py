"""dbtool CLI — parity with reference src/dbtool/main.go (8 flags);
counterpart of zkpos_tpu/services/dbtool.py.

  --delete_all            drop the 3 tables + flush the task queue (:44-99)
  --check_prover_status   row counts per status (:101-145)
  --query_cex_assets      recover final CEX state from latest witness (:147-170)
  --query_witness_data H  dump witness blob info for height H (:172-199)
  --query_account_data I  print user config JSON for account I (:201-215)
  --push_task_to_redis    enqueue all witness heights (:217-260)
  --export_proof_csv F    export proof table to CSV (:262-300)
"""

from __future__ import annotations

import csv
import json
import sys
from dataclasses import asdict

from ..db.codec import decode_batch_witness
from ..db.redis_backend import queue_from_config
from ..db.storage import (ProofModel, open_database, STATUS_FINISHED,
                          STATUS_PUBLISHED, STATUS_RECEIVED, UserProofModel,
                          WitnessModel)

PROOF_CSV_COLUMNS = ["proof_info", "cex_asset_list_commitments",
                     "account_tree_roots", "batch_commitment",
                     "account_min_index", "account_max_index",
                     "assets_count", "batch_number"]


class DbTool:
    def __init__(self, cfg, device=None):
        self.cfg = cfg
        # where query_cex_assets re-checks the CEX commitment (the card
        # unless the caller asks for the CPU)
        self.device = device
        self.db = open_database(cfg.db_path)
        self.witness = WitnessModel(self.db, cfg.db_suffix)
        self.userproof = UserProofModel(self.db, cfg.db_suffix)
        self.proof = ProofModel(self.db, cfg.db_suffix)
        self.queue = queue_from_config(cfg, self.db)

    def close(self):
        """Closes the database connection and the Redis socket, if any."""
        client = getattr(self.queue, "client", None)
        if client is not None:
            client.close()
        self.db.close()

    def delete_all(self):
        self.witness.drop_table()
        self.userproof.drop_table()
        self.proof.drop_table()
        self.queue.flush()
        print("deleted witness/userproof/proof tables and flushed queue")

    def check_prover_status(self):
        counts = {
            "published": self.witness.count_by_status(STATUS_PUBLISHED),
            "received": self.witness.count_by_status(STATUS_RECEIVED),
            "finished": self.witness.count_by_status(STATUS_FINISHED),
        }
        print(f"Published: {counts['published']}, "
              f"Received: {counts['received']}, "
              f"Finished: {counts['finished']}")
        return counts

    def query_cex_assets(self):
        from .witness import recover_after_cex_assets
        latest = self.witness.get_latest_batch_witness()
        wit = decode_batch_witness(latest.witness_data)
        cex = recover_after_cex_assets(wit, self.device)
        out = [{
            "TotalEquity": a.total_equity, "TotalDebt": a.total_debt,
            "BasePrice": a.base_price, "Symbol": a.symbol, "Index": a.index,
            "LoanCollateral": a.loan_collateral,
            "MarginCollateral": a.margin_collateral,
            "PortfolioMarginCollateral": a.portfolio_margin_collateral,
            "LoanRatios": _ratios_json(a.loan_ratios),
            "MarginRatios": _ratios_json(a.margin_ratios),
            "PortfolioMarginRatios": _ratios_json(a.portfolio_margin_ratios),
        } for a in cex]
        print(json.dumps(out))
        return out

    def query_witness_data(self, height: int):
        row = self.witness.get_batch_witness_by_height(height)
        wit = decode_batch_witness(row.witness_data)
        print(f"height {row.height} status {row.status} "
              f"ops {len(wit.create_user_ops)} "
              f"batch_commitment {wit.batch_commitment.hex()}")
        return wit

    def query_account_data(self, index: int):
        row = self.userproof.get_by_index(index)
        print(row.config)
        return json.loads(row.config)

    def push_task_to_redis(self):
        heights = [r[0] for r in self.db.query(
            f"SELECT height FROM {self.witness.table} ORDER BY height")]
        # page 1024 at a time (dbtool main.go:217-260)
        for start in range(0, len(heights), 1024):
            self.queue.lpush(*heights[start:start + 1024])
        print(f"pushed {len(heights)} tasks")
        return len(heights)

    def export_proof_csv(self, path: str):
        rows = self.proof.get_all_proofs()
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=PROOF_CSV_COLUMNS)
            w.writeheader()
            for r in rows:
                w.writerow(asdict(r))
        print(f"exported {len(rows)} proofs to {path}")
        return len(rows)


def _ratios_json(ratios):
    return [{"BoundaryValue": str(t.boundary_value), "Ratio": t.ratio,
             "PrecomputedValue": str(t.precomputed_value)} for t in ratios]


def main(argv=None):
    import argparse
    from .config import load_config
    ap = argparse.ArgumentParser("zkpos-dbtool")
    ap.add_argument("--config", default="config/config.json")
    ap.add_argument("--delete_all", action="store_true")
    ap.add_argument("--check_prover_status", action="store_true")
    ap.add_argument("--query_cex_assets", action="store_true")
    ap.add_argument("--query_witness_data", type=int, default=None)
    ap.add_argument("--query_account_data", type=int, default=None)
    ap.add_argument("--push_task_to_redis", action="store_true")
    ap.add_argument("--export_proof_csv", default=None)
    args = ap.parse_args(argv)
    tool = DbTool(load_config(args.config))
    if args.delete_all:
        tool.delete_all()
    elif args.check_prover_status:
        tool.check_prover_status()
    elif args.query_cex_assets:
        tool.query_cex_assets()
    elif args.query_witness_data is not None:
        tool.query_witness_data(args.query_witness_data)
    elif args.query_account_data is not None:
        tool.query_account_data(args.query_account_data)
    elif args.push_task_to_redis:
        tool.push_task_to_redis()
    elif args.export_proof_csv:
        tool.export_proof_csv(args.export_proof_csv)
    else:
        print("no action specified", file=sys.stderr)


if __name__ == "__main__":
    main()
