"""Storage models — parity with reference src/witness/witness/*_model.go and
src/prover/prover/proof_model.go.

Schema, status machine and claim semantics match the reference:
  * witness<suffix>(height UNIQUE, witness_data TEXT, status INT)
    with Published(0) / Received(1) / Finished(2) (witness_model.go:12-16);
  * claim = transactional Published->Received flip on a specific height
    (witness_model.go:129-152's SELECT ... FOR UPDATE becomes BEGIN
    IMMEDIATE in sqlite — same mutual exclusion);
  * userproof<suffix>(account_index UNIQUE, ...) (userproof_model.go:14-28);
  * proof<suffix>(batch_number UNIQUE, ...) (proof_model.go:29-39).

Backend: sqlite (always available).  A MySQL backend drops in behind the
same Database facade when a client library is present (the DSN decides);
the services never see the difference.
"""

from __future__ import annotations

import os
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

STATUS_PUBLISHED = 0
STATUS_RECEIVED = 1
STATUS_FINISHED = 2


class DbErrNotFound(Exception):
    pass


@dataclass
class BatchWitnessRow:
    height: int
    witness_data: str
    status: int


@dataclass
class UserProofRow:
    account_index: int
    account_id: str
    account_leaf: str
    total_equity: str
    total_debt: str
    total_collateral: str
    config: str


@dataclass
class ProofRow:
    proof_info: str
    cex_asset_list_commitments: str
    account_tree_roots: str
    batch_commitment: str
    account_min_index: int
    account_max_index: int
    assets_count: int
    batch_number: int


def open_database(dsn: str):
    """Backend selection by DSN: `mysql://…` -> MySQL (db/mysql_backend.py,
    reference-parity dialect + FOR UPDATE claims); anything else is a
    sqlite path (the tested default)."""
    if dsn.startswith("mysql://"):
        from .mysql_backend import connect_dsn
        return connect_dsn(dsn)
    return Database(dsn)


class Database:
    """Thin sqlite wrapper with per-thread connections and WAL mode."""

    def __init__(self, path: str):
        self.path = path
        self._local = threading.local()
        if path != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        con = self._conn()
        con.execute("PRAGMA journal_mode=WAL")

    def _conn(self) -> sqlite3.Connection:
        con = getattr(self._local, "con", None)
        if con is None:
            con = sqlite3.connect(self.path, timeout=30.0)
            con.execute("PRAGMA busy_timeout=30000")
            self._local.con = con
        return con

    def execute(self, sql, params=()):
        con = self._conn()
        with con:
            return con.execute(sql, params)

    def query(self, sql, params=()):
        return self._conn().execute(sql, params).fetchall()

    def immediate(self):
        """Context for an IMMEDIATE (write-locked) transaction."""
        return _Immediate(self._conn())

    def close(self):
        """Closes this thread's connection; a later call opens another."""
        con = getattr(self._local, "con", None)
        if con is not None:
            con.close()
            self._local.con = None


class _Immediate:
    def __init__(self, con):
        self.con = con

    def __enter__(self):
        self.con.execute("BEGIN IMMEDIATE")
        return self.con

    def __exit__(self, et, ev, tb):
        if et is None:
            self.con.execute("COMMIT")
        else:
            self.con.execute("ROLLBACK")
        return False


class WitnessModel:
    """witness_model.go equivalents."""

    def __init__(self, db: Database, suffix: str = ""):
        self.db = db
        self.table = f"witness{suffix}"

    def create_table(self):
        self.db.execute(
            f"CREATE TABLE IF NOT EXISTS {self.table} ("
            "height INTEGER PRIMARY KEY, witness_data TEXT, status INTEGER)")

    def drop_table(self):
        self.db.execute(f"DROP TABLE IF EXISTS {self.table}")

    def create_batch_witness(self, rows: List[BatchWitnessRow]):
        con = self.db._conn()
        with con:
            con.executemany(
                f"INSERT INTO {self.table}(height, witness_data, status) "
                "VALUES (?,?,?)",
                [(r.height, r.witness_data, r.status) for r in rows])

    def get_latest_batch_witness(self) -> BatchWitnessRow:
        rows = self.db.query(
            f"SELECT height, witness_data, status FROM {self.table} "
            "ORDER BY height DESC LIMIT 1")
        if not rows:
            raise DbErrNotFound()
        return BatchWitnessRow(*rows[0])

    def get_batch_witness_by_height(self, height: int) -> BatchWitnessRow:
        rows = self.db.query(
            f"SELECT height, witness_data, status FROM {self.table} "
            "WHERE height=?", (height,))
        if not rows:
            raise DbErrNotFound()
        return BatchWitnessRow(*rows[0])

    def claim_witness_by_height(self, height: int,
                                from_status: int = STATUS_PUBLISHED
                                ) -> Optional[BatchWitnessRow]:
        """Transactional Published->Received claim
        (witness_model.go:129-152).  Returns None if already taken."""
        # the MySQL backend turns the trailing marker into FOR UPDATE (row
        # lock, witness_model.go:129-152); sqlite's BEGIN IMMEDIATE already
        # serializes writers so the marker is dropped there
        for_update = getattr(self.db, "for_update_suffix", "")
        with self.db.immediate() as con:
            row = con.execute(
                f"SELECT height, witness_data, status FROM {self.table} "
                f"WHERE height=? AND status=?{for_update}",
                (height, from_status)).fetchone()
            if row is None:
                return None
            con.execute(
                f"UPDATE {self.table} SET status=? WHERE height=?",
                (STATUS_RECEIVED, height))
            return BatchWitnessRow(row[0], row[1], STATUS_RECEIVED)

    def update_status(self, height: int, status: int):
        self.db.execute(
            f"UPDATE {self.table} SET status=? WHERE height=?",
            (status, height))

    def rows_by_status(self, status: int) -> List[int]:
        return [r[0] for r in self.db.query(
            f"SELECT height FROM {self.table} WHERE status=? ORDER BY height",
            (status,))]

    def count_by_status(self, status: int) -> int:
        return self.db.query(
            f"SELECT COUNT(*) FROM {self.table} WHERE status=?",
            (status,))[0][0]

    def count(self) -> int:
        return self.db.query(f"SELECT COUNT(*) FROM {self.table}")[0][0]


class UserProofModel:
    """userproof_model.go equivalents."""

    def __init__(self, db: Database, suffix: str = ""):
        self.db = db
        self.table = f"userproof{suffix}"

    def create_table(self):
        self.db.execute(
            f"CREATE TABLE IF NOT EXISTS {self.table} ("
            "account_index INTEGER PRIMARY KEY, account_id TEXT, "
            "account_leaf TEXT, total_equity TEXT, total_debt TEXT, "
            "total_collateral TEXT, config TEXT)")

    def drop_table(self):
        self.db.execute(f"DROP TABLE IF EXISTS {self.table}")

    def create_user_proofs(self, rows: List[UserProofRow]):
        con = self.db._conn()
        with con:
            con.executemany(
                f"INSERT INTO {self.table} VALUES (?,?,?,?,?,?,?)",
                [(r.account_index, r.account_id, r.account_leaf,
                  r.total_equity, r.total_debt, r.total_collateral, r.config)
                 for r in rows])

    def max_account_index(self) -> int:
        rows = self.db.query(
            f"SELECT MAX(account_index) FROM {self.table}")
        if not rows or rows[0][0] is None:
            raise DbErrNotFound()
        return rows[0][0]

    def get_by_index(self, idx: int) -> UserProofRow:
        rows = self.db.query(
            f"SELECT * FROM {self.table} WHERE account_index=?", (idx,))
        if not rows:
            raise DbErrNotFound()
        return UserProofRow(*rows[0])

    def add_account_id_index(self):
        """Deferred secondary index (userproof_model.go:84-87)."""
        self.db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{self.table}_account_id "
            f"ON {self.table}(account_id)")

    def count(self) -> int:
        return self.db.query(f"SELECT COUNT(*) FROM {self.table}")[0][0]


class ProofModel:
    """proof_model.go equivalents."""

    def __init__(self, db: Database, suffix: str = ""):
        self.db = db
        self.table = f"proof{suffix}"

    def create_table(self):
        self.db.execute(
            f"CREATE TABLE IF NOT EXISTS {self.table} ("
            "proof_info TEXT, cex_asset_list_commitments TEXT, "
            "account_tree_roots TEXT, batch_commitment TEXT, "
            "account_min_index INTEGER, account_max_index INTEGER, "
            "assets_count INTEGER, batch_number INTEGER PRIMARY KEY)")

    def drop_table(self):
        self.db.execute(f"DROP TABLE IF EXISTS {self.table}")

    def create_proof(self, row: ProofRow) -> bool:
        try:
            self.db.execute(
                f"INSERT INTO {self.table} VALUES (?,?,?,?,?,?,?,?)",
                (row.proof_info, row.cex_asset_list_commitments,
                 row.account_tree_roots, row.batch_commitment,
                 row.account_min_index, row.account_max_index,
                 row.assets_count, row.batch_number))
            return True
        except sqlite3.IntegrityError:
            return False

    def get_proof_by_batch_number(self, n: int) -> ProofRow:
        rows = self.db.query(
            f"SELECT * FROM {self.table} WHERE batch_number=?", (n,))
        if not rows:
            raise DbErrNotFound()
        return ProofRow(*rows[0])

    def get_all_proofs(self) -> List[ProofRow]:
        return [ProofRow(*r) for r in self.db.query(
            f"SELECT * FROM {self.table} ORDER BY batch_number")]

    def count(self) -> int:
        return self.db.query(f"SELECT COUNT(*) FROM {self.table}")[0][0]
