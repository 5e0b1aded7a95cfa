"""Task queue with Redis list semantics (LPUSH / BRPOP); counterpart of
zkpos_tpu/db/queue.py.

The reference distributes proving work through the Redis list
`por_batch_task_queue_<suffix>` (src/dbtool/main.go:217,
src/prover/prover/prover.go:74).  This module preserves that protocol with
a sqlite-backed queue (atomic pop via IMMEDIATE transaction), so N prover
processes on one host race exactly like the reference's fleet does on
Redis.  A real Redis backend drops in behind the same class when a client
library is available.
"""

from __future__ import annotations

import time
from typing import Optional

from .storage import Database


class TaskQueue:
    def __init__(self, db: Database, suffix: str = ""):
        self.db = db
        self.table = f"por_batch_task_queue_{suffix}"
        self.db.execute(
            f"CREATE TABLE IF NOT EXISTS {self.table} ("
            "seq INTEGER PRIMARY KEY AUTOINCREMENT, value TEXT)")

    def lpush(self, *values) -> None:
        con = self.db._conn()
        with con:
            con.executemany(
                f"INSERT INTO {self.table}(value) VALUES (?)",
                [(str(v),) for v in values])

    def rpop(self) -> Optional[str]:
        for_update = getattr(self.db, "for_update_suffix", "")
        with self.db.immediate() as con:
            row = con.execute(
                f"SELECT seq, value FROM {self.table} "
                f"ORDER BY seq LIMIT 1{for_update}").fetchone()
            if row is None:
                return None
            con.execute(f"DELETE FROM {self.table} WHERE seq=?", (row[0],))
            return row[1]

    def brpop(self, timeout: float = 10.0) -> Optional[str]:
        """Blocking pop with timeout (prover.go:74 semantics: returns None
        on timeout, signalling 'queue empty, exit')."""
        deadline = time.monotonic() + timeout
        while True:
            v = self.rpop()
            if v is not None:
                return v
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.05)

    def flush(self) -> None:
        self.db.execute(f"DELETE FROM {self.table}")

    def llen(self) -> int:
        return self.db.query(f"SELECT COUNT(*) FROM {self.table}")[0][0]
