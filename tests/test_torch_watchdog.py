"""The port's prover watchdog (zkpos_tpu_torch/services/watchdog.py) against
the JAX package's check_prover_status.py: the same arguments and defaults,
and its loop run with injected poll and relaunch functions at a poll of a
millisecond (no prover process is started), and its default poll over a
sqlite file and over a MySQL-like driver."""
import argparse
import json

import pytest

import check_prover_status
from zkpos_tpu_torch.db.mysql_backend import MySQLDatabase
from zkpos_tpu_torch.db.storage import (BatchWitnessRow, Database,
                                        STATUS_FINISHED, STATUS_PUBLISHED,
                                        STATUS_RECEIVED, WitnessModel)
from zkpos_tpu_torch.services import dbtool, watchdog

FAST = ["--poll-secs", "0.001", "--stall-secs", "0.02"]


class _Parsed(Exception):
    pass


def _parse(main, argv, monkeypatch):
    """The namespace `main` parses from argv, and its options; main is
    stopped right after parsing."""
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["args"] = vars(orig(self, args, namespace))
        seen["options"] = sorted(s for a in self._actions
                                 for s in a.option_strings)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        main(argv)
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("argv", [
    [], ["--config", "c.json", "--poll-secs", "5", "--stall-secs", "7.5",
         "--max-retries", "9"]])
def test_arguments_match_reference(argv, monkeypatch):
    port = _parse(watchdog.main, argv, monkeypatch)
    ref = _parse(check_prover_status.main, argv, monkeypatch)
    assert port == ref
    if not argv:
        assert port["args"] == {"config": "config/config.json",
                                "poll_secs": 60.0, "stall_secs": 480.0,
                                "max_retries": 3}


def _counts(published, received, finished):
    return {"published": published, "received": received,
            "finished": finished}


def test_stall_relaunches_up_to_max_retries():
    launched = []
    rc = watchdog.main(FAST + ["--config", "x.json", "--max-retries", "2"],
                       poll=lambda: _counts(3, 1, 5),
                       relaunch=launched.append)
    assert rc == 1
    assert launched == ["x.json", "x.json"]


def test_progress_resets_the_stall_clock():
    """Finished grows by one a poll for 100 polls (about 0.1 s, five stall
    windows), then all work is done: no relaunch, exit 0."""
    state = {"polls": 0}

    def poll():
        state["polls"] += 1
        n = state["polls"]
        return _counts(0, 1, n) if n <= 100 else _counts(0, 0, n)

    launched = []
    assert watchdog.main(FAST, poll=poll, relaunch=launched.append) == 0
    assert launched == [] and state["polls"] == 101


def test_relaunch_that_unsticks_then_finishes():
    """A stall, one relaunch, then progress and the end of the work."""
    launched = []

    def poll():
        if not launched:
            return _counts(2, 0, 0)
        return _counts(0, 0, 2)

    assert watchdog.main(FAST, poll=poll, relaunch=launched.append) == 0
    assert launched == ["config/config.json"]


def test_finished_work_exits_zero():
    launched = []
    assert watchdog.main(FAST, poll=lambda: _counts(0, 0, 7),
                         relaunch=launched.append) == 0
    assert launched == []


class _Fleet:
    """Witness counts that move on by one finished row each time a reader
    takes a snapshot, as a fleet of provers at work shows them.  Every
    connection opened and closed is counted."""

    def __init__(self, n):
        self.published, self.finished = n, 0
        self.opened = self.closed = 0

    def snapshot(self):
        snap = {STATUS_PUBLISHED: self.published, STATUS_RECEIVED: 0,
                STATUS_FINISHED: self.finished}
        if self.published:
            self.published -= 1
            self.finished += 1
        return snap

    def connect(self, **_):
        self.opened += 1
        return _Conn(self)


class _Conn:
    """A DB-API connection with autocommit off under REPEATABLE READ: the
    first read of a transaction takes the snapshot that every later read
    sees until a commit or a rollback."""

    def __init__(self, fleet):
        self.fleet, self.snap = fleet, None

    def cursor(self):
        return _Cursor(self)

    def commit(self):
        self.snap = None

    rollback = commit

    def close(self):
        self.fleet.closed += 1


class _Cursor:
    def __init__(self, con):
        self.con, self.rows = con, []

    def execute(self, sql, params=()):
        if sql.lstrip().upper().startswith("SELECT"):
            if self.con.snap is None:
                self.con.snap = self.con.fleet.snapshot()
            self.rows = [(self.con.snap[params[0]],)]

    def fetchall(self):
        return self.rows

    def close(self):
        pass


def test_default_poll_reads_fresh_counts(monkeypatch):
    """The default poll over a MySQL-like driver: each poll sees the rows
    finished since the last one, so progress is seen, nothing is
    relaunched, and every connection is closed."""
    fleet = _Fleet(3)
    monkeypatch.setattr(dbtool, "open_database",
                        lambda dsn: MySQLDatabase(fleet.connect))
    launched = []
    assert watchdog.main(FAST, relaunch=launched.append) == 0
    assert launched == []
    assert fleet.opened == fleet.closed == 4


def test_default_poll_over_sqlite(tmp_path):
    """The default poll over a sqlite file that the relaunched prover
    updates from a connection of its own: one stall, one relaunch, then
    all work finished."""
    db_path = str(tmp_path / "zkpos.db")
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps({"MysqlDataSource": db_path}))
    witness = WitnessModel(Database(db_path))
    witness.create_table()
    witness.create_batch_witness([BatchWitnessRow(h, "", STATUS_PUBLISHED)
                                  for h in range(3)])
    launched = []

    def relaunch(config):
        launched.append(config)
        prover = WitnessModel(Database(db_path))
        for h in range(3):
            prover.update_status(h, STATUS_FINISHED)
        prover.db.close()

    assert watchdog.main(FAST + ["--config", str(cfg)],
                         relaunch=relaunch) == 0
    assert launched == [str(cfg)]
    witness.db.close()
