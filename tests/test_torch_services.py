"""The port's service layer on the CPU, held against the JAX package on the
same seeded inputs (asset universe 4, tier count 2, depth 8, tier 3:2):

* sample data: the rows of utils/sample_data equal the JAX generator's for
  the same seed and a seeded CEX table, and the CSV ingest counts the
  designed invalid rows exactly;
* queues: the sqlite TaskQueue, and the RESP client against a fake Redis
  server (tests/test_queue_backends.py's), with byte-identical requests;
  the MySQL dialect through a mocked DB-API driver, with the same SQL;
* the secret manager's file provider;
* the prover's claim, idempotency and rerun (the proof itself stubbed:
  the BatchCreateUser prove runs on the card, chip_smoke.py), and the
  mock-prover concurrency of tests/test_services.py, on the port's storage;
* verify_user on the userproof rows the port's witness service wrote, and
  on tampered copies: the JAX function's verdict;
* verify_batch_proofs' row and chain checks (groth16.verify patched in
  both packages, one worker): the JAX package's VerificationError text on
  the same tampered rows;
* dbtool's queries and CSV export against the JAX dbtool on the same
  sqlite file.

Every comparison is exact.
"""
import base64
import csv
import json
import os
import sqlite3
import threading

import pytest
import torch

from zkpos_tpu.crypto import bn254 as jbn
from zkpos_tpu.utils import constants as JC
from zkpos_tpu_torch.crypto import bn254 as tbn
from zkpos_tpu_torch.utils import constants as TC

from tests.test_queue_backends import FakeRedisServer, MockConn

torch.set_num_threads(1)

TOKENS = ["btc", "eth", "shib"]       # three held a user: tier 3
VALID, INVALID = 6, 2                 # 3 batches of 2, and 2 invalid rows
TIERS = {3: 2}
PREFIX = "keys/zkpor"


@pytest.fixture(scope="module")
def sizes():
    saved = [(C, C.ASSET_COUNTS, C.TIER_COUNT, C.ACCOUNT_TREE_DEPTH)
             for C in (JC, TC)]
    env = os.environ.get("ZKPOR_TEST_TIERS")
    for C in (JC, TC):
        C.configure(asset_counts=4, tier_count=2, tree_depth=8)
    os.environ["ZKPOR_TEST_TIERS"] = "3:2"
    yield
    for C, *vals in saved:
        C.configure(*vals)
    if env is None:
        os.environ.pop("ZKPOR_TEST_TIERS", None)
    else:
        os.environ["ZKPOR_TEST_TIERS"] = env


def _copy_db(src_root, dst_root):
    """The service database, WAL included, through sqlite's backup."""
    src = sqlite3.connect(os.path.join(src_root, "zkpos.db"))
    dst = sqlite3.connect(os.path.join(dst_root, "zkpos.db"))
    src.backup(dst)
    src.close()
    dst.close()


def _cfg(cls, root, db="zkpos.db"):
    return cls(db_path=os.path.join(root, db), user_data_file=root,
               zk_key_name=os.path.join(root, PREFIX))


@pytest.fixture(scope="module")
def witness(sizes, tmp_path_factory):
    """A seeded CEX table, one user file from the port's sample_data CLI,
    and the port's witness service over it (sqlite, on the CPU)."""
    from zkpos_tpu_torch.services.config import ServiceConfig
    from zkpos_tpu_torch.services.witness import WitnessService
    from zkpos_tpu_torch.utils import csv_ingest, sample_data
    root = str(tmp_path_factory.mktemp("svc"))
    cex_path = os.path.join(root, "cex_assets_info.csv")
    sample_data.write_cex_info(cex_path, TOKENS, seed=5)
    sample_data.main(["0", str(VALID + INVALID), str(INVALID), "--cex",
                      cex_path, "--out-dir", root, "--tokens",
                      ",".join(TOKENS), "--seed", "9"])
    accounts, cex, invalid = csv_ingest.parse_user_data_set(root)
    cfg = _cfg(ServiceConfig, root)
    svc = WitnessService(cfg, device="cpu")
    svc.prepare(accounts, cex)
    n_wit = svc.run_witness()
    n_proofs = svc.run_userproof()
    return {"root": root, "cfg": cfg, "svc": svc, "invalid": invalid,
            "accounts": accounts, "n_wit": n_wit, "n_proofs": n_proofs}


def test_sample_data_matches_jax(witness):
    from zkpos_tpu.utils import sample_data as jsd
    from zkpos_tpu_torch.utils import sample_data as tsd
    cex_path = os.path.join(witness["root"], "cex_assets_info.csv")
    jprice, jtiers = jsd.read_cex_info(cex_path)
    tprice, ttiers = tsd.read_cex_info(cex_path)
    assert (tprice, ttiers) == (jprice, jtiers)
    for seed in (9, 10):
        want = jsd.generate_rows(0, VALID + INVALID, INVALID, TOKENS,
                                 jprice, jtiers, seed)
        assert tsd.generate_rows(0, VALID + INVALID, INVALID, TOKENS,
                                 tprice, ttiers, seed) == want
    with open(os.path.join(witness["root"], "sample_users0.csv"),
              newline="") as f:
        assert list(csv.reader(f)) == jsd.generate_rows(
            0, VALID + INVALID, INVALID, TOKENS, jprice, jtiers, 9)
    # the ingest keeps the designed split: every valid user in tier 3
    assert witness["invalid"] == INVALID
    assert {k: len(v) for k, v in witness["accounts"].items()} == {3: VALID}
    assert witness["n_wit"] == VALID // 2
    assert witness["n_proofs"] == VALID


# --- queues --------------------------------------------------------------------

@pytest.fixture()
def fake_redis():
    srv = FakeRedisServer()
    srv.start()
    yield srv
    srv.stop()


def test_resp_encoding_matches_jax():
    from zkpos_tpu.db.redis_backend import RedisClient as J
    from zkpos_tpu_torch.db.redis_backend import RedisClient as T
    for args in (("PING",), ("LPUSH", "por_batch_task_queue_x", 1, "22",
                             "héllo"), ("BRPOP", "k", 10), ("AUTH", ""),
                 ("DEL", "k"), ("FLUSHALL",)):
        assert T._encode(args) == J._encode(args), args


def test_redis_queue_against_fake_server(fake_redis, tmp_path):
    """The same operations through both packages' RedisTaskQueue: the same
    replies, and the same commands on the wire."""
    from zkpos_tpu.db import redis_backend as jr
    from zkpos_tpu_torch.db import redis_backend as tr
    from zkpos_tpu_torch.db.queue import TaskQueue
    from zkpos_tpu_torch.db.storage import open_database
    from zkpos_tpu_torch.services.config import ServiceConfig
    logs = []
    for mod in (jr, tr):
        fake_redis.commands.clear()
        q = mod.RedisTaskQueue(mod.RedisClient(
            "127.0.0.1", fake_redis.port, timeout=5.0), suffix="t")
        assert q.client.ping()
        q.lpush(1, 2, 3)
        got = [q.llen(), q.brpop(1.0), q.rpop(), q.rpop(), q.rpop(),
               q.brpop(0)]
        q.lpush(42)
        q.flush()
        got.append(q.llen())
        assert got == [3, "1", "2", "3", None, None, 0]
        logs.append(list(fake_redis.commands))
    assert logs[0] == logs[1]
    db = open_database(str(tmp_path / "q.db"))
    cfg = ServiceConfig()
    assert isinstance(tr.queue_from_config(cfg, db), TaskQueue)
    cfg.redis_addr = f"127.0.0.1:{fake_redis.port}"
    q = tr.queue_from_config(cfg, db)
    assert isinstance(q, tr.RedisTaskQueue)
    q.lpush(7)
    assert q.brpop(1.0) == "7"


def test_sqlite_queue_matches_jax(tmp_path):
    from zkpos_tpu.db.queue import TaskQueue as JQ
    from zkpos_tpu.db.storage import Database as JD
    from zkpos_tpu_torch.db.queue import TaskQueue as TQ
    from zkpos_tpu_torch.db.storage import Database as TD
    out = []
    for D, Q, name in ((JD, JQ, "j.db"), (TD, TQ, "t.db")):
        q = Q(D(str(tmp_path / name)), "s")
        q.lpush(5, 6, 7)
        got = [q.llen(), q.rpop(), q.brpop(0.1), q.llen()]
        q.flush()
        got += [q.llen(), q.brpop(0.05)]
        out.append(got)
    assert out[0] == out[1] == [3, "5", "6", 1, 0, None]


def test_mysql_dialect_matches_jax():
    from zkpos_tpu.db import mysql_backend as jm
    from zkpos_tpu.db import storage as js
    from zkpos_tpu_torch.db import mysql_backend as tm
    from zkpos_tpu_torch.db import storage as ts
    logs = []
    for m, s in ((jm, js), (tm, ts)):
        log = []
        db = m.MySQLDatabase(lambda: MockConn(log, [(5, "payload", 0)]))
        wm = s.WitnessModel(db, suffix="t")
        wm.create_table()
        claimed = wm.claim_witness_by_height(5)
        assert claimed is not None and claimed.status == s.STATUS_RECEIVED
        wm.count_by_status(s.STATUS_PUBLISHED)
        logs.append(log)
    assert logs[0] == logs[1]
    sqls = [q for q, _ in logs[1]]
    select = next(q for q in sqls if "FOR UPDATE" in q)
    assert "MAX_EXECUTION_TIME(10000)" in select and "?" not in select
    # a mysql:// DSN is routed to the backend; with no driver installed
    # both packages raise the same error
    errs = []
    for s in (js, ts):
        try:
            s.open_database("mysql://u:p@localhost:3306/zkpos")
            errs.append(None)
        except RuntimeError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]


def test_secret_manager_matches_jax(tmp_path):
    from zkpos_tpu.utils import secret_manager as js
    from zkpos_tpu_torch.utils import secret_manager as ts
    (tmp_path / "pw").write_text("s3cret\n")
    conf = tmp_path / "remote.json"
    conf.write_text(json.dumps({"provider": "file",
                                "path": str(tmp_path / "pw")}))
    dsn = "mysql://u:${password}@h:3306/db"
    assert ts.get_db_source(dsn, str(conf)) == \
        js.get_db_source(dsn, str(conf)) == "mysql://u:s3cret@h:3306/db"
    conf.write_text(json.dumps({"provider": "nope"}))
    for m in (js, ts):
        with pytest.raises(ValueError):
            m.get_db_source(dsn, str(conf))


# --- the prover's queue, claim, idempotency and rerun -------------------------

def _fake_proof(proof_cls, height):
    """A proof of real points (not a valid one) that depends on the
    height: the prove itself is the card's (chip_smoke.py)."""
    k = height + 2
    return proof_cls(ar=jbn.g1_mul(jbn.G1_GEN, k),
                     bs=jbn.g2_mul(jbn.G2_GEN, k),
                     krs=jbn.g1_mul(jbn.G1_GEN, 3 * k),
                     d=jbn.g1_mul(jbn.G1_GEN, 5 * k),
                     pok=jbn.g1_mul(jbn.G1_GEN, 7 * k))


def _port_points(proof):
    """A JAX-package Proof's points as this package's."""
    def conv(p):
        if p is None or isinstance(p[0], int):
            return p
        return (tbn.Fp2(p[0].c0, p[0].c1), tbn.Fp2(p[1].c0, p[1].c1))
    return {k: conv(getattr(proof, k)) for k in ("ar", "bs", "krs", "d",
                                                 "pok")}


def _stub(prover, package):
    """generate_and_verify_proof replaced by a fake proof of each batch's
    height; returns the list of heights it was called for."""
    from zkpos_tpu.groth16.groth16 import Proof as JP
    from zkpos_tpu_torch.groth16.groth16 import Proof as TP
    calls = []

    def fake(wit, height):
        calls.append(height)
        proof = _fake_proof(JP, height)
        if package == "port":
            proof = TP(**_port_points(proof))
        return proof, 3, [int.from_bytes(wit.batch_commitment, "big")]
    prover.generate_and_verify_proof = fake
    return calls


@pytest.fixture(scope="module")
def proved(witness, tmp_path_factory):
    """Both packages' provers, stubbed, over copies of the witness
    database: queue -> claim -> proof rows.  Returns the two roots."""
    from zkpos_tpu.services.config import ServiceConfig as JCfg
    from zkpos_tpu.services.dbtool import DbTool as JDb
    from zkpos_tpu.services.prover import Prover as JProver
    from zkpos_tpu_torch.services.config import ServiceConfig as TCfg
    from zkpos_tpu_torch.services.dbtool import DbTool as TDb
    from zkpos_tpu_torch.services.prover import Prover as TProver
    roots = {}
    for pkg, Cfg, Db, Prover in (("jax", JCfg, JDb, JProver),
                                 ("port", TCfg, TDb, TProver)):
        root = str(tmp_path_factory.mktemp(pkg))
        _copy_db(witness["root"], root)
        cfg = _cfg(Cfg, root)
        kw = {"device": "cpu"} if pkg == "port" else {}
        assert Db(cfg, **kw).push_task_to_redis() == witness["n_wit"]
        prover = Prover(cfg, tiers=TIERS, **kw)
        calls = _stub(prover, pkg)
        prover.run(queue_timeout=0.2)
        assert calls == list(range(witness["n_wit"]))
        prover.run(rerun=True)             # nothing left to sweep
        assert len(calls) == witness["n_wit"]
        roots[pkg] = root
    return roots


def test_prover_claim_idempotency_rerun(witness, proved):
    from zkpos_tpu_torch.db.storage import (STATUS_FINISHED, STATUS_PUBLISHED,
                                            STATUS_RECEIVED, ProofModel,
                                            WitnessModel, open_database)
    from zkpos_tpu_torch.services.config import ServiceConfig
    from zkpos_tpu_torch.services.prover import Prover
    n = witness["n_wit"]
    db = open_database(os.path.join(proved["port"], "zkpos.db"))
    wm, pm = WitnessModel(db, ""), ProofModel(db, "")
    assert wm.count_by_status(STATUS_FINISHED) == n
    assert [r.batch_number for r in pm.get_all_proofs()] == list(range(n))
    # the same proof rows as the JAX prover wrote
    jdb = open_database(os.path.join(proved["jax"], "zkpos.db"))
    assert ProofModel(jdb, "").get_all_proofs() == pm.get_all_proofs()
    # a crash after the proof row (status back to Received): the rerun
    # sweep finishes it without proving again; a crash before it
    # (Published, no proof row): the rerun proves it
    wm.update_status(1, STATUS_RECEIVED)
    db.execute(f"DELETE FROM {pm.table} WHERE batch_number=?", (2,))
    wm.update_status(2, STATUS_PUBLISHED)
    prover = Prover(_cfg(ServiceConfig, proved["port"]), tiers=TIERS,
                    device="cpu")
    calls = _stub(prover, "port")
    prover.run(rerun=True)
    assert calls == [2]
    assert wm.count_by_status(STATUS_FINISHED) == n
    assert ProofModel(jdb, "").get_all_proofs() == pm.get_all_proofs()
    # a claimed row is not claimed twice
    assert prover.handle_height(0) is False


def test_mock_prover_concurrency(tmp_path):
    """tests/test_services.py:test_mock_prover_concurrency on the port's
    storage and queue: 16 threads race BRPOP + the transactional claim."""
    from zkpos_tpu_torch.db.queue import TaskQueue
    from zkpos_tpu_torch.db.storage import (STATUS_FINISHED, STATUS_PUBLISHED,
                                            BatchWitnessRow, Database,
                                            WitnessModel)
    n_rows, n_workers = 200, 16
    db_path = str(tmp_path / "race.db")
    wm = WitnessModel(Database(db_path), "_race")
    wm.create_table()
    wm.create_batch_witness([
        BatchWitnessRow(height=i, witness_data="x", status=STATUS_PUBLISHED)
        for i in range(n_rows)])
    TaskQueue(Database(db_path), "_race").lpush(*range(n_rows))
    claimed, lock = [], threading.Lock()

    def worker():
        mydb = Database(db_path)
        mywm, myq = WitnessModel(mydb, "_race"), TaskQueue(mydb, "_race")
        while (v := myq.brpop(timeout=0.5)) is not None:
            if mywm.claim_witness_by_height(int(v)) is not None:
                mywm.update_status(int(v), STATUS_FINISHED)
                with lock:
                    claimed.append(int(v))

    threads = [threading.Thread(target=worker) for _ in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(claimed) == list(range(n_rows))
    assert wm.count_by_status(STATUS_FINISHED) == n_rows
    assert wm.count_by_status(STATUS_PUBLISHED) == 0


# --- the verifier ----------------------------------------------------------------

def test_verify_user_matches_jax(witness):
    from zkpos_tpu.services.verifier import verify_user as jverify
    from zkpos_tpu_torch.services.verifier import verify_user as tverify
    um = witness["svc"].userproof_model
    configs = [json.loads(um.get_by_index(i).config)
               for i in range(witness["n_proofs"])]
    for c in configs:
        assert tverify(c) is jverify(c) is True
    sib = base64.b64encode(bytes(32)).decode()
    tampered = []
    for field, change in (
            ("TotalEquity", lambda c: c["TotalEquity"] + 1),
            ("TotalCollateral", lambda c: c["TotalCollateral"] - 1),
            ("AccountIndex", lambda c: c["AccountIndex"] ^ 1),
            ("Proof", lambda c: [sib] + c["Proof"][1:]),
            ("Assets", lambda c: [dict(c["Assets"][0],
                                       Equity=c["Assets"][0]["Equity"] + 1)]
             + c["Assets"][1:])):
        for c in configs[:2]:
            tampered.append(dict(c, **{field: change(c)}))
    for c in tampered:
        assert tverify(c) is jverify(c) is False


def _rows(root, jax=False):
    """The proof table as dbtool exports it."""
    if jax:
        from zkpos_tpu.services.config import ServiceConfig
        from zkpos_tpu.services.dbtool import DbTool
        from zkpos_tpu.services.verifier import load_proof_csv
        tool = DbTool(_cfg(ServiceConfig, root))
    else:
        from zkpos_tpu_torch.services.config import ServiceConfig
        from zkpos_tpu_torch.services.dbtool import DbTool
        from zkpos_tpu_torch.services.verifier import load_proof_csv
        tool = DbTool(_cfg(ServiceConfig, root), device="cpu")
    path = os.path.join(root, "proofs.csv")
    tool.export_proof_csv(path)
    return load_proof_csv(path)


def _recommit(row):
    """The row's batch commitment recomputed from its fields (what a
    forger must do to get past the per-row check)."""
    from zkpos_tpu_torch.services.verifier import _batch_commitment
    comms = [base64.b64decode(c)
             for c in json.loads(row["cex_asset_list_commitments"])]
    root = base64.b64decode(json.loads(row["account_tree_roots"])[0])
    row["batch_commitment"] = base64.b64encode(_batch_commitment(
        root, comms[0], comms[1], int(row["account_min_index"]),
        int(row["account_max_index"]))).decode()


def _b64(v: int) -> str:
    return base64.b64encode(tbn.fr_to_bytes(v)).decode()


def _tampered(rows):
    """(the verifier's error, rows) cases, each breaking one check."""
    def copy():
        return [dict(r) for r in rows]

    cases = []
    r = copy()
    r[1]["batch_commitment"] = _b64(7)
    cases.append(("batch 1: commitment mismatch", r))
    r = copy()
    r[2]["account_tree_roots"] = json.dumps([_b64(11)])
    _recommit(r[2])
    cases.append(("tree root mismatch across batches", r))
    r = copy()
    comms = json.loads(r[1]["cex_asset_list_commitments"])
    r[1]["cex_asset_list_commitments"] = json.dumps([_b64(13), comms[1]])
    _recommit(r[1])
    cases.append(("batch 1: cex commitment chain broken", r))
    r = copy()
    r[2]["account_min_index"] = str(int(r[2]["account_min_index"]) + 1)
    _recommit(r[2])
    cases.append(("batch 2: index continuity broken", r))
    # a row left out: the gap shows first in the CEX chain
    cases.append(("batch 2: cex commitment chain broken",
                  [dict(rows[0]), dict(rows[2])]))
    return cases


def _verdict(fn, *args):
    try:
        fn(*args)
        return "ok"
    except Exception as e:          # the exception's type and text compared
        return f"{type(e).__name__}: {e}"


def test_verify_batch_proofs_matches_jax(witness, proved, monkeypatch):
    from zkpos_tpu.groth16 import artifact as jaf
    from zkpos_tpu.groth16 import groth16 as jg16
    from zkpos_tpu.services import verifier as jv
    from zkpos_tpu_torch.groth16 import groth16 as tg16
    from zkpos_tpu_torch.services import verifier as tv
    jrows, trows = _rows(proved["jax"], jax=True), _rows(proved["port"])
    assert jrows == trows
    # a vk for the tier (its points do not matter: verify is patched)
    vk = jg16.VerifyingKey(
        alpha_g1=jbn.G1_GEN, beta_g2=jbn.G2_GEN, gamma_g2=jbn.G2_GEN,
        delta_g2=jbn.G2_GEN, k_gamma_g1=[jbn.G1_GEN] * 2, num_public=2)
    for root in proved.values():
        jaf.save_vk(os.path.join(root, PREFIX + "3_2.vk"), vk)
    cex_json = _cex_json(witness)
    jcex, tcex = jv._cex_from_json(cex_json), tv._cex_from_json(cex_json)
    jprefix = os.path.join(proved["jax"], PREFIX)
    tprefix = os.path.join(proved["port"], PREFIX)
    for verdict in (True, False):
        monkeypatch.setattr(jg16, "verify", lambda *a, v=verdict: v)
        monkeypatch.setattr(tg16, "verify", lambda *a, v=verdict: v)
        cases = [("ok" if verdict else "batch 0: groth16 verify failed",
                  trows)]
        if verdict:
            cases += _tampered(trows)
        for error, rows in cases:
            want = _verdict(jv.verify_batch_proofs, rows, jcex, jprefix,
                            TIERS, 1)
            assert want == (error if error == "ok"
                            else "VerificationError: " + error)
            assert _verdict(tv.verify_batch_proofs, rows, tcex, tprefix,
                            TIERS, 1) == want
    # the final CEX state must match the published one
    monkeypatch.setattr(jg16, "verify", lambda *a: True)
    monkeypatch.setattr(tg16, "verify", lambda *a: True)
    cex_json[0]["TotalEquity"] += 1
    want = _verdict(jv.verify_batch_proofs, trows,
                    jv._cex_from_json(cex_json), jprefix, TIERS, 1)
    assert want == "VerificationError: final cex commitment mismatch"
    assert _verdict(tv.verify_batch_proofs, trows,
                    tv._cex_from_json(cex_json), tprefix, TIERS, 1) == want
    # the pool: spawned workers run the real pairing check (no patch
    # reaches them), which the stubbed proofs fail
    assert _verdict(tv.verify_batch_proofs, trows, tcex, tprefix, TIERS,
                    2) == "VerificationError: batch 0: groth16 verify failed"


def _cex_json(witness):
    """The final CEX state, as dbtool publishes it."""
    from zkpos_tpu_torch.services.dbtool import DbTool
    return DbTool(witness["cfg"], device="cpu").query_cex_assets()


# --- dbtool ----------------------------------------------------------------------

def test_dbtool_matches_jax(witness, proved, tmp_path):
    from zkpos_tpu.services.config import ServiceConfig as JCfg
    from zkpos_tpu.services.dbtool import DbTool as JDb
    from zkpos_tpu_torch.services.config import ServiceConfig as TCfg
    from zkpos_tpu_torch.services.dbtool import DbTool as TDb
    root = str(tmp_path)
    _copy_db(proved["port"], root)
    jt, tt = JDb(_cfg(JCfg, root)), TDb(_cfg(TCfg, root), device="cpu")
    counts = tt.check_prover_status()
    assert counts == jt.check_prover_status() == {
        "published": 0, "received": 0, "finished": witness["n_wit"]}
    assert tt.query_cex_assets() == jt.query_cex_assets()
    for h in range(witness["n_wit"]):
        tw, jw = tt.query_witness_data(h), jt.query_witness_data(h)
        assert tw.batch_commitment == jw.batch_commitment
        assert (tw.min_account_index, tw.max_account_index) == \
            (jw.min_account_index, jw.max_account_index)
    for i in range(witness["n_proofs"]):
        assert tt.query_account_data(i) == jt.query_account_data(i)
    outs = []
    for tool, name in ((jt, "j.csv"), (tt, "t.csv")):
        assert tool.export_proof_csv(os.path.join(root, name)) == \
            witness["n_wit"]
        with open(os.path.join(root, name), "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    assert tt.push_task_to_redis() == jt.push_task_to_redis() \
        == witness["n_wit"]
    assert [tt.queue.rpop() for _ in range(witness["n_wit"])] == \
        [jt.queue.rpop() for _ in range(witness["n_wit"])]
    tt.delete_all()
    assert tt.queue.llen() == 0
    assert tt.db.query("SELECT name FROM sqlite_master WHERE type='table' "
                       "AND name IN ('witness', 'userproof', 'proof')") == []
