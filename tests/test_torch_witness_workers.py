"""The witness service's worker pools in the port
(zkpos_tpu_torch/services/witness.py) against the JAX package's
(zkpos_tpu/services/witness.py), at test_witness_service's small sizes
(asset universe 4, tier 4:8, depth 12; eight seeded accounts).

* ZKPOS_USERPROOF_WORKERS=0 (and 1) takes the serial userproof path;
* a pool that cannot start (``_pool`` raising OSError or ValueError) takes
  the serial path in run_witness and in run_userproof;
* every path writes the rows of the pooled run, in its order, and the
  pooled run those of the JAX package's service on the same accounts (its
  device Poseidon taken by the package's host Poseidon, see ``pooled``);
* an error inside a running pool still raises.

The userproof segments are cut to 3 accounts, so that eight accounts make
three segments and the pooled path runs.
"""

import concurrent.futures as cf
import os
import sqlite3

import pytest
import torch

import chip_smoke
from zkpos_tpu.crypto.bn254 import R
from zkpos_tpu.crypto.poseidon_ref import poseidon
from zkpos_tpu.ops import fr as jfr
from zkpos_tpu.utils import commitments as jcm
from zkpos_tpu.utils import constants as JC
from zkpos_tpu.utils import types as jtypes
from zkpos_tpu_torch.services import witness as tw
from zkpos_tpu_torch.services.config import ServiceConfig
from zkpos_tpu_torch.utils import commitments as cm
from zkpos_tpu_torch.utils import constants as TC
from zkpos_tpu_torch.utils import types as T

torch.set_num_threads(1)
N_ACCOUNTS = 8


@pytest.fixture(scope="module", autouse=True)
def sizes():
    saved = [(C, C.ASSET_COUNTS, C.TIER_COUNT, C.ACCOUNT_TREE_DEPTH)
             for C in (JC, TC)]
    env = os.environ.get("ZKPOR_TEST_TIERS")
    for C in (JC, TC):
        C.configure(asset_counts=4, tier_count=12, tree_depth=12)
    os.environ["ZKPOR_TEST_TIERS"] = "4:8"
    yield
    for C, *vals in saved:
        C.configure(*vals)
    if env is None:
        os.environ.pop("ZKPOR_TEST_TIERS", None)
    else:
        os.environ["ZKPOR_TEST_TIERS"] = env


def _inputs(C, types, comm):
    cex = chip_smoke.make_cex_assets(
        C, types.TierRatio, types.CexAssetInfo,
        comm.calculate_precomputed_value, comm.padding_tier_ratios)
    accounts = chip_smoke.make_accounts(
        C, cex, N_ACCOUNTS, 3, types.AccountAsset, types.AccountInfo,
        comm.calculate_asset_value_for_collateral)
    return {4: accounts}, cex


def _rows(db_path):
    """Every row of both tables, in the order written."""
    con = sqlite3.connect(db_path)
    try:
        return {t: con.execute(f"SELECT * FROM {t} ORDER BY rowid").fetchall()
                for t in ("witness", "userproof")}
    finally:
        con.close()


@pytest.fixture(scope="module")
def prepared():
    """The port's service state after prepare (accounts, capacity, tree
    and CEX table), built once: each run copies it onto a fresh service."""
    svc = tw.WitnessService(ServiceConfig(db_path=":memory:"), device="cpu")
    svc.prepare(*_inputs(TC, T, cm))
    return svc.accounts, svc.capacity, svc.tree, svc.cex_assets


def _service(prepared, tmp_path, name):
    from zkpos_tpu_torch.witness import core as wcore
    db = str(tmp_path / f"{name}.db")
    svc = tw.WitnessService(ServiceConfig(db_path=db), device="cpu")
    svc.accounts, svc.capacity, svc.tree, cex = prepared
    svc.cex_assets = wcore._copy_cex(cex)
    return svc, db


def _port_run(prepared, tmp_path, name, resume=False):
    """run_witness and run_userproof (and, with resume, both again:
    nothing more to write); returns the rows."""
    svc, db = _service(prepared, tmp_path, name)
    assert svc.run_witness() == 1
    assert svc.run_userproof() == N_ACCOUNTS
    if resume:
        assert svc.run_witness() == 0
        assert svc.run_userproof() == 0
    return _rows(db)


def _host_hash_batch(inputs):
    """zkpos_tpu.ops.poseidon.hash_batch on the JAX package's host
    Poseidon: one digest a column of the (n, B) rows."""
    return [poseidon([row[j] for row in inputs])
            for j in range(len(inputs[0]))]


def _host_build(tree, leaves):
    """zkpos_tpu.merkle.tree.AccountTree.build_from_leaf_ints with every
    node hashed by the host Poseidon: the populated levels pair by pair (an
    odd level padded with its nil hash), then the fold with the nil
    siblings up to the full depth, stored as the tree stores them
    (Montgomery limbs)."""
    levels = [[v % R for v in leaves]]
    while len(levels[-1]) > 1:
        cur = levels[-1]
        if len(cur) % 2:
            cur = cur + [tree.nils[len(levels) - 1]]
        levels.append([poseidon(cur[i:i + 2]) for i in range(0, len(cur), 2)])
    for k in range(len(levels) - 1, tree.depth):
        levels.append([poseidon([levels[-1][0], tree.nils[k]])])
    tree.levels = [jfr.ints_to_limbs([v * jfr.R_MONT % R for v in lv])
                   for lv in levels]


@pytest.fixture(scope="module")
def pooled(prepared, tmp_path_factory):
    """The port's rows with real process pools in both phases (2
    serialize workers, 2 segment workers), and the JAX package's service's
    rows on the same accounts.  The JAX service runs with its device
    Poseidon (hash_batch, the tree's level hash) in the package's host
    Poseidon, where the XLA CPU path takes minutes to compile and run, and
    its process pool refused, so that it takes its own serial fallback."""
    tmp = tmp_path_factory.mktemp("pooled")
    asked = []
    real = tw._pool
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZKPOS_USERPROOF_WORKERS", "2")
        mp.setattr(os, "cpu_count", lambda: 3)
        mp.setattr(tw, "SEGMENT", 3)
        mp.setattr(tw, "_pool", lambda w: asked.append(w) or real(w))
        got = _port_run(prepared, tmp, "pooled", resume=True)
    from zkpos_tpu.merkle import tree as jtree
    from zkpos_tpu.ops import poseidon as jpos
    from zkpos_tpu.services.witness import WitnessService as JService

    def refuse(*a, **k):
        raise OSError("no processes")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpos, "hash_batch", _host_hash_batch)
        mp.setattr(jtree.AccountTree, "build_from_leaf_ints", _host_build)
        mp.setattr(cf, "ProcessPoolExecutor", refuse)
        db = str(tmp / "jax.db")
        ref = JService(ServiceConfig(db_path=db))
        ref.prepare(*_inputs(JC, jtypes, jcm))
        assert ref.run_witness() == 1
        assert ref.run_userproof() == N_ACCOUNTS
        assert ref.run_witness() == 0
    return got, asked, _rows(db)


@pytest.fixture
def pools(monkeypatch):
    """_pool as a thread pool that records the worker counts it is asked
    for; segments of 3 accounts, 3 CPUs."""
    asked = []

    def pool(workers):
        asked.append(workers)
        return cf.ThreadPoolExecutor(workers)
    monkeypatch.setattr(tw, "_pool", pool)
    monkeypatch.setattr(tw, "SEGMENT", 3)
    monkeypatch.setattr(os, "cpu_count", lambda: 3)
    return asked


def test_pooled_rows_match_jax(pooled):
    """Both phases in real process pools write the JAX package's rows, in
    its order: one witness row, eight userproof rows by account index."""
    got, asked, want = pooled
    assert asked == [2, 2]
    assert len(want["witness"]) == 1
    assert [r[0] for r in want["userproof"]] == list(range(N_ACCOUNTS))
    assert got == want


@pytest.mark.parametrize("workers", ["0", "1"])
def test_userproof_workers_env_serial(prepared, pooled, pools, tmp_path,
                                      monkeypatch, workers):
    """ZKPOS_USERPROOF_WORKERS at 0 or 1: no segment pool (only
    run_witness's is asked for), the rows of the pooled run."""
    monkeypatch.setenv("ZKPOS_USERPROOF_WORKERS", workers)
    assert _port_run(prepared, tmp_path, "serial") == pooled[0]
    assert pools == [2]


@pytest.mark.parametrize("exc", [OSError, ValueError])
def test_pool_that_cannot_start_runs_serial(prepared, pooled, pools,
                                            tmp_path, monkeypatch, exc):
    """_pool raising in both phases: the serial path writes the rows of
    the pooled run."""
    monkeypatch.setenv("ZKPOS_USERPROOF_WORKERS", "2")
    tried = []

    def cannot(workers):
        tried.append(workers)
        raise exc("cannot start")
    monkeypatch.setattr(tw, "_pool", cannot)
    assert _port_run(prepared, tmp_path, "fallback") == pooled[0]
    assert tried == [2, 2]


def test_error_inside_running_pool_raises(prepared, pools, tmp_path,
                                          monkeypatch):
    """A pool that starts but whose work fails: the error reaches the
    caller in both phases; nothing falls back."""
    monkeypatch.setenv("ZKPOS_USERPROOF_WORKERS", "2")
    svc, _ = _service(prepared, tmp_path, "broken")

    def broken(*a):
        raise RuntimeError("worker failed")
    monkeypatch.setattr(tw, "encode_batch_witness", broken)
    with pytest.raises(RuntimeError, match="worker failed"):
        svc.run_witness()
    monkeypatch.setattr(tw, "_userproof_rows_segment", broken)
    with pytest.raises(RuntimeError, match="worker failed"):
        svc.run_userproof()
    assert pools == [2, 2]
