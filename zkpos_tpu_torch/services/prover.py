"""prover service — parity with reference src/prover/prover/prover.go;
counterpart of zkpos_tpu/services/prover.py.

Loop: BRPOP height from the task queue (:74) -> transactional
Published->Received claim (witness_model.go:129-152) -> decode witness ->
SetBatchCreateUserCircuitWitness -> lazily load per-tier pk/vk/r1cs
(LoadSnarkParamsOnce, :285-367; the pk's bases land on the device) ->
native solve (its commitment MSMs on the device) + Groth16 prove on the
device -> immediate self-verify (:276) -> idempotency check -> insert
proof row, mark Finished.  `--rerun` sweeps Received then Published rows
directly from the DB (crash recovery, :107-137).

The solve replays the artifact's recorded solver program; the eager
Python solve runs only for an artifact that carries none.  A failure of
the native solve or of its device MSMs propagates.
"""

from __future__ import annotations

import base64
import json
import time
from typing import Dict

import torch

from ..circuit import batch_create_user as bcu
from ..circuit import solver_native as sn
from ..circuit.cs import ConstraintSystem
from ..db.codec import decode_batch_witness
from ..db.redis_backend import queue_from_config
from ..db.storage import (DbErrNotFound, ProofModel, ProofRow, open_database,
                          STATUS_FINISHED, STATUS_PUBLISHED, STATUS_RECEIVED,
                          WitnessModel)
from ..groth16 import groth16 as g16
from ..groth16.serialize import proof_to_base64
from ..utils import constants as C
from ..utils.device import resolve
from .keygen import key_file_names, load_artifact


class Prover:
    def __init__(self, cfg, tiers=None, device=None):
        self.cfg = cfg
        self.tiers = tiers or C.get_tiers()
        self.device = resolve(device)
        self.db = open_database(cfg.db_path)
        self.witness_model = WitnessModel(self.db, cfg.db_suffix)
        self.proof_model = ProofModel(self.db, cfg.db_suffix)
        self.proof_model.create_table()
        self.queue = queue_from_config(cfg, self.db)
        self._params: Dict[int, tuple] = {}   # assets -> (r1cs, pk, vk)
        self._compiled: Dict[int, object] = {}   # assets -> CompiledSystem
        self._commit_keys: Dict[int, dict] = {}  # device-base cache rides here
        # seconds: the parameter load of each tier, and per batch the solve,
        # the prove and the self-verify
        self.load_seconds: Dict[int, float] = {}
        self.batch_seconds: Dict[int, dict] = {}

    # -- snark params ---------------------------------------------------------

    def load_snark_params_once(self, assets: int):
        """prover.go:285-367: load pk/vk/r1cs for a tier, with tier switch."""
        if assets in self._params:
            return self._params[assets]
        batch = self.tiers[assets]
        pk_f, vk_f, r1cs_f = key_file_names(self.cfg.zk_key_name, assets,
                                            batch)
        t0 = time.time()
        r1cs = load_artifact(r1cs_f)
        pk = load_artifact(pk_f, self.device)
        vk = load_artifact(vk_f)
        self.load_seconds[assets] = time.time() - t0
        print(f"prover: loaded snark params for tier {assets}:{batch} "
              f"in {self.load_seconds[assets]:.1f}s")
        self._params[assets] = (r1cs, pk, vk)
        return self._params[assets]

    # -- proving --------------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generate_and_verify_proof(self, wit, batch_number: int):
        """prover.go:250-283."""
        circuit_w = bcu.set_batch_create_user_circuit_witness(wit)
        # tier = the PADDED per-user asset-list length of the circuit
        # witness (reference prover.go:258 uses
        # len(circuitWitness.CreateUserOps[0].Assets)), consistent with the
        # adapter's own padding, including the all-padding tail batch
        assets = len(circuit_w.create_user_ops[0].assets)
        if assets not in self.tiers:
            raise ValueError(f"no tier fits padded asset count {assets}")
        r1cs_meta, pk, vk = self.load_snark_params_once(assets)
        key = None
        if pk.commit_wires is not None:
            key = self._commit_keys.setdefault(assets, {
                "bases": pk.ck_bases, "sigma_bases": pk.ck_sigma_bases})
        secs = self.batch_seconds.setdefault(batch_number, {})
        t0 = time.time()
        if r1cs_meta.get("solver_program") is not None:
            compiled = self._compiled.get(assets)
            if compiled is None:
                compiled = sn.CompiledSystem(r1cs_meta)
                self._compiled[assets] = compiled
            cs = sn.solve(compiled, bcu.input_vector(circuit_w), key)
        else:
            cs = ConstraintSystem(solve=True,
                                  range_bits=r1cs_meta.get("range_bits", 8))
            bcu.define(cs, circuit_w)
            if key is not None:
                cs.set_commitment_key(key)
            cs.finalize()   # deferred gadget constraints, keyed commitment
            if len(cs.constraints) != r1cs_meta["num_constraints"]:
                raise ValueError(
                    "constraint count mismatch vs keygen artifact")
        self._sync()
        secs["solve_s"] = time.time() - t0
        t0 = time.time()
        proof = g16.prove(cs, pk)
        self._sync()
        secs["prove_s"] = time.time() - t0
        if hasattr(cs, "public_values"):
            public = cs.public_values()
        else:
            public = [cs.values[i] for i in range(1, cs.num_public)]
        t0 = time.time()
        if not g16.verify(proof, vk, public):
            raise ValueError("self-verify failed")
        secs["self_verify_s"] = time.time() - t0
        print(f"prover: batch {batch_number} solved in {secs['solve_s']:.1f}s,"
              f" proved in {secs['prove_s']:.1f}s, self-verified in "
              f"{secs['self_verify_s']:.1f}s")
        return proof, assets, public

    def handle_height(self, height: int,
                      from_status: int = STATUS_PUBLISHED) -> bool:
        row = self.witness_model.claim_witness_by_height(height, from_status)
        if row is None:
            return False
        wit = decode_batch_witness(row.witness_data)
        # idempotency (prover.go:210-225): only ErrNotFound means "no proof
        # yet, go prove"; any other DB error must propagate, not be
        # swallowed as if the proof were absent
        try:
            self.proof_model.get_proof_by_batch_number(height)
        except DbErrNotFound:
            pass
        else:
            self.witness_model.update_status(height, STATUS_FINISHED)
            return True
        proof, assets, public = self.generate_and_verify_proof(wit, height)
        self.proof_model.create_proof(ProofRow(
            proof_info=proof_to_base64(proof),
            cex_asset_list_commitments=json.dumps([
                base64.b64encode(wit.before_cex_assets_commitment).decode(),
                base64.b64encode(wit.after_cex_assets_commitment).decode()]),
            account_tree_roots=json.dumps([
                base64.b64encode(wit.account_tree_root).decode()]),
            batch_commitment=base64.b64encode(
                wit.batch_commitment).decode(),
            account_min_index=wit.min_account_index,
            account_max_index=wit.max_account_index,
            assets_count=assets,
            batch_number=height))
        self.witness_model.update_status(height, STATUS_FINISHED)
        return True

    def run(self, rerun: bool = False, queue_timeout: float = 10.0):
        """prover.go:139-248 (normal) / :107-137 (rerun)."""
        if rerun:
            for status in (STATUS_RECEIVED, STATUS_PUBLISHED):
                for height in self.witness_model.rows_by_status(status):
                    self.handle_height(height, from_status=status)
            return
        while True:
            v = self.queue.brpop(queue_timeout)
            if v is None:
                print("prover: queue empty, exit")
                return
            self.handle_height(int(v))


def main(argv=None):
    import argparse
    from .config import load_config
    ap = argparse.ArgumentParser("zkpos-prover")
    ap.add_argument("--config", default="config/config.json")
    ap.add_argument("--rerun", action="store_true")
    args = ap.parse_args(argv)
    Prover(load_config(args.config)).run(rerun=args.rerun)


if __name__ == "__main__":
    main()
