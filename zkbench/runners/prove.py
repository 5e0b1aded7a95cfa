"""One prover proving back to back: the batch prove of the port's main
path (zkpos_tpu_torch.groth16.groth16.prove) on batches of the
BatchCreateUser circuit.

Set-up: the compiled circuit (loaded from the checkout's cache, compiled
into it on a miss), `batches` consecutive batches of seeded accounts made
into witnesses by the program's witness core, a proving key made on the
card by the program's setup from toxic waste drawn from the seed, the
native solve of each batch, then `warmup` proves.  The window proves the
batches in turn, each with r and s drawn from the seed, so that nothing
keyed on one witness or one draw serves the next prove.  Then the program's
state is freed and every proof of the window is held against the closed
form (reference/prove_check.py).
"""

from __future__ import annotations

import gc
import glob
import hashlib
import json
import os
import random
import time
from typing import Dict, List

import numpy as np
import torch

from .. import counts, gen
from ..reference.host import R
from ..reference.prove_check import ProveReference, hz_of

# what a circuit's compiled form depends on: the circuit, its gadgets and
# hash, the constants and types it is built from, and the file format
CIRCUIT_SOURCES = ("circuit/*.py", "crypto/*.py", "utils/constants.py",
                   "utils/commitments.py", "utils/types.py",
                   "groth16/artifact.py")
STATEMENT_KEYS = ("asset_counts", "tier_count", "tree_depth", "asset_tier",
                  "batch_ops", "range_bits")
STAGES = ("compute_h", "plan_z", "msm_a", "msm_b1", "msm_b2", "msm_k",
          "msm_z", "assemble")


def circuit_key(config: dict, package_dir: str) -> str:
    h = hashlib.sha256(json.dumps({k: config[k] for k in STATEMENT_KEYS},
                                  sort_keys=True).encode())
    for pattern in CIRCUIT_SOURCES:
        for path in sorted(glob.glob(os.path.join(package_dir, pattern))):
            h.update(os.path.relpath(path, package_dir).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:20]


def g2_pair(pt):
    """A G2 point as ((x0, x1), (y0, y1)), from the program's Fp2 objects."""
    if pt is None or isinstance(pt[0], tuple):
        return pt
    return ((pt[0].c0, pt[0].c1), (pt[1].c0, pt[1].c1))


class Cell:
    """The prove cell.  `cache_dir`: where the compiled circuit is kept."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 cache_dir: str, traced: bool = False):
        self.config, self.traffic = config, traffic
        self.seed, self.dev = seed, torch.device(device)
        self.cache_dir = cache_dir
        self.traced = traced
        self.on_card = self.dev.type == "cuda"
        self.rs = random.Random(gen.sub_seed(seed, "rs"))
        self.proofs: List[tuple] = []
        self.stage_log: List[tuple] = []
        from zkpos_tpu_torch.groth16 import groth16 as g16
        self.g16 = g16
        self.prove_fn = g16.prove

    # -- set-up -------------------------------------------------------------

    def configure(self):
        from zkpos_tpu_torch.utils import constants as C
        cfg = self.config
        C.configure(asset_counts=cfg["asset_counts"],
                    tier_count=cfg["tier_count"], tree_depth=cfg["tree_depth"])
        os.environ["ZKPOR_TEST_TIERS"] = (f"{cfg['asset_tier']}:"
                                          f"{cfg['batch_ops']}")

    def statement(self):
        """The compiled circuit, as the prover loads it (the program's r1cs
        artifact with its solver program)."""
        from zkpos_tpu_torch.circuit import solver_native as sn
        from zkpos_tpu_torch.groth16 import artifact
        from zkpos_tpu_torch.services.keygen import compile_tier
        import zkpos_tpu_torch
        cfg = self.config
        pkg = os.path.dirname(os.path.abspath(zkpos_tpu_torch.__file__))
        path = os.path.join(self.cache_dir,
                            f"circuit-{circuit_key(cfg, pkg)}.r1cs")
        if not os.path.exists(path):
            cs = compile_tier(cfg["asset_tier"], cfg["batch_ops"],
                              range_bits=cfg["range_bits"])
            prog = sn.program_to_dict(sn.record_program(cs))
            os.makedirs(self.cache_dir, exist_ok=True)
            tmp = path + ".part"
            artifact.save_r1cs(tmp, {
                "num_vars": cs.num_vars, "num_public": cs.num_public,
                "num_constraints": len(cs.constraints),
                "range_bits": cs.range_bits, "commitment": cs.commitment,
                "constraints": cs.constraints, "solver_program": prog})
            os.replace(tmp, path)
            del cs, prog
            gc.collect()
        return sn.CompiledSystem(artifact.load_r1cs(path))

    def batch_inputs(self) -> List[list]:
        """The circuit's input wires for each batch of seeded accounts."""
        from zkpos_tpu_torch.circuit import batch_create_user as bcu
        from zkpos_tpu_torch.utils.commitments import (
            calculate_asset_value_for_collateral, calculate_precomputed_value,
            padding_tier_ratios)
        from zkpos_tpu_torch.utils.types import (AccountAsset, AccountInfo,
                                                 CexAssetInfo, TierRatio)
        from zkpos_tpu_torch.witness import core as wcore
        cfg, n = self.config, self.traffic["batches"]
        tier, batch = cfg["asset_tier"], cfg["batch_ops"]
        cex = gen.cex_assets(cfg["asset_counts"], TierRatio, CexAssetInfo,
                             calculate_precomputed_value, padding_tier_ratios)
        accounts = gen.tier_accounts(
            random.Random(gen.sub_seed(self.seed, "accounts")), n * batch,
            cfg["asset_counts"], tier, cex, AccountAsset, AccountInfo,
            calculate_asset_value_for_collateral)
        by_tier, capacity = wcore.prepare_accounts({tier: accounts},
                                                   {tier: batch})
        tree = wcore.build_account_tree(by_tier, capacity, device=self.dev)
        wits = list(wcore.generate_batch_witnesses(tree, by_tier, cex,
                                                   {tier: batch}))
        if len(wits) != n:
            raise RuntimeError(f"{len(wits)} batch witnesses, {n} wanted")
        out = []
        for _, wit in wits:
            wcore.densify_ops_assets(wit)
            out.append(bcu.input_vector(
                bcu.set_batch_create_user_circuit_witness(wit)))
        return out

    def setup(self) -> Dict[str, float]:
        from zkpos_tpu_torch.circuit import solver_native as sn
        parts = {}
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            if self.on_card:
                torch.cuda.synchronize(self.dev)
            now = time.perf_counter()
            parts[name] = now - t
            t = now

        self.configure()
        self.cs = self.statement()
        lap("circuit_s")
        inputs = self.batch_inputs()
        lap("witness_s")
        draws = random.Random(gen.sub_seed(self.seed, "key"))
        waste = [draws.randrange(1, R) for _ in range(6)]
        self.toxic = dict(zip(("alpha", "beta", "gamma", "delta", "tau"),
                              waste))
        self.pk, _ = self.g16.setup(self.cs, rng=iter(waste).__next__,
                                    device=self.dev)
        lap("key_s")
        key = {"bases": self.pk.ck_bases, "sigma_bases": self.pk.ck_sigma_bases}
        self.solved = [sn.solve(self.cs, inp, key) for inp in inputs]
        lap("solve_s")
        warm = random.Random(gen.sub_seed(self.seed, "warmup"))
        for i in range(self.traffic["warmup"]):
            self.prove_fn(self.solved[i % len(self.solved)], self.pk,
                          rng=lambda: warm.randrange(R))
        lap("warmup_s")
        self.sizes = {"constraints": len(self.cs.constraints),
                      "wires": self.cs.num_vars,
                      "domain": self.pk.domain_size}
        return parts

    # -- the window -----------------------------------------------------------

    def step(self) -> None:
        i = len(self.proofs) % len(self.solved)
        r, s = self.rs.randrange(R), self.rs.randrange(R)
        draws = iter((r, s))
        spans = {} if self.traced else None
        t = time.perf_counter()
        proof = self.prove_fn(self.solved[i], self.pk, rng=draws.__next__,
                              spans=spans)
        if self.on_card:
            torch.cuda.synchronize(self.dev)
        self.proofs.append((i, r, s, proof))
        self.stage_log.append((t, time.perf_counter(), spans))

    def stage_peak(self) -> int:
        """The largest device peak of a traced prove's stages."""
        return max((v for sp in self.spans()
                    for v in (sp.get("peak_bytes") or {}).values()),
                   default=0)

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"prove_s": window_s / len(self.proofs)}

    def spans(self) -> List[Dict[str, float]]:
        return [sp for _, _, sp in self.stage_log if sp]

    def host_label(self, t: float) -> str:
        """The prove stage the host was in at time t (perf_counter)."""
        for start, end, sp in self.stage_log:
            if start <= t <= end:
                at = start
                for name in STAGES:
                    at += (sp or {}).get(name, 0.0)
                    if t <= at:
                        return name
                return "prove"
        return "between proves"

    def work(self) -> Dict[str, dict]:
        """The segment sums' work of the proves in the window: the witness
        MSMs' digits counted from each batch's witness, the H MSM's
        expected for uniform scalars."""
        npub = self.cs.num_public
        per_batch = []
        for z in self.z:
            g1 = counts.bucket_adds(z, counts.WINDOW_BITS["g1"])
            g1k = counts.bucket_adds(z[npub:], counts.WINDOW_BITS["g1"])
            g2 = counts.bucket_adds(z, counts.WINDOW_BITS["g2"])
            per_batch.append([("g1", g1), ("g1", g1), ("g1", g1k),
                              ("g2", g2)])
        h = counts.uniform_bucket_adds(self.sizes["domain"] - 1,
                                       counts.WINDOW_BITS["g1"])
        parts = []
        for i, _, _, _ in self.proofs:
            parts += per_batch[i] + [("g1", h)]
        return {"seg_sums": counts.seg_sums_work(parts)}

    # -- after the window ------------------------------------------------------

    def release(self) -> None:
        """Keep what the check reads (the statement, the witnesses, the
        proofs), free the rest of the program's state."""
        self.z = [s.values_u64 for s in self.solved]
        self.meta = (self.cs.constraints, self.cs.num_vars,
                     self.cs.num_public, self.cs.commitment)
        del self.pk, self.solved
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def reference(self) -> ProveReference:
        return ProveReference(*self.meta, self.toxic, self.dev)

    def check(self) -> Dict[str, object]:
        ref = self.reference()
        evs = [ref.evaluate(z) for z in self.z]
        wrong = failed = 0
        for i, r, s, proof in self.proofs:
            want = ref.points(*ref.scalars(evs[i], r, s))
            got = (proof.ar, g2_pair(proof.bs), proof.krs)
            bad = sum(g != w for g, w in zip(got, want))
            wrong += bad
            failed += bad > 0
        return {"numbers": [("proof_points_wrong", wrong, 0)],
                "attempted": len(self.proofs), "failed": failed,
                "notes": {"proofs_checked": len(self.proofs),
                          **self.sizes}}


def truncated(z_u64: np.ndarray, bits: int) -> np.ndarray:
    """Each scalar below 2^bits: its higher bits cleared."""
    out = np.array(z_u64, dtype=np.uint64, copy=True)
    for word in range(4):
        lo = 64 * word
        if lo >= bits:
            out[:, word] = 0
        elif lo + 64 > bits:
            out[:, word] &= np.uint64((1 << (bits - lo)) - 1)
    return out


def control(cell: Cell, mode: str):
    """Put the reference in the program's place, one guarantee broken:
    mode "top_window" proves with every witness scalar of the four witness
    MSMs cut to its low 240 bits (the top 16-bit window dropped), H as the
    reference's.  Returns what undoes it."""
    if mode != "top_window":
        raise ValueError(f"no control {mode!r} for the prove cell")
    from zkpos_tpu_torch.crypto import bn254 as bn
    from zkpos_tpu_torch.groth16.groth16 import Proof
    state = {}

    def prove_fn(solved, pk, rng, spans=None):
        if "ref" not in state:
            state["ref"] = ProveReference(
                solved.constraints, solved.num_vars, solved.num_public,
                solved.commitment, cell.toxic, cell.dev)
        ref = state["ref"]
        key = id(solved)
        if key not in state:
            z = solved.values_u64
            state[key] = (ref.evaluate(truncated(z, 240)), ref.evaluate(z))
        cut, full = state[key]
        r, s = rng(), rng()
        a, b, c = ref.points(*ref.scalars(cut, r, s, hz=hz_of(full)))
        return Proof(ar=a, bs=(bn.Fp2(*b[0]), bn.Fp2(*b[1])), krs=c)

    kept, cell.prove_fn = cell.prove_fn, prove_fn

    def undo():
        cell.prove_fn = kept
    return undo
