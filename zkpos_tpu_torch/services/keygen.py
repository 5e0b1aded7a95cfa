"""keygen service — parity with reference src/keygen/main.go; counterpart
of zkpos_tpu/services/keygen.py.

For each (assetTier, batchCount) tier: build the empty circuit, compile to
R1CS, run Groth16 setup on the device, record the native solver's
schedule, and persist `<prefix><assets>_<batch>.pk/.vk/.r1cs` artifacts
(main.go:27-66; groth16/artifact.py).
"""

from __future__ import annotations

import os
import time

import torch

from ..circuit import batch_create_user as bcu
from ..circuit import solver_native as sn
from ..circuit.cs import ConstraintSystem
from ..groth16 import artifact
from ..groth16 import groth16 as g16
from ..utils import constants as C
from ..utils.device import resolve


def key_file_names(prefix: str, assets: int, batch: int):
    base = f"{prefix}{assets}_{batch}"
    return base + ".pk", base + ".vk", base + ".r1cs"


def compile_tier(assets: int, batch: int,
                 range_bits: int = 8) -> ConstraintSystem:
    """frontend.Compile equivalent (keygen main.go:30).  range_bits sets
    the shared lookup range-check limb width (16 at production scale:
    fewer lookups per check; 8 for small test tiers: 256-entry table)."""
    shape = bcu.new_empty_assignment(assets, C.ASSET_COUNTS, batch)
    cs = ConstraintSystem(solve=False, range_bits=range_bits)
    bcu.define(cs, shape)
    cs.finalize()   # flush deferred gadget constraints (logUp tables) so the
    # compiled system matches what prove() solves
    return cs


def save_artifact(path: str, obj) -> None:
    """.vk = gnark-layout bytes, .pk / .r1cs = ZKPOSAR1 containers."""
    artifact.save(path, obj)


def load_artifact(path: str, device=None):
    """Any artifact; a proving key's bases land on `device`."""
    return artifact.load(path, device)


def run(prefix: str, tiers=None, force: bool = False, device=None,
        range_bits: int = 8, spans=None) -> dict:
    """Compile, set up and persist every tier.  Returns {assets: (pk, vk)}
    for the tiers it set up (the keys stay on the device).  With a `spans`
    dict, each tier's phase seconds and artifact bytes are recorded in
    spans[assets]."""
    dev = resolve(device)
    tiers = tiers or C.get_tiers()
    made = {}
    for assets in sorted(tiers):
        batch = tiers[assets]
        pk_f, vk_f, r1cs_f = key_file_names(prefix, assets, batch)
        if not force and all(os.path.exists(f) for f in (pk_f, vk_f, r1cs_f)):
            print(f"keygen: artifacts for tier {assets}:{batch} exist, skip")
            continue
        sp = {}
        t0 = time.time()

        def lap(name):
            nonlocal t0
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            sp[name] = time.time() - t0
            t0 = time.time()

        cs = compile_tier(assets, batch, range_bits)
        lap("compile_s")
        sp["constraints"] = len(cs.constraints)
        print(f"keygen: tier {assets}:{batch} compiled "
              f"{len(cs.constraints)} constraints in {sp['compile_s']:.1f}s")
        pk, vk = g16.setup(cs, device=dev)
        lap("setup_s")
        print(f"keygen: setup done in {sp['setup_s']:.1f}s")
        # the native solver's schedule goes into the artifact (what gnark's
        # .r1cs carries: constraints + hint/solve instructions), so the
        # prover replays batches without recompiling the circuit
        try:
            solver_program = sn.program_to_dict(sn.record_program(cs))
        except sn.UnsupportedCircuit as e:
            print(f"keygen: no native solver program ({e})")
            solver_program = None
        lap("record_program_s")
        save_artifact(r1cs_f, {"num_vars": cs.num_vars,
                               "num_public": cs.num_public,
                               "num_constraints": len(cs.constraints),
                               "range_bits": cs.range_bits,
                               "commitment": cs.commitment,
                               "constraints": cs.constraints,
                               "solver_program": solver_program})
        save_artifact(pk_f, pk)
        save_artifact(vk_f, vk)
        lap("write_s")
        sp["bytes"] = {os.path.basename(f): os.path.getsize(f)
                       for f in (pk_f, vk_f, r1cs_f)}
        print(f"keygen: wrote {pk_f}, {vk_f}, {r1cs_f} "
              f"({sum(sp['bytes'].values())} bytes) in {sp['write_s']:.1f}s")
        if spans is not None:
            spans[assets] = sp
        made[assets] = (pk, vk)
    return made


def main(argv=None):
    import argparse
    from .config import load_config
    ap = argparse.ArgumentParser("zkpos-keygen")
    ap.add_argument("--config", default="config/config.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    run(cfg.zk_key_name, force=args.force)


if __name__ == "__main__":
    main()
