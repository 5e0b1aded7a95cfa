"""Top-level entry points of the port; counterpart of the JAX package's
__graft_entry__.py.

  entry()              -> (fn, args): the account tree's node hash
                          (ops/poseidon_sparse.hash2_mont_sparse, the
                          witness service's hot kernel) over 1,024 seeded
                          pairs on the card;
  dryrun_multichip(n)  -> one sharded pipeline step on n ranks
                          (parallel/mesh.py): the tree's root over 32
                          leaves a rank and the double-and-add MSM over 16
                          G1 points a rank (training_step), the
                          sorted-stream MSM over 4 G1 and 4 G2 points a
                          rank at c = 4 with scalars below 2^8, and the
                          point fold; every result held against the host
                          oracles;
  sharded_step(mesh, build) -> that step on one rank over the shards that
                          build gives (chip_smoke.py's mesh path runs it
                          at the prove's sizes).

  python -m zkpos_tpu_torch.graft --ranks N [--backend nccl|gloo]
                                  [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .crypto import bn254 as bn
from .crypto.poseidon_ref import poseidon
from .ops import ec, field as F, msm_device as md
from .ops.poseidon_sparse import hash2_mont_sparse
from .parallel import mesh as pm
from .utils.device import resolve

ENTRY_BATCH = 1024
LEAVES = 32         # leaves a rank
MSM_POINTS = 4      # sorted-stream MSM bases a rank
MSM_C = 4           # its window width
MSM_WINDOWS = 2     # the window rows its scalars (below 2^8) fill
DBL_POINTS = 16     # double-and-add points a rank


def _fr_rows(rng, n, device):
    vals = [int.from_bytes(rng.bytes(32), "little") % bn.R for _ in range(n)]
    return F.ints_to_tensor(vals, device)


def entry(device=None):
    """(fn, args): fn(a, b) hashes 1,024 pairs of seeded Montgomery rows,
    on the card unless the caller asks for the CPU."""
    dev = resolve(device)
    rng = np.random.default_rng(0)
    a = _fr_rows(rng, ENTRY_BATCH, dev)
    b = _fr_rows(rng, ENTRY_BATCH, dev)
    return hash2_mont_sparse, (a, b)


def dryrun_inputs(world: int) -> dict:
    """The dryrun's host inputs for `world` ranks, each rank's a contiguous
    range: standard-form leaves, the stream MSMs' affine G1 / G2 bases and
    scalars (below 2^8), the double-and-add's G1 points and scalars."""
    rng = np.random.default_rng(1)
    n_msm, n_dbl = MSM_POINTS * world, DBL_POINTS * world
    return {
        "leaves": [int.from_bytes(rng.bytes(32), "little") % bn.R
                   for _ in range(LEAVES * world)],
        "g1": [bn.g1_mul(bn.G1_GEN, 7 * i + 3) for i in range(n_msm)],
        "g2": [bn.g2_mul(bn.G2_GEN, 7 * i + 3) for i in range(n_msm)],
        "msm_scalars": [(37 * i + 11) % 255 + 1 for i in range(n_msm)],
        "dbl": [bn.g1_mul(bn.G1_GEN, 5 * i + 2) for i in range(n_dbl)],
        "dbl_scalars": [(29 * i + 5) % 256 for i in range(n_dbl)],
    }


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_step(mesh: pm.Mesh, build, *args) -> dict:
    """One rank of a sharded pipeline step (parallel/mesh.run_ranks starts
    it; `build` must be a module-level function).  build(mesh, *args) gives
    this rank's shards: "leaves", (L, 8) Montgomery rows; "pts", (N, 3, 8)
    projective G1 points, with "scalars" for the double-and-add (the point
    fold sums the same points); "stream", {curve: keyword arguments of
    mesh.sharded_stream_msm}.  Then training_step, the stream MSMs and the
    point fold, with the launch counts set to 0 just before and read just
    after.  Returns the replicated results as host values ("results": the
    root as an int, the sums as affine points), the launches, each step's
    seconds, the build's seconds, the shard length, the device and its
    peak memory."""
    dev = mesh.device
    t0 = time.perf_counter()
    inp = build(mesh, *args)
    _sync(dev)
    prep_s = time.perf_counter() - t0
    F.LAUNCHES.clear()
    seconds, out = {}, {}

    def step(name, fn):
        t = time.perf_counter()
        out[name] = fn()
        _sync(dev)
        seconds[name] = time.perf_counter() - t

    step("training_step", lambda: pm.training_step(
        mesh, inp["leaves"], inp["pts"], inp["scalars"]))
    for cv, kw in inp["stream"].items():
        step(f"stream_msm_{cv}",
             lambda: pm.sharded_stream_msm(mesh, cv, **kw))
    step("point_fold", lambda: pm.sharded_point_fold(mesh, inp["pts"]))
    launches = dict(F.LAUNCHES)
    root, acc = out.pop("training_step")
    res = {k: ec.to_affine(v)[0] for k, v in out.items()}
    res.update(root=F.tensor_to_ints(F.from_mont(root))[0],
               dbl_msm=ec.to_affine(acc)[0])
    return {"results": res, "launches": launches, "seconds": seconds,
            "prep_s": prep_s, "shard": inp["leaves"].shape[0],
            "device": str(dev),
            "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None)}


def _dryrun_shards(mesh: pm.Mesh) -> dict:
    """This rank's range of dryrun_inputs, for sharded_step; the stream
    MSMs' plans keep the two window rows the scalars fill."""
    dev, r = mesh.device, mesh.rank
    inp = dryrun_inputs(mesh.world)
    part = lambda key, k: inp[key][r * k:(r + 1) * k]
    return {
        "leaves": F.to_mont(F.ints_to_tensor(part("leaves", LEAVES), dev)),
        "pts": ec.from_affine(part("dbl", DBL_POINTS), "g1", dev),
        "scalars": part("dbl_scalars", DBL_POINTS),
        "stream": {cv: {"base_shard": md.device_base(
                            cv, part(cv, MSM_POINTS), dev),
                        "plan": md.ScalarPlan(
                            part("msm_scalars", MSM_POINTS), c=MSM_C,
                            device=dev, windows=MSM_WINDOWS)}
                   for cv in ("g1", "g2")},
    }


def _oracle_sum(add, mul, pts, scalars):
    acc = None
    for p, s in zip(pts, scalars):
        if s:
            acc = add(acc, mul(p, s))
    return acc


def dryrun_oracle(world: int) -> dict:
    """What every rank of the dryrun must return, from the host oracles:
    the root by host Poseidon level by level and the sums by bn254."""
    inp = dryrun_inputs(world)
    level = inp["leaves"]
    while len(level) > 1:
        level = [poseidon([level[i], level[i + 1]])
                 for i in range(0, len(level), 2)]
    g1 = (bn.g1_add, bn.g1_mul)
    return {
        "root": level[0],
        "dbl_msm": _oracle_sum(*g1, inp["dbl"], inp["dbl_scalars"]),
        "stream_msm_g1": _oracle_sum(*g1, inp["g1"], inp["msm_scalars"]),
        "stream_msm_g2": _oracle_sum(bn.g2_add, bn.g2_mul, inp["g2"],
                                     inp["msm_scalars"]),
        "point_fold": _oracle_sum(*g1, inp["dbl"], [1] * len(inp["dbl"])),
    }


def pick_backend(n: int, device=None) -> str:
    """nccl when each of the n ranks has a card of its own, else gloo."""
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def dryrun_multichip(n: int, backend=None, device=None,
                     store_dir=None) -> list:
    """One sharded pipeline step on n ranks, each result checked against
    the host oracles on every rank (a mismatch raises).  Returns the ranks'
    results.  The ranks run on the card unless device='cpu'."""
    t0 = time.time()
    if device is None:
        resolve(None)              # raises without a card
    backend = backend or pick_backend(n, device)
    print(f"dryrun: {n} ranks over {backend} on "
          f"{device or 'the card'}", flush=True)
    results = pm.run_ranks(sharded_step, n, backend, device,
                           args=(_dryrun_shards,), store_dir=store_dir)
    want = dryrun_oracle(n)
    for r, res in enumerate(results):
        bad = [k for k, v in want.items() if res["results"][k] != v]
        if bad:
            raise RuntimeError(f"dryrun rank {r}: {', '.join(bad)} differ "
                               "from the host oracle")
    print(f"dryrun_multichip({n}): ok in {time.time() - t0:.1f} s; root, "
          "double-and-add MSM, stream MSMs (G1, G2) and point fold equal "
          "the host oracle on every rank; rank 0's steps (s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      results[0]["seconds"].items()), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("python -m zkpos_tpu_torch.graft")
    ap.add_argument("--ranks", type=int, default=None,
                    help="world size (default: the number of cards)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="run on the CPU (the plain versions)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print(f"entry: {tuple(out.shape)} on {out.device}", flush=True)
    n = args.ranks or max(torch.cuda.device_count(), 1)
    dryrun_multichip(n, args.backend, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
