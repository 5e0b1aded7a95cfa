#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (zkpos_tpu_torch) on one H100.

  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. build both native libraries from the checkout (nvcc for csrc/*.cu,
     g++ for the host runtime) and print ptxas registers / spills;
  2. print the card's name and power limit (nvidia-smi);
  3. small MSMs at c = 16 (G1) and c = 12 (G2), and an all-zero scalar
     vector, against the host oracle;
  4. the prove path at full size: compile_tier(50, 16) at universe 100 and
     depth 28 (1,316,341 constraints, domain 2^21), setup, the witness
     pipeline (leaves, tree and CEX commitments on the Poseidon kernels),
     the native solve with the device commitment MSM, two proves and the
     verification of both on the host pairing, with the launch count of
     every kernel of the path (each must be above 0) and of each phase (a
     prove must make no one-point add launch and one Horner launch a
     MSM);
  5. every kernel of the prove path held against its plain PyTorch version
     on the card at the largest shape the path launched it with: the Fr/Fp
     kernels and one NTT over the 2^21 domain, the QAP row evaluation of
     the path's A, B and C matrices at its witness (and of three CSRs that
     stress it: A's rows of 8,192 terms or more alone, one row of 2^20
     terms, 2^21 rows with no term), G1/G2 adds over as many pairs as
     setup adds (identity, equal and negated pairs included, also on
     representatives with a coordinate's limbs at p - 1 or 1), the Horner
     kernels on prove #2's five window-sum sets (against plain_horner and
     the host oracle; then the one-point add loop the MSM ran before
     against one launch, by canonical value, in turns), and the
     segmented scan and segment sums over the path's own MSM streams (the
     30.8 M-point G1 witness stream in full; the 33.6 M-point G1 H stream
     and the 42.3 M-point G2 stream on head-aligned slices), and over
     streams of one segment and of all heads (2^22 G2, 2^24 G1 points);
     each kernel timed with CUDA events beside its plain version and its
     bound (the work its inputs need);
  6. the pipeline path: the service entry points at the prove path's size
     (universe 100, tier 50:16, depth 28), as an operator runs them: a
     seeded CEX table and user files from the sample_data CLI (each user
     holds 30 tokens; the ingest must count the invalid rows exactly), the
     witness service, keygen.run to artifacts (the keys read back equal to
     keygen's on the card), dbtool's queue push, Prover.run until the queue
     is empty (native solve, prove, self-verify a batch) and a rerun that
     writes nothing, dbtool's status and proof export, and the verifier CLI
     in subprocesses: on the proof CSV and sampled user proofs (exit 0),
     and on a changed proof byte, a missing row and a changed user total
     (exit non-zero);
  7. the tree path: a depth-28 account tree over 2^27 random leaves made
     on the card, built level by level with the sparse Poseidon kernel,
     its whole first level held against the plain-schedule kernel, 64
     nodes of every level against the host Poseidon of their children,
     and 16 inclusion proofs (and a changed leaf that must fail);
  8. the mesh path (zkpos_tpu_torch/parallel/mesh.py): graft.entry()'s
     node hash once against its plain version, then ranks started by
     torch.multiprocessing.spawn, at one rank over nccl and at two and
     four ranks that share the card over gloo, each rank on its contiguous
     range (graft.sharded_step over mesh_shards): the sharded root of
     the tree path's 2^27 leaves against the tree's level-27 node, the
     stream MSMs over 1,924,679 bases (G1 at c = 16, G2 at c = 12), the
     double-and-add MSM and the point fold over 2^20 G1 points, each
     against the single-process msm_device.msm_point on the same inputs
     by affine value; the ranks report their launch counts and each
     step's seconds;
  9. the witness-service path at the reference's production constants
     (500 assets, 12 tiers, depth 28, tiers 500:200 and 50:1380) over
     SERVICE_ACCOUNTS seeded accounts: prepare, run_witness,
     run_userproof on sqlite, a second run that writes nothing, and 256
     sampled userproof rows verified against the root and the host leaf
     hash;
 10. every Poseidon kernel held against its plain version, bit for bit,
     on a slice of the inputs of its largest launch on paths 4, 6, 7 and 9,
     and timed on the whole of them: the tree's kernel, the one-thread
     sparse permutation at each width the paths ran (against the plain
     schedule; with its ptxas figures, and the warp-a-chain kernel on the
     largest leaf-commitment input beside the per-block chain), and the
     chain kernel on the service path's batched launch (every chain
     against the per-block kernel) and on one chain, with the products on
     a chain's critical path;
 11. the probes path (zkpos_tpu_torch/probes, the counterparts of the TPU
     probes in scripts/): instruction rates, the digit convolutions
     (beside one conv1d call a round, their library yardstick; the
     grouped form's persistent kernel also at a column count that makes
     each of its threads refill every stage of its ring and leaves its
     last slab ragged), the
     Montgomery product's stages, the sparse Poseidon(2) ablations over
     the tree path's first level in the tree kernel's layout (their base
     beside that kernel), the seg-scan stages (the single pass's byte
     floor and structure; seg_scan's own body cut into its lanes' passes,
     those with its aggregates and look-backs, and the whole; the
     three-pass yardstick) over streams of the prove path's sizes and mean
     segment lengths (measured in phase 5),
     and the weights-first product on the FP32 pipes and the TF32 tensor
     cores beside torch.matmul; one JSON line per probe, every variant
     held against its plain version (exactly, or within its stated
     tolerance for the float probes).
Launches are counted per path: every count is set to 0 just before a path
and read just after it (on the probes path, around each probe's timed
launches; its checks run after the reading).  The last two lines are the
kernel JSON line and the status line.
"""

import csv
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet / Hopper whitepaper): HBM3 at 3.35 TB/s;
# 32-bit integer multiply-adds at 64 per SM per clock, half of the 128
# FP32 lanes behind the 67 TFLOP/s float32 figure: 132 x 64 x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 132 * 64 * 1.98e9
# 32-bit multiplies of one 8-limb CIOS Montgomery product: 8 x (8 wide
# a*b products + 1 for m + 8 wide m*p products), a wide product = lo + hi
MULS_PER_MONT = 8 * (16 + 1 + 16)
# G1: 12 (its two 3b = 9 are doublings); G2: 3 x (12 + two 3b)
MONTS_PER_ADD = {3: 12, 6: 42}
# the doubling (Algorithm 9, 6M + 2S): G1 8 (its 3b = 9 by doublings); G2
# 3 x (8 + one 3b)
MONTS_PER_DBL = {3: 8, 6: 27}
# accounts of the witness-service path (2^16; not below 2^14)
SERVICE_ACCOUNTS = 1 << 16

REPLACES = {
    "g1_add": "zkpos_tpu/ops/ec_pallas.py:150",
    "g2_add": "zkpos_tpu/ops/ec_pallas.py:243",
    "g1_horner": "zkpos_tpu/ops/ec_pallas.py:150 (_padd_kernel, looped by "
                 "zkpos_tpu/ops/msm_device.py:407 _horner_windows)",
    "g2_horner": "zkpos_tpu/ops/ec_pallas.py:243 (_padd2_kernel, looped by "
                 "zkpos_tpu/ops/msm_device.py:407 _horner_windows)",
    "seg_scan_g1": "zkpos_tpu/ops/ec_pallas.py:268",
    "seg_scan_g2": "zkpos_tpu/ops/ec_pallas.py:268",
    "seg_sums_g1": "zkpos_tpu/ops/ec_pallas.py:268",
    "seg_sums_g2": "zkpos_tpu/ops/ec_pallas.py:268",
    "ff_mul": "zkpos_tpu/ops/fd32.py:300 (XLA, no Pallas kernel)",
    "ff_add": "zkpos_tpu/ops/fd32.py:300 (XLA, no Pallas kernel)",
    "ff_sub": "zkpos_tpu/ops/fd32.py:300 (XLA, no Pallas kernel)",
    "ff_pow": "zkpos_tpu/groth16/groth16.py:111 (host batch_inverse)",
    "ntt_stage": "zkpos_tpu/groth16/ntt_device.py:122 (XLA, no Pallas "
                 "kernel)",
    "csr_eval": "zkpos_tpu/groth16/qap_device.py:107 (XLA, no Pallas "
                "kernel)",
    "poseidon_sparse3": "zkpos_tpu/ops/poseidon_f32_pallas.py:273",
    "poseidon_plain_t3": "zkpos_tpu/ops/poseidon_pallas.py:99",
    "poseidon_sparse_t": "zkpos_tpu/ops/poseidon.py:70 (XLA permute, no "
                         "Pallas kernel)",
    "poseidon_chain": "zkpos_tpu/ops/poseidon.py:117 (XLA lax.scan of "
                      "hash_chain_mont, no Pallas kernel)",
}
SOURCES = {
    "g1_add": "zkpos_tpu_torch/csrc/ec_add.cu",
    "g2_add": "zkpos_tpu_torch/csrc/ec_add.cu",
    "g1_horner": "zkpos_tpu_torch/csrc/ec_add.cu",
    "g2_horner": "zkpos_tpu_torch/csrc/ec_add.cu",
    "seg_scan_g1": "zkpos_tpu_torch/csrc/seg_scan.cu",
    "seg_scan_g2": "zkpos_tpu_torch/csrc/seg_scan_g2.cu",
    "seg_sums_g1": "zkpos_tpu_torch/csrc/seg_scan.cu",
    "seg_sums_g2": "zkpos_tpu_torch/csrc/seg_scan_g2.cu",
}
POSEIDON_SOURCE = "zkpos_tpu_torch/csrc/poseidon.cu"
# the kernels each path must launch
PR1_KERNELS = ("g1_add", "g2_add", "g1_horner", "g2_horner", "seg_scan_g1",
               "seg_scan_g2",
               "seg_sums_g1", "seg_sums_g2", "ff_mul", "ff_add", "ff_sub",
               "ff_pow", "ntt_stage", "csr_eval")
PATH_KERNELS = {
    "prove": PR1_KERNELS + ("poseidon_sparse3", "poseidon_sparse_t6",
                            "poseidon_sparse_t17", "poseidon_chain"),
    "tree": ("poseidon_sparse3", "poseidon_plain_t3", "ff_mul"),
    "service": ("poseidon_sparse3", "poseidon_sparse_t6",
                "poseidon_sparse_t17", "poseidon_chain", "ff_mul"),
    # witness service, keygen's setup and the artifacts' normalisation, the
    # prover's solves and proves: the prove path's kernels
    "pipeline": PR1_KERNELS + ("poseidon_sparse3", "poseidon_sparse_t6",
                               "poseidon_sparse_t17", "poseidon_chain"),
    # the sharded root, point fold, double-and-add and stream MSMs
    "mesh": ("poseidon_sparse3", "seg_sums_g1", "seg_sums_g2", "g1_add",
             "g1_horner", "g2_horner"),
}
# the probes path's kernels (PATH_KERNELS["probes"], one per probe variant)
# are filled in by main from the probes package; the path's time budget
PROBES_PATH_LIMIT_S = 120


def replaces(name):
    """REPLACES, with the sparse permutation at every width (the leaves,
    the commitments' blocks and their narrower tails) under the XLA
    permute."""
    if name.startswith("poseidon_sparse_t"):
        return REPLACES["poseidon_sparse_t"]
    return REPLACES[name]


def source(name):
    if name.startswith("poseidon_"):
        return POSEIDON_SOURCE
    return SOURCES.get(name, "zkpos_tpu_torch/csrc/fr_kernels.cu")


def need(launches, path):
    missing = [k for k in PATH_KERNELS[path] if launches.get(k, 0) == 0]
    if missing:
        fail(f"kernels not launched on the {path} path: "
             + ", ".join(missing))


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# --- helpers on the card -----------------------------------------------------

def cuda_ms(fn, reps=3, warm=True):
    """Mean ms of reps calls of fn by CUDA events, after one call unless
    warm is False (a kernel that already ran on a slice of the input)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def rand_fe(n, field, gen):
    """n random reduced elements (top limb below the modulus's top limb)."""
    import torch
    x = torch.randint(0, 1 << 32, (n, 8), generator=gen, dtype=torch.int64)
    x[:, 7] %= 0x30644E72
    x = torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)
    return x.cuda()


def negate(pts):
    from zkpos_tpu_torch.ops import field as F
    out = pts.clone()
    na = pts.shape[1]
    ys = [1] if na == 3 else [2, 3]
    for y in ys:
        zero = F.const(0, F.FP, pts.device, mont=False)
        out[:, y] = F.plain_sub(zero, pts[:, y].contiguous(), F.FP)
    return out


def rescale(pts, rows, side):
    """pts[rows] as other projective representatives of the same points:
    each scaled by the element that makes one coordinate's limbs (its c0 in
    G2) p - 1 or 1 in turn, x, y and z in turn from `side` (y where the
    coordinate is 0, as at the identity)."""
    from zkpos_tpu_torch.ops import field as F
    rows = list(rows)
    na = pts.shape[1]
    per = na // 3                      # Fp rows a coordinate
    vals = F.tensor_to_ints(pts[rows].reshape(-1, 8))
    out = []
    for j in range(len(rows)):
        v = vals[na * j:na * (j + 1)]
        k = (j + side) % 3
        if v[k * per] == 0:
            k = 1
        target = F.FP_MOD - 1 if j % 2 == 0 else 1
        lam = target * pow(v[k * per], -1, F.FP_MOD) % F.FP_MOD
        out += [x * lam % F.FP_MOD for x in v]
    pts[rows] = F.ints_to_tensor(out, pts.device).reshape(len(rows), na, 8)


def sass_of(obj, pattern):
    """Base opcodes (IMAD.WIDE kept whole) of the kernel in csrc object
    `obj` whose mangled name contains `pattern`, from cuobjdump -sass of
    this run's build; None without cuobjdump."""
    import re
    import shutil
    from zkpos_tpu_torch.utils import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", os.path.join(
        build.cuda_objects_dir(), obj)], capture_output=True, text=True,
        check=True).stdout
    ops, cur = Counter(), False
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = pattern in m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if cur and m:
            op = m.group(1)
            ops["IMAD.WIDE" if op.startswith("IMAD.WIDE")
                else op.split(".")[0]] += 1
    return dict(ops)


def ptxas_of(pattern):
    """Registers, stack and spill bytes of the kernel whose mangled name
    contains `pattern` (ptxas -v of this run's build)."""
    from zkpos_tpu_torch.probes.common import kernel_resources
    return next(iter(kernel_resources(pattern).values()), None)


def max_abs_err(a, b):
    if isinstance(a, list):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


# --- phases ------------------------------------------------------------------

def phase_build():
    from zkpos_tpu_torch.utils import build
    t0 = time.time()
    build.cuda_lib()
    build.host_lib()
    log(f"build: {time.time() - t0:.1f} s")
    for line in build.PTXAS_LOG.splitlines():
        if ("Compiling entry" in line or "Used" in line or "spill" in line
                or line.startswith("==")):
            log("  " + line.strip())


def phase_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi unavailable"
    log(line)
    return line


def phase_msm_oracle():
    """Small MSMs at the main path's window widths (c = 16 in G1, c = 12 in
    G2) and an all-zero scalar vector against the host oracle: a quick
    failure before the main path if the engine is wrong."""
    from zkpos_tpu_torch.crypto import bn254 as bn
    from zkpos_tpu_torch.ops import msm_device as md
    rpy = random.Random(1)
    for curve, c, m in (("g1", 16, 512), ("g2", 12, 256)):
        g, mul, add = ((bn.G1_GEN, bn.g1_mul, bn.g1_add) if curve == "g1"
                       else (bn.G2_GEN, bn.g2_mul, bn.g2_add))
        hp = [mul(g, rpy.randrange(1, bn.R)) for _ in range(8)]
        pts = [hp[i % 8] for i in range(m)]
        sc = [rpy.choice([0, 1, 2, rpy.randrange(bn.R)]) for _ in range(m)]
        ref = None
        for p_, s in zip(pts, sc):
            ref = add(ref, mul(p_, s))
        got = md.msm(curve, md.device_base(curve, pts, "cuda"),
                     plan=md.ScalarPlan(sc, c=c, device="cuda"))
        log(f"check msm {curve} c={c} n={m}: {got == ref}")
        if got != ref:
            fail(f"msm {curve} c={c} disagrees with the host oracle")
    if md.msm("g1", md.device_base("g1", [bn.G1_GEN] * 8, "cuda"),
              scalars=[0] * 8) is not None:
        fail("msm of zero scalars is not the identity")


# --- the main path -----------------------------------------------------------

E8 = 10 ** 8


def make_cex_assets(C, TierRatio, CexAssetInfo, calc_pre, pad_tiers):
    out = []
    for i in range(C.ASSET_COUNTS):
        tiers = [TierRatio(boundary_value=10_000 * 10 ** 16, ratio=90),
                 TierRatio(boundary_value=50_000 * 10 ** 16, ratio=70)]
        calc_pre(tiers)
        out.append(CexAssetInfo(
            symbol=f"tok{i}", index=i, base_price=(i + 1) * E8,
            loan_ratios=pad_tiers(list(tiers)),
            margin_ratios=pad_tiers(list(tiers)),
            portfolio_margin_ratios=pad_tiers(list(tiers))))
    return out


def make_accounts(C, cex, n_users, n_assets, AccountAsset, AccountInfo,
                  collateral):
    accounts = []
    for u in range(n_users):
        assets = []
        te = td = tc = 0
        for k in range(n_assets):
            idx = (u + k * 3) % C.ASSET_COUNTS
            eq = (10 + u + k) * E8
            de = (1 + (u + k) % 3) * E8
            lo = ma = pm = (1 + k % 2) * E8
            assets.append(AccountAsset(index=idx, equity=eq, debt=de,
                                       loan=lo, margin=ma,
                                       portfolio_margin=pm))
            price = cex[idx].base_price
            te += eq * price
            td += de * price
            tc += collateral(lo, ma, pm, cex[idx])
        assets.sort(key=lambda a: a.index)
        accounts.append(AccountInfo(account_id=b"", total_equity=te,
                                    total_debt=td, total_collateral=tc,
                                    assets=assets))
    return accounts


def phase_main(universe=100, tier=50, batch=16, tier_count=None, depth=None,
               range_bits=16, device="cuda"):
    """compile_tier -> setup -> witness -> solve -> prove x 2 -> verify at
    the given sizes (the defaults are the repo's prove size, with the
    constants' own tier table and tree depth); phase seconds, peak device
    memory and the launch count of every kernel over the run.  Returns
    (cs, pk, scs, launches, sizes)."""
    import torch
    from zkpos_tpu_torch.utils import constants as C
    C.configure(asset_counts=universe, tier_count=tier_count,
                tree_depth=depth)
    os.environ["ZKPOR_TEST_TIERS"] = f"{tier}:{batch}"
    from zkpos_tpu_torch.utils.types import (AccountAsset, AccountInfo,
                                             CexAssetInfo, TierRatio)
    from zkpos_tpu_torch.utils.commitments import (
        calculate_asset_value_for_collateral, calculate_precomputed_value,
        padding_tier_ratios)
    from zkpos_tpu_torch.witness import core as wcore
    from zkpos_tpu_torch.circuit import batch_create_user as bcu
    from zkpos_tpu_torch.circuit import solver_native as sn
    from zkpos_tpu_torch.groth16 import groth16 as g16
    from zkpos_tpu_torch.services.keygen import compile_tier
    from zkpos_tpu_torch.ops import ec, field as F

    phases = {}

    on_card = torch.device(device).type == "cuda"

    seen = Counter()

    def phase(name, t0):
        if on_card:
            torch.cuda.synchronize()
        phases[name] = round(time.time() - t0, 3)
        # the phase's own launches (setup's fixed-base batches, the solve's
        # commitment MSMs, each prove's): the split PERF.md reports
        own = {k: v - seen[k] for k, v in F.LAUNCHES.items() if v - seen[k]}
        seen.update(own)
        log(json.dumps({"phase": name, "seconds": phases[name],
                        "launches": own}))
        return time.time()

    F.LAUNCHES.clear()
    F.SIZES.clear()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t = time.time()
    cs = compile_tier(tier, batch, range_bits=range_bits)
    t = phase("compile", t)
    log(json.dumps({"constraints": len(cs.constraints),
                    "vars": cs.num_vars,
                    "tree_depth": C.ACCOUNT_TREE_DEPTH}))
    rs = random.Random(2024)
    pk, vk = g16.setup(cs, rng=lambda: rs.randrange(1, F.FR_MOD),
                       device=device)
    log(json.dumps({"domain": pk.domain_size}))
    t = phase("setup", t)
    cex = make_cex_assets(C, TierRatio, CexAssetInfo,
                          calculate_precomputed_value, padding_tier_ratios)
    accounts = make_accounts(C, cex, batch, min(tier, 30), AccountAsset,
                             AccountInfo, calculate_asset_value_for_collateral)
    by_tier, capacity = wcore.prepare_accounts({tier: accounts})
    tree = wcore.build_account_tree(by_tier, capacity, device=device)
    wits = list(wcore.generate_batch_witnesses(tree, by_tier, cex))
    if len(wits) != 1:
        fail(f"expected one batch witness, got {len(wits)}")
    _, wit = wits[0]
    wcore.densify_ops_assets(wit)
    w = bcu.set_batch_create_user_circuit_witness(wit)
    inputs = bcu.input_vector(w)
    t = phase("witness", t)
    key = {"bases": pk.ck_bases, "sigma_bases": pk.ck_sigma_bases}
    scs = sn.solve(cs, inputs, key)
    t = phase("solve", t)
    proofs = []
    spans = {}
    # the window sums and c of each MSM's Horner in prove #2 (its five
    # MSMs), for the Horner kernels' checks
    windows = []
    horner = ec.horner

    def keep_horner(rw, c):
        windows.append((rw.clone(), c))
        return horner(rw, c)
    for i in range(2):
        before = dict(F.LAUNCHES)
        if i == 1:
            ec.horner = keep_horner
        try:
            proofs.append(g16.prove(scs, pk,
                                    rng=lambda: rs.randrange(F.FR_MOD),
                                    spans=spans if i == 1 else None))
        finally:
            ec.horner = horner
        t = phase(f"prove_{i + 1}", t)
    per_prove = {k: v - before.get(k, 0) for k, v in F.LAUNCHES.items()
                 if v - before.get(k, 0)}
    log(json.dumps({"prove_2_spans_s": {k: round(v, 4)
                                        for k, v in spans.items()}}))
    log(json.dumps({"launches_per_prove": per_prove}))
    # a prove makes no one-point add launch: each MSM's Horner is one
    # launch, four in G1 and one in G2
    want = {"g1_add": 0, "g2_add": 0, "g1_horner": 4, "g2_horner": 1}
    got = {k: per_prove.get(k, 0) for k in want}
    if got != want:
        fail(f"launches per prove {got}, expected {want}")
    if on_card:
        proofs.append(prove_profiled(lambda: g16.prove(
            scs, pk, rng=lambda: rs.randrange(F.FR_MOD))))
        t = phase("prove_3_profiled", t)
    public = scs.public_values()
    for i, pf in enumerate(proofs):
        if not g16.verify(pf, vk, public):
            fail(f"proof {i + 1} does not verify")
    if g16.verify(proofs[0], vk, [(public[0] + 1) % F.FR_MOD] + public[1:]):
        fail("a proof verified against a wrong public input")
    t = phase("verify", t)
    launches = dict(F.LAUNCHES)
    sizes = dict(F.SIZES)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    log(json.dumps({"main_path": {"constraints": len(cs.constraints),
                                  "domain": pk.domain_size,
                                  "phases_s": phases,
                                  "peak_device_bytes": peak,
                                  "verified": True}}))
    log(json.dumps({"kernels": launches}))
    return cs, pk, scs, launches, sizes, windows


# the port's kernels in a profile, by a piece of their (demangled) names
PROFILE_NAMES = (("k_seg_sums_g1", "seg_sums_g1"),
                 ("k_seg_sums_g2", "seg_sums_g2"),
                 ("k_seg_scan_g1", "seg_scan_g1"),
                 ("k_seg_scan_g2", "seg_scan_g2"),
                 ("k_padd<ff::Fp1>", "g1_add"), ("k_padd<ff::Fp2>", "g2_add"),
                 ("k_horner<ff::Fp1>", "g1_horner"),
                 ("k_horner<ff::Fp2>", "g2_horner"),
                 ("k_ntt_stage", "ntt_stage"), ("k_csr_eval", "csr_eval"),
                 ("k_csr_fixup", "csr_eval"),
                 ("k_binary", "ff_mul / ff_add / ff_sub"), ("k_pow", "ff_pow"))


def prove_profiled(prove):
    """prove() under torch.profiler: the device time of each kernel in it
    (the port's by their launch names, PyTorch's by theirs), the device's
    busy time (the union of the kernels' intervals) and its idle share of
    the prove's wall time (profiler on).  Logs "not measured" when the
    profile holds no kernel.  Returns prove()'s result."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        out = prove()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    spans, ms, calls = [], Counter(), Counter()
    for ev in prof.events():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end      # microseconds
        name = next((n for k, n in PROFILE_NAMES if k in ev.name),
                    ev.name[:80])
        ms[name] += (b - a) / 1e3
        calls[name] += 1
        spans.append((a, b))
    if not spans:
        log(json.dumps({"prove_3_profile": "not measured: the profile "
                        "holds no device kernel"}))
        return out
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    log(json.dumps({"prove_3_profile": {
        "wall_ms": round(wall_ms, 3), "device_busy_ms": round(busy / 1e3, 3),
        "idle_share": round(1 - busy / 1e3 / wall_ms, 4),
        "kernels": [{"name": n, "calls": calls[n], "ms": round(v, 3)}
                    for n, v in ms.most_common(24)]}}))
    return out


# --- every kernel against its plain version at the main path's shapes ------

def timed(fn):
    """fn() once: its result and its CUDA-event milliseconds."""
    import torch
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def plain_scan_slices(pts, heads, out, slices, chunk, sums=None):
    """The plain scan over each [a, b) of `slices` (a must be a head: a
    scan restarted at a head does not depend on what came before), run in
    chunks of `chunk` elements with the running point carried from one
    chunk into the next, each chunk compared canonically with the same
    rows of the kernel's scan `out` and, at each segment end in the chunk,
    with that segment's row of the kernel's segment sums `sums` (when
    given).  Returns (max_abs_err, plain ms, elements scanned)."""
    import torch
    from zkpos_tpu_torch.ops import ec
    if sums is not None:
        first = heads.bool().clone()
        first[0] = True
        rank = torch.cumsum(first, 0) - 1        # each element's segment
        del first
        end = torch.ones_like(heads, dtype=torch.bool)
        end[:-1] = heads[1:].bool()
    err, ms, n = 0, 0.0, 0
    for a, b in slices:
        if not bool(heads[a]) and a != 0:
            fail(f"scan slice start {a} is not a head")
        carry = None
        for c0 in range(a, b, chunk):
            c1 = min(c0 + chunk, b)
            x, h = pts[c0:c1].clone(), heads[c0:c1].clone()
            if carry is not None and not bool(h[0]):
                x[0:1] = ec.plain_point_add(carry, x[0:1].contiguous())
            h[0] = True
            y, t = timed(lambda: ec.plain_seg_scan(x, h))
            ms += t
            carry = y[-1:].contiguous()
            err = max(err, max_abs_err(
                ec.canonical(out[c0:c1].contiguous()), ec.canonical(y)))
            if sums is not None:
                e = end[c0:c1].nonzero().flatten()
                if e.numel():
                    err = max(err, max_abs_err(
                        ec.canonical(sums[rank[c0 + e]].contiguous()),
                        ec.canonical(y[e].contiguous())))
            del x, h, y
        n += b - a
    return err, ms, n


def canonical_err(a, b, chunk=1 << 22):
    """max_abs_err of the canonical values (affine, ops/ec.canonical on the
    card's Fp kernels) of two point tensors, chunk by chunk."""
    from zkpos_tpu_torch.ops import ec
    return max((max_abs_err(ec.canonical(a[i:i + chunk].contiguous()),
                            ec.canonical(b[i:i + chunk].contiguous()))
                for i in range(0, a.shape[0], chunk)), default=0)


def scan_slices(heads, W, Np, span):
    """Head-aligned slices of a stream too long for the plain scan in
    full: its start, the middle window's start, its longest segment, and
    its tail from the first head at least `span` before the end."""
    import torch
    N = heads.shape[0]
    hidx = heads.nonzero().flatten()
    seg = torch.diff(torch.cat([hidx, hidx.new_tensor([N])]))
    i = int(seg.argmax())
    lo = int(hidx[i])
    tail = hidx[hidx >= N - span]
    t0 = int(tail[0]) if tail.numel() else int(hidx[-1])
    mid = (W // 2) * Np
    return [(0, min(span, N)), (mid, min(mid + span, N)),
            (lo, min(lo + int(seg[i]) + 4096, lo + 3 * span, N)), (t0, N)]


def make_row(name, err, ms, n, plain_ms, plain_n, byts, muls):
    """One kernel's entry of the kernels line (its launches are filled in
    from the paths' counts at the end); fails on any disagreement."""
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = muls / INT32_MUL_PER_S * 1e3
    log(f"kernel {name}: max_abs_err={err} ms={ms:.3f} (n={n}) "
        f"plain_ms={plain_ms:.3f} (n={plain_n}) bound_ms="
        f"{max(t_bytes, t_ops):.3f}")
    if err != 0:
        fail(f"{name} disagrees with its plain version")
    return {"name": name, "route": "cuda", "source": source(name),
            "replaces": replaces(name), "launches": 0,
            "max_abs_err": err, "ms": round(ms, 4), "n": n,
            "plain_ms": round(plain_ms, 4), "plain_n": plain_n,
            "bound_ms": round(max(t_bytes, t_ops), 4),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bytes_ms": round(t_bytes, 4),
            "ops_ms": round(t_ops, 4)}


def phase_kernels(cs, pk, scs, sizes, windows):
    """Each kernel on the card at the largest shape the main path launched
    it with (the main path's own streams and matrix where it has them),
    held against its plain version on the same inputs: exact agreement of
    canonical values, the kernel's CUDA-event time after a warm-up, the
    plain version's time, and the bound."""
    import torch
    from zkpos_tpu_torch.crypto import bn254 as bn
    from zkpos_tpu_torch.ops import ec, field as F, msm_device as md
    from zkpos_tpu_torch.groth16 import ntt_device as nd, qap_device as qd
    from zkpos_tpu_torch.probes.probe_segscan import point_pool
    gen = torch.Generator().manual_seed(3)
    rows = []

    def row(*args):
        rows.append(make_row(*args))

    # field kernels: both fields, with 0, 1 and p - 1 among the operands
    for name, fn, plain, muls in (("ff_mul", F.mul, F.plain_mul,
                                   MULS_PER_MONT),
                                  ("ff_add", F.add, F.plain_add, 0),
                                  ("ff_sub", F.sub, F.plain_sub, 0)):
        n = sizes[name]
        err = 0
        for field in (F.FP, F.FR):
            a, b = rand_fe(n, field, gen), rand_fe(n, field, gen)
            a[:3] = F.ints_to_tensor([0, 1, F.MODULI[field] - 1], "cuda")
            b[:3] = F.ints_to_tensor([F.MODULI[field] - 1, 1, 1], "cuda")
            k = fn(a, b, field)
            p, plain_ms = timed(lambda: plain(a, b, field))
            err = max(err, max_abs_err(k, p))
        ms = cuda_ms(lambda: fn(a, b), reps=10)
        row(name, err, ms, n, plain_ms, n, 3 * 32 * n, muls * n)
        del a, b, k, p
    n = sizes["ff_pow"]
    e = F.FR_MOD - 2
    x = rand_fe(n, F.FR, gen)
    x[:3] = F.ints_to_tensor([0, 1, F.FR_MOD - 1], "cuda")
    k = F.power(x, e)
    p, plain_ms = timed(lambda: F.plain_pow(x, e))
    ms = cuda_ms(lambda: F.power(x, e), reps=3)
    row("ff_pow", max_abs_err(k, p), ms, n, plain_ms, n, 2 * 32 * n,
        (255 + bin(e).count("1")) * MULS_PER_MONT * n)
    del x, k, p

    # one NTT over the domain: kernel stages against plain stages
    n = sizes["ntt_stage"]
    log_n = n.bit_length() - 1
    x = rand_fe(n, F.FR, gen)
    k = nd.ntt_mont(x)
    tw = nd._twiddles(log_n, False, "cuda")
    z0 = x.index_select(0, nd._bitrev(log_n, "cuda"))

    def plain_ntt():
        z = z0
        for s in range(log_n):
            z = F.plain_ntt_stage(z, tw, 1 << s, n >> (s + 1))
        return z
    p, plain_ms = timed(plain_ntt)
    z = z0.clone()
    ms = cuda_ms(lambda: [F.ntt_stage(z, tw, 1 << s, n >> (s + 1))
                          for s in range(log_n)], reps=3) / log_n
    row("ntt_stage", max_abs_err(k, p), ms, n, plain_ms / log_n, n,
        (2 * 32 + 32) * n // 2 + 32 * n, MULS_PER_MONT * n // 2)
    del x, k, p, z, z0

    # the QAP rows of the main path's three matrices at its own witness,
    # then three CSRs that stress the even split (phase_csr_adversarial)
    zt = md.scalars_tensor(scs.witness_vector(), "cuda")
    zm = F.to_mont(zt)
    d = pk.domain_size
    pool = qd.pool_mont(cs, zm.device)
    by_matrix, err = {}, 0
    for which, mat in enumerate("ABC"):
        rid, col, cid = qd._row_terms(cs, which, zm.device)
        T = col.shape[0]
        k = F.csr_eval(rid, col, cid, pool, zm, d)
        p, plain_ms = timed(lambda: F.plain_csr_eval(rid, col, cid, pool, zm,
                                                     d))
        e = max_abs_err(k, p)
        err = max(err, e)
        ms = cuda_ms(lambda: F.csr_eval(rid, col, cid, pool, zm, d), reps=5)
        lens = torch.bincount(rid.long(), minlength=d)
        by_matrix[mat] = {
            "terms": T, "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
            "max_abs_err": e, **csr_bound(col, cid, d),
            "median_row": int(lens[lens > 0].float().median()) if T else 0,
            "longest_row": int(lens.max()),
            "rows_ge_8192": int((lens >= 8192).sum()),
            "rows_ge_33": int((lens >= 33).sum())}
        log(f"  csr_eval {mat}: {json.dumps(by_matrix[mat])}")
        if mat == "A":
            a_args = (T, ms, plain_ms, csr_bytes(col, cid, d))
            long_rows = (lens >= 8192)[rid.long()]
            adv_a = (rid[long_rows].contiguous(), col[long_rows].contiguous(),
                     cid[long_rows].contiguous())
        del rid, col, cid, k, p, lens
    adversarial = phase_csr_adversarial(adv_a, pool, zm, d)
    T, ms, plain_ms, nbytes = a_args
    row("csr_eval", max([err] + [a["max_abs_err"]
                                 for a in adversarial.values()]),
        ms, T, plain_ms, T, nbytes, MULS_PER_MONT * T)
    rows[-1].update({"ptxas": ptxas_of("10k_csr_eval"),
                     "by_matrix": by_matrix, "adversarial": adversarial})
    del zm, adv_a

    # point adds: identity on each side, P + P and P + (-P) among the
    # pairs, and the same kinds again (rows 500-619) on representatives
    # scaled so that a coordinate's limbs are p - 1 or 1
    for curve, k_pool in (("g1", 32), ("g2", 16)):
        name = f"{curve}_add"
        n = sizes[name]
        pool_pts = point_pool(curve, k_pool, 3, "cuda")
        ia = torch.randint(0, pool_pts.shape[0], (n,), generator=gen).cuda()
        ib = torch.randint(0, pool_pts.shape[0], (n,), generator=gen).cuda()
        a, b = pool_pts[ia].contiguous(), pool_pts[ib].contiguous()
        na = a.shape[1]
        a[:100] = ec.identity(na, 100, "cuda")
        b[100:200] = ec.identity(na, 100, "cuda")
        a[200:300] = ec.identity(na, 100, "cuda")
        b[200:300] = ec.identity(na, 100, "cuda")
        b[300:400] = a[300:400]
        b[400:500] = negate(a[400:500])
        b[500:530] = a[500:530]
        b[530:560] = negate(a[530:560])
        a[560:590] = ec.identity(na, 30, "cuda")
        rescale(a, range(500, 620), 0)
        rescale(b, range(500, 620), 1)
        k = ec.point_add(a, b)
        p, plain_ms = timed(lambda: ec.plain_point_add(a, b))
        sel = [0, 150, 250, 350, 450, 505, 506, 535, 536, 565, 566, 600, 601,
               700, n - 1]
        got = ec.to_affine(k[sel].cpu())
        ha, hb = ec.to_affine(a[sel].cpu()), ec.to_affine(b[sel].cpu())
        add = bn.g1_add if curve == "g1" else bn.g2_add
        if got != [add(u, v) for u, v in zip(ha, hb)]:
            fail(f"{name} disagrees with the host oracle")
        ms = cuda_ms(lambda: ec.point_add(a, b), reps=5)
        row(name, max_abs_err(k, p), ms, n, plain_ms, n, 3 * na * 32 * n,
            MONTS_PER_ADD[na] * MULS_PER_MONT * n)
        rows[-1]["ptxas"] = ptxas_of(f"6k_paddIN2ff3Fp{na // 3}EE")
        # the add's instructions a thread (the function, its staging loops
        # once), and two floors they set for n adds: all of them at the
        # issue rate (4 warp instructions an SM a clock), the IMADs at the
        # IMAD rate (64 lanes an SM a clock)
        ops = sass_of("ec_add.cu.o", f"6k_paddIN2ff3Fp{na // 3}EE")
        if ops:
            total = sum(ops.values())
            imad = sum(v for k, v in ops.items() if k.startswith("IMAD"))
            rows[-1]["sass"] = {
                "instructions": total, "imad": imad,
                "top": dict(Counter(ops).most_common(8)),
                "issue_ms": round(total * n / (132 * 128 * 1.98e9) * 1e3, 4),
                "imad_ms": round(imad * n / INT32_MUL_PER_S * 1e3, 4)}
            log(f"  {name} SASS: {json.dumps(rows[-1]['sass'])}")
        del a, b, k, p, ia, ib
        torch.cuda.empty_cache()
    rows += phase_horner(windows)

    # segmented scans over the main path's own MSM streams: G1 over the
    # witness (A, c = 16; digit-0/1 segments of millions) in full, and over
    # H (Z, the longest G1 stream) on head-aligned slices; G2 over the
    # witness (B, c = 12, the longest stream) on head-aligned slices.  Both
    # outputs are checked against the same plain scan (seg_sums at the
    # segment ends) and timed on the A and B streams.  Bound: one complete
    # add for each element that is not a head; the scan reads and writes
    # every point, the sums read every point and write one a segment.
    bases = pk.dev_bases
    h = qd.compute_h_device(cs, zt, d)
    acc = {}
    means = {}
    for curve, base, plan, span, chunk, timed_here in (
            ("g1", bases["a"], md.ScalarPlan(zt, device="cuda"),
             None, 1 << 21, True),
            ("g1", bases["z"], md.ScalarPlan(h, device="cuda"),
             1 << 21, 1 << 21, False),
            ("g2", bases["b2"], md.ScalarPlan(zt, c=12, device="cuda"),
             1 << 20, 1 << 20, True)):
        pts, heads = md.sorted_stream(plan, base)
        W, Np = plan.W, plan.Np
        del plan
        N, na = pts.shape[0], pts.shape[1]
        k = ec.seg_scan(pts, heads)
        ks = ec.seg_sums(pts, heads)
        slices = ([(0, N)] if span is None
                  else scan_slices(heads, W, Np, span))
        err, plain_ms, plain_n = plain_scan_slices(pts, heads, k, slices,
                                                   chunk, ks)
        del k
        log(f"check seg_scan / seg_sums {curve} on a stream of {N} (W={W}): "
            f"slices {slices}, max_abs_err={err}")
        S = ks.shape[0]
        if timed_here:
            means[curve] = N / S
            pb = na * 32
            muls = (N - S) * MONTS_PER_ADD[na] * MULS_PER_MONT
            again = ec.seg_sums(pts, heads)
            rerun = canonical_err(again, ks)
            log(f"seg_sums_{curve} run twice: max_abs_err={rerun}")
            err = max(err, rerun)
            del again
        del ks
        for mode in ("scan", "sums"):
            name = f"seg_{mode}_{curve}"
            a = acc.setdefault(name, {"err": 0, "plain_ms": 0.0,
                                      "plain_n": 0})
            a["err"] = max(a["err"], err)
            a["plain_ms"] += plain_ms
            a["plain_n"] += plain_n
            if timed_here:
                fn = ec.seg_scan if mode == "scan" else ec.seg_sums
                a["ms"] = cuda_ms(lambda: fn(pts, heads), reps=3)
                a["n"] = N
                a["bytes"] = (2 * pb * N if mode == "scan"
                              else pb * N + pb * S) + N
                a["muls"] = muls
        del pts, heads
        torch.cuda.empty_cache()
    adversarial = phase_scan_adversarial()
    for name, a in acc.items():
        r = make_row(name, max(a["err"], adversarial[name]), a["ms"], a["n"],
                     a["plain_ms"], a["plain_n"], a["bytes"], a["muls"])
        kname = "k_" + name              # as mangled: length, then name
        r["ptxas"] = ptxas_of(f"{len(kname)}{kname}")
        r["adversarial_max_abs_err"] = adversarial[name]
        rows.append(r)
    log(json.dumps({"scan_segment_mean": means}))
    return rows, means


def csr_bytes(col, cid, nrows):
    """Bytes the row evaluation must move: a row id, a column and a
    coefficient id a term (4 bytes each), each coefficient and each
    element of x that the terms name, read once (32 bytes each: a gather
    that repeats one hits the caches at best), 32 bytes a row out."""
    import torch
    used = torch.unique(cid).numel() + torch.unique(col).numel()
    return 12 * col.shape[0] + 32 * used + 32 * nrows


def csr_bound(col, cid, nrows):
    """The row evaluation's bound on these terms, as make_row gives a
    kernel's: its bytes (csr_bytes) and its products, each at the card's
    rate."""
    t_bytes = csr_bytes(col, cid, nrows) / HBM_BYTES_PER_S * 1e3
    t_ops = MULS_PER_MONT * col.shape[0] / INT32_MUL_PER_S * 1e3
    return {"bound_ms": round(max(t_bytes, t_ops), 4),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": round(t_bytes, 4), "ops_ms": round(t_ops, 4)}


def phase_csr_adversarial(adv_a, pool, zm, d):
    """The row evaluation on three CSRs that stress the even split, each
    bit for bit against plain_csr_eval and timed: the A matrix's rows of
    8,192 terms or more alone (at their rows, the others empty), one row of
    2^20 terms (a row through 4,096 chunks), and d rows with no term.
    Returns {case: its figures}."""
    import torch
    from zkpos_tpu_torch.ops import field as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    n = 1 << 20
    one = (torch.full((n,), 5, dtype=torch.int32, device="cuda"),
           torch.randint(0, zm.shape[0], (n,), generator=gen, device="cuda",
                         dtype=torch.int32),
           torch.randint(0, pool.shape[0], (n,), generator=gen,
                         device="cuda", dtype=torch.int32))
    empty = tuple(torch.empty((0,), dtype=torch.int32, device="cuda")
                  for _ in range(3))
    out = {}
    for case, terms, nrows in (("a_rows_ge_8192", adv_a, d),
                               ("one_row_2p20", one, 7),
                               ("no_terms", empty, d)):
        k = F.csr_eval(*terms, pool, zm, nrows)
        p, plain_ms = timed(lambda: F.plain_csr_eval(*terms, pool, zm, nrows))
        T = terms[0].shape[0]
        out[case] = {
            "terms": T, "rows": nrows,
            "max_abs_err": max_abs_err(k, p),
            "ms": round(cuda_ms(lambda: F.csr_eval(*terms, pool, zm, nrows),
                                reps=5), 4),
            "plain_ms": round(plain_ms, 4),
            **csr_bound(terms[1], terms[2], nrows)}
        log(f"  csr_eval adversarial {case}: {json.dumps(out[case])}")
        if out[case]["max_abs_err"]:
            fail(f"csr_eval disagrees with its plain version on {case}")
        del k, p
    return out


def phase_horner(windows):
    """The Horner kernels on prove #2's own window sums (four G1 MSMs at
    c = 16, the G2 MSM at c = 12), each held bit for bit against
    plain_horner and by affine value against the host oracle
    sum_w 2^(c w) rw[w]; then the G2 window sums and one G1 set through the
    loop of one-point ec.point_add launches the MSM made before (written
    here: the package keeps no second path; its complete-add doublings give
    another projective representative, so it is held by canonical value,
    same_points) and through ec.horner, in turns, with the launches of
    each.  Bound: the function's
    products (a doubling by Algorithm 9, an add by the complete formula) at
    the data sheet's rate; beside it the schedule's critical path in
    product levels and the ms a level."""
    import torch
    from zkpos_tpu_torch.crypto import bn254 as bn
    from zkpos_tpu_torch.ops import ec, field as F
    acc = {}
    for rw, c in windows:
        na, W = rw.shape[1], rw.shape[0]
        name = "g1_horner" if na == 3 else "g2_horner"
        k = ec.horner(rw, c)
        p, plain_ms = timed(lambda: ec.plain_horner(rw, c))
        mul, add = ((bn.g1_mul, bn.g1_add) if na == 3
                    else (bn.g2_mul, bn.g2_add))
        want = None
        for w, pt in enumerate(ec.to_affine(rw.cpu())):
            if pt is not None:
                want = add(want, mul(pt, 1 << (c * w)))
        if ec.to_affine(k.cpu()) != [want]:
            fail(f"{name} disagrees with the host oracle")
        monts = (W - 1) * (c * MONTS_PER_DBL[na] + MONTS_PER_ADD[na])
        a = acc.setdefault(name, {"err": 0, "ms": [], "plain_ms": 0.0,
                                  "n": (W - 1) * (c + 1), "monts": monts,
                                  "depth": ec.horner_levels(W, c),
                                  "bytes": (W + 1) * na * 32})
        a["err"] = max(a["err"], max_abs_err(k, p))
        a["ms"].append(cuda_ms(lambda: ec.horner(rw, c), reps=3))
        a["plain_ms"] += plain_ms
    rows = []
    for name, a in sorted(acc.items()):
        na = 3 if name == "g1_horner" else 6
        ms = sum(a["ms"]) / len(a["ms"])
        rows.append(make_row(name, a["err"], ms, a["n"],
                             a["plain_ms"] / len(a["ms"]), a["n"],
                             a["bytes"], a["monts"] * MULS_PER_MONT))
        rows[-1]["ptxas"] = ptxas_of(f"8k_hornerIN2ff3Fp{na // 3}EE")
        rows[-1]["ms_each"] = [round(x, 4) for x in a["ms"]]
        rows[-1]["products"] = a["monts"]
        rows[-1]["critical_path_levels"] = a["depth"]
        rows[-1]["us_per_level"] = round(ms * 1e3 / a["depth"], 4)
        log(f"  {name}: {a['depth']} product levels on the critical path, "
            f"{rows[-1]['us_per_level']} us a level; ptxas "
            f"{json.dumps(rows[-1]['ptxas'])}")

    # the loop the MSM ran before, against one launch, in turns
    def loop(rw, c):
        acc_pt = rw[-1:]
        for w in range(rw.shape[0] - 2, -1, -1):
            for _ in range(c):
                acc_pt = ec.point_add(acc_pt, acc_pt)
            acc_pt = ec.point_add(acc_pt, rw[w:w + 1])
        return acc_pt
    g1 = next(x for x in windows if x[0].shape[1] == 3)
    g2 = next(x for x in windows if x[0].shape[1] == 6)
    apart = {}
    for curve, (rw, c) in (("g2", g2), ("g1", g1)):
        res = {"windows": rw.shape[0], "c": c, "old_loop_ms": [],
               "horner_ms": []}
        for form in ("old_loop", "horner", "horner", "old_loop"):
            fn = (lambda: loop(rw, c)) if form == "old_loop" else (
                lambda: ec.horner(rw, c))
            before = Counter(F.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            res[f"{form}_ms"].append(round((time.time() - t0) * 1e3, 3))
            res[f"{form}_launches"] = sum((Counter(F.LAUNCHES)
                                           - before).values())
            if not same_points(out, ec.horner(rw, c)):
                fail(f"{curve}: the one-point add loop and the Horner kernel "
                     "differ")
        apart[curve] = res
    log(json.dumps({"horner_old_loop_vs_one_launch": apart}))
    return rows


def phase_scan_adversarial():
    """The scans on the streams that stress the look-back: a 2^22-point G2
    and a 2^24-point G1 stream of one segment each (a chain through every
    tile; both outputs against the chunked plain scan and its sum), and the
    same streams with every element a head (both outputs equal to the
    input).  Returns {kernel name: max_abs_err}."""
    import torch
    from zkpos_tpu_torch.ops import ec
    from zkpos_tpu_torch.probes.probe_segscan import point_pool
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    errs = {}
    for curve, log_n in (("g2", 22), ("g1", 24)):
        n = 1 << log_n
        pool = point_pool(curve, 16, 17, "cuda")
        pts = pool[torch.randint(0, pool.shape[0], (n,), generator=gen,
                                 device="cuda")].contiguous()
        one = torch.zeros(n, dtype=torch.bool, device="cuda")
        (k, ks), ms = timed(lambda: (ec.seg_scan(pts, one),
                                     ec.seg_sums(pts, one)))
        err, plain_ms, _ = plain_scan_slices(pts, one, k, [(0, n)], 1 << 21,
                                             ks)
        del k, ks
        every = torch.ones(n, dtype=torch.bool, device="cuda")
        e_scan = canonical_err(ec.seg_scan(pts, every), pts)
        e_sums = canonical_err(ec.seg_sums(pts, every), pts)
        log(json.dumps({"scan_adversarial": {
            "curve": curve, "n": n, "one_segment_max_abs_err": err,
            "one_segment_ms_both": round(ms, 3),
            "plain_ms": round(plain_ms, 3),
            "all_heads_max_abs_err": {"scan": e_scan, "sums": e_sums}}}))
        errs[f"seg_scan_{curve}"] = max(err, e_scan)
        errs[f"seg_sums_{curve}"] = max(err, e_sums)
        del pts, one, every, pool
        torch.cuda.empty_cache()
    return errs


# --- the tree and witness-service paths, and the Poseidon kernels ------------

def poseidon_monts(t):
    """Montgomery products of one plain-schedule permutation of width t."""
    from zkpos_tpu_torch.crypto.poseidon_params import R_FULL, partial_rounds
    return R_FULL * (3 * t + t * t) + partial_rounds(t) * (3 + t * t)


def sparse_monts(t):
    """Montgomery products of one sparse-schedule permutation of width t:
    8 full rounds of t S-boxes and t^2 mix products, R_P lane-0 S-boxes,
    R_P - 1 sparse rows of 2t - 1 products and one dense t x t mix."""
    from zkpos_tpu_torch.crypto.poseidon_params import R_FULL, partial_rounds
    rp = partial_rounds(t)
    return R_FULL * (3 * t + t * t) + 3 * rp + (rp - 1) * (2 * t - 1) + t * t


def sparse_critical(t):
    """Montgomery products in a row on one lane of the chain kernel's warp
    permutation of width t: a full round's S-box and the lane's share of
    the mix, three a sparse partial round, and the last partial round's
    S-box and mix share."""
    from zkpos_tpu_torch.crypto.poseidon_params import R_FULL, partial_rounds
    share = (t * t + 31) // 32
    return R_FULL * (3 + share) + 3 * (partial_rounds(t) - 1) + 3 + share


def chain_widths(n):
    """The widths of the permutations of one chained hash of n inputs."""
    if n <= 16:
        return [n + 1]
    widths, pos = [17], 16
    while pos < n:
        k = min(15, n - pos)
        widths.append(k + 2)
        pos += k
    return widths


def chain_monts(n):
    """Montgomery products of one chained hash of n inputs on the sparse
    schedule (the schedule the chain kernel runs)."""
    return sum(sparse_monts(t) for t in chain_widths(n))


class LargestInputs:
    """Keeps a copy of the input of the largest launch of each permutation
    and chain Poseidon kernel while installed, by wrapping ops.poseidon's
    permute and chain_mont (the wrappers count their launches as ever), and
    of the largest per-block chain (hash_chain_mont: the leaves' asset
    commitments) under "leaf_chain".  Inputs of more than `cap` states are
    not kept: the one such launch, the tree path's plain-schedule check, is
    rebuilt from the tree.  The shape of every chain launch is recorded in
    `chain_launches`."""

    def __init__(self, cap=1 << 20):
        self.cap = cap
        self.best = {}
        self.orig = None
        # (chains, inputs a chain) of every chain launch, in order
        self.chain_launches = []

    def _keep(self, name, n, x):
        if n <= self.cap and n > self.best.get(name, (0, None))[0]:
            self.best[name] = (n, x.clone())

    def install(self):
        from zkpos_tpu_torch.ops import poseidon as P
        self.orig = (P.permute, P.chain_mont, P.hash_chain_mont)
        permute, chain_mont, hash_chain_mont = self.orig

        def keep_permute(state):
            self._keep(P.kernel_name(state.shape[1]), state.shape[0], state)
            return permute(state)

        def keep_leaf_chain(inputs):
            self._keep("leaf_chain", inputs.shape[0], inputs)
            return hash_chain_mont(inputs)

        def keep_chain(inputs):
            self._keep("poseidon_chain", inputs.shape[0] * inputs.shape[1],
                       inputs)
            self.chain_launches.append(tuple(inputs.shape[:2]))
            return chain_mont(inputs)
        P.permute, P.chain_mont = keep_permute, keep_chain
        P.hash_chain_mont = keep_leaf_chain

    def remove(self):
        from zkpos_tpu_torch.ops import poseidon as P
        P.permute, P.chain_mont, P.hash_chain_mont = self.orig


def random_leaves(n, seed, device="cuda"):
    """n standard-form leaves below r on the device, from a seeded
    generator: limbs 0-6 uniform, the top limb uniform below r's top
    limb."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((n, 8), dtype=torch.int32, device=device)
    for j in range(8):
        hi = 0x30644E72 if j == 7 else 1 << 32
        col = torch.randint(0, hi, (n,), generator=gen, dtype=torch.int64,
                            device=device)
        out[:, j] = torch.where(col >= 1 << 31, col - (1 << 32), col)
    return out


def phase_tree(log_leaves=27, depth=28, seed=7, device="cuda"):
    """The depth-28 tree over 2^27 leaves, built and checked three ways.
    Returns (tree, launches)."""
    import torch
    from zkpos_tpu_torch.crypto.bn254 import R, fr_from_bytes, fr_to_bytes
    from zkpos_tpu_torch.crypto.poseidon_ref import poseidon
    from zkpos_tpu_torch.merkle.tree import AccountTree, verify_proof
    from zkpos_tpu_torch.ops import field as F, poseidon as P
    n = 1 << log_leaves
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    leaves = random_leaves(n, seed, device)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    F.LAUNCHES.clear()
    F.SIZES.clear()
    t0 = time.time()
    tree = AccountTree(depth=depth, device=device)
    tree.build_from_leaves(leaves)
    sync()
    build_s = time.time() - t0
    del leaves
    peak = torch.cuda.max_memory_allocated() if on_card else None
    # (3) the whole first level again, on the plain-schedule kernel
    t0 = time.time()
    lvl0 = tree.levels[0]
    plain1 = P.hash2_mont(lvl0[0::2].contiguous(), lvl0[1::2].contiguous())
    if not torch.equal(plain1, tree.levels[1]):
        fail("tree level 1: the sparse and plain Poseidon kernels differ")
    del plain1
    sync()
    plain_s = time.time() - t0
    # (1) 64 random nodes of every level against their children
    rng = random.Random(seed)
    wanted, checks = [], []
    for k in range(1, depth + 1):
        n_k = tree.levels[k].shape[0]
        pos = rng.sample(range(n_k), min(64, n_k))
        for p_ in pos:
            checks.append((k, len(wanted)))
            wanted += [(k, [p_]), (k - 1, [2 * p_]), (k - 1, [2 * p_ + 1])]
    nodes = tree.read_nodes(wanted)
    for k, i in checks:
        node, left, right = (fr_from_bytes(nodes[i + j][0])
                             for j in range(3))
        if poseidon([left, right]) != node:
            fail(f"tree node at level {k} is not the hash of its children")
    # (2) inclusion proofs, and a changed leaf that must fail
    root = tree.root()
    for key in [rng.randrange(n) for _ in range(16)]:
        leaf = tree.get(key)
        proof = tree.get_proof(key)
        if not verify_proof(root, key, proof, leaf, depth):
            fail(f"tree proof of key {key} does not verify")
        bad = fr_to_bytes((fr_from_bytes(leaf) + 1) % R)
        if verify_proof(root, key, proof, bad, depth):
            fail(f"tree proof of key {key} verifies a changed leaf")
    launches = dict(F.LAUNCHES)
    log(json.dumps({"tree_path": {
        "leaves": n, "depth": depth, "build_s": round(build_s, 3),
        "hashes": n - 1, "hashes_per_s": round((n - 1) / build_s),
        "peak_device_bytes": peak, "plain_level1_s": round(plain_s, 3),
        "nodes_checked": len(checks), "proofs_checked": 16,
        "launches": launches}}))
    return tree, launches


# --- the mesh path -------------------------------------------------------------

# world sizes and their backends: one rank over nccl, and two and four ranks
# that share the card over gloo
MESH_WORLDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
# the stream MSMs' bases (the prove's G2 base count) and the double-and-add's
# points
MESH_MSM_N = 1924679
MESH_DBL_N = 1 << 20
# the stream MSMs' window widths: the prove's
MESH_C = (("g1", 16), ("g2", 12))


def mesh_inputs(device, n_msm, n_dbl):
    """The mesh path's seeded scalars on the device, (N, 8) standard-form
    rows below r: those that make the stream MSMs' bases (s * G1 and
    s * G2), each curve's MSM scalars, and the double-and-add's base and
    scalars."""
    return {"base": random_leaves(n_msm, 21, device),
            "g1": random_leaves(n_msm, 22, device),
            "g2": random_leaves(n_msm, 23, device),
            "dbl_base": random_leaves(n_dbl, 24, device),
            "dbl": random_leaves(n_dbl, 25, device)}


def mesh_shards(mesh, log_leaves, n_msm, n_dbl, widths):
    """One rank's shards of the mesh path, for graft.sharded_step: its
    contiguous range of the tree path's leaves and of every MSM input."""
    from zkpos_tpu_torch.ops import field as F, msm, msm_device as md
    dev, D, r = mesh.device, mesh.world, mesh.rank

    def mine(x):
        n = x.shape[0]
        return x[r * n // D:(r + 1) * n // D].contiguous()

    leaves = random_leaves(1 << log_leaves, 7, dev)
    shard = F.to_mont(mine(leaves))
    del leaves
    inp = {k: mine(v) for k, v in mesh_inputs(dev, n_msm, n_dbl).items()}
    return {"leaves": shard,
            "pts": msm.fixed_base_batch("g1", inp["dbl_base"]),
            "scalars": inp["dbl"],
            "stream": {cv: {"base_shard": md.device_base(
                                cv, msm.fixed_base_batch(cv, inp["base"])),
                            "scalars_shard": inp[cv], "c": c}
                       for cv, c in widths}}


def phase_mesh(tree, card, log_leaves=27, device="cuda"):
    """The mesh path: graft.entry()'s function once against its plain
    version, then at each world size of MESH_WORLDS the ranks' results
    against the single-process ones on the same inputs: the sharded root
    against the tree path's level-27 node, the stream MSMs (G1 at c = 16,
    G2 at c = 12), the double-and-add MSM and the point fold against
    msm_device.msm_point (the fold's with every scalar 1), by affine value.
    Returns the launches of the entry and of every rank."""
    import torch
    from zkpos_tpu_torch import graft
    from zkpos_tpu_torch.ops import ec, field as F, msm, msm_device as md
    from zkpos_tpu_torch.ops.poseidon_sparse import plain_hash2_mont_sparse
    from zkpos_tpu_torch.parallel import mesh as pm
    t_all = time.time()
    want_root = F.tensor_to_ints(F.from_mont(tree.levels[log_leaves][:1]))[0]
    inp = mesh_inputs(device, MESH_MSM_N, MESH_DBL_N)
    want = {}
    for cv, c in MESH_C:
        base = md.device_base(cv, msm.fixed_base_batch(cv, inp["base"]))
        want[f"stream_msm_{cv}"] = ec.to_affine(md.msm_point(
            cv, base, plan=md.ScalarPlan(inp[cv], c=c)))[0]
        del base
    dbl = md.device_base("g1", msm.fixed_base_batch("g1", inp["dbl_base"]))
    ones = torch.zeros_like(inp["dbl"])
    ones[:, 0] = 1
    want["dbl_msm"] = ec.to_affine(md.msm_point("g1", dbl, inp["dbl"]))[0]
    want["point_fold"] = ec.to_affine(md.msm_point("g1", dbl, ones))[0]
    del dbl, ones, inp
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref_s = time.time() - t_all
    F.LAUNCHES.clear()
    fn, args = graft.entry(device)
    got = fn(*args)
    launches = Counter(F.LAUNCHES)
    if not torch.equal(got, plain_hash2_mont_sparse(*args)):
        fail("graft.entry(): the node hash disagrees with its plain version")
    # each rank on cuda:{rank % cards}, unless on the CPU
    rank_device = None if torch.device(device).type == "cuda" else device
    for world, backend in MESH_WORLDS:
        t0 = time.time()
        ranks = pm.run_ranks(graft.sharded_step, world, backend,
                             rank_device, args=(mesh_shards, log_leaves,
                                                MESH_MSM_N, MESH_DBL_N,
                                                MESH_C))
        wall = time.time() - t0
        for r, out in enumerate(ranks):
            res = out["results"]
            if res["root"] != want_root:
                fail(f"mesh world {world} rank {r}: the sharded root is not "
                     f"the tree's level-{log_leaves} node")
            bad = [k for k, v in want.items() if res[k] != v]
            if bad:
                fail(f"mesh world {world} rank {r}: {', '.join(bad)} differ "
                     "from the single-process results")
            launches.update(out["launches"])
        log(json.dumps({"mesh_path": {
            "world": world, "backend": backend, "card": card,
            "ranks_s": round(wall, 3),
            "shards": [o["shard"] for o in ranks],
            "prep_s": [o["prep_s"] for o in ranks],
            "steps_s": [o["seconds"] for o in ranks],
            "peak_device_bytes": [o["peak_device_bytes"] for o in ranks],
            "launches": [o["launches"] for o in ranks]}}))
    log(json.dumps({"mesh_path_s": round(time.time() - t_all, 3),
                    "single_process_reference_s": round(ref_s, 3)}))
    return dict(launches)


def make_user_base(C, cex, n_users, seed, AccountAsset, AccountInfo,
                   collateral):
    """n_users valid accounts by asset tier, from a seed, in the manner of
    make_accounts: about 90 % hold 1 to 50 assets (the 50-asset tier), the
    rest 51 to 500 (the 500-asset tier); collateral covers debt."""
    rng = random.Random(seed)
    coll = {}
    out = {50: [], 500: []}
    for _ in range(n_users):
        if rng.random() < 0.9:
            tier, k = 50, rng.randint(1, 50)
        else:
            tier, k = 500, rng.randint(51, 500)
        assets = []
        te = td = tc = 0
        for idx in sorted(rng.sample(range(C.ASSET_COUNTS), k)):
            eq = rng.randint(10, 1000) * E8
            de = rng.randint(0, 2) * E8
            lo = rng.randint(1, 3) * E8
            assets.append(AccountAsset(index=idx, equity=eq, debt=de,
                                       loan=lo, margin=lo,
                                       portfolio_margin=lo))
            price = cex[idx].base_price
            if (idx, lo) not in coll:
                coll[idx, lo] = collateral(lo, lo, lo, cex[idx])
            te += eq * price
            td += de * price
            tc += coll[idx, lo]
        out[tier].append(AccountInfo(account_id=b"", total_equity=te,
                                     total_debt=td, total_collateral=tc,
                                     assets=assets))
    return out


def phase_service(n_accounts=SERVICE_ACCOUNTS, seed=11, device="cuda"):
    """The witness service at the reference's production constants.
    Returns its launches."""
    import base64
    import torch
    from zkpos_tpu_torch.crypto.bn254 import fr_to_bytes
    from zkpos_tpu_torch.crypto.poseidon_ref import poseidon
    from zkpos_tpu_torch.db.codec import decode_batch_witness
    from zkpos_tpu_torch.merkle.tree import verify_proof
    from zkpos_tpu_torch.ops import field as F
    from zkpos_tpu_torch.services.config import ServiceConfig
    from zkpos_tpu_torch.services.witness import WitnessService
    from zkpos_tpu_torch.utils import constants as C
    from zkpos_tpu_torch.utils import commitments as cm
    from zkpos_tpu_torch.utils.types import (AccountAsset, AccountInfo,
                                             CexAssetInfo, TierRatio)
    os.environ.pop("ZKPOR_TEST_TIERS", None)
    C.configure(asset_counts=500, tier_count=12, tree_depth=28)
    t0 = time.time()
    cex = make_cex_assets(C, TierRatio, CexAssetInfo,
                          cm.calculate_precomputed_value,
                          cm.padding_tier_ratios)
    first_cex = [e for a in cex for e in cm.cex_asset_elements(a)]
    by_tier = make_user_base(C, cex, n_accounts, seed, AccountAsset,
                             AccountInfo,
                             cm.calculate_asset_value_for_collateral)
    phases = {"make_accounts": round(time.time() - t0, 3)}
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    F.LAUNCHES.clear()
    F.SIZES.clear()
    with tempfile.TemporaryDirectory() as tmp:
        svc = WitnessService(ServiceConfig(
            db_path=os.path.join(tmp, "zkpos.db")), device=device)
        counts = {}
        for name, fn in (("prepare", lambda: svc.prepare(by_tier, cex)),
                         ("run_witness", svc.run_witness),
                         ("run_userproof", svc.run_userproof),
                         ("run_witness_again", svc.run_witness),
                         ("run_userproof_again", svc.run_userproof)):
            t0 = time.time()
            counts[name] = fn()
            sync()
            phases[name] = round(time.time() - t0, 3)
            log(json.dumps({"service_phase": name,
                            "seconds": phases[name]}))
        launches = dict(F.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if on_card else None
        tiers = C.get_tiers()
        batches = sum(len(svc.accounts[k]) // tiers[k] for k in svc.accounts)
        if (counts["run_witness"] != batches
                or svc.witness_model.count() != batches):
            fail(f"witness rows: {counts['run_witness']} written, "
                 f"{svc.witness_model.count()} stored, {batches} expected")
        if (counts["run_userproof"] != svc.capacity
                or svc.userproof_model.count() != svc.capacity):
            fail(f"userproof rows: {counts['run_userproof']} written, "
                 f"expected {svc.capacity}")
        if counts["run_witness_again"] or counts["run_userproof_again"]:
            fail("a second run of the service wrote rows")
        t0 = time.time()
        root = svc.tree.root()
        by_index = {a.account_index: a for k in svc.accounts
                    for a in svc.accounts[k]}
        rng = random.Random(seed)
        sample = rng.sample(range(svc.capacity), min(256, svc.capacity))
        for idx in sample:
            row = svc.userproof_model.get_by_index(idx)
            config = json.loads(row.config)
            leaf = base64.b64decode(row.account_leaf)
            proof = [base64.b64decode(p_) for p_ in config["Proof"]]
            if leaf != cm.account_info_to_hash(by_index[idx]):
                fail(f"userproof {idx}: leaf differs from the host hash")
            if config["Root"] != root.hex() or not verify_proof(
                    root, idx, proof, leaf):
                fail(f"userproof {idx} does not verify against the root")
        wit = decode_batch_witness(
            svc.witness_model.get_batch_witness_by_height(0).witness_data)
        if wit.before_cex_assets_commitment != fr_to_bytes(
                poseidon(first_cex)):
            fail("the first batch's CEX commitment differs from the host "
                 "Poseidon")
        phases["checks"] = round(time.time() - t0, 3)
        capacity = svc.capacity
        del svc
    log(json.dumps({"service_path": {
        "accounts": n_accounts,
        "accounts_by_tier": {k: len(v) for k, v in by_tier.items()},
        "capacity": capacity, "batches": batches, "phases_s": phases,
        "peak_device_bytes": peak, "userproofs_checked": len(sample),
        "launches": launches}}))
    return launches


# --- the pipeline path: the service entry points ------------------------------

# users of the pipeline path: each holds PIPELINE_TOKENS tokens (so every
# batch lands in the 50-asset tier); two user files of PIPELINE_FILE_ROWS
# rows, the first PIPELINE_INVALID of each invalid by design
PIPELINE_TOKENS = 30
PIPELINE_FILE_ROWS = 28
PIPELINE_INVALID = 4
# the verifier CLI in a subprocess, at the path's asset universe (the
# constants' test-size override; the tiers come from ZKPOR_TEST_TIERS)
VERIFIER_CLI = ("import sys; from zkpos_tpu_torch.utils import constants as "
                "C; C.configure(asset_counts={universe}, tier_count=12, "
                "tree_depth={depth}); from zkpos_tpu_torch.services.verifier"
                " import main; sys.exit(main(sys.argv[1:]))")


def same_points(a, b):
    """Two (N, na, 8) point tensors hold the same points: the same
    identities, and equal affine coordinates (ec.canonical) on the card."""
    import torch
    from zkpos_tpu_torch.ops import ec

    def zmask(t):
        z = t[:, 2] if t.shape[1] == 3 else t[:, 4:].reshape(-1, 16)
        return (z != 0).any(dim=1)
    return (a.shape == b.shape and torch.equal(zmask(a), zmask(b))
            and all(torch.equal(x, y)
                    for x, y in zip(ec.canonical(a), ec.canonical(b))))


def run_verifier(args, cwd, universe, depth, tiers):
    """The verifier CLI in a subprocess (it runs on the host and forks its
    pool): Popen, to be waited on by finish_verifier."""
    env = dict(os.environ, ZKPOR_TEST_TIERS=tiers, PYTHONPATH=HERE)
    return subprocess.Popen(
        [sys.executable, "-c", VERIFIER_CLI.format(universe=universe,
                                                   depth=depth)] + args,
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish_verifier(proc, timeout=600):
    """(exit code, standard output, the last line of standard error)."""
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, (err.strip().splitlines() or [""])[-1]


def phase_pipeline(n_constraints, universe=100, tier=50, batch=16, depth=28,
                   range_bits=16, seed=21, device="cuda"):
    """The services as an operator runs them, at the prove path's size:
    sample data (a seeded CEX table, user files from the sample_data CLI),
    the witness service, keygen.run to artifacts (the keys read back equal
    to keygen's on the card), dbtool's queue push, Prover.run until the
    queue is empty and a rerun that writes nothing, dbtool's status and
    proof export, the verifier CLI in a subprocess on the proof CSV and on
    sampled user proofs, and tampered rows it must reject.  Returns the
    path's launches."""
    import base64
    import contextlib
    import io
    import torch
    from zkpos_tpu_torch.groth16.serialize import vk_to_bytes
    from zkpos_tpu_torch.ops import field as F
    from zkpos_tpu_torch.services import keygen
    from zkpos_tpu_torch.services.config import ServiceConfig
    from zkpos_tpu_torch.services.dbtool import DbTool
    from zkpos_tpu_torch.services.prover import Prover
    from zkpos_tpu_torch.services.verifier import load_proof_csv
    from zkpos_tpu_torch.services.witness import WitnessService
    from zkpos_tpu_torch.utils import constants as C
    from zkpos_tpu_torch.utils import csv_ingest, sample_data
    C.configure(asset_counts=universe, tier_count=12, tree_depth=depth)
    tiers = f"{tier}:{batch}"
    os.environ["ZKPOR_TEST_TIERS"] = tiers
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    phases = {}
    t_path = time.time()

    def lap(name, t0):
        sync()
        phases[name] = round(time.time() - t0, 3)
        log(json.dumps({"pipeline_phase": name, "seconds": phases[name]}))
        return time.time()

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        tokens = ["btc", "eth", "shib"] + [
            f"tok{i}" for i in range(3, PIPELINE_TOKENS)]
        t = time.time()
        cex_csv = sample_data.write_cex_info(
            os.path.join(data, csv_ingest.CEX_ASSET_INFO_FILE), tokens, seed)
        for fid in range(2):
            subprocess.run(
                [sys.executable, "-m", "zkpos_tpu_torch.utils.sample_data",
                 str(fid), str(PIPELINE_FILE_ROWS), str(PIPELINE_INVALID),
                 "--cex", cex_csv, "--out-dir", data, "--tokens",
                 ",".join(tokens), "--seed", str(seed + 1 + fid)],
                cwd=HERE, check=True, capture_output=True)
        accounts, cex, invalid = csv_ingest.parse_user_data_set(data)
        valid = {k: len(v) for k, v in accounts.items()}
        if invalid != 2 * PIPELINE_INVALID or valid != {
                tier: 2 * (PIPELINE_FILE_ROWS - PIPELINE_INVALID)}:
            fail(f"sample data: {valid} valid by tier, {invalid} invalid")
        n_batches = valid[tier] // batch
        t = lap("sample_data", t)
        cfg = ServiceConfig(
            db_path=os.path.join(tmp, "zkpos.db"), user_data_file=data,
            zk_key_name=os.path.join(tmp, "keys", "zkpor"),
            proof_table=os.path.join(tmp, "proofs.csv"),
            cex_assets_info=os.path.join(tmp, "cex_assets.json"))
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        F.LAUNCHES.clear()
        F.SIZES.clear()
        t = time.time()
        svc = WitnessService(cfg, device=device)
        svc.prepare(accounts, cex)
        t = lap("witness_prepare", t)
        if svc.run_witness() != n_batches:
            fail("witness service: wrong number of batch witnesses")
        t = lap("run_witness", t)
        if svc.run_userproof() != svc.capacity:
            fail("witness service: wrong number of user proofs")
        t = lap("run_userproof", t)
        del svc
        spans = {}
        made = keygen.run(cfg.zk_key_name, device=device,
                          range_bits=range_bits, spans=spans)
        t = lap("keygen", t)
        sp = spans[tier]
        if sp["constraints"] != n_constraints:
            fail(f"keygen compiled {sp['constraints']} constraints, the "
                 f"prove path {n_constraints}")
        log(json.dumps({"keygen": {k: (round(v, 3) if isinstance(v, float)
                                       else v) for k, v in sp.items()}}))
        pk, vk = made.pop(tier)
        pk_f, vk_f, r1cs_f = keygen.key_file_names(cfg.zk_key_name, tier,
                                                   batch)
        back = keygen.load_artifact(pk_f, device)
        for name in ("a_g1", "b1_g1", "k_g1", "z_g1", "b_g2", "ck_bases",
                     "ck_sigma_bases"):
            if not same_points(getattr(back, name), getattr(pk, name)):
                fail(f"pk artifact: {name} differs from keygen's key")
        for name in ("alpha_g1", "beta_g1", "delta_g1", "beta_g2",
                     "delta_g2", "num_public", "domain_size", "commit_wires",
                     "challenge_wire"):
            if getattr(back, name) != getattr(pk, name):
                fail(f"pk artifact: {name} differs from keygen's key")
        if vk_to_bytes(keygen.load_artifact(vk_f)) != vk_to_bytes(vk):
            fail("vk artifact differs from keygen's key")
        r1cs = keygen.load_artifact(r1cs_f)
        if (r1cs["num_constraints"] != n_constraints
                or r1cs["solver_program"] is None):
            fail("r1cs artifact: wrong size or no solver program")
        del made, pk, vk, back, r1cs
        torch.cuda.empty_cache()
        t = lap("artifacts_checked", t)
        tool = DbTool(cfg, device=device)
        if tool.push_task_to_redis() != n_batches:
            fail("dbtool pushed a wrong number of tasks")
        prover = Prover(cfg, device=device)
        prover.run(queue_timeout=1.0)
        t = lap("prover_run", t)
        proofs = tool.proof.get_all_proofs()
        if [r.batch_number for r in proofs] != list(range(n_batches)):
            fail(f"prover wrote proofs for {[r.batch_number for r in proofs]}")
        prover.run(rerun=True)
        if (tool.proof.get_all_proofs() != proofs
                or len(prover.batch_seconds) != n_batches):
            fail("the prover's rerun wrote rows")
        t = lap("prover_rerun", t)
        log(json.dumps({"prover": {
            "load_s": {k: round(v, 3) for k, v in
                       prover.load_seconds.items()},
            "batches_s": {h: {k: round(v, 3) for k, v in s_.items()}
                          for h, s_ in prover.batch_seconds.items()}}}))
        del prover
        status = tool.check_prover_status()
        if status != {"published": 0, "received": 0,
                      "finished": n_batches}:
            fail(f"prover status {status}")
        if tool.export_proof_csv(cfg.proof_table) != n_batches:
            fail("dbtool exported a wrong number of proofs")
        with contextlib.redirect_stdout(io.StringIO()):
            cex_json = tool.query_cex_assets()
        with open(cfg.cex_assets_info, "w") as f:
            json.dump(cex_json, f)
        t = lap("dbtool", t)
        # the card's part of the path ends here: the verifier runs on the
        # host, in other processes
        launches = dict(F.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if on_card else None
        torch.cuda.empty_cache()
        # the verifier CLI: the proofs alone first (timed), then sampled
        # user proofs and the tampered cases together
        conf = os.path.join(tmp, "config.json")
        with open(conf, "w") as f:
            json.dump({"MysqlDataSource": cfg.db_path,
                       "ZkKeyName": cfg.zk_key_name,
                       "ProofTable": cfg.proof_table,
                       "CexAssetsInfo": cfg.cex_assets_info}, f)
        vargs = (universe, depth, tiers)
        rc, out, err = finish_verifier(run_verifier(
            ["-config", conf], tmp, *vargs))
        if rc != 0 or "All proofs verified!!!" not in out:
            fail(f"verifier CLI on the proof CSV: exit {rc}, {err}")
        t = lap("verifier_cli", t)
        rows = load_proof_csv(cfg.proof_table)
        cases = {}
        bad = [dict(r) for r in rows]
        proof = bytearray(base64.b64decode(bad[1]["proof_info"]))
        proof[0] ^= 0x40       # Ar's flag: the other root, -Ar
        bad[1]["proof_info"] = base64.b64encode(bytes(proof)).decode()
        cases["proof_byte"] = bad
        cases["index_gap"] = [dict(rows[0])] + [dict(r) for r in rows[2:]]
        procs = {}
        for name, case in cases.items():
            d = os.path.join(tmp, name)
            os.makedirs(d)
            with open(os.path.join(d, "proofs.csv"), "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0]))
                w.writeheader()
                w.writerows(case)
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump({"ZkKeyName": cfg.zk_key_name,
                           "ProofTable": os.path.join(d, "proofs.csv"),
                           "CexAssetsInfo": cfg.cex_assets_info}, f)
            procs[name] = run_verifier(["-config", "config.json"], d, *vargs)
        rng = random.Random(seed)
        um = tool.userproof
        users = sorted(rng.sample(range(valid[tier]), 3))
        for idx in users + ["tampered"]:
            config = json.loads(um.get_by_index(
                users[0] if idx == "tampered" else idx).config)
            if idx == "tampered":
                config["TotalEquity"] += 1
            d = os.path.join(tmp, f"user_{idx}")
            os.makedirs(os.path.join(d, "config"))
            with open(os.path.join(d, "config", "user_config.json"),
                      "w") as f:
                json.dump(config, f)
            procs[f"user_{idx}"] = run_verifier(["-user"], d, *vargs)
        verdicts = {}
        for name, proc in procs.items():
            rc, out, err = finish_verifier(proc)
            verdicts[name] = {"exit": rc, "said": (out.strip().splitlines()
                                                   or [""])[-1][:120],
                              "error": err[:200]}
            want_ok = name.startswith("user_") and name != "user_tampered"
            if (rc == 0) != want_ok:
                fail(f"verifier CLI, {name}: exit {rc}, {verdicts[name]}")
        if "batch 1: groth16 verify failed" not in verdicts["proof_byte"][
                "error"]:
            fail(f"a changed proof byte: {verdicts['proof_byte']}")
        if "batch 2" not in verdicts["index_gap"]["error"]:
            fail(f"an index gap: {verdicts['index_gap']}")
        t = lap("verifier_cli_checks", t)
        log(json.dumps({"verifier_cli": verdicts}))
    phases["path"] = round(time.time() - t_path, 3)
    log(json.dumps({"pipeline_path": {
        "universe": universe, "tier": tier, "batch": batch, "depth": depth,
        "constraints": n_constraints, "batches": n_batches,
        "invalid_rows": invalid, "artifact_bytes": sp["bytes"],
        "phases_s": phases, "peak_device_bytes": peak,
        "launches": launches}}))
    return launches


def phase_poseidon_kernels(tree, inputs):
    """Each Poseidon kernel against its plain version on the card, bit for
    bit, on a slice of the inputs of its largest launch (hashes are
    independent), and timed on the whole launch."""
    import torch
    from zkpos_tpu_torch.ops import poseidon as P, poseidon_sparse as S
    rows = []
    lvl0 = tree.levels[0]
    a_all, b_all = lvl0[0::2], lvl0[1::2]
    n = a_all.shape[0]
    s = 1 << 18
    a, b = a_all[:s].contiguous(), b_all[:s].contiguous()
    p, plain_ms = timed(lambda: S.plain_hash2_mont_sparse(a, b))
    # exact on the slice and on its odd head (a block whose last threads
    # run past n), timed on the whole level
    err = max(max_abs_err(S.hash2_mont_sparse(a, b), p),
              max_abs_err(S.hash2_mont_sparse(a[:4097], b[:4097]), p[:4097]))
    ms = cuda_ms(lambda: S.hash2_mont_sparse(a_all, b_all), reps=1,
                 warm=False)
    r = make_row("poseidon_sparse3", err, ms, n, plain_ms, s, 3 * 32 * n,
                 sparse_monts(3) * MULS_PER_MONT * n)
    r["per_thread"] = 1          # k_sparse3: one hash a thread
    rows.append(r)
    # the plain schedule at t = 3 on the same pairs (its largest launch:
    # the tree path's whole first level)
    st = torch.stack([torch.zeros_like(a_all), a_all, b_all], 1)
    k = P.permute(st[:s].contiguous())
    p, plain_ms = timed(lambda: P.plain_permute(st[:s]))
    ms = cuda_ms(lambda: P.permute(st), reps=1, warm=False)
    rows.append(make_row("poseidon_plain_t3", max_abs_err(k, p), ms, n,
                         plain_ms, s, 4 * 32 * n,
                         poseidon_monts(3) * MULS_PER_MONT * n))
    del st, a, b, k, p
    torch.cuda.empty_cache()
    # the sparse permutation at each width the paths ran, launched on the
    # whole of its largest launch's input and timed there: every digest
    # against the plain sparse schedule (the wrapper's CPU route), and a
    # slice's (which bounds its memory) against the plain schedule, which
    # reads none of the sparse tables
    for name in sorted(inputs.best, key=lambda x: (len(x), x)):
        if not name.startswith("poseidon_sparse_t"):
            continue
        n, x = inputs.best[name]
        t = x.shape[1]
        s = min(n, (1 << 18) * 9 // (t * t))
        k = P.permute(x)
        p, plain_ms = timed(lambda: S.plain_permute_sparse(x))
        err = max_abs_err(k, p)
        p, schedule_ms = timed(lambda: P.plain_permute(x[:s]))
        err = max(err, max_abs_err(k[:s], p))
        ms = cuda_ms(lambda: P.permute(x), reps=3)
        rows.append(make_row(name, err, ms, n, plain_ms, n,
                             (t + 1) * 32 * n,
                             sparse_monts(t) * MULS_PER_MONT * n))
        rows[-1]["ptxas"] = ptxas_of(f"6k_wideILi{t}EE")
        rows[-1]["plain_schedule"] = {"ms": round(schedule_ms, 4), "n": s,
                                      "monts": poseidon_monts(t)}
        rows[-1]["sparse_monts"] = sparse_monts(t)
        del k, p
    # the largest leaf-commitment input: one launch a block of the chain
    # (the path's route) beside the warp-a-chain kernel, a yardstick only
    _, x = inputs.best["leaf_chain"]
    per_block = P.hash_chain_mont(x)
    if not torch.equal(P.chain_mont(x), per_block):
        fail("leaf commitments: chain_mont and hash_chain_mont differ")
    cmp = {"accounts": x.shape[0], "inputs": x.shape[1],
           "widths": chain_widths(x.shape[1]),
           "hash_chain_mont_ms": round(cuda_ms(
               lambda: P.hash_chain_mont(x), reps=1, warm=False), 4),
           "chain_mont_ms": round(cuda_ms(lambda: P.chain_mont(x), reps=1,
                                          warm=False), 4)}
    log(json.dumps({"leaf_chain_vs_chain_mont": cmp}))
    rows[-1]["leaf_chain_vs_chain_mont"] = cmp
    # the chain at its largest launch (the service path's batched CEX
    # commitments): every chain against the per-block plain-schedule
    # kernel, the first 113 inputs of every chain (8 blocks, a narrower
    # last one) against the plain version; timed there and at one chain
    _, x = inputs.best["poseidon_chain"]
    b, n = x.shape[:2]
    err = max_abs_err(P.chain_mont(x), P.hash_chain_mont(x))
    head = x[:, :113].contiguous()
    p, plain_ms = timed(lambda: P.plain_chain_mont(head))
    err = max(err, max_abs_err(P.chain_mont(head), p))
    ms = cuda_ms(lambda: P.chain_mont(x), reps=1, warm=False)
    one = x[:1].contiguous()
    ms_one = cuda_ms(lambda: P.chain_mont(one), reps=1)
    # products on one chain's critical path: counted from the schedule
    # (sparse_critical), not measured; the time a product is the measured
    # one-chain time over that count
    crit = sum(sparse_critical(t) for t in chain_widths(n))
    r = make_row("poseidon_chain", err, ms, b * n, plain_ms, b * 113,
                 32 * b * (n + 1), chain_monts(n) * MULS_PER_MONT * b)
    r.update({"chains": b, "ms_one_chain": round(ms_one, 4),
              "critical_path": {
                  "monts": crit, "monts_from": "schedule count",
                  "ns_per_mont": round(ms_one * 1e6 / crit, 2)}})
    log(f"  poseidon_chain: {b} chains of {n} inputs in {ms:.3f} ms, one "
        f"chain {ms_one:.3f} ms; {crit} products on a chain's critical "
        f"path by the schedule's count, {ms_one * 1e6 / crit:.1f} ns each")
    rows.append(r)
    return rows


# --- the probes path ----------------------------------------------------------

ROW_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "max_rel_err", "tol", "ms", "n", "plain_ms", "plain_n",
            "bound_ms", "bound_by", "library_ms", "ptxas", "counted_as",
            "adds", "bytes_ms", "ops_ms", "fixup_elements",
            "design_adds", "design_ops_ms", "tiles_per_chunk",
            "check_tiles_per_chunk", "ragged_n", "ragged_walk",
            "ragged_rel_err")


def probe_row(r):
    """A probe variant's entry of the kernels line; fails if it disagrees
    with its plain version: exactly for the integer probes, above the
    stated relative tolerance for the float ones."""
    tol = r.get("tol")
    log(f"kernel {r['name']}: max_abs_err={r['max_abs_err']} "
        + (f"max_rel_err={r['max_rel_err']:.3e} (tol {tol}) "
           if tol is not None else "")
        + f"ms={r['ms']:.3f} (n={r['n']}) plain_ms={r['plain_ms']:.3f} "
        f"(n={r['plain_n']}) bound_ms={r['bound_ms']:.3f}")
    if (r["max_abs_err"] != 0 if tol is None else not
            r["max_rel_err"] <= tol):
        fail(f"{r['name']} disagrees with its plain version")
    if "ragged_n" in r:
        log(f"kernel {r['name']} at n={r['ragged_n']} (a ragged last slab; "
            f"{r['ragged_blocks']} blocks, {r['ragged_walk'][0]}-"
            f"{r['ragged_walk'][1]} columns a thread): "
            f"max_rel_err={r['ragged_rel_err']:.3e} (tol {tol})")
    for k in ("full_equals_main_kernel", "cios_equals_reduce_of_product",
              "equals_seg_sums", "carries_equal_main_kernel",
              "elements_equal_local", "check_spans_chunks",
              "ragged_within_tol", "ragged_refills_ring"):
        if r.get(k) is False:
            fail(f"{r['name']}: {k} is false")
    return {k: r[k] for k in ROW_KEYS if k in r}


def phase_probes(card, means):
    """Every probe on the card, the counts set to 0 just before each probe's
    timed launches and read just after (probes.run_probe; its checks come
    after the reading).  Returns (its kernel rows, its launches, the
    measured rate of the field core's wide multiply-add in 32-bit
    multiplies a second)."""
    import torch
    from zkpos_tpu_torch import probes
    t_all = time.time()
    rows, raw, launches = [], [], Counter()
    for name, mod in probes.PROBES:
        t0 = time.time()
        kw = {"means": means} if name == "probe_segscan" else {}
        out, counted = probes.run_probe(mod, "cuda", log=log, **kw)
        launches.update(counted)
        torch.cuda.empty_cache()
        log(json.dumps({"probe": name, "card": card,
                        "seconds": round(time.time() - t0, 3),
                        "rows": out}))
        rows += [probe_row(r) for r in out]
        raw += out
    # two 32-bit multiplies a step
    wide = next(2 * r["steps_per_s"] for r in raw
                if r["name"] == "rate_u64_widemad")
    seconds = time.time() - t_all
    log(json.dumps({"probes_path": {"seconds": round(seconds, 3),
                                    "limit_s": PROBES_PATH_LIMIT_S,
                                    "launches": dict(launches)}}))
    return rows, dict(launches), wide


def rebound(rows, wide):
    """The bound of every kernel row that counts 32-bit multiplies, again
    at the rate this run measured for the field core's wide multiply-add
    (two multiplies a step) in place of the data sheet's INT32 rate."""
    log(json.dumps({"wide_mad_muls_per_s": round(wide),
                    "of_int32_mul_per_s": round(wide / INT32_MUL_PER_S, 4)}))
    parts = [p for r in rows for key in ("by_matrix", "adversarial")
             for p in r.get(key, {}).values()]
    for r in rows + parts:
        if "ops_ms" in r:
            r["bound_ms_at_measured_rate"] = round(
                max(r["bytes_ms"], r["ops_ms"] * INT32_MUL_PER_S / wide), 4)


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "zkpos_tpu_torch")):
        print("FAIL: run from a checkout of the repository "
              "(zkpos_tpu_torch/ not found beside chip_smoke.py)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_all = time.time()
    phase_build()
    smi = phase_smi()
    phase_msm_oracle()
    inputs = LargestInputs()
    inputs.install()
    launches = {}
    cs, pk, scs, launches["prove"], sizes, windows = phase_main()
    need(launches["prove"], "prove")
    log(json.dumps({"prove_chain_launches": len(inputs.chain_launches),
                    "chains_per_launch": [c for c, _ in
                                          inputs.chain_launches]}))
    log(f"prove path done at {time.time() - t_all:.1f} s")
    rows, means = phase_kernels(cs, pk, scs, sizes, windows)
    n_constraints = len(cs.constraints)
    del windows
    del cs, pk, scs
    torch.cuda.empty_cache()
    log(f"prove-path kernel checks done at {time.time() - t_all:.1f} s")
    launches["pipeline"] = phase_pipeline(n_constraints)
    need(launches["pipeline"], "pipeline")
    log(f"pipeline path done at {time.time() - t_all:.1f} s")
    tree, launches["tree"] = phase_tree()
    need(launches["tree"], "tree")
    log(f"tree path done at {time.time() - t_all:.1f} s")
    launches["mesh"] = phase_mesh(tree, smi)
    need(launches["mesh"], "mesh")
    log(f"mesh path done at {time.time() - t_all:.1f} s")
    k0 = len(inputs.chain_launches)
    launches["service"] = phase_service()
    need(launches["service"], "service")
    shapes = inputs.chain_launches[k0:]
    log(json.dumps({"service_chain_launches": len(shapes),
                    "chains_per_launch": [c for c, _ in shapes],
                    "inputs_per_chain": sorted({n for _, n in shapes})}))
    inputs.remove()
    log(f"service path done at {time.time() - t_all:.1f} s")
    rows += phase_poseidon_kernels(tree, inputs)
    del tree
    torch.cuda.empty_cache()
    from zkpos_tpu_torch.probes import kernel_names
    PATH_KERNELS["probes"] = kernel_names()
    probe_rows, launches["probes"], wide = phase_probes(smi, means)
    need(launches["probes"], "probes")
    rows += probe_rows
    rebound(rows, wide)
    # the chain's time a critical-path product beside one product's latency
    # on a lone warp (probes/latency.py)
    from zkpos_tpu_torch.probes import latency
    cp = next(r for r in rows if r["name"] == "poseidon_chain")[
        "critical_path"]
    lat_ms = next(r["ms"] for r in rows if r["name"] == "latency_mont")
    cp["latency_probe_ns"] = round(lat_ms * 1e6 / latency.STEPS, 2)
    cp["latency_share"] = round(cp["latency_probe_ns"] / cp["ns_per_mont"], 4)
    log(json.dumps({"chain_critical_path": cp}))
    # the single-pass segment sums on the prove's streams beside the
    # three-pass scan they replaced on streams of the same sizes; seg_scan's
    # stages on the probes' streams, and what its fix-up costs an element
    cmp, split = {}, {}
    for curve in ("g1", "g2"):
        k = next(r for r in rows if r["name"] == f"seg_sums_{curve}")
        st = {s_: next(r for r in rows if r["name"] == f"scan_{s_}_{curve}")
              for s_ in ("local", "local_agg", "full", "three_pass")}
        f = st["three_pass"]
        cmp[curve] = {"seg_sums_ms": k["ms"], "n": k["n"],
                      "three_pass_ms": f["ms"], "three_pass_n": f["n"],
                      "three_pass_over_seg_sums": round(f["ms"] / k["ms"], 3)}
        fix_ms = st["full"]["ms"] - st["local_agg"]["ms"]
        split[curve] = {
            **{f"{s_}_ms": r["ms"] for s_, r in st.items()},
            **{f"{s_}_adds": r.get("design_adds", r.get("adds"))
               for s_, r in st.items()},
            "fixup_ms": round(fix_ms, 4),
            "fixup_share": round(fix_ms / st["full"]["ms"], 4),
            "fixup_elements": st["full"]["fixup_elements"],
            "fixup_ns_per_element": round(
                fix_ms * 1e6 / st["full"]["fixup_elements"], 4),
            "pass_ns_per_add": round(
                st["local"]["ms"] * 1e6 / st["local"]["adds"], 4)}
    log(json.dumps({"seg_sums_vs_three_pass": cmp}))
    log(json.dumps({"seg_scan_stages": split}))
    # the ablations' base beside the tree's kernel that it takes apart, at
    # the same n (the tree path's first level)
    k = next(r for r in rows if r["name"] == "poseidon_sparse3")
    f = next(r for r in rows if r["name"] == "split_full")
    log(json.dumps({"split_full_vs_poseidon_sparse3": {
        "poseidon_sparse3_ms": k["ms"], "n": k["n"],
        "split_full_ms": f["ms"], "split_n": f["n"],
        "split_full_over_poseidon_sparse3": round(f["ms"] / k["ms"], 4)}}))
    log(f"probes path done at {time.time() - t_all:.1f} s")
    for r in rows:
        # a probe row that times another kernel (the scan's full stage is
        # seg_scan's own) counts that kernel's launches on the probes path
        key = r.get("counted_as", r["name"])
        paths = {"probes": launches["probes"]} if "counted_as" in r \
            else launches
        by_path = {p_: n for p_, c in paths.items() if (n := c.get(key, 0))}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
    launched = {k for c in launches.values() for k, n in c.items() if n}
    unchecked = launched - {r["name"] for r in rows}
    if unchecked:
        fail("kernels launched but not checked: " + ", ".join(
            sorted(unchecked)))
    log(f"total {time.time() - t_all:.1f} s")
    log(smi)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
