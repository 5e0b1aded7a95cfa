"""The segmented EC-sum scan split into its stages.

Counterpart of scripts/probe_segscan.py:19-192 (``kernel``, stages 1-4:
the scan's structure with a dummy ``x + part`` combine; ``main6.kern``,
stages 6-8: the real G1 add core with the carry merge only, one
Hillis-Steele step, all steps), which cut the TPU's ``_seg_scan_kernel``
apart to find what its time went to.  The port's first scan was three
passes: a serial local pass of K = 16 elements a thread, the
recursive scan of the per-thread aggregates, and the fix-up; csrc/seg_scan.cu
now runs one pass.  The stages here reproduce the three-pass design, each
run over a whole stream by the kernels of csrc/probes.cu (built on ec.cuh's
load, store and complete add):

* ``copy``: every point loaded and stored with its head flag in the scan's
  thread mapping, no combine: the byte floor of that mapping;
* ``structure``: all three passes, the combine a limb-wise wrapping add
  (TPU stages 1-4);
* ``local``: the local pass with the real add (stage 6);
* ``local_agg``: that and the recursive scan of the aggregates (stage 7);
* ``full``: the whole scan (stage 8): the earlier design of ops/ec.seg_scan,
  kept as the yardstick of the single-pass kernel that replaced it, and
  held against it by affine value;
* ``lookback_k32``: the single-pass segment sums (csrc/seg_scan.cuh, as
  ops/ec.seg_sums) at 32 elements a lane where csrc/seg_scan.cu takes 64
  (csrc/probes_scan.cu), held against ops/ec.seg_sums by affine value.

Streams: the prove path's sizes, G1 at 30,795,264 and G2 at 42,343,488
points (the witness streams of its A and B MSMs), points drawn from a pool
of valid points, heads from a seeded Bernoulli pattern with the streams'
mean segment length (SEGMENT_MEAN, which chip_smoke.py measures on the
path's own streams and passes in).  Bound: complete adds (12 Montgomery
products in G1, its two by 3b = 9 being doublings; 42 in G2) at the INT32
rate -- for the whole scan and the
segment sums the function's own (one for each element that is not a head),
for the partial stages those the three-pass design makes on this head
pattern -- or the stream's bytes.
"""

from __future__ import annotations

import random

import torch

from ..crypto import bn254 as bn
from ..ops import ec
from ..ops import field as F
from ..utils import build
from ..utils.device import resolve
from . import common as C

K = 16          # elements a thread in the three-pass design
STAGES = ("copy", "structure", "local", "local_agg", "full", "lookback_k32")
REPLACES = {"copy": "scripts/probe_segscan.py:19",
            "structure": "scripts/probe_segscan.py:19",
            "local": "scripts/probe_segscan.py:101",
            "local_agg": "scripts/probe_segscan.py:101",
            "full": "scripts/probe_segscan.py:101",
            "lookback_k32": "zkpos_tpu/ops/ec_pallas.py:268"}
SOURCES = {"lookback_k32": "zkpos_tpu_torch/csrc/probes_scan.cu"}
STREAMS = {"g1": 30_795_264, "g2": 42_343_488}
# mean segment length of the prove path's A (G1) and B (G2) witness
# streams, as chip_smoke.py measures them on the card (PERF.md, section 4)
SEGMENT_MEAN = {"g1": 31.5, "g2": 492.3}
MONTS_PER_ADD = {3: 12, 6: 42}
CHECK_N = K ** 4        # a prefix the plain versions check: whole blocks
REPS = 3                # timed launches of each stage


def _na(curve: str) -> int:
    return 3 if curve == "g1" else 6


# --- plain versions -----------------------------------------------------------

def _block_flags(heads: torch.Tensor) -> torch.Tensor:
    n = heads.shape[0]
    T = -(-n // K)
    h = torch.zeros(T * K, dtype=torch.bool, device=heads.device)
    h[:n] = heads.bool()
    return h.reshape(T, K).any(1)


def _wrap_scan(pts: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """Segmented scan under the limb-wise wrapping add: prefix sums of
    each limb mod 2^32, less the sum before the segment's head."""
    n = pts.shape[0]
    x = pts.long() & 0xFFFFFFFF
    cs = torch.cumsum(x, 0)
    idx = torch.arange(n, device=pts.device)
    h = heads.bool().clone()
    h[0] = True
    start = torch.cummax(torch.where(h, idx, torch.zeros_like(idx)), 0)[0]
    before = torch.where((start > 0)[:, None, None], cs[start - 1],
                         torch.zeros_like(cs[:1]))
    v = (cs - before) & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _local_heads(heads: torch.Tensor) -> torch.Tensor:
    h = heads.bool().clone()
    h[::K] = True
    return h


def plain_stage(stage: str, pts: torch.Tensor, heads: torch.Tensor):
    """(out, aux) of the stage: copy -> (pts, per-thread head flags);
    local_agg -> (the local pass, the scanned aggregates); the rest ->
    (out, None).  The scans run ec.plain_seg_scan with the kernels' block
    size, which adds in the kernels' order, so results are equal bit for
    bit."""
    if stage == "copy":
        return pts.clone(), _block_flags(heads).to(torch.uint8)
    if stage == "structure":
        return _wrap_scan(pts, heads), None
    if stage == "full":
        return ec.plain_seg_scan(pts, heads, K), None
    if stage == "lookback_k32":
        return ec.plain_seg_sums(pts, heads), None
    out = ec.plain_seg_scan(pts, _local_heads(heads), K)
    if stage == "local":
        return out, None
    n = pts.shape[0]
    ends = torch.clamp(torch.arange(K - 1, -(-n // K) * K, K,
                                    device=pts.device), max=n - 1)
    agg = ec.plain_seg_scan(out[ends].contiguous(), _block_flags(heads), K)
    return out, agg


# --- the stages on the card ---------------------------------------------------------

def _local(L, na, comb, x, heads, out, name):
    """seg_scan.cu's local pass with the given combine (0 the complete
    add, 1 the wrapping add); returns the per-thread aggregates and their
    head flags."""
    n = x.shape[0]
    T = -(-n // K)
    agg = torch.empty((T, na, 8), dtype=torch.int32, device=x.device)
    flag = torch.empty((T,), dtype=torch.uint8, device=x.device)
    build.check(L.zk_probe_scan_local(na, comb, build.ptr(x),
                                      build.ptr(heads), build.ptr(out),
                                      build.ptr(agg), build.ptr(flag), n, K,
                                      build.stream_ptr(x)), name)
    F.count_launch(name, n)
    return agg, flag


def _scan(L, na, comb, x, heads, out, name, fix=True):
    """The local pass, then the same scan of the aggregates and, if fix,
    the fix-up.  Returns the scanned aggregates."""
    n = x.shape[0]
    agg, flag = _local(L, na, comb, x, heads, out, name)
    if agg.shape[0] > 1:
        _scan(L, na, comb, agg, flag, agg, name)
        if fix:
            build.check(L.zk_probe_scan_fixup(
                na, comb, build.ptr(out), build.ptr(heads), build.ptr(agg),
                n, K, build.stream_ptr(x)), name)
            F.count_launch(name, n)
    return agg


def scan_stage(stage: str, pts: torch.Tensor, heads: torch.Tensor):
    """The stage's kernels on the card (every launch counted as
    ``scan_<stage>_<g1|g2>``), plain_stage on the CPU; returns what
    plain_stage returns.  pts (N, 3|6, 8) int32, heads (N,) uint8."""
    ec._check_pts(pts)
    if heads.shape != (pts.shape[0],) or heads.dtype != torch.uint8:
        raise ValueError("heads must be (N,) uint8")
    if C.check_device(pts, heads) == "cpu":
        return plain_stage(stage, pts, heads)
    na, n = pts.shape[1], pts.shape[0]
    name = f"scan_{stage}_{'g1' if na == 3 else 'g2'}"
    L = build.cuda_lib()
    out = torch.empty_like(pts)
    if stage == "copy":
        flag = torch.empty((-(-n // K),), dtype=torch.uint8,
                           device=pts.device)
        build.check(L.zk_probe_scan_copy(na, build.ptr(pts), build.ptr(heads),
                                         build.ptr(out), build.ptr(flag), n,
                                         K, build.stream_ptr(pts)), name)
        F.count_launch(name, n)
        return out, flag
    if stage == "local":
        _local(L, na, 0, pts, heads, out, name)
        return out, None
    if stage == "lookback_k32":
        S = 1 + int(heads[1:].sum())
        sums = torch.empty((S, na, 8), dtype=torch.int32, device=pts.device)
        scratch = torch.empty(L.zk_probe_lookback_bytes(na, n),
                              dtype=torch.uint8, device=pts.device)
        build.check(L.zk_probe_lookback(na, build.ptr(pts), build.ptr(heads),
                                        build.ptr(sums), build.ptr(scratch),
                                        n, build.stream_ptr(pts)), name)
        F.count_launch(name, n)
        return sums, None
    comb = 1 if stage == "structure" else 0
    agg = _scan(L, na, comb, pts, heads, out, name,
                fix=stage != "local_agg")
    return out, (agg if stage == "local_agg" else None)


# --- inputs and the run ------------------------------------------------------------

def point_pool(curve: str, k: int, seed: int, device) -> torch.Tensor:
    """k^2 valid points: k host multiples of the generator, then every
    pair sum by the plain add."""
    rng = random.Random(seed)
    g, mul = ((bn.G1_GEN, bn.g1_mul) if curve == "g1"
              else (bn.G2_GEN, bn.g2_mul))
    base = ec.from_affine([mul(g, rng.randrange(1, bn.R)) for _ in range(k)],
                          curve, device)
    i = torch.arange(k, device=device).repeat_interleave(k)
    j = torch.arange(k, device=device).repeat(k)
    return ec.plain_point_add(base[i].contiguous(), base[j].contiguous())


def stream(curve: str, n: int, mean: float, seed: int, device):
    """n points of the pool and a head pattern with segments of the given
    mean length (a head with probability 1 / mean; the first is a head)."""
    pool = point_pool(curve, 16, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    idx = torch.randint(0, pool.shape[0], (n,), generator=gen, device=device)
    pts = pool[idx]
    heads = (torch.rand(n, generator=gen, device=device) < 1.0 / mean).to(
        torch.uint8)
    heads[0] = 1
    return pts, heads


def _same_points(a: torch.Tensor, b: torch.Tensor,
                 chunk: int = 1 << 22) -> bool:
    """Whether two point tensors hold the same points, row by row (their
    canonical values, chunk by chunk)."""
    for i in range(0, a.shape[0], chunk):
        ca = ec.canonical(a[i:i + chunk].contiguous())
        cb = ec.canonical(b[i:i + chunk].contiguous())
        if not all(torch.equal(x, y) for x, y in zip(ca, cb)):
            return False
    return True


def stage_adds(stage: str, heads: torch.Tensor) -> int:
    """Complete adds on this head pattern: for the whole scan and the
    segment sums, the function's own work (one add for each element that
    is not a head); for the partial stages, the adds the three-pass design
    makes -- the local pass adds where no head is, each recursion level the
    same over its aggregates (and, below the top, each fix-up once per
    element before its thread's first head)."""
    if stage in ("copy", "structure"):
        return 0
    if stage in ("full", "lookback_k32"):   # the function's own work
        return heads.shape[0] - 1 - int(heads[1:].bool().sum())
    total, h, level = 0, heads.bool(), 0
    while True:
        n = h.shape[0]
        T = -(-n // K)
        hp = torch.ones(T * K, dtype=torch.bool, device=h.device)
        hp[:n] = h
        hp = hp.reshape(T, K)
        total += int((~hp[:, 1:]).sum())
        if stage == "local" or T == 1:
            return total
        if level > 0:
            before = torch.cumsum(hp.int(), dim=1) == 0
            before[0] = False
            total += int(before.sum())
        h, level = hp.any(dim=1), level + 1


def run(device=None, means=None, log=print):
    """Times every stage over a G1 and a G2 stream of the prove path's
    sizes (means: {curve: mean segment length}, SEGMENT_MEAN by default)
    and returns ``check``, which holds each stage against its plain version
    on a prefix (and ``full`` against ops/ec.seg_scan on the whole stream)
    and returns the rows."""
    dev = resolve(device)
    means = means or SEGMENT_MEAN
    streams, times = {}, {}
    for curve in ("g1", "g2"):
        n = STREAMS[curve]
        pts, heads = streams[curve] = stream(curve, n, means[curve],
                                             21 + _na(curve), dev)
        warm = min(n, 1 << 16)
        for st in STAGES:
            times[curve, st] = C.time_ms(
                lambda: scan_stage(st, pts, heads), dev, reps=REPS,
                warm=lambda: scan_stage(st, pts[:warm], heads[:warm]))
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def check():
        rows = []
        for curve in ("g1", "g2"):
            na = _na(curve)
            n = STREAMS[curve]
            pts, heads = streams.pop(curve)
            s = min(CHECK_N, n)
            # the main path's scan on the card, by affine value: it adds in
            # another order than the three passes
            full_eq = (_same_points(scan_stage("full", pts, heads)[0],
                                    ec.seg_scan(pts, heads))
                       if dev.type == "cuda" else None)
            sums_eq = (_same_points(scan_stage("lookback_k32", pts, heads)[0],
                                    ec.seg_sums(pts, heads))
                       if dev.type == "cuda" else None)
            t_full = times[curve, "full"]
            for st in STAGES:
                got = scan_stage(st, pts[:s], heads[:s])
                p, plain_ms = C.timed(lambda: plain_stage(st, pts[:s],
                                                          heads[:s]), dev)
                if st == "lookback_k32":     # another order of adds
                    err = max(C.max_abs_err(a, b) for a, b in zip(
                        ec.canonical(got[0]), ec.canonical(p[0])))
                else:
                    err = max(C.max_abs_err(a, b) for a, b in zip(got, p)
                              if a is not None)
                if st == "full" and full_eq is False:
                    err = max(err, 1)
                adds = stage_adds(st, heads)
                name = f"scan_{st}_{curve}"
                ms = times[curve, st]
                extra = {"full_equals_main_kernel": full_eq}
                byts = 2 * na * 32 * n + n
                if st == "lookback_k32":
                    S = n - adds
                    byts = na * 32 * (n + S) + n
                    extra = {"equals_seg_sums": sums_eq,
                             "source": SOURCES[st],
                             "ptxas": next(iter(C.kernel_resources(
                                 f"17k_{st}_{curve}").values()), None)}
                r = C.row(name, REPLACES[st], n, ms, plain_ms, s, byts,
                          adds * MONTS_PER_ADD[na] * C.MULS_PER_MONT
                          / C.INT32_OPS_PER_S, err, adds=adds,
                          segment_mean=means[curve],
                          heads=int(heads.sum()),
                          share_of_full=round(ms / t_full, 4),
                          device=dev.type, **extra)
                log(f"probe {name}: {ms:.3f} ms "
                    f"({r['share_of_full']:.3f} of full), {adds} adds, "
                    f"err {err}")
                rows.append(r)
            del pts, heads
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        return rows
    return check
