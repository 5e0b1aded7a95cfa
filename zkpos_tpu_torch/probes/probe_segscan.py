"""The segmented EC-sum scan split into its stages.

Counterpart of scripts/probe_segscan.py:19-192 (``kernel``, stages 1-4:
the scan's structure with a dummy ``x + part`` combine; ``main6.kern``,
stages 6-8: the real G1 add core with the carry merge only, one
Hillis-Steele step, all steps), which cut the TPU's ``_seg_scan_kernel``
apart to find what its time went to.  Stages 1-4 run on the mapping of the
scan that the port runs, csrc/seg_scan.cuh's single pass (a warp a chunk
of whole tiles of 32 lanes x 64 elements, each tile streamed through
shared memory; csrc/probes_scan.cu):

* ``copy``: every point streamed through shared memory and back, and each
  chunk's head count, with no add: the byte floor of that mapping (TPU
  stage 1);
* ``structure``: seg_scan (every position) with a limb-wise wrapping add
  in place of the complete add wherever one runs -- the lanes' passes,
  their Hillis-Steele scan, the carries, the look-back and the fix-up
  (TPU stages 2-4): the scan's structure without curve arithmetic;
* ``lookback_k32``: the single-pass segment sums (as ops/ec.seg_sums) at
  32 elements a lane where csrc/seg_scan.cu takes 64, held against
  ops/ec.seg_sums by affine value.

Stages 6-8 keep the port's first scan, three passes on the complete add
(csrc/probes.cu: a serial local pass of K = 16 elements a thread, the
recursive scan of the per-thread aggregates, the fix-up), as the yardstick
of the single pass that replaced it:

* ``local``: the local pass (stage 6);
* ``local_agg``: that and the recursive scan of the aggregates (stage 7);
* ``full``: the whole scan (stage 8), held against ops/ec.seg_scan by
  affine value.

Streams: the prove path's sizes, G1 at 30,795,264 and G2 at 42,343,488
points (the witness streams of its A and B MSMs), points drawn from a pool
of valid points, heads from a seeded Bernoulli pattern with the streams'
mean segment length (SEGMENT_MEAN, which chip_smoke.py measures on the
path's own streams and passes in).  Bound: complete adds (12 Montgomery
products in G1, its two by 3b = 9 being doublings; 42 in G2) at the INT32
rate -- for the whole scan and the
segment sums the function's own (one for each element that is not a head),
for the partial stages those the three-pass design makes on this head
pattern -- or the stream's bytes (copy and structure: its points read and
written and its heads read).
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
TILE = 32 * 64  # elements a tile of the single pass: 32 lanes x 64
STAGES = ("copy", "structure", "local", "local_agg", "full", "lookback_k32")
REPLACES = {"copy": "scripts/probe_segscan.py:19",
            "structure": "scripts/probe_segscan.py:19",
            "local": "scripts/probe_segscan.py:101",
            "local_agg": "scripts/probe_segscan.py:101",
            "full": "scripts/probe_segscan.py:101",
            "lookback_k32": "zkpos_tpu/ops/ec_pallas.py:268"}
# the single-pass stages: their kernels (csrc/probes_scan.cu) and the
# zk_probe_scan_bytes stage numbers of their scratch
SINGLE_PASS = {"copy": 0, "structure": 1, "lookback_k32": 2}
SOURCE = "zkpos_tpu_torch/csrc/probes_scan.cu"
STREAMS = {"g1": 30_795_264, "g2": 42_343_488}
# mean segment length of the prove path's A (G1) and B (G2) witness
# streams, as chip_smoke.py measures them on the card (PERF.md, section 4)
SEGMENT_MEAN = {"g1": 31.5, "g2": 492.3}
MONTS_PER_ADD = {3: 12, 6: 42}
CHECK_N = K ** 4        # a prefix the plain versions check: whole blocks
# structure's prefix: past the card's resident warps, so chunks of two
# tiles or more and look-backs across them (copy is checked whole)
CHECK_STRUCTURE_N = 1 << 23
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
    each limb mod 2^32, less the sum before the segment's head.  The limbs
    are scanned as rows (the innermost dimension), which the card scans in
    parallel."""
    n = pts.shape[0]
    x = (pts.reshape(n, -1).long() & 0xFFFFFFFF).T.contiguous()
    cs = torch.cumsum(x, 1)
    idx = torch.arange(n, device=pts.device)
    h = heads.bool().clone()
    h[0] = True
    start = torch.cummax(torch.where(h, idx, torch.zeros_like(idx)), 0)[0]
    before = torch.where(start > 0, cs[:, start - 1],
                         torch.zeros_like(cs[:, :1]))
    v = (cs - before) & 0xFFFFFFFF
    v = torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    return v.T.reshape(pts.shape).contiguous()


def fixup_elements(heads: torch.Tensor, lane_k: int = 64) -> int:
    """The elements seg_scan's fix-up reads and writes a second time: in
    each lane's range of lane_k elements, those before its first head (all
    of a range without one)."""
    n = heads.shape[0]
    m = -(-n // lane_k)
    h = torch.ones(m * lane_k, dtype=torch.bool, device=heads.device)
    h[:n] = heads.bool()
    h[0] = True
    h = h.reshape(m, lane_k)
    first = torch.where(h.any(1), h.int().argmax(1), lane_k)
    return int(first.sum())


def _local_heads(heads: torch.Tensor) -> torch.Tensor:
    h = heads.bool().clone()
    h[::K] = True
    return h


def chunk_heads(heads: torch.Tensor, tpc: int) -> torch.Tensor:
    """The heads in each chunk of tpc tiles, position 0 counted: (chunks,)
    int64."""
    h = heads.bool().clone()
    h[0] = True
    per = tpc * TILE
    c = -(-h.shape[0] // per)
    pad = torch.zeros(c * per, dtype=torch.int64, device=h.device)
    pad[:h.shape[0]] = h.long()
    return pad.reshape(c, per).sum(1)


def plain_stage(stage: str, pts: torch.Tensor, heads: torch.Tensor,
                tpc: int = 1):
    """(out, aux) of the stage: copy -> (pts, each chunk's head count, in
    chunks of tpc tiles); local_agg -> (the local pass, the scanned
    aggregates); the rest -> (out, None).  The three-pass scans run
    ec.plain_seg_scan with the kernels' block size, which adds in the
    kernels' order, and the wrapping add is associative and commutative
    limb by limb, so results are equal bit for bit."""
    if stage == "copy":
        return pts.clone(), chunk_heads(heads, tpc)
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

def _local(L, na, x, heads, out, name):
    """The three-pass scan's local pass; returns the per-thread aggregates
    and their head flags."""
    n = x.shape[0]
    T = -(-n // K)
    agg = torch.empty((T, na, 8), dtype=torch.int32, device=x.device)
    flag = torch.empty((T,), dtype=torch.uint8, device=x.device)
    build.check(L.zk_probe_scan_local(na, build.ptr(x),
                                      build.ptr(heads), build.ptr(out),
                                      build.ptr(agg), build.ptr(flag), n, K,
                                      build.stream_ptr(x)), name)
    F.count_launch(name, n)
    return agg, flag


def _scan(L, na, x, heads, out, name, fix=True):
    """The local pass, then the same scan of the aggregates and, if fix,
    the fix-up.  Returns the scanned aggregates."""
    n = x.shape[0]
    agg, flag = _local(L, na, x, heads, out, name)
    if agg.shape[0] > 1:
        _scan(L, na, agg, flag, agg, name)
        if fix:
            build.check(L.zk_probe_scan_fixup(
                na, build.ptr(out), build.ptr(heads), build.ptr(agg),
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
    if stage in SINGLE_PASS:
        return _single_pass(L, stage, na, pts, heads, name)
    out = torch.empty_like(pts)
    if stage == "local":
        _local(L, na, pts, heads, out, name)
        return out, None
    agg = _scan(L, na, pts, heads, out, name, fix=stage != "local_agg")
    return out, (agg if stage == "local_agg" else None)


def copy_tpc(na: int, n: int) -> int:
    """The tiles a chunk of the copy kernel over n points on this card."""
    return int(build.cuda_lib().zk_probe_scan_tpc(na, n))


def _single_pass(L, stage, na, pts, heads, name):
    """One launch of a single-pass stage's kernel (csrc/probes_scan.cu)."""
    n = pts.shape[0]
    scratch = torch.empty(L.zk_probe_scan_bytes(SINGLE_PASS[stage], na, n),
                          dtype=torch.uint8, device=pts.device)
    if stage == "lookback_k32":
        out = torch.empty((1 + int(heads[1:].sum()), na, 8),
                          dtype=torch.int32, device=pts.device)
    else:
        out = torch.empty_like(pts)
    fn = {"copy": L.zk_probe_scan_copy,
          "structure": L.zk_probe_scan_structure,
          "lookback_k32": L.zk_probe_lookback}[stage]
    build.check(fn(na, build.ptr(pts), build.ptr(heads), build.ptr(out),
                   build.ptr(scratch), n, build.stream_ptr(pts)), name)
    F.count_launch(name, n)
    if stage != "copy":
        return out, None
    tiles = -(-n // TILE)
    return out, chunk_counts(scratch, -(-tiles // copy_tpc(na, n)))


def chunk_counts(scratch: torch.Tensor, chunks: int) -> torch.Tensor:
    """The copy kernel's head counts, (chunks,) int64: the scan's count
    words, 8 bytes a chunk from byte 16 of the (uint8) scratch."""
    return scratch[16:16 + 8 * chunks].view(torch.int64).clone()


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
    (copy on the whole stream, structure on its first CHECK_STRUCTURE_N
    points, the others on their first CHECK_N; ``full`` and
    ``lookback_k32`` against ops/ec.seg_scan and seg_sums on the whole
    stream too) and returns the rows."""
    dev = resolve(device)
    means = means or SEGMENT_MEAN
    streams, times = {}, {}
    for curve in ("g1", "g2"):
        n = STREAMS[curve]
        pts, heads = streams[curve] = stream(curve, n, means[curve],
                                             21 + _na(curve), dev)
        # warmed up on the whole stream, so that the timed calls find
        # their outputs' and scratch's blocks in the allocator's cache
        for st in STAGES:
            times[curve, st] = C.time_ms(
                lambda: scan_stage(st, pts, heads), dev, reps=REPS)
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def check():
        rows = []
        for curve in ("g1", "g2"):
            na = _na(curve)
            n = STREAMS[curve]
            pts, heads = streams.pop(curve)
            # the main path's scans on the card, by affine value: they add
            # in another order than the three passes
            full_eq = (_same_points(scan_stage("full", pts, heads)[0],
                                    ec.seg_scan(pts, heads))
                       if dev.type == "cuda" else None)
            sums_eq = (_same_points(scan_stage("lookback_k32", pts, heads)[0],
                                    ec.seg_sums(pts, heads))
                       if dev.type == "cuda" else None)
            t_full = times[curve, "full"]
            for st in STAGES:
                rows.append(_check_row(st, curve, pts, heads, times[curve, st],
                                       t_full, means[curve], full_eq, sums_eq,
                                       dev, log))
            del pts, heads
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        return rows
    return check


def _check_row(st, curve, pts, heads, ms, t_full, mean, full_eq, sums_eq,
               dev, log):
    """Stage st held against its plain version (copy on the whole stream,
    the others on a prefix) and its row."""
    na, n = _na(curve), pts.shape[0]
    s = {"copy": n, "structure": min(CHECK_STRUCTURE_N, n)}.get(
        st, min(CHECK_N, n))
    got = scan_stage(st, pts[:s], heads[:s])
    tpc = copy_tpc(na, s) if st == "copy" and dev.type == "cuda" else 1
    p, plain_ms = C.timed(lambda: plain_stage(st, pts[:s], heads[:s], tpc),
                          dev)
    if st == "lookback_k32":     # another order of adds
        err = max(C.max_abs_err(a, b) for a, b in zip(
            ec.canonical(got[0]), ec.canonical(p[0])))
    else:
        err = max(C.max_abs_err(a, b) for a, b in zip(got, p)
                  if a is not None)
    del got, p
    if st == "full" and full_eq is False:
        err = max(err, 1)
    adds = stage_adds(st, heads)
    name = f"scan_{st}_{curve}"
    extra = {"full_equals_main_kernel": full_eq}
    byts = 2 * na * 32 * n + n
    library_ms = None
    if st in SINGLE_PASS:
        kernel = f"k_{st}_{curve}"
        extra = {"source": SOURCE,
                 "ptxas": next(iter(C.kernel_resources(
                     f"{len(kernel)}{kernel}").values()), None)}
    if st == "structure":
        # the bytes it moves: its fix-up's second pass included
        f = fixup_elements(heads)
        extra["fixup_elements"] = f
        extra["moved_bytes_ms"] = round(
            (byts + 2 * na * 32 * f) / C.HBM_BYTES_PER_S * 1e3, 4)
    if st == "copy":
        extra["tiles_per_chunk"] = tpc
        # one PyTorch call that moves the same points (no head count)
        library_ms = C.time_ms(lambda: pts.clone(), dev, reps=REPS)
    if st == "lookback_k32":
        byts = na * 32 * (2 * n - adds) + n
        extra["equals_seg_sums"] = sums_eq
    r = C.row(name, REPLACES[st], n, ms, plain_ms, s, byts,
              adds * MONTS_PER_ADD[na] * C.MULS_PER_MONT
              / C.INT32_OPS_PER_S, err, library_ms=library_ms, adds=adds,
              segment_mean=mean, heads=int(heads.sum()),
              share_of_full=round(ms / t_full, 4), device=dev.type, **extra)
    log(f"probe {name}: {ms:.3f} ms "
        f"({r['share_of_full']:.3f} of full), {adds} adds, err {err}")
    return r
