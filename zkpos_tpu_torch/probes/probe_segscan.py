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

Stages 6-8 run seg_scan's own body (csrc/seg_scan.cuh) with its
production adds, cut off by a compile-time phase (csrc/probes_stages.cu,
probes_stages_g2.cu):

* ``local``: the lanes' serial passes alone, each lane's first element
  taken as a head (stage 6), held bit for bit against ops/ec.plain_seg_scan
  with every lane start a head;
* ``local_agg``: everything but adding the carries to the elements before
  each lane's first head (stage 7): the count look-back, the lanes' scan,
  the carries, the chunk look-back; its second output is each lane's
  carry-in, held by affine value against the full scan at the element
  before the lane (on the card: lane_carries on the wide prefix, and
  seg_scan itself on the whole stream);
* ``full``: seg_scan itself (stage 8): ops/ec.seg_scan's k_seg_scan_g1 /
  g2, no copy of them, counted as ``seg_scan_<curve>``;
* ``three_pass``: the port's first scan, three passes on the complete add
  (csrc/probes.cu: a serial local pass of K = 16 elements a thread, the
  recursive scan of the per-thread aggregates, the fix-up), the yardstick
  of the single pass that replaced it, held against ops/ec.seg_scan by
  affine value.

Streams: the prove path's sizes, G1 at 30,795,264 and G2 at 42,343,488
points (the witness streams of its A and B MSMs), points drawn from a pool
of valid points, heads from a seeded Bernoulli pattern with the streams'
mean segment length (SEGMENT_MEAN, which chip_smoke.py measures on the
path's own streams and passes in).  Bound: complete adds (12 Montgomery
products in G1, its two by 3b = 9 being doublings; 42 in G2) at the INT32
rate -- for full, three_pass and the segment sums the function's own (one
for each element that is not a head), for local and local_agg those their
design makes on this head pattern (stage_adds; full's design_adds beside
its bound, the fix-up's included) -- or the stream's bytes
(copy and structure: its points read and written and its heads read).
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
LANE_K = 64     # elements a lane of the single pass
LANES = 32      # lanes a tile
TILE = LANES * LANE_K
STAGES = ("copy", "structure", "local", "local_agg", "full", "three_pass",
          "lookback_k32")
REPLACES = {"copy": "scripts/probe_segscan.py:19",
            "structure": "scripts/probe_segscan.py:19",
            "local": "scripts/probe_segscan.py:101",
            "local_agg": "scripts/probe_segscan.py:101",
            "full": "scripts/probe_segscan.py:101",
            "three_pass": "scripts/probe_segscan.py:101",
            "lookback_k32": "zkpos_tpu/ops/ec_pallas.py:268"}
# the single-pass probes of csrc/probes_scan.cu and the zk_probe_scan_bytes
# stage numbers of their scratch; seg_scan's stages (csrc/probes_stages.cu)
# and their scan::Phase
SINGLE_PASS = {"copy": 0, "structure": 1, "lookback_k32": 2}
PHASES = {"local": 0, "local_agg": 1}
SOURCES = {"copy": "zkpos_tpu_torch/csrc/probes_scan.cu",
           "structure": "zkpos_tpu_torch/csrc/probes_scan.cu",
           "lookback_k32": "zkpos_tpu_torch/csrc/probes_scan.cu",
           "local": "zkpos_tpu_torch/csrc/probes_stages.cu",
           "local_agg": "zkpos_tpu_torch/csrc/probes_stages.cu",
           "full": "zkpos_tpu_torch/csrc/seg_scan.cu",
           "three_pass": "zkpos_tpu_torch/csrc/probes.cu"}
STREAMS = {"g1": 30_795_264, "g2": 42_343_488}
# mean segment length of the prove path's A (G1) and B (G2) witness
# streams, as chip_smoke.py measures them on the card (PERF.md, section 4)
SEGMENT_MEAN = {"g1": 31.5, "g2": 492.3}
MONTS_PER_ADD = {3: 12, 6: 42}
CHECK_N = K ** 4        # a prefix the plain versions check: whole blocks
# the single pass's stages' prefix (structure, local, local_agg): past the
# card's resident warps, so chunks of two tiles or more and look-backs
# across them (copy is checked whole; on the card local and local_agg on
# the shortest such prefix, wide_prefix)
CHECK_WIDE_N = 1 << 23
WIDE = ("structure", "local", "local_agg")
REPS = 3                # timed launches of each stage


def _na(curve: str) -> int:
    return 3 if curve == "g1" else 6


def source(stage: str, curve: str) -> str:
    """The source of the stage's kernel for the curve."""
    src = SOURCES[stage]
    if curve == "g2" and stage in ("local", "local_agg", "full"):
        return src.replace(".cu", "_g2.cu")
    return src


def launch_name(stage: str, curve: str) -> str:
    """The name the stage's launches are counted under: ``full`` is
    ops/ec.seg_scan's kernel, counted by its own wrapper."""
    return f"{'seg_scan' if stage == 'full' else 'scan_' + stage}_{curve}"


def kernel(stage: str, curve: str) -> str:
    """A part of the mangled name of the stage's kernel, as ptxas gives
    it."""
    if stage == "full":
        return f"13k_seg_scan_{curve}E"
    if stage == "three_pass":
        return f"12k_scan_localIN2ff3Fp{1 if curve == 'g1' else 2}E"
    k = f"k_{stage}_{curve}"
    return f"{len(k)}{k}E"


# --- plain versions -----------------------------------------------------------

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


def _lanes(heads: torch.Tensor, lane_k: int) -> torch.Tensor:
    """The heads as (lanes, lane_k) bool, position 0 counted, the last
    lane padded with heads."""
    n = heads.shape[0]
    m = -(-n // lane_k)
    h = torch.ones(m * lane_k, dtype=torch.bool, device=heads.device)
    h[:n] = heads.bool()
    h[0] = True
    return h.reshape(m, lane_k)


def fixup_elements(heads: torch.Tensor, lane_k: int = LANE_K) -> int:
    """The elements seg_scan's fix-up reads and writes a second time: in
    each lane's range of lane_k elements, those before its first head (all
    of a range without one)."""
    h = _lanes(heads, lane_k)
    first = torch.where(h.any(1), h.int().argmax(1), lane_k)
    return int(first.sum())


def lane_heads(heads: torch.Tensor, lane_k: int = LANE_K) -> torch.Tensor:
    """The heads with every lane's first element a head."""
    h = heads.bool().clone()
    h[::lane_k] = True
    return h


def open_lanes(heads: torch.Tensor, lane_k: int = LANE_K) -> torch.Tensor:
    """(lanes,) bool: the lanes whose first element is no head, which
    continue a segment from before them and so have a carry-in."""
    return ~_lanes(heads, lane_k)[:, 0]


def plain_carries(full: torch.Tensor, heads: torch.Tensor,
                  lane_k: int = LANE_K) -> torch.Tensor:
    """Each lane's carry-in from the full scan: the scan at the element
    before an open lane's start, the zero row for every other lane."""
    m = -(-full.shape[0] // lane_k)
    out = torch.zeros((m,) + tuple(full.shape[1:]), dtype=full.dtype,
                      device=full.device)
    o = open_lanes(heads, lane_k)
    starts = torch.arange(m, device=full.device) * lane_k
    out[o] = full[starts[o] - 1]
    return out


def lane_carries(local: torch.Tensor, heads: torch.Tensor,
                 lane_k: int = LANE_K) -> torch.Tensor:
    """plain_carries from the lanes' passes (plain_stage's local output)
    in place of the full scan: the segmented scan over the lanes of each
    lane's last element (its sum from its last head, or from its start),
    a lane that holds a head starting a segment, taken at the lane before
    each open lane; the zero row for every other lane.  Equal to
    plain_carries by affine value, at the memory of a scan of one point a
    lane."""
    n = local.shape[0]
    m = -(-n // lane_k)
    ends = (torch.arange(m, device=local.device) * lane_k
            + lane_k - 1).clamp(max=n - 1)
    lanes = ec.plain_seg_scan(local[ends].contiguous(),
                              _lanes(heads, lane_k).any(1).to(torch.uint8))
    out = torch.zeros_like(lanes)
    o = open_lanes(heads, lane_k)
    at = o.nonzero()[:, 0]
    out[at] = lanes[at - 1]
    return out


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
                tpc: int = 1, lane_k: int = LANE_K):
    """(out, aux) of the stage: copy -> (pts, each chunk's head count, in
    chunks of tpc tiles); local_agg -> (the lanes' passes, each lane's
    carry-in, plain_carries); the rest -> (out, None).  local runs
    ec.plain_seg_scan with lanes of lane_k elements, each started by a
    head, and three_pass with the kernels' block size: each adds in the
    kernel's order, so results are equal bit for bit (structure too: the
    wrapping add is associative and commutative limb by limb)."""
    if stage == "copy":
        return pts.clone(), chunk_heads(heads, tpc)
    if stage == "structure":
        return _wrap_scan(pts, heads), None
    if stage == "full":
        return ec.plain_seg_scan(pts, heads), None
    if stage == "three_pass":
        return ec.plain_seg_scan(pts, heads, K), None
    if stage == "lookback_k32":
        return ec.plain_seg_sums(pts, heads), None
    out = ec.plain_seg_scan(pts, lane_heads(heads, lane_k), lane_k)
    if stage == "local":
        return out, None
    return out, plain_carries(ec.plain_seg_scan(pts, heads), heads, lane_k)


# --- the stages on the card ---------------------------------------------------------

def _three_pass(L, na, x, heads, out, name):
    """The three-pass scan: the local pass (K elements a thread), the same
    scan of the per-thread aggregates, the fix-up.  Returns the scanned
    aggregates."""
    n = x.shape[0]
    T = -(-n // K)
    agg = torch.empty((T, na, 8), dtype=torch.int32, device=x.device)
    flag = torch.empty((T,), dtype=torch.uint8, device=x.device)
    build.check(L.zk_probe_scan_local(na, build.ptr(x),
                                      build.ptr(heads), build.ptr(out),
                                      build.ptr(agg), build.ptr(flag), n, K,
                                      build.stream_ptr(x)), name)
    F.count_launch(name, n)
    if T > 1:
        _three_pass(L, na, agg, flag, agg, name)
        build.check(L.zk_probe_scan_fixup(
            na, build.ptr(out), build.ptr(heads), build.ptr(agg),
            n, K, build.stream_ptr(x)), name)
        F.count_launch(name, n)
    return agg


def scan_stage(stage: str, pts: torch.Tensor, heads: torch.Tensor):
    """The stage's kernels on the card (counted as launch_name(stage,
    curve)), plain_stage on the CPU; returns what plain_stage returns.
    pts (N, 3|6, 8) int32, heads (N,) uint8."""
    ec._check_pts(pts)
    if heads.shape != (pts.shape[0],) or heads.dtype != torch.uint8:
        raise ValueError("heads must be (N,) uint8")
    if C.check_device(pts, heads) == "cpu":
        return plain_stage(stage, pts, heads)
    na = pts.shape[1]
    name = launch_name(stage, "g1" if na == 3 else "g2")
    if stage == "full":
        return ec.seg_scan(pts, heads), None
    L = build.cuda_lib()
    if stage in SINGLE_PASS:
        return _single_pass(L, stage, na, pts, heads, name)
    if stage in PHASES:
        return _phase(L, stage, na, pts, heads, name)
    out = torch.empty_like(pts)
    _three_pass(L, na, pts, heads, out, name)
    return out, None


def _phase(L, stage, na, pts, heads, name):
    """One launch of a stage of seg_scan (csrc/probes_stages.cu); local_agg
    returns the carry-in of every open lane (open_lanes) from its scratch,
    zero rows for the others."""
    n = pts.shape[0]
    out = torch.empty_like(pts)
    scratch = torch.empty(L.zk_probe_stage_bytes(na, n), dtype=torch.uint8,
                          device=pts.device)
    build.check(L.zk_probe_scan_stage(
        PHASES[stage], na, build.ptr(pts), build.ptr(heads), build.ptr(out),
        build.ptr(scratch), n, build.stream_ptr(pts)), name)
    F.count_launch(name, n)
    if stage == "local":
        return out, None
    m = -(-n // LANE_K)
    at = L.zk_probe_stage_carries(na, n)
    carries = scratch[at:at + m * na * 32].view(torch.int32).view(m, na, 8)
    o = open_lanes(heads).view(m, 1, 1)
    return out, torch.where(o, carries, torch.zeros_like(carries))


def stage_tpc(stage: str, na: int, n: int) -> int:
    """The tiles a chunk of the stage's kernel over n points on this card:
    copy's, or the seg_scan stages' (full's taken as local_agg's: the
    same body, launch bounds and shared memory)."""
    L = build.cuda_lib()
    if stage == "copy":
        return int(L.zk_probe_scan_tpc(na, n))
    return int(L.zk_probe_stage_tpc(int(stage != "local"), na, n))


def wide_prefix(stage: str, na: int, n: int) -> int:
    """The shortest prefix of whole tiles, at most n points, on which the
    stage's kernel runs chunks of two tiles on this card: a tile past its
    resident warps.  (Its plain version adds about a million G1 points a
    second, so the check takes no more.)"""
    lo, hi = 1, -(-n // TILE)
    if stage_tpc(stage, na, n) < 2:
        return n
    while lo < hi:
        mid = (lo + hi) // 2
        if stage_tpc(stage, na, mid * TILE) >= 2:
            hi = mid
        else:
            lo = mid + 1
    return min(n, lo * TILE)


def _single_pass(L, stage, na, pts, heads, name):
    """One launch of a single-pass probe's kernel (csrc/probes_scan.cu)."""
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
    return out, chunk_counts(scratch, -(-tiles // stage_tpc(stage, na, n)))


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


def stage_adds(stage: str, heads: torch.Tensor, tpc: int = 1,
               lane_k: int = LANE_K, lanes: int = LANES) -> int:
    """Complete adds on this head pattern.  copy and structure make none;
    three_pass and lookback_k32 are counted by the function's own work (one
    add for each element that is not a head); the single pass's stages by
    what its design makes over tiles of `lanes` x lane_k elements in chunks
    of tpc tiles (csrc/seg_scan.cuh):

    * local: one add for each element that is neither a head nor a lane's
      first;
    * local_agg: those, the lanes' Hillis-Steele rounds (lane l >= d adds
      in round d while its span holds no head), each carry that joins the
      chunk's running prefix to the lanes before it (lane_carry), each
      extension of that prefix by a tile without a head (run_extend), and
      for each chunk that starts inside a segment its inclusive prefix (when
      it holds no head) and one add for each of its lanes before its first
      head but its first lane (the carry joined with the prefix before the
      chunk).  The look-back is counted at its least, one step: a fold over
      chunks that have not yet published their prefix adds more;
    * full: local_agg's and one add for each element before its lane's
      first head (fixup_elements)."""
    n = heads.shape[0]
    if stage in ("copy", "structure"):
        return 0
    if stage in ("three_pass", "lookback_k32"):   # the function's own work
        return n - 1 - int(heads[1:].bool().sum())
    h = _lanes(heads, lane_k)
    first = torch.arange(h.numel(), device=h.device) % lane_k == 0
    local = int((~h.reshape(-1)[:n] & ~first[:n]).sum())
    if stage == "local":
        return local
    m = h.shape[0]
    T = -(-m // lanes)
    has = torch.ones(T * lanes, dtype=torch.bool, device=h.device)
    has[:m] = h.any(1)                 # lanes past the stream count as flagged
    opened = torch.zeros(T * lanes, dtype=torch.bool, device=h.device)
    opened[:m] = ~h[:, 0]
    has, opened = has.reshape(T, lanes), opened.reshape(T, lanes)
    lane = torch.arange(lanes, device=h.device)
    total, f = local, has
    d = 1
    while d < lanes:
        total += int(((lane >= d) & ~f).sum())
        g = f.clone()
        g[:, d:] |= f[:, :-d]
        f, d = g, d * 2
    later = torch.arange(T, device=h.device) % tpc != 0   # has_run
    total += int((opened[:, 1:] & ~f[:, :-1] & later[:, None]).sum())
    total += int((later & ~f[:, -1]).sum())
    # chunks that start inside a segment: their lanes that start before
    # the chunk's first head (lanes past the stream count as started by one)
    chunk = tpc * lanes
    c = -(-m // chunk)
    real = torch.zeros(c * chunk, dtype=torch.bool, device=h.device)
    real[:m] = h.any(1)
    hc = torch.ones(c * chunk, dtype=torch.bool, device=h.device)
    hc[:m] = real[:m]
    sc = torch.ones(c * chunk, dtype=torch.bool, device=h.device)
    sc[:m] = h[:, 0]
    real, hc, sc = (x.reshape(c, chunk) for x in (real, hc, sc))
    before = (torch.cumsum(hc.int(), 1) == 0).sum(1)
    at = before.clamp(max=chunk - 1)
    waiting = before + ((before < chunk)
                        & ~sc.gather(1, at[:, None])[:, 0]).long() - 1
    starts_open = ~sc[:, 0]
    total += int(waiting[starts_open].sum())
    total += int((starts_open & ~real.any(1)).sum())
    if stage == "local_agg":
        return total
    return total + fixup_elements(heads, lane_k)


def run(device=None, means=None, log=print):
    """Times every stage over a G1 and a G2 stream of the prove path's
    sizes (means: {curve: mean segment length}, SEGMENT_MEAN by default)
    and returns ``check``, which holds each stage against its plain version
    (copy on the whole stream, the stages of WIDE on their first
    CHECK_WIDE_N points, the others on their first CHECK_N) and, on the
    card, the
    stages on the whole stream against ops/ec.seg_scan and seg_sums
    (three_pass and local_agg's carries by affine value, local_agg's
    elements against local's bit for bit), and returns the rows."""
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
            pts, heads = streams.pop(curve)
            flags = (_main_kernel_flags(pts, heads) if dev.type == "cuda"
                     else {})
            plain = {}
            for st in STAGES:
                tpc = (stage_tpc(st, _na(curve), pts.shape[0])
                       if dev.type == "cuda" and st != "structure" else 1)
                rows.append(_check_row(st, curve, pts, heads, times, tpc,
                                       means[curve], flags.get(st, {}),
                                       plain, dev, log))
            del pts, heads
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        return rows
    return check


def _main_kernel_flags(pts, heads):
    """The stages on the whole stream beside the main path's scans:
    three_pass against seg_scan and lookback_k32 against seg_sums by
    affine value; local_agg's elements against local's, bit for bit, and
    its carries against seg_scan at the element before each open lane."""
    full = ec.seg_scan(pts, heads)
    flags = {"three_pass": {"full_equals_main_kernel": _same_points(
        scan_stage("three_pass", pts, heads)[0], full)}}
    carries = plain_carries(full, heads)
    del full
    out, got = scan_stage("local_agg", pts, heads)
    flags["local_agg"] = {
        "carries_equal_main_kernel": _same_points(got, carries),
        "elements_equal_local": torch.equal(
            out, scan_stage("local", pts, heads)[0])}
    del out, got, carries
    flags["lookback_k32"] = {"equals_seg_sums": _same_points(
        scan_stage("lookback_k32", pts, heads)[0], ec.seg_sums(pts, heads))}
    return flags


def _err(st, got, p):
    """The stage's error against its plain version: exact, but by affine
    value where the kernel adds in another order (full, lookback_k32, and
    local_agg's carries)."""
    def affine(a, b):
        return max(C.max_abs_err(x, y)
                   for x, y in zip(ec.canonical(a), ec.canonical(b)))
    if st in ("full", "lookback_k32"):
        return affine(got[0], p[0])
    err = C.max_abs_err(got[0], p[0])
    if st == "local_agg":
        err = max(err, affine(got[1], p[1]))
    elif st == "copy":
        err = max(err, C.max_abs_err(got[1], p[1]))
    return err


def _plain(st, pts, heads, tpc, dev, memo):
    """(plain_stage's result, its milliseconds), the stages of a curve
    sharing through memo, by stage and prefix: local_agg's from local's,
    its carries by lane_carries (the full scan's plain version takes tens
    of GB at the wide prefix); full's and lookback_k32's, which are held
    by affine value, from three_pass's (the same scan, added in another
    order)."""
    if st == "local_agg":
        (out, _), ms_l = _plain("local", pts, heads, tpc, dev, memo)
        carries, ms_c = C.timed(lambda: lane_carries(out, heads), dev)
        return (out, carries), ms_l + ms_c
    if st in ("full", "lookback_k32"):
        (out, _), ms = _plain("three_pass", pts, heads, tpc, dev, memo)
        if st == "full":
            return (out, None), ms
        end = torch.ones(out.shape[0], dtype=torch.bool, device=out.device)
        end[:-1] = heads[1:].bool()
        return (out[end].contiguous(), None), ms
    key = st, pts.shape[0]
    if key not in memo:
        memo[key] = C.timed(lambda: plain_stage(st, pts, heads, tpc), dev)
    return memo[key]


def _check_row(st, curve, pts, heads, times, tpc, mean, flags, plain, dev,
               log):
    """Stage st held against its plain version (copy on the whole stream,
    the others on a prefix; plain shares the plain versions among a
    curve's stages) and its row.  On the card local and local_agg must run
    chunks of two tiles or more on their prefix (check_tiles_per_chunk).
    full's bound counts the function's adds, one for each element that is
    not a head, as three_pass's does; its design's (stage_adds: the
    fix-up's included) are design_adds and design_ops_ms, outside the
    bound."""
    na, n = _na(curve), pts.shape[0]
    if st == "copy":
        s = n
    elif st in PHASES and dev.type == "cuda":
        s = max(wide_prefix(x, na, n) for x in PHASES)
    else:
        s = min(CHECK_WIDE_N if st in WIDE else CHECK_N, n)
    got = scan_stage(st, pts[:s], heads[:s])
    ptpc = stage_tpc(st, na, s) if st == "copy" and dev.type == "cuda" else 1
    p, plain_ms = _plain(st, pts[:s], heads[:s], ptpc, dev, plain)
    err = _err(st, got, p)
    del got, p
    if st in PHASES and dev.type == "cuda":
        flags = dict(flags, check_tiles_per_chunk=stage_tpc(st, na, s))
        flags["check_spans_chunks"] = flags["check_tiles_per_chunk"] >= 2
    for k, v in flags.items():
        if v is False:
            err = max(err, 1)
    adds = stage_adds("three_pass" if st == "full" else st, heads, tpc)
    byts = 2 * na * 32 * n + n
    if st == "local_agg":           # and each lane's carry-in
        byts += na * 32 * -(-n // LANE_K)
    if st == "lookback_k32":
        byts = na * 32 * (2 * n - adds) + n
    ms = times[curve, st]
    k = kernel(st, curve)
    extra = dict(flags, source=source(st, curve), ptxas=next(iter(
        C.kernel_resources(k).values()), None))
    if st in ("structure", "full"):
        # the elements that the fix-up reads and writes a second time
        f = fixup_elements(heads)
        extra["fixup_elements"] = f
        extra["moved_bytes_ms"] = round(
            (byts + 2 * na * 32 * f) / C.HBM_BYTES_PER_S * 1e3, 4)
    if st != "structure":
        extra["tiles_per_chunk"] = tpc
    if st == "full":
        extra["counted_as"] = launch_name(st, curve)
        d = extra["design_adds"] = stage_adds(st, heads, tpc)
        extra["design_ops_ms"] = round(
            d * MONTS_PER_ADD[na] * C.MULS_PER_MONT / C.INT32_OPS_PER_S * 1e3,
            4)
    library_ms = None
    if st == "copy":
        # one PyTorch call that moves the same points (no head count)
        library_ms = C.time_ms(lambda: pts.clone(), dev, reps=REPS)
    ops_s = adds * MONTS_PER_ADD[na] * C.MULS_PER_MONT / C.INT32_OPS_PER_S
    r = C.row(f"scan_{st}_{curve}", REPLACES[st], n, ms, plain_ms, s, byts,
              ops_s, err, library_ms=library_ms, adds=adds,
              bytes_ms=round(byts / C.HBM_BYTES_PER_S * 1e3, 4),
              ops_ms=round(ops_s * 1e3, 4), segment_mean=mean,
              heads=int(heads.sum()),
              share_of_full=round(ms / times[curve, "full"], 4),
              device=dev.type, **extra)
    log(f"probe {r['name']}: {ms:.3f} ms "
        f"({r['share_of_full']:.3f} of full), {adds} adds, bound "
        f"{r['bound_ms']:.3f} ms, err {err}")
    return r
