// The segmented EC-sum scan in one pass: the pieces every thread runs
// (FF_HD, so g++ runs them in the CPU rehearsal: the lane's pass, the
// lanes' scan, the carries and the look-backs' folds) and, under nvcc, the
// kernel that strings them together over a stream.
//
// A stream of n points with head flags is cut into tiles of kLanes x K
// elements and the tiles into chunks, one warp a chunk, as many chunks as
// the card holds warps at once; lane l of a tile owns the K consecutive
// elements from tile start + l K.  Position 0 counts as a head.  A warp:
//
//   1. counts its chunk's heads and takes the count before it from a
//      decoupled look-back over the chunks before (status words
//      invalid / aggregate / inclusive prefix, a count in the low bits);
//      seg_sums needs it to place each segment's sum at its rank;
//   2. for each tile in turn, streams its points through shared memory, 16
//      bytes a thread with neighbouring lanes on neighbouring addresses
//      (cp.async, two stages), while each lane runs its serial pass: one
//      complete add for each element that is not a head (run_take); then
//      combines the lanes' (head flag, sum after the last head) by a
//      Hillis-Steele scan across the warp in shared memory (hs_round),
//      gives each lane its carry from the tile's lanes before it and the
//      chunk's running prefix (lane_carry), adds it where the lane's
//      elements continue an earlier segment (seg_sums: once, to the lane's
//      one open segment end; seg_scan: to each element before its first
//      head), and extends the running prefix (run_extend);
//   3. publishes its chunk's point: the sum after its last head (the
//      prefix the next chunk needs), or, with no head in it, its aggregate
//      and later its inclusive prefix.  If its first element is no head,
//      it takes the prefix before it by a decoupled look-back that adds up
//      aggregates until it meets a prefix (fold_point), and finishes what
//      waited for it: seg_sums its first segment end, seg_scan the
//      elements before its first head (one add each, of the prefix and the
//      lane's carry together, kept in scratch).
//
// There is no second kernel and no recursion.  Chunk ids come from a
// global counter, so every chunk a chunk waits on is held by a running
// warp.  A segment longer than a chunk costs the look-back one step a
// chunk it spans.
#pragma once

#include "ec.cuh"

// The FF_HD templates below call what they are given (an emitter, an add,
// a word reader); on the card those are device functions.
#if defined(__CUDACC__)
#define SCAN_HD_TEMPLATE _Pragma("nv_exec_check_disable")
#else
#define SCAN_HD_TEMPLATE
#endif

namespace scan {

using ff::Point;
using ff::padd;

// How much of seg_scan's body runs: all of it (the production kernels),
// or a probes' stage (csrc/probes_stages.cu), cut off at compile time.
// kPhaseLocal runs the lanes' serial passes alone, each lane's first
// element taken as a head (no count, no lanes' scan, no carry, no
// look-back); kPhaseAgg runs everything but adding the carries to the
// elements before each lane's first head, and leaves each such lane's
// carry-in in its scratch slot (Scratch::carry, lane l of tile t at
// t kLanes + l).
enum Phase { kPhaseLocal = 0, kPhaseAgg = 1, kPhaseFull = 2 };

// One lane's serial pass over its range.  `acc` is the sum of the current
// segment's elements within the range, `idx` the current segment's index
// in the stream, `open` whether the current segment began before the range,
// and `pre` how many of the range's elements belong to that segment.
template <class E>
struct Run {
  Point<E> acc;
  long long idx;
  uint32_t open;
  uint32_t pre;
};

// The range's first element; `base` counts the heads before the range
// (position 0 included).
template <class E>
FF_HD void run_first(Run<E>& r, const Point<E>& p, bool head,
                     long long base) {
  r.acc = p;
  r.idx = base - 1 + (head ? 1 : 0);
  r.open = head ? 0u : 1u;
  r.pre = r.open;
}

// The complete add, r = p + q (r may alias either), inlined: the pass's
// add, and on the host every add.  On the card one out-of-line copy
// (ColdAdd) serves the adds outside the pass, keeping the kernel to one
// inlined add (inlining the lanes' scan's and seg_scan's fix-up's adds too
// made neither faster and the G2 source's build two and a half times as
// long, PERF.md).  The pieces below take the add as a parameter, so that
// the probes run the same structure over a cheaper one
// (csrc/probes_scan.cu).
struct InlineAdd {
  template <class E>
  FF_HD void operator()(Point<E>& r, const Point<E>& p,
                        const Point<E>& q) const {
    r = padd(p, q);
  }
};

// Every later element of the range.  A head closes the current segment
// first: emit(r) sees its sum in r.acc at index r.idx (partial while
// r.open).
SCAN_HD_TEMPLATE
template <class E, class Emit, class Add>
FF_HD void run_take(Run<E>& r, const Point<E>& p, bool head, Emit& emit,
                    const Add& add) {
  if (head) {
    emit(r);
    r.acc = p;
    r.open = 0;
    ++r.idx;
  } else {
    add(r.acc, r.acc, p);
    r.pre += r.open;
  }
}

// Round d of the lanes' inclusive scan, for lane l.  A lane's span is its
// sum after its last head (all of it if it has none) and a flag: whether it
// holds a head.  (prev, pf) are the spans after the round before, (next,
// nf) after this one: lane l takes in the span d lanes to its left, which
// ends where it begins.
SCAN_HD_TEMPLATE
template <class E, class Add>
FF_HD void hs_round(int l, int d, const Point<E>* prev, const uint32_t* pf,
                    Point<E>* next, uint32_t* nf, const Add& add) {
  if (l >= d && !pf[l]) add(next[l], prev[l - d], prev[l]);
  else next[l] = prev[l];
  nf[l] = pf[l] | (l >= d ? pf[l - d] : 0u);
}

// The carry into lane l from within its chunk: the lanes before it in its
// tile (their inclusive span and flag at l - 1) after `run`, the prefix
// from the chunk's start to the tile (when has_run).  Returns false when
// there is none (lane 0 of a chunk's first tile).
SCAN_HD_TEMPLATE
template <class E, class Add>
FF_HD bool lane_carry(Point<E>& out, int l, const Point<E>* incl,
                      const uint32_t* f, const Point<E>& run, bool has_run,
                      const Add& add) {
  if (l > 0 && f[l - 1]) {
    out = incl[l - 1];
    return true;
  }
  if (l == 0) {
    if (has_run) out = run;
    return has_run;
  }
  if (has_run) add(out, run, incl[l - 1]);
  else out = incl[l - 1];
  return true;
}

// The chunk's running prefix after a tile whose span is (v, f): the sum
// after the chunk's last head, or of all of it while it has none.
SCAN_HD_TEMPLATE
template <class E, class Add>
FF_HD void run_extend(Point<E>& run, bool& has_run, bool& head,
                      const Point<E>& v, bool f, const Add& add) {
  if (f || !has_run) run = v;
  else add(run, run, v);
  has_run = true;
  head = head || f;
}

// Count look-back words: the state in the top two bits, the count below.
const uint64_t kCntAgg = 1ull << 62;    // the tile's own head count
const uint64_t kCntIncl = 2ull << 62;   // heads up to the tile's end
const uint64_t kCntMask = kCntAgg - 1;

// Folds the words of the tiles before one, nearest first (word(i) for
// i < m, none invalid), into excl; true once an inclusive word is reached.
SCAN_HD_TEMPLATE
template <class Get>
FF_HD bool fold_counts(Get& word, int m, uint64_t& excl) {
  for (int i = 0; i < m; ++i) {
    const uint64_t w = word(i);
    excl += w & kCntMask;
    if ((w >> 62) == 2) return true;
  }
  return false;
}

// Point status of a chunk, invalid until it publishes: its aggregate (no
// head in it), its aggregate with a head (that is its prefix too), or the
// inclusive prefix of a chunk with no head.
const uint32_t kPtAgg = 1;
const uint32_t kPtHead = 2;
const uint32_t kPtIncl = 3;

// One step of the point look-back, over the chunk before the ones folded
// so far (nearest first): an aggregate joins the suffix (s, has_s) of
// aggregates after it; a prefix completes x = prefix + suffix.  Returns
// true once x is complete.
SCAN_HD_TEMPLATE
template <class E, class Add>
FF_HD bool fold_point(uint32_t status, const Point<E>& agg,
                      const Point<E>& incl, Point<E>& s, bool& has_s,
                      Point<E>& x, const Add& add) {
  if (status == kPtAgg) {
    if (has_s) add(s, agg, s);
    else s = agg;
    has_s = true;
    return false;
  }
  const Point<E>& p = status == kPtIncl ? incl : agg;
  if (has_s) add(x, p, s);
  else x = p;
  return true;
}

}  // namespace scan

#if defined(__CUDACC__)

namespace scan {

using ff::Fp1;
using ff::Fp2;

const int kLanes = 32;
const unsigned kFull = 0xffffffffu;
enum Mode { kScan = 0, kSums = 1 };

template <class E>
struct Words {
  static const int W = ff::Layout<E>::NA * 8;   // 32-bit words a point
  static const int C = W / 4;                   // 16-byte chunks a point
};

struct Args {
  const uint32_t* in;
  const uint8_t* heads;
  uint32_t* out;
  long long n;
  uint8_t* scratch;
  long long tpc;      // tiles a chunk
};

// Scratch: the chunk counter, one count word and one point status a chunk,
// two published points a chunk (its aggregate, its inclusive prefix), and
// for seg_scan one carry a lane of every tile (those that wait for the
// chunk's prefix).  Sized for a chunk a tile, the most chunks a launch can
// have; only the counter and the status words are reset.
struct Scratch {
  long long chunks, cnt, pst, pay, carry, reset, bytes;
  FF_HD Scratch(long long n, int tile, int words, bool scan) {
    chunks = (n + tile - 1) / tile;
    cnt = 16;
    pst = cnt + 8 * chunks;
    reset = pst + 4 * chunks;
    pay = (reset + 15) / 16 * 16;
    carry = pay + 8ll * words * chunks;
    bytes = carry + (scan ? 4ll * words * kLanes * chunks : 0);
  }
};

// A warp's shared memory, in 32-bit words: two stages of kLanes points (the
// pass's double buffer, then the lanes' scan's two buffers), slots for the
// chunk's running prefix, the look-back's prefix, suffix and one read
// point, the scan's two flag rows, and for seg_scan an output stage.
template <class E, int MODE>
struct WarpSmem {
  static const int W = Words<E>::W;
  static const int stage = kLanes * W;
  static const int run = 2 * stage;
  static const int x = run + W;
  static const int s = x + W;
  static const int tmp = s + W;
  static const int flags = tmp + W;
  static const int ostage = flags + 2 * kLanes;
  static const int words = ostage + (MODE == kScan ? stage : 0);
  static const int bytes = 4 * words;
};

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// The out-of-line add (see InlineAdd): operands and result in memory.
template <class E>
__device__ __noinline__ void padd_cold(Point<E>* r, const Point<E>* p,
                                       const Point<E>* q) {
  const Point<E> x = padd(*p, *q);
  *r = x;
}
struct ColdAdd {
  template <class E>
  __device__ void operator()(Point<E>& r, const Point<E>& p,
                             const Point<E>& q) const {
    padd_cold(&r, &p, &q);
  }
};

// A point between global memory and a shared (or global) slot, 16 bytes a
// move, through L2 only: published points are read by other SMs.
template <class E>
__device__ __forceinline__ void copy_point_cg(uint32_t* dst,
                                              const uint32_t* src) {
  FF_UNROLL
  for (int q = 0; q < Words<E>::C; ++q)
    reinterpret_cast<uint4*>(dst)[q] =
        __ldcg(reinterpret_cast<const uint4*>(src) + q);
}
template <class E>
__device__ __forceinline__ void publish_point(uint32_t* dst,
                                              const uint32_t* src) {
  FF_UNROLL
  for (int q = 0; q < Words<E>::C; ++q)
    __stcg(reinterpret_cast<uint4*>(dst) + q,
           reinterpret_cast<const uint4*>(src)[q]);
}

// Element j of every lane whose bit is set in `lanes` (and which lies in
// the stream), between global memory at point index s0 + l K + j and
// lane l's slot of a shared-memory stage: the warp moves 16 bytes a
// thread, neighbouring threads on neighbouring addresses.
template <class E, int K>
__device__ __forceinline__ void stage_in(uint32_t* stage, const uint32_t* src,
                                         long long s0, int j, long long n,
                                         unsigned lanes, int lane) {
  const int W = Words<E>::W, C = Words<E>::C;
  FF_UNROLL
  for (int k = 0; k < C; ++k) {
    const int c = k * kLanes + lane, l = c / C, q = c % C;
    const long long i = s0 + (long long)l * K + j;
    if (((lanes >> l) & 1u) && i < n)
      cp_async16(stage + l * W + 4 * q, src + i * W + 4 * q);
  }
}
template <class E, int K>
__device__ __forceinline__ void stage_out(uint32_t* dst, const uint32_t* stage,
                                          long long s0, int j, long long n,
                                          unsigned lanes, int lane) {
  const int W = Words<E>::W, C = Words<E>::C;
  FF_UNROLL
  for (int k = 0; k < C; ++k) {
    const int c = k * kLanes + lane, l = c / C, q = c % C;
    const long long i = s0 + (long long)l * K + j;
    if (((lanes >> l) & 1u) && i < n)
      *reinterpret_cast<uint4*>(dst + i * W + 4 * q) =
          *reinterpret_cast<const uint4*>(stage + l * W + 4 * q);
  }
}

// The count look-back of tile t (all lanes): publishes the tile's count,
// returns the heads before the tile, publishes the inclusive count.
__device__ __forceinline__ uint64_t count_lookback(uint64_t* cnt, long long t,
                                                  uint64_t own, int lane) {
  if (lane == 0) st_relaxed(cnt + t, (t == 0 ? kCntIncl : kCntAgg) | own);
  if (t == 0) return 0;
  uint64_t excl = 0;
  for (long long top = t - 1;; top -= kLanes) {
    const long long i = top - lane;
    uint64_t w = i >= 0 ? ld_relaxed(cnt + i) : kCntIncl;
    while (__any_sync(kFull, (w >> 62) == 0)) {
      if ((w >> 62) == 0) {
        __nanosleep(32);
        w = ld_relaxed(cnt + i);
      }
    }
    auto word = [&](int k) { return __shfl_sync(kFull, w, k); };
    if (fold_counts(word, kLanes, excl)) break;
  }
  if (lane == 0) st_relaxed(cnt + t, kCntIncl | (excl + own));
  return excl;
}

// seg_scan's carries: each lane adds `carry` to its first `pre` elements
// of the tile at t0, the warp moving them through `stage` as the pass does.
template <class E, int K, class Add>
__device__ __forceinline__ void fix_up(uint32_t* out, uint32_t* stage,
                                      long long t0, long long n, uint32_t pre,
                                      const Point<E>& carry, int lane,
                                      const Add& add) {
  Point<E>* slot = reinterpret_cast<Point<E>*>(stage);
  __threadfence_block();    // the pass's stores before these reads
  const int len = (int)__reduce_max_sync(kFull, pre);
  for (int j = 0; j < len; ++j) {
    const unsigned now = __ballot_sync(kFull, (uint32_t)j < pre);
    stage_in<E, K>(stage, out, t0, j, n, now, lane);
    cp_commit();
    cp_wait<0>();
    __syncwarp();
    if ((uint32_t)j < pre) add(slot[lane], carry, slot[lane]);
    __syncwarp();
    stage_out<E, K>(out, stage, t0, j, n, now, lane);
    __syncwarp();
  }
}

// The point look-back of chunk c (lane 0): the prefix just before it, into
// the x slot, from the published points of the chunks before it.
template <class E, class Add>
__device__ __forceinline__ void point_lookback(const uint32_t* pst,
                                              const uint32_t* pay, long long c,
                                              uint32_t* smem_x,
                                              uint32_t* smem_s,
                                              uint32_t* smem_tmp,
                                              const Add& add) {
  const int W = Words<E>::W;
  Point<E>& x = *reinterpret_cast<Point<E>*>(smem_x);
  Point<E>& s = *reinterpret_cast<Point<E>*>(smem_s);
  const Point<E>& p = *reinterpret_cast<const Point<E>*>(smem_tmp);
  bool has_s = false;
  for (long long j = c - 1;; --j) {
    uint32_t st;
    while ((st = ld_acquire(pst + j)) == 0) __nanosleep(64);
    copy_point_cg<E>(smem_tmp, pay + (2 * j + (st == kPtIncl ? 1 : 0)) * W);
    if (fold_point(st, p, p, s, has_s, x, add)) return;
  }
}

// One chunk (one warp): tpc tiles of kLanes x K elements in a row, the
// chunk's running prefix carried from each tile to the next; `smem` is
// the warp's own share of shared memory.  Pass is the serial pass's add,
// Add every other.
template <class E, int MODE, int K, class Pass, class Add, int PHASE>
__device__ __forceinline__ void seg_chunk(const Args& a, uint32_t* smem) {
  static_assert(K <= 64, "a lane's heads are one 64-bit mask");
  static_assert(PHASE == kPhaseFull || MODE == kScan,
                "the stages are seg_scan's");
  typedef WarpSmem<E, MODE> S;
  const int W = Words<E>::W;
  const long long tile = kLanes * K;
  const int lane = threadIdx.x & (kLanes - 1);
  const long long n = a.n;
  const long long chunks = ((n + tile - 1) / tile + a.tpc - 1) / a.tpc;
  const Scratch lay(n, tile, W, MODE == kScan);
  uint32_t* counter = reinterpret_cast<uint32_t*>(a.scratch);
  uint64_t* cnt = reinterpret_cast<uint64_t*>(a.scratch + lay.cnt);
  uint32_t* pst = reinterpret_cast<uint32_t*>(a.scratch + lay.pst);
  uint32_t* pay = reinterpret_cast<uint32_t*>(a.scratch + lay.pay);
  // seg_scan: lane l's carry in the chunk's k-th tile, waiting for x
  auto waiting = [&](long long ch, long long k, int l) {
    return reinterpret_cast<Point<E>*>(a.scratch + lay.carry) +
           (ch * a.tpc + k) * kLanes + l;
  };
  auto pts = [&](int buf) {
    return reinterpret_cast<Point<E>*>(smem + (buf & 1) * S::stage);
  };
  Point<E>& run = *reinterpret_cast<Point<E>*>(smem + S::run);
  Point<E>& x = *reinterpret_cast<Point<E>*>(smem + S::x);
  Point<E>* ost = reinterpret_cast<Point<E>*>(smem + S::ostage);
  uint32_t* flags = smem + S::flags;
  const Pass pass;
  const Add add;

  long long c = 0;
  if (lane == 0) c = atomicAdd(counter, 1u);
  c = __shfl_sync(kFull, c, 0);
  if (c >= chunks) return;
  const long long c0 = c * a.tpc * tile;
  const long long c1 = c0 + a.tpc * tile < n ? c0 + a.tpc * tile : n;

  // 1. the chunk's head count, and the heads before it by the look-back
  long long seen = 0;
  if constexpr (PHASE != kPhaseLocal) {
    uint32_t own = 0;
    for (long long i = c0 + lane; i < c1; i += kLanes)
      own += (i == 0 || a.heads[i]) ? 1u : 0u;
    own = __reduce_add_sync(kFull, own);
    seen = (long long)count_lookback(cnt, c, own, lane);
  }

  // 2. the tiles, each: its lanes' passes, their scan, their carries
  const bool open_start = !(c0 == 0 || a.heads[c0]);
  bool head = false, has_run = false;   // the chunk so far
  long long deferred = -1;              // seg_sums: the end that needs x
  long long first_head = c1;            // seg_scan: where x stops
  for (long long t0 = c0; t0 < c1; t0 += tile) {
    const long long s = t0 + (long long)lane * K;
    stage_in<E, K>(smem, a.in, t0, 0, n, kFull, lane);
    cp_commit();
    uint64_t mask = 0;
    for (int j = 0; j < K; ++j)
      if (s + j < n && (s + j == 0 || a.heads[s + j])) mask |= 1ull << j;
    const long long e = s + K < n ? s + K : n;
    const bool seg_end = e >= n || a.heads[e];
    const uint32_t mine = __popcll(mask);
    uint32_t incl = mine;
    for (int d = 1; d < kLanes; d <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const long long base = seen + incl - mine;
    seen += __shfl_sync(kFull, incl, kLanes - 1);
    if (!head) {
      const unsigned any = __ballot_sync(kFull, mask != 0);
      if (any) {
        const int l = __ffs(any) - 1;
        const uint64_t m = __shfl_sync(kFull, mask, l);
        const long long h = t0 + (long long)l * K + __ffsll(m) - 1;
        if (h < first_head) first_head = h;
      }
    }

    // the serial pass, the next stage loading while this one is added
    Run<E> r;
    r.acc = Point<E>{};
    r.idx = base - 1;
    r.open = 0;
    r.pre = 0;
    bool open_sum = false;  // seg_sums: wrote its open segment's partial sum
    auto emit = [&](const Run<E>& y) {
      if constexpr (MODE == kSums) {
        *reinterpret_cast<Point<E>*>(a.out + y.idx * W) = y.acc;
        open_sum |= y.open != 0;
      }
    };
    for (int j = 0; j < K; ++j) {
      if (j + 1 < K)
        stage_in<E, K>(smem + ((j + 1) & 1) * S::stage, a.in, t0, j + 1, n,
                       kFull, lane);
      cp_commit();
      cp_wait<1>();
      __syncwarp();
      if (s + j < n) {
        const Point<E>& p = pts(j)[lane];
        const bool h = (mask >> j) & 1;
        if (j == 0) run_first(r, p, PHASE == kPhaseLocal || h, base);
        else run_take(r, p, h, emit, pass);
        if constexpr (MODE == kScan) ost[lane] = r.acc;
      }
      __syncwarp();
      if constexpr (MODE == kScan) {
        stage_out<E, K>(a.out, smem + S::ostage, t0, j, n, kFull, lane);
        __syncwarp();
      }
    }
    if (s < n && seg_end) emit(r);
    cp_wait<0>();
    if constexpr (PHASE == kPhaseLocal) continue;

    // the lanes' inclusive scan in shared memory
    pts(0)[lane] = r.acc;
    flags[lane] = (s >= n || !r.open) ? 1u : 0u;
    int cur = 0;
    for (int d = 1; d < kLanes; d <<= 1, cur ^= 1) {
      __syncwarp();
      hs_round(lane, d, pts(cur), flags + cur * kLanes, pts(cur ^ 1),
               flags + (cur ^ 1) * kLanes, add);
    }
    __syncwarp();
    const Point<E>* span = pts(cur);
    const uint32_t* sf = flags + cur * kLanes;

    // the carry where a lane's elements continue an earlier segment, in the
    // lane's slot of the free scan buffer; without x while the chunk has
    // shown no head (its first segment began before it)
    Point<E>& cy = pts(cur ^ 1)[lane];
    const bool done = head || (lane > 0 && sf[lane - 1]);
    if constexpr (MODE == kSums) {
      if (open_sum) {
        Point<E>* o = reinterpret_cast<Point<E>*>(a.out + (base - 1) * W);
        if (lane_carry(cy, lane, span, sf, run, has_run, add)) add(*o, cy, *o);
        if (!done) deferred = base - 1;
      }
    } else {
      // a carry without x waits in scratch: the element gets one add, at the
      // end, of x and it together
      bool has = r.pre && lane_carry(cy, lane, span, sf, run, has_run, add);
      if constexpr (PHASE == kPhaseAgg) {
        if (has) *waiting(c, (t0 - c0) / tile, lane) = cy;
      } else {
        if (has && !done) {
          *waiting(c, (t0 - c0) / tile, lane) = cy;
          has = false;
        }
        fix_up<E, K>(a.out, smem + S::ostage, t0, n, has ? r.pre : 0u, cy,
                     lane, add);
      }
    }
    __syncwarp();
    if (lane == kLanes - 1)
      run_extend(run, has_run, head, span[kLanes - 1], sf[kLanes - 1] != 0,
                 add);
    has_run = true;
    head = __shfl_sync(kFull, (uint32_t)head, kLanes - 1) != 0;
    __syncwarp();
  }
  if constexpr (PHASE == kPhaseLocal) return;
  deferred = __reduce_max_sync(kFull, (unsigned)(deferred + 1)) - 1ll;

  // 3. publish the chunk's point; if it began inside a segment, take the
  // prefix before it and finish what waited for it
  if (lane == 0) {
    publish_point<E>(pay + 2 * c * W, smem + S::run);
    __threadfence();
    st_release(pst + c, head ? kPtHead : kPtAgg);
  }
  if (!open_start) return;
  if (lane == 0) {
    point_lookback<E>(pst, pay, c, smem + S::x, smem + S::s, smem + S::tmp,
                      add);
    if (!head) {
      add(*reinterpret_cast<Point<E>*>(pay + (2 * c + 1) * W), x, run);
      __threadfence();
      st_release(pst + c, kPtIncl);
    }
  }
  __syncwarp();
  if constexpr (MODE == kSums) {
    if (lane == 0 && deferred >= 0) {
      Point<E>* o = reinterpret_cast<Point<E>*>(a.out + deferred * W);
      add(*o, x, *o);
    }
  } else {
    Point<E>& cx = pts(0)[lane];
    for (long long t0 = c0; t0 < first_head; t0 += tile) {
      const long long s = t0 + (long long)lane * K;
      const long long e = s + K < first_head ? s + K : first_head;
      const uint32_t pre = e > s ? (uint32_t)(e - s) : 0u;
      if (pre) {
        if (t0 == c0 && lane == 0) cx = x;
        else add(cx, x, *waiting(c, (t0 - c0) / tile, lane));
      }
      if constexpr (PHASE == kPhaseAgg) {
        if (pre) *waiting(c, (t0 - c0) / tile, lane) = cx;
      } else {
        fix_up<E, K>(a.out, smem + S::ostage, t0, n, pre, cx, lane, add);
      }
    }
  }
}

template <class E, int MODE, int K, class Pass = InlineAdd,
          class Add = ColdAdd, int PHASE = kPhaseFull>
__device__ __forceinline__ void seg_kernel_body(const Args& a) {
  extern __shared__ uint4 seg_smem[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(seg_smem) +
                   (threadIdx.x / kLanes) * WarpSmem<E, MODE>::words;
  seg_chunk<E, MODE, K, Pass, Add, PHASE>(a, smem);
}

template <class E>
inline long long scratch_bytes(long long n, int K, bool scan) {
  return Scratch(n, kLanes * K, Words<E>::W, scan).bytes;
}

// Tiles a chunk over a stream of `tiles` tiles: as many warps as the card
// holds at once (fewer for a short stream), each a chunk of whole tiles, so
// that a segment longer than a chunk makes a look-back chain one link a
// chunk, not one a tile.
template <class E, int MODE, int WARPS>
long long tiles_per_chunk(void (*kernel)(Args), long long tiles) {
  const int smem = WARPS * WarpSmem<E, MODE>::bytes;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                WARPS * kLanes, smem);
  const long long warps = (long long)(per_sm > 0 ? per_sm : 1) * sms * WARPS;
  return (tiles + warps - 1) / warps;
}

// Resets the scratch's counter and status words on the stream, then
// launches one warp a chunk of tiles_per_chunk tiles.
template <class E, int MODE, int K, int WARPS>
int launch(void (*kernel)(Args), Args a, void* stream) {
  const Scratch lay(a.n, kLanes * K, Words<E>::W, MODE == kScan);
  const long long tiles = lay.chunks;
  if (tiles == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  a.tpc = tiles_per_chunk<E, MODE, WARPS>(kernel, tiles);
  const long long chunks = (tiles + a.tpc - 1) / a.tpc;
  cudaMemsetAsync(a.scratch, 0, (size_t)lay.reset, st);
  kernel<<<(unsigned)((chunks + WARPS - 1) / WARPS), WARPS * kLanes,
           WARPS * WarpSmem<E, MODE>::bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace scan

#endif  // __CUDACC__
