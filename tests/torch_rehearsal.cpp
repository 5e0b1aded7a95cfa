// CPU rehearsal of the port's device arithmetic: the same headers the CUDA
// kernels include (fp_ec.cuh's carry-chain primitives in their C++ forms),
// compiled by g++ into a small shared library that
// tests/test_torch_rehearsal.py drives through ctypes.  It is a test aid,
// not a path of the port.
#include "field.cuh"
#include "csr.cuh"
#include "ec.cuh"
#include "poseidon.cuh"
#include "probes.cuh"
#include "seg_scan.cuh"

#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

using namespace ff;

namespace {

// --- a warp on the host: one thread per lane --------------------------------

class Barrier {
 public:
  explicit Barrier(int n) : n_(n) {}
  void wait() {
    std::unique_lock<std::mutex> lk(m_);
    const long gen = gen_;
    if (++waiting_ == n_) {
      waiting_ = 0;
      ++gen_;
      cv_.notify_all();
    } else {
      cv_.wait(lk, [&] { return gen_ != gen; });
    }
  }

 private:
  std::mutex m_;
  std::condition_variable cv_;
  const int n_;
  int waiting_ = 0;
  long gen_ = 0;
};

// The exchanges poseidon.cuh's warp schedule asks of W, for the lane
// `lane` of a warp whose lanes are host threads: the barrier stands for
// __syncwarp, and the broadcast and the sum go through `slots` where the
// card uses shuffles.
struct HostLanes {
  Barrier bar{pos::kLanes};
  uint32_t state[pos::kMaxWidth][8];
  uint32_t parts[2 * pos::kLanes][8];
  uint32_t slots[pos::kLanes][8];
};

struct HostExchange {
  HostLanes* h;
  int lane;
  uint32_t* state;
  uint32_t* parts;
  void sync() { h->bar.wait(); }
  void bcast(uint32_t* v, const uint32_t* x) {
    if (lane == 0) pos::copy8(h->slots[0], x);
    sync();
    pos::copy8(v, h->slots[0]);
    sync();
  }
  void sum(uint32_t* s, const uint32_t* c, int) {
    pos::copy8(h->slots[lane], c);
    sync();
    pos::zero8(s);
    for (int l = 0; l < pos::kLanes; ++l) add<Fr>(s, s, h->slots[l]);
    sync();
  }
};

// body(w, lane) on the 32 lanes of one host warp
template <class F>
void run_warp(F body) {
  HostLanes h;
  std::vector<std::thread> lanes;
  for (int lane = 0; lane < pos::kLanes; ++lane)
    lanes.emplace_back([&h, &body, lane] {
      HostExchange w{&h, lane, &h.state[0][0], &h.parts[0][0]};
      body(w, lane);
    });
  for (auto& th : lanes) th.join();
}

template <int T>
void plain_rows(const uint32_t* st, const uint32_t* C, const uint32_t* M,
                uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    uint32_t x[T][8];
    for (int j = 0; j < T; ++j) pos::copy8(x[j], st + 8 * (T * i + j));
    pos::permute_plain<T>(x, C, M);
    pos::copy8(out + 8 * i, x[pos::kOutputIndex]);
  }
}

template <class B>
void rate_rows(void* x, const void* b, long n, int iters) {
  typename B::T* v = (typename B::T*)x;
  const typename B::U* w = (const typename B::U*)b;
  for (long i = 0; i < n; ++i) v[i] = probe::chain<B>(v[i], w[i], iters);
}

template <class P, bool STACK, bool SYNC = false>
void split_rows(const uint32_t* a, const uint32_t* b, const uint32_t* K,
                uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    probe::sparse3_hash<P, STACK, SYNC>(out + 8 * i, a + 8 * i, b + 8 * i, K,
                                        0);
}

// The three passes of the probe kernels run serially: every thread's block
// through scan_block, the aggregates scanned the same way, the fix-ups.
template <class E>
void scan3(const uint32_t* in, const uint8_t* heads, uint32_t* out, long n,
           int K, bool recurse) {
  const int w = Layout<E>::NA * 8;
  const long T = (n + K - 1) / K;
  std::vector<uint32_t> agg(T * w);
  std::vector<uint8_t> flag(T);
  for (long t = 0; t < T; ++t) {
    long end = (t + 1) * K < n ? (t + 1) * K : n;
    store_point(agg.data() + w * t,
                probe::scan_block<E>(in, heads, out, t * K, end, &flag[t]));
  }
  if (!recurse || T == 1) return;
  scan3<E>(agg.data(), flag.data(), agg.data(), T, K, true);
  for (long t = 1; t < T; ++t) {
    long end = (t + 1) * K < n ? (t + 1) * K : n;
    probe::fixup_block<E>(out, heads,
                          load_point<E>(agg.data() + w * (t - 1)), t * K,
                          end);
  }
}

// The copy probe's walk (csrc/probes_scan.cu copy_chunk) on the host:
// chunks of tpc tiles of lanes x K elements; each chunk's head count, its
// lanes' shares summed, into the 64-bit word at byte 16 + 8 c of scratch
// (the scan's count words); then each tile, element j of every lane at a
// time.
void copy_host(int na, int lanes, int K, int tpc, const uint32_t* in,
               const uint8_t* heads, uint32_t* out, uint8_t* scratch,
               long n) {
  const int W = na * 8;
  const long tile = (long)lanes * K, chunk = tile * tpc;
  uint64_t* cnt = reinterpret_cast<uint64_t*>(scratch + 16);
  for (long c = 0; c * chunk < n; ++c) {
    const long c0 = c * chunk, c1 = c0 + chunk < n ? c0 + chunk : n;
    uint64_t own = 0;
    for (int l = 0; l < lanes; ++l)
      for (long i = c0 + l; i < c1; i += lanes)
        own += (i == 0 || heads[i]) ? 1 : 0;
    cnt[c] = own;
    for (long t0 = c0; t0 < c1; t0 += tile)
      for (int j = 0; j < K; ++j)
        for (int l = 0; l < lanes; ++l) {
          const long i = t0 + (long)l * K + j;
          if (i < n)
            for (int w = 0; w < W; ++w) out[W * i + w] = in[W * i + w];
        }
  }
}

// Poseidon(2) on the sparse schedule with H hashes a thread, as k_sparse3
// (H = 1) and the probes' k_split_hashes run it: hashes i .. i + H - 1
// together, the count's tail on zeros; K is the t = 3 table of
// poseidon.cuh.
template <int H>
void sparse3_rows(const uint32_t* a, const uint32_t* b, const uint32_t* K,
                  uint32_t* out, long n) {
  for (long i = 0; i < n; i += H) {
    uint32_t x[H][3][8];
    for (int h = 0; h < H; ++h) {
      pos::zero8(x[h][0]);
      pos::zero8(x[h][1]);
      pos::zero8(x[h][2]);
      if (i + h < n) {
        pos::copy8(x[h][1], a + 8 * (i + h));
        pos::copy8(x[h][2], b + 8 * (i + h));
      }
    }
    pos::permute_sparse3<H, true>(x, K);
    for (int h = 0; h < H && i + h < n; ++h)
      pos::copy8(out + 8 * (i + h), x[h][pos::kOutputIndex]);
  }
}

// The kernel of seg_scan.cuh on the host, with its pieces in its order:
// chunks of `tpc` tiles of `lanes` x K elements (one warp a chunk, 32 x K a
// tile, on the card).  Every chunk publishes its head count first; the
// count look-backs then run last chunk first, over windows of `window`
// words, so that each folds the aggregate-only words of all the chunks
// before it.  Then each chunk's tiles in order (the lanes' passes, their
// scan, their carries, the running prefix), each chunk publishing its
// point; last, the point look-backs, even chunks before odd ones, so that
// they meet aggregates, prefixes with a head and inclusive prefixes.  Add
// is every add of the scan (the probes' structure runs it on
// probe::WrapAdd).  phase (seg_scan only) cuts the body off as
// scan::Phase does on the card: kPhaseLocal after the lanes' passes, each
// lane's first element a head; kPhaseAgg before the carries are added to
// the elements, each lane's carry-in into `carry` (lane l of tile t at
// t lanes + l) instead.
template <class E, class Add = scan::InlineAdd>
void seg_host(int sums, int lanes, int K, int tpc, int window,
              const uint32_t* in, const uint8_t* heads, uint32_t* out,
              long n, int phase = 2, uint32_t* carry = nullptr) {
  using namespace scan;
  const int W = Layout<E>::NA * 8;
  const Add add;
  auto add_to = [&](uint32_t* o, const Point<E>& v) {
    Point<E> r;
    add(r, v, load_point<E>(o));
    store_point(o, r);
  };
  const long tile = (long)lanes * K, T = (n + tile - 1) / tile;
  const long C = (T + tpc - 1) / tpc, chunk = tile * tpc;
  auto head = [&](long i) { return i == 0 || heads[i] != 0; };
  std::vector<uint64_t> cnt(C), own(C, 0), before(C, 0);
  for (long c = 0; c < C; ++c) {
    for (long i = c * chunk; i < n && i < (c + 1) * chunk; ++i) own[c] += head(i);
    cnt[c] = (c == 0 ? kCntIncl : kCntAgg) | own[c];
  }
  for (long c = C - 1; c > 0; --c) {
    uint64_t excl = 0;
    for (long top = c - 1;; top -= window) {
      auto word = [&](int k) { return top - k >= 0 ? cnt[top - k] : kCntIncl; };
      if (fold_counts(word, window, excl)) break;
    }
    before[c] = excl;
    cnt[c] = kCntIncl | (excl + own[c]);
  }
  std::vector<Point<E>> agg(C), incl(C);
  std::vector<uint32_t> pst(C, 0);
  std::vector<char> chunk_head(C, 0);
  std::vector<long long> deferred(C, -1);
  std::vector<long> first_head(C);
  std::vector<Point<E>> waiting(C * tpc * lanes);   // seg_scan
  for (long c = 0; c < C; ++c) {
    const long c0 = c * chunk, c1 = c0 + chunk < n ? c0 + chunk : n;
    long long seen = (long long)before[c];
    Point<E> run = {};
    bool has_run = false, hd = false;
    first_head[c] = c1;
    for (long t0 = c0; t0 < c1; t0 += tile) {
      std::vector<Point<E>> buf[2] = {std::vector<Point<E>>(lanes),
                                      std::vector<Point<E>>(lanes)};
      std::vector<uint32_t> fb[2] = {std::vector<uint32_t>(lanes),
                                     std::vector<uint32_t>(lanes)};
      std::vector<Run<E>> runs(lanes);
      std::vector<long long> base(lanes);
      std::vector<char> open_sum(lanes, 0);
      for (int l = 0; l < lanes; ++l) {
        const long s = t0 + (long)l * K, e = s + K < n ? s + K : n;
        Run<E>& r = runs[l];
        r = Run<E>{};
        base[l] = seen;
        r.idx = seen - 1;
        char& opened = open_sum[l];
        auto emit = [&](const Run<E>& x) {
          if (sums) {
            store_point(out + W * x.idx, x.acc);
            opened |= x.open != 0;
          }
        };
        for (long i = s; i < e; ++i) {
          const Point<E> p = load_point<E>(in + W * i);
          if (i == s)
            run_first(r, p, phase == kPhaseLocal || head(i), seen);
          else run_take(r, p, head(i), emit, add);
          if (!sums) store_point(out + W * i, r.acc);
          if (!hd && head(i) && i < first_head[c]) first_head[c] = i;
        }
        if (s < n && (e >= n || head(e))) emit(r);
        for (long i = s; i < e; ++i) seen += head(i);
        buf[0][l] = r.acc;
        fb[0][l] = (s >= n || !r.open) ? 1u : 0u;
      }
      if (phase == kPhaseLocal) continue;
      int cur = 0;
      for (int d = 1; d < lanes; d <<= 1, cur ^= 1)
        for (int l = 0; l < lanes; ++l)
          hs_round(l, d, buf[cur].data(), fb[cur].data(), buf[cur ^ 1].data(),
                   fb[cur ^ 1].data(), add);
      const Point<E>* span = buf[cur].data();
      const uint32_t* sf = fb[cur].data();
      for (int l = 0; l < lanes; ++l) {
        const long s = t0 + (long)l * K;
        const bool done = hd || (l > 0 && sf[l - 1]);
        Point<E> cy;
        if (sums ? !open_sum[l] : !runs[l].pre) continue;
        const bool has = lane_carry(cy, l, span, sf, run, has_run, add);
        if (sums) {
          uint32_t* o = out + W * (base[l] - 1);
          if (has) add_to(o, cy);
          if (!done) deferred[c] = base[l] - 1;
        } else if (has && !done) {
          waiting[(t0 - c0) / tile * lanes + l + c * tpc * lanes] = cy;
        } else if (has && phase == kPhaseAgg) {
          store_point(carry + W * (t0 / tile * lanes + l), cy);
        } else if (has) {
          for (uint32_t j = 0; j < runs[l].pre; ++j)
            add_to(out + W * (s + j), cy);
        }
      }
      run_extend(run, has_run, hd, span[lanes - 1], sf[lanes - 1] != 0, add);
    }
    agg[c] = run;
    chunk_head[c] = hd;
    pst[c] = hd ? kPtHead : kPtAgg;
  }
  if (phase == kPhaseLocal) return;
  for (int parity = 0; parity < 2; ++parity)
    for (long c = parity; c < C; c += 2) {
      if (head(c * chunk)) continue;
      Point<E> x, sfx;
      bool has_s = false;
      for (long j = c - 1;; --j) {
        if (j < 0 || !pst[j]) throw 1;   // nothing published before it
        if (fold_point(pst[j], agg[j], incl[j], sfx, has_s, x, add)) break;
      }
      if (!chunk_head[c]) {
        add(incl[c], x, agg[c]);
        pst[c] = kPtIncl;
      }
      if (sums && deferred[c] >= 0) add_to(out + W * deferred[c], x);
      if (!sums)
        for (long t0 = c * chunk; t0 < first_head[c]; t0 += tile)
          for (int l = 0; l < lanes; ++l) {
            const long s = t0 + (long)l * K;
            const long e = s + K < first_head[c] ? s + K : first_head[c];
            Point<E> cx = x;
            if (s < e && (t0 != c * chunk || l != 0))
              add(cx, x, waiting[(t0 - c * chunk) / tile * lanes + l +
                                 c * tpc * lanes]);
            if (phase == kPhaseAgg) {
              if (s < e) store_point(carry + W * (t0 / tile * lanes + l), cx);
              continue;
            }
            for (long i = s; i < e; ++i) add_to(out + W * i, cx);
          }
    }
}

// Poseidon of n states of T lanes on the one-thread sparse schedule
// (poseidon.cuh permute_wide, as k_wide runs it); K the width-T table.
template <int T>
void wide_rows(const uint32_t* st, const uint32_t* K, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    uint32_t x[T][8];
    for (int j = 0; j < T; ++j) pos::copy8(x[j], st + 8 * (T * i + j));
    pos::permute_wide<T>(x, K);
    pos::copy8(out + 8 * i, x[pos::kOutputIndex]);
  }
}

// The row evaluation of csr.cuh on the host, as fr_kernels.cu strings it
// together: out zeroed; chunks of `lanes` x K terms, each chunk's lanes
// through lane_runs, the scan rounds (double-buffered, as in the warp's
// exchange area) and lane_finish; then every carry slot through
// fixup_item.  Returns 1 if a chunk left a carry slot unwritten.
int csr_host(int lanes, int K, const csr::Terms& m, long long nrows,
             uint32_t* out) {
  const int kUnset = -2;
  for (long long i = 0; i < 8 * nrows; ++i) out[i] = 0;
  const long long chunk = (long long)lanes * K;
  const long long C = (m.T + chunk - 1) / chunk;
  std::vector<int> crow(2 * C, kUnset);
  std::vector<uint32_t> cval(16 * C, 0xdeadbeefu);
  std::vector<csr::Runs> L(lanes);
  std::vector<int> hr(lanes), tr(lanes);
  std::vector<uint32_t> v[2] = {std::vector<uint32_t>(8 * lanes),
                                std::vector<uint32_t>(8 * lanes)};
  for (long long c = 0; c < C; ++c) {
    for (int l = 0; l < lanes; ++l) {
      csr::lane_runs(L[l], m, c * chunk + (long long)l * K, K, out);
      hr[l] = L[l].hr;
      tr[l] = L[l].tr;
      csr::copy8(&v[0][8 * l], L[l].ts);
    }
    int cur = 0;
    for (int d = 1; d < lanes; d <<= 1, cur ^= 1)
      for (int l = 0; l < lanes; ++l)
        csr::scan_round(l, d, tr.data(), v[cur].data(), v[cur ^ 1].data());
    for (int l = 0; l < lanes; ++l)
      csr::lane_finish(L[l], l, lanes, hr.data(), tr.data(), v[cur].data(),
                       &crow[2 * c], &cval[16 * c], out);
    if (crow[2 * c] == kUnset || crow[2 * c + 1] == kUnset) return 1;
  }
  for (long long i = 0; i < 2 * C; ++i)
    csr::fixup_item(i, 2 * C, crow.data(), cval.data(), nrows, out);
  return 0;
}

// probes.cuh conv_walk's memory under g++: the fetch a plain copy, which
// counts each read outside the inputs' (34, n) planes; each store counted
// by the output word it writes.
struct HostConvMem {
  static const float* a;
  static const float* b;
  static long long words;     // 34 n
  static const float* out;
  static int* writes;         // 34 n counts
  static long long puts;      // stores in all
  static long long stray;     // fetches outside a and b
  static void fetch(float* dst, const float* src) {
    if (!((src >= a && src < a + words) || (src >= b && src < b + words)))
      ++stray;
    *dst = *src;
  }
  static void commit() {}
  template <int N>
  static void wait() {}
  static void put(float* p, float v) {
    ++writes[p - out];
    ++puts;
    *p = v;
  }
};
const float* HostConvMem::a;
const float* HostConvMem::b;
long long HostConvMem::words;
const float* HostConvMem::out;
int* HostConvMem::writes;
long long HostConvMem::puts;
long long HostConvMem::stray;

}  // namespace

// The FFMA route of the weights-first product over one slab of 64
// columns (X: 64 x 64, row-major, in place): k_dot_ffma's tiles of 8 x TC
// (probe::dot_tile; warp w of 16 / TC, lane (g, q) at rows 4g, columns
// 4 TC w + 4q) in turn, each chain step's output written back once every
// tile has read its operands; mix: 0 k_dot, 1 k_mix
template <int TC>
void dot_slab(int mix, const float* W, float* X) {
  const int F = probe::kDotF;
  std::vector<float> Wt(F * F), nx(F * F);
  for (int r = 0; r < F; ++r)
    for (int k = 0; k < F; ++k) Wt[k * F + r] = W[r * F + k];
  for (int step = 0; step < (mix ? 4 : 8); ++step) {
    for (int w = 0; w < 16 / TC; ++w)
      for (int lane = 0; lane < 32; ++lane) {
        const int r0 = 4 * (lane % 8), c0 = 4 * TC * w + 4 * (lane / 8);
        float acc[8][TC], xo[8][TC];
        probe::dot_tile<TC>(acc, Wt.data(), F, X, F, r0, c0);
        for (int i = 0; i < 8; ++i)
          for (int j = 0; j < TC; ++j)
            xo[i][j] = X[probe::dot_row(r0, i) * F + probe::dot_col(c0, j)];
        if (mix) probe::dot_step_tail<true, TC>(acc, xo);
        else probe::dot_step_tail<false, TC>(acc, xo);
        for (int i = 0; i < 8; ++i)
          for (int j = 0; j < TC; ++j)
            nx[probe::dot_row(r0, i) * F + probe::dot_col(c0, j)] = acc[i][j];
      }
    for (int e = 0; e < F * F; ++e) X[e] = nx[e];
  }
}

// The Horner's lanes under g++, stepped in order (ec.cuh's hs::Lanes),
// with a check at each level's end: every slot below 2p.
struct CheckedLanes : hs::Lanes {
  int over = 0;
  template <class M>
  void sync(const M& m) {
    for (int i = 0; i < M::kSlots; ++i) {
      const Fp1& x = m.s[i];
      Fp1 d;
      Carry k;
      sub_cc(k, d.v[0], x.v[0], p2_limb(0));
      for (int q = 1; q < 8; ++q) subc_cc(k, d.v[q], x.v[q], p2_limb(q));
      if (!k.c) over = 1;                 // no borrow: x >= 2p
    }
  }
};

template <class E>
int schedule_fault(int* counts) {
  using namespace hs;
  static Mem<E> m;
  Expander<E> b{m.job, m.lev, m.out, 0, 0, true};
  build(b);
  if (!b.ok) return 1;
  if (b.nl != kLevels) return 2;
  const int slots = kVals * Sched<E>::NC;
  for (int i = 0; i < kLevels; ++i) {
    const Level& L = m.lev[i];
    counts[i] = L.n;
    std::vector<char> wr(slots, 0);
    for (int j = 0; j < L.n; ++j) {
      const Job& J = m.job[L.first + j];
      if (J.out == 0 || J.out >= slots || wr[J.out]) return 3;
      wr[J.out] = 1;
    }
    for (int j = 0; j < L.n; ++j) {
      const Job& J = m.job[L.first + j];
      for (int k = 0; k < 3; ++k)
        if (wr[J.a.t[k]] || wr[J.b.t[k]]) return 4;
    }
  }
  return 0;
}

extern "C" {

// which: 0 = Fr, 1 = Fp.  Arrays are n rows of 8 uint32 limbs.
void rh_mont_mul(int which, const uint32_t* a, const uint32_t* b,
                 uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    if (which == 0) mul<Fr>(out + 8 * i, a + 8 * i, b + 8 * i);
    else mul<Fp>(out + 8 * i, a + 8 * i, b + 8 * i);
  }
}

// the EC core's Fp2 product (fp_ec.cuh lmul), reduced
void rh_fp2_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    Fp2 x, y;
    load_coord(x, a + 16 * i);
    load_coord(y, b + 16 * i);
    store_coord(out + 16 * i, reduce(lmul(x, y)));
  }
}

// One carry-chain primitive of fp_ec.cuh on n rows: the carry flag in from
// cin[i], d[i] and the flag out in cout[i].  op: 0 add_cc, 1 addc_cc,
// 2 addc, 3 sub_cc, 4 subc_cc, 5 subc, 6 mad_lo_cc, 7 madc_lo_cc,
// 8 madc_hi_cc, 9 madc_hi, 10 mul_hi (a, b, c: operands; c for the mads).
int rh_cc(int op, const uint32_t* a, const uint32_t* b, const uint32_t* c,
          const uint32_t* cin, uint32_t* d, uint32_t* cout, long n) {
  for (long i = 0; i < n; ++i) {
    Carry k{cin[i]};
    uint32_t r = 0;
    switch (op) {
      case 0: add_cc(k, r, a[i], b[i]); break;
      case 1: addc_cc(k, r, a[i], b[i]); break;
      case 2: addc(k, r, a[i], b[i]); break;
      case 3: sub_cc(k, r, a[i], b[i]); break;
      case 4: subc_cc(k, r, a[i], b[i]); break;
      case 5: subc(k, r, a[i], b[i]); break;
      case 6: mad_lo_cc(k, r, a[i], b[i], c[i]); break;
      case 7: madc_lo_cc(k, r, a[i], b[i], c[i]); break;
      case 8: madc_hi_cc(k, r, a[i], b[i], c[i]); break;
      case 9: madc_hi(k, r, a[i], b[i], c[i]); break;
      case 10: r = mul_hi(a[i], b[i]); break;
      default: return 1;
    }
    d[i] = r;
    cout[i] = k.c;
  }
  return 0;
}

// fp_ec.cuh's lazy operations on n rows (Fp: 8 limbs a row; Fp2: 16).
// op: 0 lmul, 1 ladd, 2 lsub, 3 lsum, 4 reduce (of a), 5 mul_b3 (of a),
// 6-10 the same five for Fp2 (6 lmul, 7 ladd, 8 lsub, 9 reduce, 10 mul_b3).
int rh_fp_lazy(int op, const uint32_t* a, const uint32_t* b, uint32_t* out,
               long n) {
  for (long i = 0; i < n; ++i) {
    if (op < 6) {
      Fp1 x, y, r;
      load_coord(x, a + 8 * i);
      load_coord(y, b + 8 * i);
      switch (op) {
        case 0: r = lmul(x, y); break;
        case 1: r = ladd(x, y); break;
        case 2: r = lsub(x, y); break;
        case 3: r = lsum(x, y); break;
        case 4: r = reduce(x); break;
        default: r = mul_b3(x); break;
      }
      store_coord(out + 8 * i, r);
    } else {
      Fp2 x, y, r;
      load_coord(x, a + 16 * i);
      load_coord(y, b + 16 * i);
      switch (op) {
        case 6: r = lmul(x, y); break;
        case 7: r = ladd(x, y); break;
        case 8: r = lsub(x, y); break;
        case 9: r = reduce(x); break;
        case 10: r = mul_b3(x); break;
        default: return 1;
      }
      store_coord(out + 16 * i, r);
    }
  }
  return 0;
}

// ec.cuh's horner (the kernel of zk_g1_horner / zk_g2_horner): W window
// sums of na = 3 | 6 coordinates -> one point, the 32 lanes stepped in
// order over one Mem.  Returns 0, or 1 if a slot held 2p or more at a
// level's end.
int rh_horner(int na, const uint32_t* rw, int W, int c, uint32_t* out) {
  CheckedLanes ln;
  if (na == 3) {
    hs::Mem<Fp1> m;
    horner<Fp1>(out, rw, W, c, m, ln);
  } else {
    hs::Mem<Fp2> m;
    horner<Fp2>(out, rw, W, c, m, ln);
  }
  return ln.over;
}

// ec.cuh's pdbl on n points of na = 3 | 6 coordinates
void rh_point_double(int na, const uint32_t* in, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    if (na == 3)
      store_point(out + 24 * i, pdbl(load_point<Fp1>(in + 24 * i)));
    else
      store_point(out + 48 * i, pdbl(load_point<Fp2>(in + 48 * i)));
  }
}

// The Horner's job table for na = 3 | 6: 0 if it was built whole (every
// sum within its leaves, six levels), no job of a level reading a slot
// that the level writes, no two jobs writing one slot and none writing
// slot 0; else a code naming the first fault.  counts (kLevels ints): the
// jobs of each level.
int rh_horner_schedule(int na, int* counts) {
  return na == 3 ? schedule_fault<Fp1>(counts) : schedule_fault<Fp2>(counts);
}

void rh_g1_add(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    store_point(out + 24 * i,
                padd(load_point<Fp1>(a + 24 * i), load_point<Fp1>(b + 24 * i)));
}

void rh_g2_add(const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    store_point(out + 48 * i,
                padd(load_point<Fp2>(a + 48 * i), load_point<Fp2>(b + 48 * i)));
}

// Poseidon(2) on the sparse schedule, one hash a thread (k_sparse3).
void rh_poseidon_sparse3(const uint32_t* a, const uint32_t* b,
                         const uint32_t* K, uint32_t* out, long n) {
  sparse3_rows<1>(a, b, K, out, n);
}

// n states of t lanes -> their digests, each permutation run on a host warp
// by the schedule of the chain kernel (poseidon.cuh permute_warp); K is the
// width-t sparse table
void rh_poseidon_sparse_warp(int t, const uint32_t* st, const uint32_t* K,
                             uint32_t* out, long n) {
  for (long i = 0; i < n; ++i)
    run_warp([&](HostExchange& w, int lane) {
      uint32_t x[8];
      if (lane < t) pos::copy8(x, st + 8 * (t * i + lane));
      else pos::zero8(x);
      pos::permute_warp(w, x, lane, t, K);
      if (lane == pos::kOutputIndex) pos::copy8(out + 8 * i, x);
    });
}

// n states of t lanes -> their digests (t = 3, 6 or 17)
int rh_poseidon_plain(int t, const uint32_t* st, const uint32_t* C,
                      const uint32_t* M, uint32_t* out, long n) {
  switch (t) {
    case 3: plain_rows<3>(st, C, M, out, n); return 0;
    case 6: plain_rows<6>(st, C, M, out, n); return 0;
    case 17: plain_rows<17>(st, C, M, out, n); return 0;
    default: return 1;
  }
}

// n states of t lanes -> their digests on the one-thread sparse schedule
// (t = 4, 6, 11 or 17); K is the width-t sparse table
int rh_poseidon_wide(int t, const uint32_t* st, const uint32_t* K,
                     uint32_t* out, long n) {
  switch (t) {
    case 4: wide_rows<4>(st, K, out, n); return 0;
    case 6: wide_rows<6>(st, K, out, n); return 0;
    case 11: wide_rows<11>(st, K, out, n); return 0;
    case 17: wide_rows<17>(st, K, out, n); return 0;
    default: return 1;
  }
}

// One chain of n inputs on a host warp, by the chain kernel's schedule
// (poseidon.cuh chain_warp); K17 and Kt are the sparse tables of width 17
// and of the chain's narrower block.
void rh_poseidon_chain(const uint32_t* in, int n, const uint32_t* K17,
                       const uint32_t* Kt, uint32_t* out) {
  run_warp([&](HostExchange& w, int lane) {
    uint32_t x[8];
    pos::chain_warp(w, x, lane, in, n, K17, Kt);
    if (lane == pos::kOutputIndex) pos::copy8(out, x);
  });
}

// --- the probes' device functions (probes.cuh) -------------------------------

// body as zk_probe_rate; x is updated in place
int rh_probe_rate(int body, void* x, const void* b, long n, int iters) {
  switch (body) {
    case 0: rate_rows<probe::U32Chain>(x, b, n, iters); return 0;
    case 1: rate_rows<probe::U32MulMask>(x, b, n, iters); return 0;
    case 2: rate_rows<probe::U32MulAdd>(x, b, n, iters); return 0;
    case 3: rate_rows<probe::F32Fma>(x, b, n, iters); return 0;
    case 4: rate_rows<probe::F32Floor>(x, b, n, iters); return 0;
    case 5: rate_rows<probe::U64WideMad>(x, b, n, iters); return 0;
    default: return 1;
  }
}

// form as zk_probe_conv; a, b, out: (34, n) digit planes
void rh_probe_conv(int form, const float* a, const float* b, float* out,
                   long n) {
  for (long c = 0; c < n; ++c) {
    float x[probe::kDigits], bb[probe::kDigits];
    for (int i = 0; i < probe::kDigits; ++i) {
      x[i] = a[i * n + c];
      bb[i] = b[i * n + c];
    }
    if (form == 0) probe::conv_rounds<0>(x, bb);
    else if (form == 1) probe::conv_rounds<1>(x, bb);
    else probe::conv_rounds<2>(x, bb);
    for (int i = 0; i < probe::kDigits; ++i) out[i * n + c] = x[i];
  }
}

// k_conv_ring (the grouped form's persistent walk, probes.cuh conv_walk)
// with `resident` blocks resident at once: every block's threads, one
// after another (a thread reads only its own slots, so the order does not
// matter), each over its own walk with the kernel's ring.
// writes: 34 n counts of the stores to each output word; walks: the
// columns each thread of the launch computed (blk * kConvSlab + t, for
// the blocks conv_blocks gives); returns the fetches that read outside a
// and b.
long long rh_probe_conv_ring(const float* a, const float* b, float* out,
                             long long n, long long resident, int* writes,
                             int* walks) {
  HostConvMem::a = a;
  HostConvMem::b = b;
  HostConvMem::words = probe::kDigits * n;
  HostConvMem::out = out;
  HostConvMem::writes = writes;
  HostConvMem::puts = 0;
  HostConvMem::stray = 0;
  const long long blocks = probe::conv_blocks(n, resident);
  std::vector<float> ring(probe::kConvStages * probe::kConvRows *
                          probe::kConvSlab);
  for (long long blk = 0; blk < blocks; ++blk)
    for (int t = 0; t < probe::kConvSlab; ++t) {
      const long long before = HostConvMem::puts;
      probe::conv_walk<HostConvMem>(out, a, b, n, blk, blocks, t,
                                    ring.data());
      walks[blk * probe::kConvSlab + t] =
          (int)((HostConvMem::puts - before) / probe::kDigits);
    }
  return HostConvMem::stray;
}

// as zk_probe_latency, one row after another
void rh_probe_latency(const uint32_t* a, const uint32_t* b, uint32_t* out,
                      long n, int steps) {
  for (long i = 0; i < n; ++i) {
    pos::copy8(out + 8 * i, a + 8 * i);
    probe::mont_chain(out + 8 * i, b + 8 * i, steps);
  }
}

// stage as zk_probe_product (Fr)
void rh_probe_product(int stage, const uint32_t* a, const uint32_t* b,
                      uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    if (stage == 0) probe::prod8(out + 16 * i, a + 8 * i, b + 8 * i);
    else if (stage == 1) probe::redc8<Fr>(out + 8 * i, a + 16 * i);
    else mul<Fr>(out + 8 * i, a + 8 * i, b + 8 * i);
  }
}

// mode as zk_probe_split; a, b: n contiguous rows
int rh_probe_split(int mode, const uint32_t* a, const uint32_t* b,
                   const uint32_t* K, uint32_t* out, long n) {
  using namespace probe;
  switch (mode) {
    case 0: split_rows<PFull, false, true>(a, b, K, out, n); return 0;
    case 1: split_rows<PNoProduct, false, true>(a, b, K, out, n); return 0;
    case 2: split_rows<PNoReduce, false, true>(a, b, K, out, n); return 0;
    case 3: split_rows<PNoFinalSub, false, true>(a, b, K, out, n); return 0;
    case 4: split_rows<PNoConst, false, true>(a, b, K, out, n); return 0;
    case 5: split_rows<PFull, true, true>(a, b, K, out, n); return 0;
    case 6: split_rows<PFull, false>(a, b, K, out, n); return 0;
    case 7: split_rows<PFull, false>(a, b, K, out, n); return 0;
    case 8:
      for (long i = 0; i < n; ++i)
        probe::sparse3_registers(out + 8 * i, a + 8 * i, b + 8 * i, K);
      return 0;
    case 9: sparse3_rows<2>(a, b, K, out, n); return 0;
    case 10: sparse3_rows<4>(a, b, K, out, n); return 0;
    default: return 1;
  }
}

// the three-pass scan; na = 3 | 6; recurse = 0 stops after the local pass
void rh_probe_scan(int na, int recurse, const uint32_t* in,
                   const uint8_t* heads, uint32_t* out, long n, int K) {
  if (na == 3) scan3<Fp1>(in, heads, out, n, K, recurse);
  else scan3<Fp2>(in, heads, out, n, K, recurse);
}

// the copy probe (copy_host); scratch: 16 + 8 x chunks bytes
void rh_probe_scan_copy(int na, int lanes, int K, int tpc, const uint32_t* in,
                        const uint8_t* heads, uint32_t* out, uint8_t* scratch,
                        long n) {
  copy_host(na, lanes, K, tpc, in, heads, out, scratch, n);
}

// csr.cuh's row evaluation on the host (csr_host) at `lanes` x K terms a
// chunk: out (nrows, 8) from the T terms (row, col, cid); returns 1 if a
// chunk left a carry slot unwritten
int rh_csr(int lanes, int K, const int* row, const int* col, const int* cid,
           const uint32_t* pool, const uint32_t* x, long long T,
           long long nrows, uint32_t* out) {
  return csr_host(lanes, K, csr::Terms{row, col, cid, pool, x, T}, nrows,
                  out);
}

// seg_scan.cuh on the host (seg_host): sums = 1 for seg_sums, 0 for
// seg_scan; wrap = 1 for every add the wrapping add (the structure probe);
// returns 1 if a look-back found nothing published before it
int rh_seg(int na, int sums, int wrap, int lanes, int K, int tpc, int window,
           const uint32_t* in, const uint8_t* heads, uint32_t* out, long n) {
  try {
    if (na == 3 && wrap)
      seg_host<Fp1, probe::WrapAdd>(sums, lanes, K, tpc, window, in, heads,
                                    out, n);
    else if (na == 3)
      seg_host<Fp1>(sums, lanes, K, tpc, window, in, heads, out, n);
    else if (wrap)
      seg_host<Fp2, probe::WrapAdd>(sums, lanes, K, tpc, window, in, heads,
                                    out, n);
    else
      seg_host<Fp2>(sums, lanes, K, tpc, window, in, heads, out, n);
  } catch (int) {
    return 1;
  }
  return 0;
}

// A stage of seg_scan.cuh on the host (seg_host): phase 0 local, 1
// local_agg (carry: a point a lane of the stream's tiles), 2 full;
// returns 1 if a look-back found nothing published before it
int rh_seg_stage(int na, int phase, int lanes, int K, int tpc, int window,
                 const uint32_t* in, const uint8_t* heads, uint32_t* out,
                 uint32_t* carry, long n) {
  try {
    if (na == 3)
      seg_host<Fp1>(0, lanes, K, tpc, window, in, heads, out, n, phase,
                    carry);
    else
      seg_host<Fp2>(0, lanes, K, tpc, window, in, heads, out, n, phase,
                    carry);
  } catch (int) {
    return 1;
  }
  return 0;
}

// dot_slab at a tile of 8 x tc
void rh_probe_dot_slab(int mix, int tc, const float* W, float* X) {
  if (tc == 8) dot_slab<8>(mix, W, X);
  else dot_slab<4>(mix, W, X);
}

// scan::fold_counts over m words, nearest first; returns whether it
// reached an inclusive word, the fold in *excl
int rh_fold_counts(const uint64_t* words, int m, uint64_t* excl) {
  auto word = [&](int k) { return words[k]; };
  return scan::fold_counts(word, m, *excl) ? 1 : 0;
}

// scan::fold_point over m G1 predecessors, nearest first (status, their
// aggregate and inclusive points); returns whether the prefix is complete,
// the prefix in *x
int rh_fold_points(const uint32_t* status, const uint32_t* agg,
                   const uint32_t* incl, int m, uint32_t* x) {
  const scan::InlineAdd add;
  Point<Fp1> s, px;
  bool has_s = false;
  for (int i = 0; i < m; ++i)
    if (scan::fold_point(status[i], load_point<Fp1>(agg + 24 * i),
                         load_point<Fp1>(incl + 24 * i), s, has_s, px, add)) {
      store_point(x, px);
      return 1;
    }
  return 0;
}

}  // extern "C"
