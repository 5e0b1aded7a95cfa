// Complete projective point addition on BN254 G1 and G2 (Renes, Costello
// and Batina 2015, a = 0), shared by the add kernels and the segmented
// scan; and the MSM's Horner on the lanes of one warp, with a dedicated
// doubling (pdbl; the section at the end).  The add's formula has no
// exceptional cases: the identity (0 : 1 : 0), P + P and P + (-P) all take
// the same path.
//
//   t0 = X1X2  t1 = Y1Y2  t2 = Z1Z2   txy / tyz / txz = cross sums
//   u = t1 - 3b t2   v = t1 + 3b t2   w = 3b txz
//   X3 = txy u - tyz w   Y3 = u v + 3 t0 w   Z3 = tyz v + 3 t0 txy
//
// On fp_ec.cuh's lazy core: the operands are fully reduced (below p), every
// value inside stays below 2p, and each output coordinate is reduced once,
// so the stored point is the one a fully reduced computation gives, bit for
// bit.  The order keeps few values live (a G2 value is 16 registers): the
// operands are read where they are used (from memory, when the caller
// passes references into it) and are all read before the first output is
// written, so an output may overwrite an operand; then the last six
// products run around the cycle txy u, u v, v tyz, tyz w, w 3t0, 3t0 txy,
// each value dying at its second product and each output written as soon
// as it is complete (X3, Y3, Z3 in that order), at most seven values live.
#pragma once

#include "fp_ec.cuh"

namespace ff {

template <class E>
struct Point { E x, y, z; };

// out.x(X3), out.y(Y3), out.z(Z3) receive the sum p + q, in that order,
// after every read of p and q.
template <class E, class Out>
FF_HD void padd_emit(const Point<E>& p, const Point<E>& q, Out& out) {
  const E t0 = lmul(p.x, q.x);
  const E t1 = lmul(p.y, q.y);
  const E txy = lsub(lmul(lsum(p.x, p.y), lsum(q.x, q.y)), ladd(t0, t1));
  const E t2 = lmul(p.z, q.z);
  const E tyz = lsub(lmul(lsum(p.y, p.z), lsum(q.y, q.z)), ladd(t1, t2));
  const E w = mul_b3(lsub(lmul(lsum(p.x, p.z), lsum(q.x, q.z)),
                          ladd(t0, t2)));
  const E t0p = ladd(ladd(t0, t0), t0);
  const E bt2 = mul_b3(t2);
  const E u = lsub(t1, bt2);
  const E v = ladd(t1, bt2);
  const E x3 = lmul(txy, u);
  const E y3 = lmul(u, v);
  const E z3 = lmul(v, tyz);
  out.x(reduce(lsub(x3, lmul(tyz, w))));
  out.y(reduce(ladd(y3, lmul(w, t0p))));
  out.z(reduce(ladd(z3, lmul(t0p, txy))));
}

template <class E>
struct ToPoint {
  Point<E>* r;
  FF_HD void x(const E& v) { r->x = v; }
  FF_HD void y(const E& v) { r->y = v; }
  FF_HD void z(const E& v) { r->z = v; }
};

template <class E>
FF_HD Point<E> padd(const Point<E>& p, const Point<E>& q) {
  Point<E> r;
  ToPoint<E> out{&r};
  padd_emit(p, q, out);
  return r;
}

// Points live in memory as (N, NA, 8) int32 rows: NA = 3 coordinates for
// G1, NA = 6 (x.c0, x.c1, y.c0, y.c1, z.c0, z.c1) for G2.
template <class E> struct Layout;
template <> struct Layout<Fp1> { static const int NA = 3; };
template <> struct Layout<Fp2> { static const int NA = 6; };

FF_HD void load_coord(Fp1& e, const uint32_t* src) {
  FF_UNROLL
  for (int i = 0; i < 8; ++i) e.v[i] = src[i];
}
FF_HD void load_coord(Fp2& e, const uint32_t* src) {
  load_coord(e.c0, src);
  load_coord(e.c1, src + 8);
}
FF_HD void store_coord(uint32_t* dst, const Fp1& e) {
  FF_UNROLL
  for (int i = 0; i < 8; ++i) dst[i] = e.v[i];
}
FF_HD void store_coord(uint32_t* dst, const Fp2& e) {
  store_coord(dst, e.c0);
  store_coord(dst + 8, e.c1);
}

template <class E>
FF_HD Point<E> load_point(const uint32_t* src) {
  const int w = Layout<E>::NA / 3 * 8;  // words per coordinate
  Point<E> p;
  load_coord(p.x, src);
  load_coord(p.y, src + w);
  load_coord(p.z, src + 2 * w);
  return p;
}

template <class E>
FF_HD void store_point(uint32_t* dst, const Point<E>& p) {
  const int w = Layout<E>::NA / 3 * 8;
  store_coord(dst, p.x);
  store_coord(dst + w, p.y);
  store_coord(dst + 2 * w, p.z);
}

// --- the MSM's Horner on the lanes of one warp ------------------------------
//
// sum_w 2^(c w) rw[w] over W window sums: acc = rw[W - 1]; for w = W - 2
// .. 0, c doublings of acc, then acc + rw[w].  The chain is serial, so the
// speed is in each step's depth.  Every formula below is written once, as
// a schedule of levels of independent Montgomery products, one a lane: a
// lane evaluates its two operands, each a sum of up to two slots less a
// third (ladd, lsub) doubled e times, multiplies them (lmul: the same
// instructions on every lane) and writes the product to its own slot; a
// __syncwarp closes the level.  So a formula costs its depth in products,
// not its count: a doubling two levels (Algorithm 9's 6M + 2S and its
// constants as eight products, then six), an add two (nine, then six),
// and b3 Z of the sum one more.
//
// Values live in shared memory, one Fp slot each in G1 and three in G2:
// (c0, c1, s = c0 + c1), what the three lanes of a Karatsuba product read.
// Those lanes compute t0 = a0 b0, t1 = a1 b1, t2 = s_a s_b; each takes the
// parts it needs (through shuffles on the card) and writes its own
// component, c0 = t0 - t1, c1 = t2 - t1 - t0 or s = t2 - t1 - t1.  The
// accumulator is kept as sums of products, X = Xa - Xb, Y = Yc + Yd, Z =
// Ze + Zf, and carries K = b3 Z and K3 = 3 b3 Z, so that b3 Z^2 is one
// product (Z K) and the doubling's constant costs no level of its own.
//
// Bounds, as in padd_emit: the window sums are loaded below p, every slot
// and every operand stays below 2p (lmul of two, ladd / lsub of two), and
// the stored coordinates are reduced once: the stored point is what a
// fully reduced computation of the same formulas gives, bit for bit
// (ops/ec.py plain_horner).  A level reads no slot that it writes, so its
// jobs may run in any order: the card runs them on the lanes at once, and
// g++ steps them in order over the same array (the rehearsal).

namespace hs {

// The schedule's values (slot = value x 1 in G1, x 3 in G2).
enum : int {
  kZero, kB3, kB33,                       // 0, b3, 3 b3
  kQX, kQY, kQZ, kQX3,                    // the window sum q, 3 q.X
  kXa, kXb, kYc, kYd, kZe, kZf,           // the accumulator's sums
  kK, kK3, kQBZ,                          // b3 Z, 3 b3 Z, b3 q.Z
  kA, kA8, kYZ, kXY, kBZ, kBZ3, kYK, kYK3,           // the doubling's
  kT0P, kT1, kXQY, kYQX, kYQZ, kZQY, kBT2, kWA, kWB,  // the add's
  kVals
};

// the schedules' levels, in the order build() emits them
enum { kLevK = 0, kLevQ = 1, kLevDbl = 2, kLevAdd = 4, kLevels = 6 };

// the jobs a level (one pass of the warp)
const int kLevelJobs = 32;

// An operand: s[t[0]] + s[t[1]] - s[t[2]], doubled e times.  Unused leaves
// name slot 0, which holds 0.
struct Tree {
  uint8_t t[3];
  uint8_t e;
};

// s[out] = a b.  ea, eb: the level's largest e of an a / b operand (the
// doublings every lane runs); live: a job (a lane's copy of a level it
// has no job in is not).
struct Job {
  Tree a, b;
  uint8_t out, ea, eb, live;
};

struct Level {
  uint16_t first, n;   // its jobs
};

// per curve: the slots a value, the job table's size
template <class E> struct Sched;
template <> struct Sched<Fp1> { static const int NC = 1, kJobs = 40; };
template <> struct Sched<Fp2> { static const int NC = 3, kJobs = 112; };

// A value-level operand: 2^e sum_i l[i] v[i].
struct Form {
  int v[2], l[2], e;
};

FF_HD Form fm(int v0, int l0 = 1, int v1 = kZero, int l1 = 0, int e = 0) {
  Form f;
  f.v[0] = v0; f.l[0] = l0; f.v[1] = v1; f.l[1] = l1; f.e = e;
  return f;
}

// Expands the value-level formulas into one job a slot.  ok turns false
// if an operand needs more leaves than two added and one subtracted, a
// level more jobs than the warp's lanes, or the table more than its size.
template <class E>
struct Expander {
  static const int NC = Sched<E>::NC;
  Job* job;
  Level* lev;
  Tree* out;
  int nj, nl;
  bool ok;

  FF_HD void level() {
    lev[nl].first = (uint16_t)nj;
    lev[nl].n = 0;
    ++nl;
  }
  // component j of f
  FF_HD Tree tree(const Form& f, int j) {
    Tree T = {{0, 0, 0}, (uint8_t)f.e};
    int np = 0, nn = 0;
    for (int i = 0; i < 2; ++i)
      for (int r = 0; r < (f.l[i] < 0 ? -f.l[i] : f.l[i]); ++r) {
        const uint8_t slot = (uint8_t)(f.v[i] * NC + j);
        if (f.l[i] > 0 && np < 2) T.t[np++] = slot;
        else if (f.l[i] < 0 && nn < 1) T.t[2 + nn++] = slot;
        else ok = false;
      }
    return T;
  }
  // out = a b
  FF_HD void mul(int o, const Form& a, const Form& b) {
    Level& L = lev[nl - 1];
    for (int j = 0; j < NC; ++j) {
      if (nj == Sched<E>::kJobs || L.n == kLevelJobs) {
        ok = false;
        return;
      }
      Job& J = job[nj++];
      ++L.n;
      J.a = tree(a, j);
      J.b = tree(b, j);
      J.out = (uint8_t)(o * NC + j);
      J.live = 1;
    }
    uint8_t ea = 0, eb = 0;
    for (int k = 0; k < L.n; ++k) {
      const Job& J = job[L.first + k];
      ea = J.a.e > ea ? J.a.e : ea;
      eb = J.b.e > eb ? J.b.e : eb;
    }
    for (int k = 0; k < L.n; ++k) {
      job[L.first + k].ea = ea;
      job[L.first + k].eb = eb;
    }
  }
};

// the accumulator's coordinates
FF_HD Form accX() { return fm(kXa, 1, kXb, -1); }
FF_HD Form accY() { return fm(kYc, 1, kYd, 1); }
FF_HD Form accZ() { return fm(kZe, 1, kZf, 1); }

// K = b3 Z, K3 = 3 b3 Z of the accumulator
template <class B>
FF_HD void sched_k(B& b) {
  b.level();
  b.mul(kK, accZ(), fm(kB3));
  b.mul(kK3, accZ(), fm(kB33));
}

// b3 q.Z, for the add: it rides along the doubling's first level, or runs
// alone when c = 0
template <class B>
FF_HD void q_mul(B& b) { b.mul(kQBZ, fm(kQZ), fm(kB3)); }
template <class B>
FF_HD void sched_q(B& b) {
  b.level();
  q_mul(b);
}

// The doubling, Renes-Costello-Batina 2015 Algorithm 9 (a = 0):
//   X3 = 2 (Y^2 - 3 b3 Z^2) X Y
//   Y3 = 8 Y^2 b3 Z^2 + (Y^2 - 3 b3 Z^2)(Y^2 + b3 Z^2)
//   Z3 = 8 Y^3 Z,  and  b3 Z3 = 8 Y^2 (Y K),  3 b3 Z3 = 8 Y^2 (Y K3)
// with 8 Y^2 = Y (8 Y).  It takes the identity (0 : 1 : 0) to itself.
template <class B>
FF_HD void sched_dbl(B& b) {
  const Form X = accX(), Y = accY(), Z = accZ();
  b.level();
  b.mul(kA, Y, Y);
  b.mul(kA8, Y, fm(kYc, 1, kYd, 1, 3));
  b.mul(kYZ, Y, Z);
  b.mul(kXY, X, Y);
  b.mul(kBZ, Z, fm(kK));              // b3 Z^2
  b.mul(kBZ3, Z, fm(kK3));            // 3 b3 Z^2
  b.mul(kYK, Y, fm(kK));
  b.mul(kYK3, Y, fm(kK3));
  q_mul(b);
  const Form U = fm(kA, 1, kBZ3, -1), A8 = fm(kA8);
  b.level();
  b.mul(kXa, U, fm(kXY, 2));          // X3
  b.mul(kXb, fm(kZero), fm(kZero));
  b.mul(kYc, fm(kBZ), A8);            // Y3
  b.mul(kYd, U, fm(kA, 1, kBZ, 1));
  b.mul(kZe, fm(kYZ), A8);            // Z3
  b.mul(kZf, fm(kZero), fm(kZero));
  b.mul(kK, fm(kYK), A8);
  b.mul(kK3, fm(kYK3), A8);
}

// The add acc + q: padd_emit's formula (Algorithm 7) with its cross sums
// taken as products and its constant folded into K and b3 q.Z:
//   t0p = X1 (3 X2)   t1 = Y1 Y2   txy = X1 Y2 + Y1 X2   tyz = Y1 Z2 + Z1 Y2
//   w = b3 txz = X1 (b3 Z2) + K1 X2   b3 t2 = K1 Z2
//   u = t1 - b3 t2   v = t1 + b3 t2
//   X3 = txy u - tyz w   Y3 = u v + t0p w   Z3 = tyz v + t0p txy
// then K and K3 of the sum come from sched_k.
template <class B>
FF_HD void sched_add(B& b) {
  const Form X = accX(), Y = accY(), Z = accZ();
  b.level();
  b.mul(kT0P, X, fm(kQX3));
  b.mul(kT1, Y, fm(kQY));
  b.mul(kXQY, X, fm(kQY));
  b.mul(kYQX, Y, fm(kQX));
  b.mul(kYQZ, Y, fm(kQZ));
  b.mul(kZQY, Z, fm(kQY));
  b.mul(kBT2, fm(kK), fm(kQZ));
  b.mul(kWA, X, fm(kQBZ));
  b.mul(kWB, fm(kK), fm(kQX));
  const Form txy = fm(kXQY, 1, kYQX, 1), tyz = fm(kYQZ, 1, kZQY, 1),
             w = fm(kWA, 1, kWB, 1), u = fm(kT1, 1, kBT2, -1),
             v = fm(kT1, 1, kBT2, 1), t0p = fm(kT0P);
  b.level();
  b.mul(kXa, txy, u);
  b.mul(kXb, tyz, w);
  b.mul(kYc, u, v);
  b.mul(kYd, t0p, w);
  b.mul(kZe, tyz, v);
  b.mul(kZf, t0p, txy);
}

template <class B>
FF_HD void build(B& b) {
  sched_k(b);
  sched_q(b);
  sched_dbl(b);
  sched_add(b);
  // the stored point: component k of (X, Y, Z), c0 / c1 in G2
  const int per = B::NC == 1 ? 1 : 2;
  const Form xyz[3] = {accX(), accY(), accZ()};
  for (int k = 0; k < 3 * per; ++k) b.out[k] = b.tree(xyz[k / per], k % per);
}

// The schedule's shared memory (a few KB): the slots, the job table, the
// levels and the stored point's sums.
template <class E>
struct Mem {
  static const int kSlots = kVals * Sched<E>::NC;
  Fp1 s[kSlots];
  Job job[Sched<E>::kJobs];
  Level lev[kLevels];
  Tree out[Layout<E>::NA];
};

// an operand: its sum, then up to emax doublings (T.e of them kept)
FF_HD Fp1 operand(const Fp1* s, const Tree& T, int emax) {
  Fp1 x = lsub(ladd(s[T.t[0]], s[T.t[1]]), s[T.t[2]]);
  for (int i = 0; i < emax; ++i) {
    const Fp1 d = ladd(x, x);
    if (i < T.e) x = d;
  }
  return x;
}

FF_HD Fp1 pick(bool c, const Fp1& a, const Fp1& b) {
  Fp1 r;
  FF_UNROLL
  for (int i = 0; i < 8; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// component j of a Karatsuba product's parts (t0, t1, t2): c0 = t0 - t1,
// c1 = t2 - t1 - t0, s = t2 - t1 - t1, as (p - t1) - q with p = t0 or t2
// and q = 0, t0 or t1: the part lanes p_lane(j), base + 1 and q_lane(j)
// hold (q masked to 0 for c0)
FF_HD int p_lane(int j) { return j == 0 ? 0 : 2; }
FF_HD int q_lane(int j) { return j == 1 ? 0 : 1; }
FF_HD Fp1 karatsuba(const Fp1& p, const Fp1& t1, const Fp1& q, int j) {
  return lsub(lsub(p, t1), pick(j == 0, Fp1{}, q));
}

// The lanes of one warp: on the card each thread is one lane, holds its
// job of each level in registers, trades a G2 product's three parts
// through shuffles, and sync() is __syncwarp; under g++ one thread steps
// every job of a level in order from the table, a product's parts and
// then their components.
struct Lanes {
  static const int kLanes = 32;
  Job mine[kLevels];

  FF_HD int begin() const {
#if defined(__CUDA_ARCH__)
    return threadIdx.x;
#else
    return 0;
#endif
  }
  FF_HD int end() const {
#if defined(__CUDA_ARCH__)
    return threadIdx.x + 1;
#else
    return kLanes;
#endif
  }
  // after the table is built: this lane's jobs
  template <class M>
  FF_HD void load(const M& m) {
#if defined(__CUDA_ARCH__)
    for (int i = 0; i < kLevels; ++i) {
      const int j = threadIdx.x;
      if (j < m.lev[i].n) mine[i] = m.job[m.lev[i].first + j];
      else mine[i].live = 0;
    }
#else
    (void)m;
#endif
  }
  // level i of the table
  template <class E>
  FF_HD void level(Mem<E>& m, int i) {
    const int NC = Sched<E>::NC;
#if defined(__CUDA_ARCH__)
    {
      const Job& J = mine[i];
      Fp1 r = {};
      if (J.live) r = lmul(operand(m.s, J.a, J.ea), operand(m.s, J.b, J.eb));
      if (NC == 3) {
        const int lane = threadIdx.x, j = lane % 3, base = lane - j;
        Fp1 p, t1, q;
        FF_UNROLL
        for (int k = 0; k < 8; ++k) {
          p.v[k] = __shfl_sync(0xffffffffu, r.v[k], base + p_lane(j));
          t1.v[k] = __shfl_sync(0xffffffffu, r.v[k], base + 1);
          q.v[k] = __shfl_sync(0xffffffffu, r.v[k], base + q_lane(j));
        }
        r = karatsuba(p, t1, q, j);
      }
      if (J.live) m.s[J.out] = r;
    }
#else
    const Level L = m.lev[i];
    for (int k = 0; k < L.n; k += NC) {
      const Job* J = m.job + L.first + k;
      Fp1 t[NC];
      FF_UNROLL
      for (int j = 0; j < NC; ++j)
        t[j] = lmul(operand(m.s, J[j].a, J[j].ea),
                    operand(m.s, J[j].b, J[j].eb));
      FF_UNROLL
      for (int j = 0; j < NC; ++j)
        m.s[J[j].out] =
            NC == 1 ? t[j] : karatsuba(t[p_lane(j)], t[1], t[q_lane(j)], j);
    }
#endif
  }
  template <class M>
  FF_HD void sync(const M&) const {
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }
};

// levels [first, first + count) of the table, unrolled (a lane's jobs in
// registers are indexed by constants)
template <int FIRST, int COUNT, class E, class L>
FF_HD void run(Mem<E>& m, L& ln) {
  FF_UNROLL
  for (int i = FIRST; i < FIRST + COUNT; ++i) {
    ln.level(m, i);
    ln.sync(m);
  }
}

// a value from an element below 2p (c0, c1, c0 + c1 in G2)
FF_HD void put(Fp1* s, int v, const Fp1& x) { s[v] = x; }
FF_HD void put(Fp1* s, int v, const Fp2& x) {
  s[3 * v] = x.c0;
  s[3 * v + 1] = x.c1;
  s[3 * v + 2] = ladd(x.c0, x.c1);
}

// coordinate i (X, Y, Z) of the point at p: 0 / 1 / 2 into the accumulator,
// 3 / 4 / 5 into q (and 3 q.X)
template <class E>
FF_HD void put_coord(Fp1* s, const uint32_t* p, int i) {
  E x;
  load_coord(x, p + (i % 3) * (Layout<E>::NA / 3) * 8);
  if (i < 3) {
    put(s, i == 0 ? kXa : i == 1 ? kYc : kZe, x);
  } else {
    put(s, i == 3 ? kQX : i == 4 ? kQY : kQZ, x);
    if (i == 3) put(s, kQX3, ladd(ladd(x, x), x));
  }
}

// zeroed slots, 0 / b3 / 3 b3, the job table (lane 0) and the point p as
// the accumulator (K and K3 not yet set)
template <class E, class L>
FF_HD void init(Mem<E>& m, const uint32_t* p, L& ln) {

  for (int l = ln.begin(); l < ln.end(); ++l)
    for (int k = l; k < Mem<E>::kSlots; k += L::kLanes) m.s[k] = Fp1{};
  ln.sync(m);
  for (int l = ln.begin(); l < ln.end(); ++l) {
    if (l == 0) {
      Expander<E> b{m.job, m.lev, m.out, 0, 0, true};
      build(b);
      E k;
      b3_const(k);
      put(m.s, kB3, k);
      put(m.s, kB33, ladd(ladd(k, k), k));
    }
    for (int i = l; i < 3; i += L::kLanes) put_coord<E>(m.s, p, i);
  }
  ln.sync(m);
  ln.load(m);
}

// the accumulator, each coordinate reduced once, to out
template <class E, class L>
FF_HD void store_acc(uint32_t* out, const Mem<E>& m, L& ln) {
  for (int l = ln.begin(); l < ln.end(); ++l)
    for (int k = l; k < Layout<E>::NA; k += L::kLanes)
      store_coord(out + 8 * k, reduce(operand(m.s, m.out[k], 0)));
}

}  // namespace hs

// The dedicated doubling: 2 p by sched_dbl (Algorithm 9), the lanes
// stepped in order over slots of its own: on the host, where the
// rehearsal holds the schedule's doubling against ops/ec.py
// plain_point_double; the card runs the schedule on the warp (horner).
// p's coordinates below p; the result reduced.
template <class E>
inline Point<E> pdbl(const Point<E>& p) {
  const int NA = Layout<E>::NA;
  uint32_t in[NA * 8], out[NA * 8];
  store_point(in, p);
  static hs::Mem<E> m;
  hs::Lanes lanes;
  hs::init<E>(m, in, lanes);
  hs::run<hs::kLevK, 1>(m, lanes);
  hs::run<hs::kLevDbl, 2>(m, lanes);
  hs::store_acc<E>(out, m, lanes);
  return load_point<E>(out);
}

// The Horner on the lanes of L (hs::Lanes: one warp on the card), with m
// in memory all of them share.  W >= 1, c >= 0.
template <class E, class L>
FF_HD void horner(uint32_t* out, const uint32_t* rw, int W, int c,
                  hs::Mem<E>& m, L& ln) {
  using namespace hs;
  const int pw = Layout<E>::NA * 8;
  init<E>(m, rw + (long long)(W - 1) * pw, ln);
  if (W > 1) run<kLevK, 1>(m, ln);
  for (int w = W - 2; w >= 0; --w) {
    for (int l = ln.begin(); l < ln.end(); ++l)
      for (int i = l; i < 3; i += L::kLanes)
        put_coord<E>(m.s, rw + (long long)w * pw, 3 + i);
    ln.sync(m);
    if (c == 0) run<kLevQ, 1>(m, ln);
    for (int s = 0; s < c; ++s) run<kLevDbl, 2>(m, ln);
    run<kLevAdd, 2>(m, ln);
    if (w > 0) run<kLevK, 1>(m, ln);
  }
  store_acc<E>(out, m, ln);
}

}  // namespace ff
