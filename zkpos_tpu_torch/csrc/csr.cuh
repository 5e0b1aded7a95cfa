// The QAP row evaluation out[r] = sum over the terms t of row r of
// pool[cid[t]] * x[col[t]] (Fr, Montgomery, fully reduced), split evenly
// by terms: the pieces every thread runs (FF_HD, so g++ runs them in the
// CPU rehearsal), strung together by csrc/fr_kernels.cu's two kernels.
//
// The terms are sorted by row, and each carries its row id.  They are cut
// into chunks of `lanes` x K terms, one warp a chunk; lane l owns the K
// consecutive terms from chunk start + l K.  Terms past T belong to the
// row kNoRow, above every real row, with product 0.
//
//   1. lane_runs: the lane forms its K products and keeps one running sum
//      a run of equal rows.  A run that starts and ends inside the lane is
//      a whole row, written at once; the lane keeps its first run (hr, hs)
//      and its last (tr, ts).
//   2. The lanes' last runs are summed across the warp by a segmented
//      Hillis-Steele scan keyed by their rows (scan_round, through the
//      warp's exchange area in shared memory): rows ascend, so lanes whose
//      last runs share a row are neighbours.
//   3. lane_finish: a lane writes its first run with the scanned sum of
//      the lanes before it that end in the same row, when that row ended
//      inside the lane, and its scanned last run when the next lane starts
//      another row.  The chunk's first row may have begun in the chunk
//      before and its last row may go on into the next: those two partial
//      sums go to the chunk's two carry slots instead of `out`.
//   4. fixup_item (a second launch): the first carry slot of each row that
//      reached a chunk boundary adds up the slots after it with the same
//      row and writes the row.  The longest row of the prove's A matrix,
//      16,385 terms, spans 64 chunks of 256.
//
// Every row with a term is written exactly once, by one of the three
// writes above; rows with no term keep the zeros the launch first sets.
// Fr addition is exact and every sum fully reduced, so the order of the
// additions does not change a bit of the result.
#pragma once

#include "field.cuh"

namespace csr {

using ff::Fr;

// the row of the terms past T: above every real row
const int kNoRow = 0x7fffffff;
// carry slots fixup_item reads at a time (a power of two)
const int kWalk = 8;

FF_HD void copy8(uint32_t* r, const uint32_t* a) {
  FF_UNROLL
  for (int i = 0; i < 8; ++i) r[i] = a[i];
}

FF_HD void zero8(uint32_t* r) {
  FF_UNROLL
  for (int i = 0; i < 8; ++i) r[i] = 0;
}

// 8 limbs of device memory, through the read-only cache on the card
FF_HD void ldg8(uint32_t* r, const uint32_t* p) {
#if defined(__CUDA_ARCH__)
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 a = __ldg(q), b = __ldg(q + 1);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
#else
  copy8(r, p);
#endif
}

FF_HD int ldg(const int* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

FF_HD void st8(uint32_t* p, const uint32_t* r) {
#if defined(__CUDA_ARCH__)
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(r[0], r[1], r[2], r[3]);
  q[1] = make_uint4(r[4], r[5], r[6], r[7]);
#else
  copy8(p, r);
#endif
}

// The terms: their rows (ascending), columns and coefficient ids, T of
// them; the coefficient pool and the vector x, 8 limbs an entry.
struct Terms {
  const int* row;
  const int* col;
  const int* cid;
  const uint32_t* pool;
  const uint32_t* x;
  long long T;
};

// term t's product pool[cid[t]] * x[col[t]] into p; returns its row
FF_HD int term(uint32_t* p, const Terms& m, long long t) {
  if (t >= m.T) {
    zero8(p);
    return kNoRow;
  }
  uint32_t c[8], v[8];
  ldg8(c, m.pool + 8 * (long long)ldg(m.cid + t));
  ldg8(v, m.x + 8 * (long long)ldg(m.col + t));
  ff::mul<Fr>(p, c, v);
  return ldg(m.row + t);
}

// What a lane keeps of its terms: the rows of its first and last run,
// whether it met more than one run, the first run's sum (when it did) and
// the last run's.
struct Runs {
  int hr, tr;
  bool two;
  uint32_t hs[8], ts[8];
};

// The lane's K terms from s: whole rows inside the lane go to out.
FF_HD void lane_runs(Runs& L, const Terms& m, long long s, int K,
                     uint32_t* out) {
  for (int k = 0; k < K; ++k) {
    uint32_t p[8];
    const int r = term(p, m, s + k);
    if (k == 0) {
      L.hr = L.tr = r;
      L.two = false;
      copy8(L.ts, p);
    } else if (r == L.tr) {
      ff::add<Fr>(L.ts, L.ts, p);
    } else {
      if (L.two) st8(out + 8 * (long long)L.tr, L.ts);   // a whole row
      else copy8(L.hs, L.ts);
      L.two = true;
      L.tr = r;
      copy8(L.ts, p);
    }
  }
}

// The warp's exchange area: each lane's first and last row, and its last
// run's sum (in) and the scan's step (out).
//
// One step of the segmented scan of the lanes' last runs: out[l] = in[l]
// plus in[l - d] when lane l - d ends in the same row.  After the steps
// d = 1, 2, 4, .. < lanes, lane l holds the sum of the last runs of the
// lanes up to l that end in its row (they are all neighbours).
FF_HD void scan_round(int l, int d, const int* tr, const uint32_t* in,
                      uint32_t* out) {
  if (l >= d && tr[l - d] == tr[l])
    ff::add<Fr>(out + 8 * l, in + 8 * l, in + 8 * (l - d));
  else
    copy8(out + 8 * l, in + 8 * l);
}

// A row's sum, complete within the chunk unless it is the chunk's first
// row: that goes to the chunk's first carry slot.
FF_HD void emit(int r, const uint32_t* v, int first, int* crow,
                uint32_t* cval, uint32_t* out) {
  if (r == first) {
    crow[0] = r;
    st8(cval, v);
  } else {
    st8(out + 8 * (long long)r, v);
  }
}

// Lane l of `lanes` after the scan: hr / tr are every lane's first and
// last rows, sc the scanned sums; crow / cval the chunk's two carry slots
// (rows, and 8 limbs each).
FF_HD void lane_finish(const Runs& L, int l, int lanes, const int* hr,
                       const int* tr, const uint32_t* sc, int* crow,
                       uint32_t* cval, uint32_t* out) {
  const int first = hr[0];
  if (L.two) {                   // the first run ended inside the lane
    uint32_t v[8];
    copy8(v, L.hs);
    if (l > 0 && tr[l - 1] == L.hr) ff::add<Fr>(v, v, sc + 8 * (l - 1));
    emit(L.hr, v, first, crow, cval, out);
  }
  if (l + 1 < lanes) {
    // the next lane starts another row: the last run's row ended here
    if (hr[l + 1] != L.tr) emit(L.tr, sc + 8 * l, first, crow, cval, out);
  } else if (L.tr == first) {    // one row through the chunk
    crow[0] = crow[1] = first;
    st8(cval, sc + 8 * l);
    uint32_t z[8];
    zero8(z);
    st8(cval + 8, z);
  } else {                       // the chunk's last row, maybe continued
    crow[1] = L.tr;
    st8(cval + 8, sc + 8 * l);
  }
}

// Carry slot i of n (two a chunk, rows ascending): if it is the first slot
// of its row, the sum of that row's slots into out.  Slots of kNoRow (or
// any row at or past nrows) are skipped.
FF_HD void fixup_item(long long i, long long n, const int* crow,
                      const uint32_t* cval, long long nrows, uint32_t* out) {
  const int r = crow[i];
  if (r >= nrows || (i > 0 && crow[i - 1] == r)) return;
  uint32_t acc[8];
  ldg8(acc, cval + 8 * i);
  // the slots after it, kWalk at a time: their rows and values are read
  // with no branch between the loads (past n the last slot again; values
  // of other rows masked to 0), then summed as a tree, so a batch waits
  // for one load and log2(kWalk) + 1 adds
  for (long long j = i + 1; j < n; j += kWalk) {
    uint32_t v[kWalk][8];
    int same = 0;
    FF_UNROLL
    for (int q = 0; q < kWalk; ++q) {
      const long long k = j + q < n ? j + q : n - 1;
      const uint32_t keep = (j + q < n && ldg(crow + k) == r) ? ~0u : 0u;
      ldg8(v[q], cval + 8 * k);
      FF_UNROLL
      for (int w = 0; w < 8; ++w) v[q][w] &= keep;
      same += (int)(keep & 1u);
    }
    FF_UNROLL
    for (int h = kWalk / 2; h > 0; h /= 2) {
      FF_UNROLL
      for (int q = 0; q < h; ++q) ff::add<Fr>(v[q], v[q], v[q + h]);
    }
    ff::add<Fr>(acc, acc, v[0]);
    if (same < kWalk) break;
  }
  st8(out + 8 * (long long)r, acc);
}

}  // namespace csr
