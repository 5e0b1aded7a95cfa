// Field kernels over Fr and Fp: elementwise Montgomery arithmetic, one
// radix-2 NTT stage, and the QAP row evaluation (sum of coefficient-times-
// value terms per row).
//
// These are not ports of Pallas kernels: on the TPU the NTT and the QAP
// row evaluation were XLA code on the f32-digit engine
// (zkpos_tpu/groth16/ntt_device.py:122 _stage_op,
// zkpos_tpu/groth16/qap_device.py:107 _eval_fn).  PyTorch has no 256-bit
// modular arithmetic, so they are kernels here.
//
// Bound on the H100: a Montgomery product is 264 32-bit multiplies (8 x
// (8 wide a*b products + 1 + 8 wide m*p products), lo and hi counted)
// against 96 bytes moved by an elementwise product, which puts the
// elementwise kernels and the NTT stage at the memory bound and the
// exponentiation (~380 products per element) at the integer-multiply
// bound.  The design keeps one element per thread with all limbs in
// registers, loads and stores 16 bytes at a time, and uses no shared
// memory; the NTT stage reads each butterfly pair once and writes it
// once.
//
// The row evaluation is bound by its bytes: per term a row id, a column
// and a coefficient id (12 B) and two gathered elements (64 B), 32 B a
// row out.  It splits the terms evenly, one warp a chunk of 32 x kCsrK
// terms, whatever rows they fall in (csr.cuh), so a long row -- the
// prove's lookup rows run to 16,385 terms -- is spread over many warps
// instead of serialised on one thread, as the one-thread-a-row kernel it
// replaces did (24.3 ms for the prove's A matrix on an H100, PERF.md).  It uploads a row id
// per term (the JAX package's term-parallel form had one too) rather than
// searching the row pointers: every lane then forms exactly kCsrK products
// with no divergence between products and row ends, for 4 more bytes a
// term.  Rows with no term are zeroed by a memset first.  A row through
// many chunks costs the fix-up one walk over its carry slots, kWalk at a
// time (csr.cuh).
#include <cuda_runtime.h>

#include "csr.cuh"
#include "field.cuh"

using namespace ff;

namespace {

const int kBlock = 256;

inline unsigned grid_for(long long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

__device__ __forceinline__ void ld8(uint32_t* r, const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 x = q[0], y = q[1];
  r[0] = x.x; r[1] = x.y; r[2] = x.z; r[3] = x.w;
  r[4] = y.x; r[5] = y.y; r[6] = y.z; r[7] = y.w;
}

__device__ __forceinline__ void st8(uint32_t* p, const uint32_t* r) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(r[0], r[1], r[2], r[3]);
  q[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// op: 0 = mul, 1 = add, 2 = sub.  sa / sb are 1 for a vector operand and
// 0 for a broadcast scalar.
template <class F, int OP>
__global__ void k_binary(uint32_t* out, const uint32_t* a, const uint32_t* b,
                         long long n, int sa, int sb) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], r[8];
  ld8(x, a + 8 * i * sa);
  ld8(y, b + 8 * i * sb);
  if (OP == 0) ff::mul<F>(r, x, y);
  else if (OP == 1) ff::add<F>(r, x, y);
  else ff::sub<F>(r, x, y);
  st8(out + 8 * i, r);
}

template <class F>
__global__ void k_pow(uint32_t* out, const uint32_t* a, const uint32_t* e,
                      const uint32_t* one, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], ee[8], o[8], r[8];
  ld8(x, a + 8 * i);
  ld8(ee, e);
  ld8(o, one);
  ff::powm<F>(r, x, ee, o);
  st8(out + 8 * i, r);
}

// One decimation-in-time stage over bit-reversed input, in place: for the
// butterfly k (of n/2), j = k mod half, i0 = 2*half*(k / half) + j,
// t = w^(j*tw_step) * a[i0 + half]; a[i0] += t; a[i0 + half] = a[i0] - t.
__global__ void k_ntt_stage(uint32_t* a, const uint32_t* tw, long long nbfly,
                            long long half, long long tw_step) {
  long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= nbfly) return;
  long long j = k & (half - 1);
  long long i0 = ((k - j) << 1) + j;
  long long i1 = i0 + half;
  uint32_t u[8], v[8], w[8], t[8];
  ld8(u, a + 8 * i0);
  ld8(v, a + 8 * i1);
  ld8(w, tw + 8 * (j * tw_step));
  ff::mul<Fr>(t, w, v);          // t = w * a[i1]
  ff::add<Fr>(w, u, t);          // a[i0] + t
  ff::sub<Fr>(v, u, t);          // a[i0] - t
  st8(a + 8 * i0, w);
  st8(a + 8 * i1, v);
}

// The row evaluation (csr.cuh): one warp a chunk of 32 x kCsrK terms,
// kCsrWarps chunks a block, each warp with its exchange area in shared
// memory; then one thread a carry slot.
const int kCsrK = 8;
const int kCsrChunk = 32 * kCsrK;
const int kCsrWarps = 4;

struct CsrExchange {
  int hr[32], tr[32];
  uint32_t v[2][32][8];
};

__global__ void __launch_bounds__(32 * kCsrWarps)
k_csr_eval(csr::Terms m, long long chunks, int* crow, uint32_t* cval,
           uint32_t* out) {
  __shared__ __align__(16) CsrExchange ex[kCsrWarps];
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  const long long c = (long long)blockIdx.x * kCsrWarps + w;
  if (c >= chunks) return;               // whole warps leave together
  CsrExchange& e = ex[w];
  csr::Runs L;
  csr::lane_runs(L, m, c * kCsrChunk + (long long)l * kCsrK, kCsrK, out);
  e.hr[l] = L.hr;
  e.tr[l] = L.tr;
  csr::st8(e.v[0][l], L.ts);
  __syncwarp();
  int cur = 0;
  for (int d = 1; d < 32; d <<= 1, cur ^= 1) {
    csr::scan_round(l, d, e.tr, &e.v[cur][0][0], &e.v[cur ^ 1][0][0]);
    __syncwarp();
  }
  csr::lane_finish(L, l, 32, e.hr, e.tr, &e.v[cur][0][0], crow + 2 * c,
                   cval + 16 * c, out);
}

__global__ void k_csr_fixup(const int* crow, const uint32_t* cval,
                            long long n, long long nrows, uint32_t* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) csr::fixup_item(i, n, crow, cval, nrows, out);
}

template <int OP>
void launch_binary(int field, uint32_t* out, const uint32_t* a,
                   const uint32_t* b, long long n, int sa, int sb,
                   cudaStream_t s) {
  if (field == 0)
    k_binary<Fr, OP><<<grid_for(n, kBlock), kBlock, 0, s>>>(out, a, b, n, sa, sb);
  else
    k_binary<Fp, OP><<<grid_for(n, kBlock), kBlock, 0, s>>>(out, a, b, n, sa, sb);
}

}  // namespace

extern "C" {

// field: 0 = Fr, 1 = Fp.  Every entry point returns cudaGetLastError().
int zk_ff_binary(int op, int field, void* out, const void* a, const void* b,
                 long long n, int sa, int sb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
  const uint32_t* x = (const uint32_t*)a;
  const uint32_t* y = (const uint32_t*)b;
  if (n > 0) {
    if (op == 0) launch_binary<0>(field, o, x, y, n, sa, sb, s);
    else if (op == 1) launch_binary<1>(field, o, x, y, n, sa, sb, s);
    else launch_binary<2>(field, o, x, y, n, sa, sb, s);
  }
  return (int)cudaGetLastError();
}

int zk_ff_pow(int field, void* out, const void* a, const void* e,
              const void* one, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (field == 0)
      k_pow<Fr><<<grid_for(n, 128), 128, 0, s>>>(
          (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)e,
          (const uint32_t*)one, n);
    else
      k_pow<Fp><<<grid_for(n, 128), 128, 0, s>>>(
          (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)e,
          (const uint32_t*)one, n);
  }
  return (int)cudaGetLastError();
}

int zk_ntt_stage(void* a, const void* tw, long long n, long long half,
                 long long tw_step, void* stream) {
  long long nb = n / 2;
  if (nb > 0)
    k_ntt_stage<<<grid_for(nb, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
        (uint32_t*)a, (const uint32_t*)tw, nb, half, tw_step);
  return (int)cudaGetLastError();
}

// Carry chunks of a row evaluation over T terms: the scratch holds 2 of
// them a chunk (a row id, and 8 limbs).
long long zk_csr_chunks(long long T) {
  return (T + kCsrChunk - 1) / kCsrChunk;
}

// out (nrows, 8) = the row sums of the T terms (row, col, cid ascending by
// row, every row below nrows); crow (2 chunks) and cval (2 chunks x 8) are
// scratch.
int zk_csr_eval(void* out, const void* row, const void* col, const void* cid,
                const void* pool, const void* x, long long nrows, long long T,
                void* crow, void* cval, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nrows > 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, 32 * nrows, s);
    if (e != cudaSuccess) return (int)e;
  }
  const long long chunks = zk_csr_chunks(T);
  if (chunks > 0) {
    csr::Terms m{(const int*)row, (const int*)col, (const int*)cid,
                 (const uint32_t*)pool, (const uint32_t*)x, T};
    k_csr_eval<<<grid_for(chunks, kCsrWarps), 32 * kCsrWarps, 0, s>>>(
        m, chunks, (int*)crow, (uint32_t*)cval, (uint32_t*)out);
    k_csr_fixup<<<grid_for(2 * chunks, kBlock), kBlock, 0, s>>>(
        (const int*)crow, (const uint32_t*)cval, 2 * chunks, nrows,
        (uint32_t*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
