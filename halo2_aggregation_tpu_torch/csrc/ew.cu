// Kernel K5: elementwise Montgomery products over Fr columns, and the power
// series.
//
// Replaces halo2_aggregation_tpu/ops/ntt_pallas.py::_ew_mul_kernel (:179,
// via ew_mul_u8 :288: a batch times a shared column, the coset shift
// powers) and ::_ew_mul_scalar_kernel (:419, via ew_mul_scalar_u8 :402: a
// batch times one scalar, 1/n and the coset points).  The power series
// replaces pow_series_u8 (:436), which ran the scalar kernel once per
// exponent bit with an XLA select between.
//
// Layout: (..., 8) int32 elements, canonical Montgomery in and out; one
// thread per element; in place is allowed (each thread reads its element
// before it writes it).
//
// What bounds it on the H100: the products are device-memory bound (one
// Montgomery product per 64 bytes moved).  The power series is one product
// an element at its least; square-and-multiply a thread spent up to 2k
// dependent ones (0.902 ms at k = 21 against a bound of 0.034).  Here it is
// two launches (ntt.cuh): the first builds two tables of 2^ceil(k/2) and
// 2^floor(k/2) entries from the host's k squares of the base, each entry
// at most ceil(k/2) products; the second takes one product an element of
// an entry of each (both tables together 96 KB at k = 21, read through L1
// and L2) and writes it with 16-byte stores, in a grid-strided loop.  On an
// NVIDIA H100 80GB HBM3 (700 W) at k = 21: 0.052 ms, the tables 0.009 and
// the products 0.043, where square-and-multiply a thread took 0.76.
//
// Two test entries measure fe_mul itself: h2a_mont_mul (one product an
// element, held to the plain PyTorch product) and h2a_mul_chain (a chain of
// dependent products a thread: the latency of one).
#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

using namespace h2a;

constexpr int kThreads = 256;

// out[c][i] = x[c][i] * col[i]; grid y = column c.
__global__ void ew_mul_col_kernel(const uint32_t* x,
                                  const uint32_t* __restrict__ col,
                                  uint32_t* out, uint32_t n) {
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  size_t e = ((size_t)blockIdx.y * n + i) * NL;
  st_fe(out + e, fe_mul<Fr>(ld_fe(x + e), ld_fe(col + (size_t)i * NL)));
}

// out[i] = x[i] * s for `total` elements.
__global__ void ew_mul_scalar_kernel(const uint32_t* x,
                                     const uint32_t* __restrict__ s,
                                     uint32_t* out, size_t total) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  st_fe(out + i * NL, fe_mul<Fr>(ld_fe(x + i * NL), ld_fe(s)));
}

// The series' tables (ntt.cuh): entry e of `len`.
__global__ void pow_series_tables_kernel(uint32_t* __restrict__ tables,
                                         const uint32_t* __restrict__ sq,
                                         int k, int bitrev, uint32_t len) {
  uint32_t e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  st_fe(tables + (size_t)e * NL, pow_series_table_entry(sq, k, bitrev, e));
}

// out[i] = TA[lo] * TB[hi] for i < 2^k, grid-strided.
__global__ void pow_series_products_kernel(uint32_t* __restrict__ out,
                                           const uint32_t* __restrict__ tables,
                                           int k) {
  uint32_t n = 1u << k, stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    st_fe(out + (size_t)i * NL, pow_series_element(tables, k, i));
}

// out[i] = a[i] * b[i] in F: the device's fe_mul alone, for the check of
// the product itself against the plain PyTorch one.
template <class F>
__global__ void mont_mul_kernel(const uint32_t* __restrict__ a,
                                const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, uint32_t n) {
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  size_t e = (size_t)i * NL;
  st_fe(out + e, fe_mul<F>(ld_fe(a + e), ld_fe(b + e)));
}

// out[i] = a[i] * b[i]^iters: every thread runs `iters` products in series,
// each waiting for the one before.  With one warp a block and one block an
// SM the time over iters is the latency of one dependent fe_mul.
template <class F>
__global__ void mul_chain_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int iters) {
  size_t e = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * NL;
  Fe x = ld_fe(a + e), y = ld_fe(b + e);
#pragma unroll 1
  for (int i = 0; i < iters; i++) x = fe_mul<F>(x, y);
  st_fe(out + e, x);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError().

extern "C" int h2a_ew_mul_col(const uint32_t* x, const uint32_t* col,
                              uint32_t* out, int cols, int n, void* stream) {
  if (cols <= 0 || n <= 0) return 0;
  dim3 grid((n + kThreads - 1) / kThreads, cols);
  ew_mul_col_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, col, out, (uint32_t)n);
  return (int)cudaGetLastError();
}

extern "C" int h2a_ew_mul_scalar(const uint32_t* x, const uint32_t* s,
                                 uint32_t* out, long long total,
                                 void* stream) {
  if (total <= 0) return 0;
  unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  ew_mul_scalar_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, s, out, (size_t)total);
  return (int)cudaGetLastError();
}

// The series' tables, pow_series_table_len(k) entries, from sq = (start,
// base, base^2, base^4, .. base^(2^(k-1))): one thread an entry, one warp a
// block, so that the few warps spread over the SMs.
extern "C" int h2a_pow_series_tables(uint32_t* tables, const uint32_t* sq,
                                     int k, int bitrev, void* stream) {
  if (k < 0 || k > 30) return (int)cudaErrorInvalidValue;
  uint32_t len = pow_series_table_len(k);
  pow_series_tables_kernel<<<(len + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      tables, sq, k, bitrev, len);
  return (int)cudaGetLastError();
}

// out[i] = start * base^idx(i) for i < 2^k from the tables: as many blocks
// as the card holds at once, at most one an element block.
extern "C" int h2a_pow_series_products(uint32_t* out, const uint32_t* tables,
                                       int k, void* stream) {
  if (k < 0 || k > 30) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pow_series_products_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  long long need = ((1ll << k) + kThreads - 1) / kThreads;
  long long fill = (long long)sms * (per_sm > 0 ? per_sm : 1);
  unsigned blocks = (unsigned)(need < fill ? need : fill);
  pow_series_products_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      out, tables, k);
  return (int)cudaGetLastError();
}

// Test entry: out[i] = a[i] * b[i] for n elements of Fq (field == 0) or Fr.
extern "C" int h2a_mont_mul(int field, const uint32_t* a, const uint32_t* b,
                            uint32_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  unsigned blocks = ((unsigned)n + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)stream;
  if (field) {
    mont_mul_kernel<Fr><<<blocks, kThreads, 0, st>>>(a, b, out, (uint32_t)n);
  } else {
    mont_mul_kernel<Fq><<<blocks, kThreads, 0, st>>>(a, b, out, (uint32_t)n);
  }
  return (int)cudaGetLastError();
}

// Latency probe: `blocks` blocks of one warp, each thread `iters` dependent
// products over element (block, thread) of a and b, in Fq (field == 0) or Fr.
extern "C" int h2a_mul_chain(int field, const uint32_t* a, const uint32_t* b,
                             uint32_t* out, int blocks, int iters,
                             void* stream) {
  if (blocks <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (field) {
    mul_chain_kernel<Fr><<<blocks, 32, 0, st>>>(a, b, out, iters);
  } else {
    mul_chain_kernel<Fq><<<blocks, 32, 0, st>>>(a, b, out, iters);
  }
  return (int)cudaGetLastError();
}
