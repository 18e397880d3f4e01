// Kernel K5: elementwise Montgomery products over Fr columns, and the power
// series.
//
// Replaces halo2_aggregation_tpu/ops/ntt_pallas.py::_ew_mul_kernel (:179,
// via ew_mul_u8 :288: a batch times a shared column, the coset shift
// powers) and ::_ew_mul_scalar_kernel (:419, via ew_mul_scalar_u8 :402: a
// batch times one scalar, 1/n and the coset points).  The third entry
// point replaces pow_series_u8 (:436), which ran the scalar kernel once
// per exponent bit with an XLA select between: here thread i computes
// start * base^idx(i) by square-and-multiply, idx(i) = i or the k-bit
// reversal of i.
//
// Layout: (..., 8) int32 elements, canonical Montgomery in and out; one
// thread per element; in place is allowed (each thread reads its element
// before it writes it).
//
// What bounds it on the H100: the products are device-memory bound (one
// Montgomery product per 64 bytes moved); pow_series is compute bound (up
// to 2k products per element, nothing read).
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

// out[i] = start * base^idx(i) for i < 2^k.
__global__ void pow_series_kernel(uint32_t* __restrict__ out,
                                  const uint32_t* __restrict__ start,
                                  const uint32_t* __restrict__ base, int k,
                                  int bitrev) {
  uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (1u << k)) return;
  uint32_t e = (bitrev && k > 0) ? bit_reverse(i, k) : i;
  st_fe(out + (size_t)i * NL, fe_pow_times(ld_fe(start), ld_fe(base), e, k));
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

extern "C" int h2a_pow_series(uint32_t* out, const uint32_t* start,
                              const uint32_t* base, int k, int bitrev,
                              void* stream) {
  if (k < 0 || k > 30) return (int)cudaErrorInvalidValue;
  unsigned blocks = ((1u << k) + kThreads - 1) / kThreads;
  pow_series_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      out, start, base, k, bitrev);
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
