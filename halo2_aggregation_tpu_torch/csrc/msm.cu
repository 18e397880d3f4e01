// Kernels K7 and K9: the bucket (Pippenger) MSM, sum_i s_i * P_i over
// affine BN254 G1 points, in two launches per MSM.
//
// Replaces halo2_aggregation_tpu/ops/ec_pallas.py::_msm_kernel_s5 (:490-601,
// via msm_bucket_pallas_s5 :899-1037; K7: signed 5-bit digits, mixed adds,
// in-kernel bucket fold) and ::_msm_kernel (:408-487, via msm_bucket_pallas
// :736-858; K9: unsigned 4-bit digits, full adds).  The TPU kernels gave each
// of 128 lanes private buckets in VMEM and streamed point tiles past them,
// one grid step at a time; the chunk sums and the Horner across windows ran
// outside in XLA.  Here:
//
// 1. msm_bucket_kernel: one thread per (window w, chunk c), C chunks a
//    window.  The thread keeps its 16 (K7) or 15 (K9) buckets in local
//    memory (96 B each), strides over the points i = c, c + C, ... so that a
//    warp reads consecutive points and digits, adds each point into bucket
//    |d| (msm.cuh::msm_chunk) and folds its buckets into one point,
//    partials[w][c].  The last chunk is ragged: the stride loop stops at n.
// 2. msm_combine_kernel: one block per window sums its C partials (a strided
//    sum per thread, then a tree in shared memory) into wsums[w]; the last
//    block to finish (a ticket counter) runs the Horner across windows and
//    writes the one Jacobian result.
//
// What bounds it on the H100: the adds.  At n = 2^21, K7 does 52 x 2^21
// mixed adds of 11 Montgomery products, about 1.2 G products; K9 64 x 2^21
// full adds of 16.  Each add also reads and writes one bucket in local
// memory (about 21 GB for K7 if none of it stays in L1 or L2), and each
// point is read once per window, by threads of all windows at about the
// same time, so mostly from L2.  C is chosen by the wrapper so that
// n_win x C threads fill the card (ops/msm.py::choose_chunks).
#include <cuda_runtime.h>

#include "msm.cuh"

namespace {

using namespace h2a;

constexpr int kBucketThreads = 128;
constexpr int kSumThreads = 128;
constexpr int kJacWords = 3 * NL;

__device__ __forceinline__ void store_jac(uint32_t* dst, const Jac& p) {
  uint4* q = reinterpret_cast<uint4*>(dst);
  const Fe* c[3] = {&p.x, &p.y, &p.z};
#pragma unroll
  for (int k = 0; k < 3; k++) {
    q[2 * k] = make_uint4(c[k]->v[0], c[k]->v[1], c[k]->v[2], c[k]->v[3]);
    q[2 * k + 1] = make_uint4(c[k]->v[4], c[k]->v[5], c[k]->v[6], c[k]->v[7]);
  }
}

__device__ __forceinline__ Jac load_jac(const uint32_t* src) {
  return Jac{msm_load(src), msm_load(src + NL), msm_load(src + 2 * NL)};
}

// A load that bypasses L1: the last combine block reads the other blocks'
// window sums, written after its own SM may have cached those lines.
__device__ __forceinline__ Fe load_fe_l2(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 a = __ldcg(q), b = __ldcg(q + 1);
  Fe r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  return r;
}

template <bool SIGNED>
__global__ void msm_bucket_kernel(const uint32_t* __restrict__ xs,
                                  const uint32_t* __restrict__ ys,
                                  const uint8_t* __restrict__ digits,
                                  uint32_t n, uint32_t C,
                                  uint32_t* __restrict__ partials) {
  uint32_t c = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t w = blockIdx.y;
  if (c >= C) return;
  Jac r = msm_chunk<SIGNED>(xs, ys, digits + (size_t)w * n, n, c, C);
  store_jac(partials + ((size_t)w * C + c) * kJacWords, r);
}

template <bool SIGNED>
__global__ void msm_combine_kernel(const uint32_t* __restrict__ partials,
                                   uint32_t C, uint32_t* wsums,
                                   unsigned int* ticket,
                                   uint32_t* __restrict__ out) {
  __shared__ Jac sh[kSumThreads];
  const uint32_t w = blockIdx.x;
  const int t = threadIdx.x;
  Jac acc = jac_identity();
  for (uint32_t c = t; c < C; c += kSumThreads)
    acc = jac_add(acc, load_jac(partials + ((size_t)w * C + c) * kJacWords));
  sh[t] = acc;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = jac_add(sh[t], sh[t + s]);
    __syncthreads();
  }
  if (t != 0) return;
  store_jac(wsums + (size_t)w * kJacWords, sh[0]);
  __threadfence();
  if (atomicAdd(ticket, 1u) != gridDim.x - 1) return;
  // the last block: every window sum is written and fenced
  __threadfence();
  constexpr int W = MsmKind<SIGNED>::WINDOWS;
  Jac ws[W];
  for (int v = 0; v < W; v++) {
    const uint32_t* src = wsums + (size_t)v * kJacWords;
    ws[v] = Jac{load_fe_l2(src), load_fe_l2(src + NL), load_fe_l2(src + 2 * NL)};
  }
  store_jac(out, msm_horner(ws, W, MsmKind<SIGNED>::BITS));
  *ticket = 0;
}

template <bool SIGNED>
int launch(const uint32_t* xs, const uint32_t* ys, const uint8_t* digits,
           int n, int C, uint32_t* partials, uint32_t* wsums,
           unsigned int* ticket, uint32_t* out, cudaStream_t stream) {
  constexpr int W = MsmKind<SIGNED>::WINDOWS;
  dim3 grid((C + kBucketThreads - 1) / kBucketThreads, W);
  msm_bucket_kernel<SIGNED><<<grid, kBucketThreads, 0, stream>>>(
      xs, ys, digits, (uint32_t)n, (uint32_t)C, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msm_combine_kernel<SIGNED><<<W, kSumThreads, 0, stream>>>(
      partials, (uint32_t)C, wsums, ticket, out);
  return (int)cudaGetLastError();
}

}  // namespace

// One MSM on `stream`: digits (n_win, n) uint8, points xs/ys (n, 8);
// scratch partials (n_win, C, 3, 8), wsums (n_win, 3, 8), ticket (1,) zeroed;
// out (3, 8) Jacobian.  Returns cudaGetLastError() (0 on success).
extern "C" int h2a_msm(int is_signed, const uint32_t* xs, const uint32_t* ys,
                       const uint8_t* digits, int n, int C,
                       uint32_t* partials, uint32_t* wsums,
                       unsigned int* ticket, uint32_t* out, void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_signed
             ? launch<true>(xs, ys, digits, n, C, partials, wsums, ticket, out, s)
             : launch<false>(xs, ys, digits, n, C, partials, wsums, ticket, out, s);
}
