// Kernels K7 and K9: the bucket (Pippenger) MSM, sum_i s_i * P_i over
// affine BN254 G1 points, in two launches per MSM.
//
// K7 replaces halo2_aggregation_tpu/ops/ec_pallas.py::_msm_kernel_s5
// (:490-601, via msm_bucket_pallas_s5 :899-1037: signed 5-bit digits, mixed
// adds, in-kernel bucket fold); K9 replaces ::_msm_kernel (:408-487, via
// msm_bucket_pallas :736-858: unsigned 4-bit digits, full adds).  The TPU
// kernels gave each of 128 lanes private buckets in VMEM and streamed point
// tiles past them, one grid step at a time; the chunk sums and the Horner
// across windows ran outside in XLA.
//
// What bounds them on the H100: the Montgomery products of the adds.  At
// n = 2^21, K7 makes 52 x 2^21 mixed adds of 11 products (1.20 G products,
// 19.6 ms at the card's 61 G products a second), K9 64 x 2^21 full adds of
// 16 (2.15 G, 35.2 ms).  The bytes are far below that: every point is read
// once a window (7 to 9 GB of 32-byte sectors, mostly from L2) and the
// digits twice.
//
// What the design does about it: nothing but the adds may cost time a
// point, so no bucket lives in local memory and no add waits on a
// data-dependent store.
// 1. msm_bucket_kernel: one thread per (window w, chunk c) of C contiguous
//    chunks a window.  The thread counting-sorts its chunk by digit
//    magnitude (histogram in shared memory, one column a thread, so no bank
//    is shared; offsets into a uint16 scratch in device memory), then walks
//    the sorted points with ONE bucket sum in registers, parks each finished
//    sum in scratch, and folds the parked sums (msm.cuh).  A warp's lanes
//    make one add an iteration each, and differ only in their chunks' zero
//    digits.  The window is the fastest block index: the blocks of all
//    windows over one range of chunks run together and share the points in
//    L2.  C comes from
//    the kernel's occupancy (h2a_msm_occupancy, ops/msm.py::choose_chunks):
//    n_win x C / 128 blocks fill a whole number of waves.  The ragged last
//    chunk stops at n.
// 2. msm_combine_kernel: one block per window sums its C partials (a strided
//    sum per thread, then a tree in shared memory) into wsums[w]; the last
//    block to finish (a ticket counter) runs the Horner across windows and
//    writes the one Jacobian result.
#include <cuda_runtime.h>

#include "msm.cuh"

namespace {

using namespace h2a;

constexpr int kBucketThreads = 128;
constexpr int kSumThreads = 128;

// blocks an SM should hold: caps the registers a thread (65,536 / 128 / 3).
// On an H100 at n = 2^21 the kernels ran within 3 % of each other at 3, 4
// and 5 (K7 61.1 / 61.8 / 63.0 ms); 3 is the one that leaves ptxas no spill.
constexpr int kBucketMinBlocks = 3;

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

// Block b covers window b % n_win and chunks [128 * (b / n_win), ...).
template <bool SIGNED>
__global__ void __launch_bounds__(kBucketThreads, kBucketMinBlocks)
msm_bucket_kernel(const uint32_t* __restrict__ xs,
                  const uint32_t* __restrict__ ys,
                  const uint8_t* __restrict__ digits, uint32_t n, uint32_t C,
                  uint32_t L, uint16_t* __restrict__ order,
                  uint32_t* __restrict__ bsums,
                  uint32_t* __restrict__ partials) {
  constexpr int W = MsmKind<SIGNED>::WINDOWS;
  constexpr int NB = MsmKind<SIGNED>::BUCKETS;
  __shared__ uint32_t cnt[(NB + 1) * kBucketThreads];
  uint32_t w = blockIdx.x % W;
  uint32_t c = (blockIdx.x / W) * kBucketThreads + threadIdx.x;
  if (c >= C) return;
  size_t lane = (size_t)w * C + c;
  Jac r = msm_chunk<SIGNED>(
      xs, ys, digits + (size_t)w * n, n, c, L, order + (size_t)w * n,
      bsums + lane * NB * kJacWords, cnt + threadIdx.x, kBucketThreads);
  msm_store_jac(partials + lane * kJacWords, r);
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
    acc = msm_jac_add(acc, msm_load_jac(partials + ((size_t)w * C + c) * kJacWords));
  sh[t] = acc;
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] = msm_jac_add(sh[t], sh[t + s]);
    __syncthreads();
  }
  if (t != 0) return;
  msm_store_jac(wsums + (size_t)w * kJacWords, sh[0]);
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
  msm_store_jac(out, msm_horner(ws, W, MsmKind<SIGNED>::BITS));
  *ticket = 0;
}

template <bool SIGNED>
int launch(const uint32_t* xs, const uint32_t* ys, const uint8_t* digits,
           int n, int C, uint16_t* order, uint32_t* bsums, uint32_t* partials,
           uint32_t* wsums, unsigned int* ticket, uint32_t* out,
           cudaStream_t stream) {
  constexpr int W = MsmKind<SIGNED>::WINDOWS;
  uint32_t L = ((uint32_t)n + (uint32_t)C - 1) / (uint32_t)C;
  if (L > kMsmMaxChunk) return (int)cudaErrorInvalidValue;
  int chunk_blocks = (C + kBucketThreads - 1) / kBucketThreads;
  msm_bucket_kernel<SIGNED><<<W * chunk_blocks, kBucketThreads, 0, stream>>>(
      xs, ys, digits, (uint32_t)n, (uint32_t)C, L, order, bsums, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msm_combine_kernel<SIGNED><<<W, kSumThreads, 0, stream>>>(
      partials, (uint32_t)C, wsums, ticket, out);
  return (int)cudaGetLastError();
}

template <bool SIGNED>
int occupancy(int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, msm_bucket_kernel<SIGNED>, kBucketThreads, 0);
}

}  // namespace

// One MSM on `stream`: digits (n_win, n) uint8, points xs/ys (n, 8); C
// contiguous chunks a window, of ceil(n / C) <= 2^15 points; scratch order
// (n_win, n) uint16, bsums (n_win, C, buckets, 3, 8), partials
// (n_win, C, 3, 8), wsums (n_win, 3, 8), ticket (1,) zeroed; out (3, 8)
// Jacobian.  Returns cudaGetLastError() (0 on success).
extern "C" int h2a_msm(int is_signed, const uint32_t* xs, const uint32_t* ys,
                       const uint8_t* digits, int n, int C, uint16_t* order,
                       uint32_t* bsums, uint32_t* partials, uint32_t* wsums,
                       unsigned int* ticket, uint32_t* out, void* stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_signed ? launch<true>(xs, ys, digits, n, C, order, bsums, partials,
                                  wsums, ticket, out, s)
                   : launch<false>(xs, ys, digits, n, C, order, bsums, partials,
                                   wsums, ticket, out, s);
}

// The bucket kernel's occupancy on the current device: the blocks (of 128
// threads) an SM holds at once, and the device's SMs.  The wrapper sizes C
// to whole waves of blocks_per_sm x sms blocks.
extern "C" int h2a_msm_occupancy(int is_signed, int* blocks_per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  return is_signed ? occupancy<true>(blocks_per_sm)
                   : occupancy<false>(blocks_per_sm);
}
