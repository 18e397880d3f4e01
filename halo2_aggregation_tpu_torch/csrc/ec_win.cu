// Kernel K1: batched 4-bit windowed BN254 G1 scalar multiplication.
//
// Replaces halo2_aggregation_tpu/ops/ec_pallas.py::_win_kernel (:354-405)
// and its canonicalizing companion _final_kernel (:604-607): the outputs of
// fe_* are canonical already, so no second pass is needed.
//
// Shape: one thread per lane.  Lane i reads P_i = (x, y, z) and the plain
// scalar s_i, each 8 x 32-bit limbs, and keeps its 16-entry table k*P in
// local memory (16 x 3 x 32 B = 1.5 KB a thread).  The ragged edge is a
// bounds check; no identity padding is needed, unlike the TPU's 128-lane
// tiles.
//
// What bounds it on the H100: integer multiply throughput, not memory.  A
// lane reads 128 B and writes 96 B, but spends about 2,950 Fq Montgomery
// products (7 doublings and 7 adds for the table, then 252 doublings and
// 64 adds; the TPU kernel's branchless add also pays a doubling, which
// bench.py:382-388 counts as 3,474), each 128 32x32->64-bit multiply-adds
// plus carries.  The design answers with 64-bit products on 32-bit limbs
// (4x fewer partial products than the TPU's 8-bit limbs) and branches for
// the rare edge cases.  One thread per lane gives few warps at the main
// path's 4,608 lanes, so latency, not issue rate, is the next limit; that
// is for a later change.
#include <cuda_runtime.h>

#include "ec_win.cuh"

namespace {

using namespace h2a;

__device__ __forceinline__ void load_fe(Fe& r, const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = src[i];
}

__device__ __forceinline__ void store_fe(uint32_t* dst, const Fe& a) {
#pragma unroll
  for (int i = 0; i < NL; i++) dst[i] = a.v[i];
}

__global__ void ec_win_kernel(const uint32_t* __restrict__ px,
                              const uint32_t* __restrict__ py,
                              const uint32_t* __restrict__ pz,
                              const uint32_t* __restrict__ scalars,
                              uint32_t* __restrict__ ox,
                              uint32_t* __restrict__ oy,
                              uint32_t* __restrict__ oz, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  size_t off = (size_t)i * NL;
  Jac P;
  load_fe(P.x, px + off);
  load_fe(P.y, py + off);
  load_fe(P.z, pz + off);
  uint32_t s[NL];
#pragma unroll
  for (int k = 0; k < NL; k++) s[k] = scalars[off + k];
  Jac r = ec_win_lane(P, s);
  store_fe(ox + off, r.x);
  store_fe(oy + off, r.y);
  store_fe(oz + off, r.z);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int h2a_ec_win(const uint32_t* px, const uint32_t* py,
                          const uint32_t* pz, const uint32_t* scalars,
                          uint32_t* ox, uint32_t* oy, uint32_t* oz, int n,
                          void* stream) {
  if (n <= 0) return 0;
  // 32 threads a block spreads the 4,608 main-path lanes over 144 blocks,
  // more than the card's 132 SMs
  const int threads = 32;
  ec_win_kernel<<<(n + threads - 1) / threads, threads, 0,
                  (cudaStream_t)stream>>>(px, py, pz, scalars, ox, oy, oz, n);
  return (int)cudaGetLastError();
}
