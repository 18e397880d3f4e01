// Kernel K8: batched bit-serial double-and-add BN254 G1 scalar
// multiplication.
//
// Replaces halo2_aggregation_tpu/ops/ec_pallas.py::_ladder_kernel (:317-351,
// via scalar_mul_pallas2 :610-665) and its _final_kernel pass: the outputs of
// fe_* are canonical already.  In the JAX package it is the H2A_PALLAS_WIN=0
// alternative to the windowed K1; here ops/ec_kernels.py::scalar_mul
// dispatches to it with method="ladder".
//
// Shape: one thread per lane, as K1 (csrc/ec_win.cu).  Lane i reads
// P_i = (x, y, z) and the plain scalar s_i, each 8 x 32-bit limbs, and runs
// nbits rounds of one doubling and, where the bit is set, one full add.
// No table, so no local array: about 7 + 8 Montgomery products a bit on
// average (7 for a doubling, 16 for an add, half the bits set), about 3,800
// a lane at nbits = 254 against K1's 2,950.  What bounds it is integer multiply
// issue and, at the verifier's 4,608 lanes (36 a SM), latency.
#include <cuda_runtime.h>

#include "ec_ladder.cuh"

namespace {

using namespace h2a;

__global__ void ec_ladder_kernel(const uint32_t* __restrict__ px,
                                 const uint32_t* __restrict__ py,
                                 const uint32_t* __restrict__ pz,
                                 const uint32_t* __restrict__ scalars,
                                 uint32_t* __restrict__ ox,
                                 uint32_t* __restrict__ oy,
                                 uint32_t* __restrict__ oz, int n, int nbits) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  size_t off = (size_t)i * NL;
  Jac P{load_fe(px + off), load_fe(py + off), load_fe(pz + off)};
  uint32_t s[NL];
#pragma unroll
  for (int k = 0; k < NL; k++) s[k] = scalars[off + k];
  Jac r = ec_ladder_lane(P, s, nbits);
  store_fe(ox + off, r.x);
  store_fe(oy + off, r.y);
  store_fe(oz + off, r.z);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int h2a_ec_ladder(const uint32_t* px, const uint32_t* py,
                             const uint32_t* pz, const uint32_t* scalars,
                             uint32_t* ox, uint32_t* oy, uint32_t* oz, int n,
                             int nbits, void* stream) {
  if (n <= 0) return 0;
  if (nbits < 1 || nbits > EC_LADDER_MAX_BITS) return (int)cudaErrorInvalidValue;
  // 32 threads a block, as K1: 144 blocks at the verifier's 4,608 lanes
  const int threads = 32;
  ec_ladder_kernel<<<(n + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(px, py, pz, scalars, ox, oy, oz,
                                             n, nbits);
  return (int)cudaGetLastError();
}
