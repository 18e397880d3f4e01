// Kernel K8: batched double-and-add BN254 G1 scalar multiplication, each
// lane one joint double-and-add over the two halves of the GLV split.
//
// Replaces halo2_aggregation_tpu/ops/ec_pallas.py::_ladder_kernel (:317-351,
// via scalar_mul_pallas2 :610-665) and its _final_kernel pass: the outputs of
// fe_* are canonical already.  In the JAX package it is the H2A_PALLAS_WIN=0
// alternative to the windowed K1; here ops/ec_kernels.py::scalar_mul
// dispatches to it with method="ladder".
//
// Contract: lane i reads P_i = (x, y, z) and the plain scalar s_i, each 8 x
// 32-bit limbs, and writes (s_i mod 2^nbits) P_i, 1 <= nbits <= 256.  The
// points are on the curve, as K1's: the scalar is reduced mod r and split
// by the endomorphism, which acts as [lambda] only there.
//
// What bounds it on the H100: at the verifier's 4,608 lanes (36 a SM) the
// latency of one thread's chain of dependent Fq products.  The bit-serial
// ladder of 256 rounds paid a doubling and a 16-product add in every round
// in which any lane of the warp had the bit: 5,888 products in series,
// 2.48 ms.  What the design does about it: the rounds run over the halves'
// ~128 bits (ec_ladder.cuh), each one doubling and one mixed add of the
// affine addend the bit pair selects by word-wise selects, so the rounds
// are uniform over the warp: one inversion (~330 products) and about 128 x
// (7 + 11) in series, ~2,650.  No table, so no local array beyond the
// inversion's.  On an NVIDIA H100 80GB HBM3 (700 W) 1.15 ms at 4,608 lanes
// and 6.5 ms at 2^17, where full Jacobian adds (~3,000 in series) took 1.27
// and 7.14.  The block comes from the lane count as K1's does
// (ec_win.cuh::choose_lane_block); the ragged edge is a bounds check.
#include <cuda_runtime.h>

#include "ec_ladder.cuh"

namespace {

using namespace h2a;

__global__ void ec_ladder_kernel(const uint32_t* __restrict__ px,
                                 const uint32_t* __restrict__ py,
                                 const uint32_t* __restrict__ pz,
                                 const uint32_t* __restrict__ scalars,
                                 const uint32_t* __restrict__ consts,
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
  Jac r = ec_ladder_lane(P, s, nbits, consts);
  store_fe(ox + off, r.x);
  store_fe(oy + off, r.y);
  store_fe(oz + off, r.z);
}

}  // namespace

// The block size the launcher takes for n lanes, into *threads.
extern "C" int h2a_ec_ladder_block(int n, int* threads) {
  return choose_lane_block(ec_ladder_kernel, n, threads);
}

// Launches on `stream` at the block h2a_ec_ladder_block gives; returns
// cudaGetLastError() (0 on success).  consts: the 7 x 8 words of
// ec_win.cuh's constants on the device.
extern "C" int h2a_ec_ladder(const uint32_t* px, const uint32_t* py,
                             const uint32_t* pz, const uint32_t* scalars,
                             const uint32_t* consts, uint32_t* ox,
                             uint32_t* oy, uint32_t* oz, int n, int nbits,
                             void* stream) {
  if (n <= 0) return 0;
  if (nbits < 1 || nbits > EC_LADDER_MAX_BITS) return (int)cudaErrorInvalidValue;
  int threads = 0;
  int rc = h2a_ec_ladder_block(n, &threads);
  if (rc != 0) return rc;
  ec_ladder_kernel<<<(n + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(px, py, pz, scalars, consts, ox,
                                             oy, oz, n, nbits);
  return (int)cudaGetLastError();
}
