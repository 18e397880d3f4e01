// Kernel K1: batched 4-bit windowed BN254 G1 scalar multiplication, each
// lane split by the GLV endomorphism over two threads.
//
// Replaces halo2_aggregation_tpu/ops/ec_pallas.py::_win_kernel (:354-405)
// and its canonicalizing companion _final_kernel (:604-607): the outputs of
// fe_* are canonical already, so no second pass is needed.
//
// What bounds it on the H100: at the main path's 4,608 lanes not the
// multiply throughput but the latency of one thread's chain of dependent Fq
// products.  A lane reads 128 B and writes 96 B; one thread a lane spent
// about 2,950 products in series (a 16-entry table, 252 doublings, 64 adds)
// on 144 warps, a quarter of the card's 528 warp schedulers, and a thread
// holds one carry chain at a time, so its products cannot overlap.
//
// What the design does about it: a shorter chain on more warps.  The scalar
// is reduced mod r and split in the kernel, s = s1 + s2 lambda with halves
// of about 128 bits (ec_win.cuh; the e-lane's scalar is made on the card,
// so the split cannot be the host's).  Thread 2i runs |s1| over +-P_i,
// thread 2i + 1 runs |s2| over +-phi(P_i) = (beta X, +-Y, Z): each 33
// windows of signed digits over a table of 8 entries in local memory
// (0.9 KB a thread), about 1,520 products in series.  Thread 2i + 1's point
// goes to thread 2i by shuffles; that thread adds the two, makes the
// identity (1, 1, 0) and stores.  The block is one warp while the launch is
// short (under two waves of the occupancy call's block), so that the warps
// spread evenly over every SM, and the size the occupancy call gives (at
// most 256 threads) above that (ec_win.cuh::choose_lane_block, which K8
// shares); the ragged edge is a bounds check.
//
// The contract gains one clause over the TPU kernel's: the points are on
// the curve (phi is [lambda] only there).
#include <cuda_runtime.h>

#include "ec_win.cuh"

namespace {

using namespace h2a;

__global__ void ec_win_kernel(const uint32_t* __restrict__ px,
                              const uint32_t* __restrict__ py,
                              const uint32_t* __restrict__ pz,
                              const uint32_t* __restrict__ scalars,
                              const uint32_t* __restrict__ consts,
                              uint32_t* __restrict__ ox,
                              uint32_t* __restrict__ oy,
                              uint32_t* __restrict__ oz, int n) {
  // every thread of the warp stays for the shuffles: no early return
  size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t lane = t >> 1;
  int h = (int)(t & 1);
  bool active = lane < (size_t)n;
  size_t off = lane * NL;
  Jac half = jac_identity();
  if (active) {
    Jac P{load_fe(px + off), load_fe(py + off), load_fe(pz + off)};
    uint32_t s[NL];
#pragma unroll
    for (int k = 0; k < NL; k++) s[k] = scalars[off + k];
    half = ec_glv_half(P, s, consts, h);
  }
  Jac other;
#pragma unroll
  for (int k = 0; k < NL; k++) {
    other.x.v[k] = __shfl_down_sync(0xffffffffu, half.x.v[k], 1);
    other.y.v[k] = __shfl_down_sync(0xffffffffu, half.y.v[k], 1);
    other.z.v[k] = __shfl_down_sync(0xffffffffu, half.z.v[k], 1);
  }
  if (!active || h) return;
  Jac r = ec_glv_finish(half, other);
  store_fe(ox + off, r.x);
  store_fe(oy + off, r.y);
  store_fe(oz + off, r.z);
}

}  // namespace

// The block size the launcher takes for n lanes, into *threads.
extern "C" int h2a_ec_win_block(int n, int* threads) {
  return choose_lane_block(ec_win_kernel, 2ll * n, threads);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).  consts:
// the 7 x 8 words of ec_win.cuh's constants on the device.  threads: the block
// size, a multiple of 32, or 0 to choose it from n.
extern "C" int h2a_ec_win(const uint32_t* px, const uint32_t* py,
                          const uint32_t* pz, const uint32_t* scalars,
                          const uint32_t* consts, uint32_t* ox, uint32_t* oy,
                          uint32_t* oz, int n, int threads, void* stream) {
  if (n <= 0) return 0;
  if (threads < 0 || threads % 32) return (int)cudaErrorInvalidValue;
  if (threads == 0) {
    int rc = h2a_ec_win_block(n, &threads);
    if (rc != 0) return rc;
  }
  unsigned blocks = (unsigned)((2ll * n + threads - 1) / threads);
  ec_win_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      px, py, pz, scalars, consts, ox, oy, oz, n);
  return (int)cudaGetLastError();
}
