// Kernels K3 (forward NTT, DIT) and K4 (inverse NTT, DIF) over a batch of
// Fr columns, one launch per stage.
//
// K3 replaces halo2_aggregation_tpu/ops/ntt_pallas.py::_local_kernel (:117)
// and ::_gstage_sp_kernel (:147), driven by ntt_batched_u8 (:251) and
// _run_gstages (:206): bit-reversed coefficients in, natural-order
// evaluations out.  K4 replaces ::_local_dif_kernel (:308) and
// ::_gstage_dif_sp_kernel (:339), driven by intt_batched_u8 (:367):
// natural-order evaluations in, bit-reversed coefficients out (the 1/n
// scale is one K5 launch after the last stage).  The TPU's split into
// in-tile and global stages, its u8 limbs-on-sublanes layout and its scalar
// prefetch are Mosaic's needs and are not carried over; the in/out
// contracts are.
//
// Layout: a (C, n, 8) int32 stack, each element's 32 bytes contiguous
// (the native engine's (n, 4) u64 Montgomery bytes), canonical in and out.
// Transforms run in place.  Grid: y = column, x = butterfly; each thread
// loads its pair and twiddle, applies one butterfly and stores the pair.
//
// What bounds it on the H100: device memory.  Every stage reads and writes
// the whole stack (64 bytes per butterfly, plus a cached twiddle) against
// one Montgomery product per butterfly, so k stages move 2 k C n 32 bytes:
// 110 GB for 39 columns at k = 21, measured at 40.8 ms (2.7 TB/s, NVIDIA
// H100 80GB HBM3, 700 W).  Fusing stages through shared memory (radix 2^r
// per pass) would cut that traffic by r; that is a later change.
#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

using namespace h2a;

template <bool DIF>
__global__ void ntt_stage_kernel(uint32_t* __restrict__ x,
                                 const uint32_t* __restrict__ tw, int k,
                                 int s) {
  uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (1u << (k - 1))) return;
  uint32_t* col = x + ((size_t)blockIdx.y << k) * NL;
  NttPair p = ntt_pair(k, s, t);
  Fe lo = ld_fe(col + (size_t)p.lo * NL);
  Fe hi = ld_fe(col + (size_t)p.hi * NL);
  Fe w = ld_fe(tw + (size_t)p.tw * NL);
  if (DIF) {
    dif_butterfly(lo, hi, w);
  } else {
    dit_butterfly(lo, hi, w);
  }
  st_fe(col + (size_t)p.lo * NL, lo);
  st_fe(col + (size_t)p.hi * NL, hi);
}

}  // namespace

// Stage s of a size-2^k transform over `cols` columns of x, in place:
// DIT (K3) if dif == 0, DIF (K4) otherwise.  tw holds the natural-order
// powers omega^0 .. omega^(n/2 - 1) of the transform's root.  Launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int h2a_ntt_stage(uint32_t* x, const uint32_t* tw, int cols,
                             int k, int s, int dif, void* stream) {
  if (cols <= 0 || k <= 0) return 0;
  const int threads = 256;
  uint32_t pairs = 1u << (k - 1);
  dim3 grid((pairs + threads - 1) / threads, cols);
  cudaStream_t st = (cudaStream_t)stream;
  if (dif) {
    ntt_stage_kernel<true><<<grid, threads, 0, st>>>(x, tw, k, s);
  } else {
    ntt_stage_kernel<false><<<grid, threads, 0, st>>>(x, tw, k, s);
  }
  return (int)cudaGetLastError();
}
