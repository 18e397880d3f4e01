// The segmented Jacobian sum: for every batch element, the sum of the points
// of each contiguous segment of lanes.
//
// Replaces no Pallas kernel: in the JAX package the lane sums are lax.scans
// inside one jitted program (halo2_aggregation_tpu/ops/curve_ops.py::jac_sum
// :210 and ::jac_segment_sum :233, called by plonk/verifier_tpu.py::
// fast_device :705-720).  Run eagerly as PyTorch operations the same sums
// were some 20,000 launches of a few microseconds a batch of 128 proofs,
// and the host that launched them was the verifier's device stage.
//
// Shape: one warp a (batch element, segment), kWarps warps a block.  Thread
// t adds lanes t, t + 32, ... of its segment with jac_add, then the warp
// halves its 32 partial sums five times through shared memory (jac_sum.cuh).
// On the verifier's path the segments are the multiopen components w, zw, f
// and the e-lane (4, 4, 27 and 1 lanes): most threads hold one point or the
// identity, and a segment costs the five adds of the tree.  Lane and batch
// strides are arguments, so the (B, lanes, 8) arrays that K1 writes and
// lane-major (lanes, B, 8) arrays are both read in place.  An empty segment
// gives the identity (1, 1, 0).
//
// What bounds it on the H100: latency.  B x segments warps of at most a few
// adds each (16 Fq products an add) are far too few products to fill the
// card; the time is the chain of five dependent adds of one warp.
#include <cuda_runtime.h>

#include "jac_sum.cuh"

namespace {

using namespace h2a;

constexpr int kWarps = 4;

__global__ void jac_sum_kernel(JacLanes L, const int32_t* __restrict__ offsets,
                               int n_seg, int batch, uint32_t* __restrict__ ox,
                               uint32_t* __restrict__ oy,
                               uint32_t* __restrict__ oz) {
  __shared__ Jac sh[kWarps][JS_WIDTH];
  int warp = threadIdx.x / JS_WIDTH, t = threadIdx.x % JS_WIDTH;
  long long job = (long long)blockIdx.x * kWarps + warp;  // seg * batch + b
  if (job >= (long long)n_seg * batch) return;  // the whole warp leaves
  int seg = (int)(job / batch);
  size_t b = (size_t)(job % batch);
  Jac* mine = sh[warp];
  mine[t] = jac_sum_partial(L, b, offsets[seg], offsets[seg + 1], t);
  __syncwarp();
  for (int s = JS_WIDTH / 2; s > 0; s >>= 1) {
    jac_sum_level(mine, t, s);
    __syncwarp();
  }
  if (t != 0) return;
  Jac r = jac_sum_finish(mine[0]);
  size_t off = (size_t)job * NL;
  store_fe(ox + off, r.x);
  store_fe(oy + off, r.y);
  store_fe(oz + off, r.z);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Inputs:
// coordinate arrays with element (b, lane) at word b * batch_stride + lane *
// lane_stride; offsets (n_seg + 1,) int32 on the device, non-decreasing lane
// indices.  Outputs (n_seg, batch, 8), contiguous.
extern "C" int h2a_jac_segment_sum(const uint32_t* px, const uint32_t* py,
                                   const uint32_t* pz, long long batch_stride,
                                   long long lane_stride,
                                   const int32_t* offsets, int n_seg,
                                   int batch, uint32_t* ox, uint32_t* oy,
                                   uint32_t* oz, void* stream) {
  if (n_seg <= 0 || batch <= 0) return 0;
  JacLanes L{px, py, pz, (size_t)batch_stride, (size_t)lane_stride};
  long long jobs = (long long)n_seg * batch;
  unsigned blocks = (unsigned)((jobs + kWarps - 1) / kWarps);
  jac_sum_kernel<<<blocks, kWarps * JS_WIDTH, 0, (cudaStream_t)stream>>>(
      L, offsets, n_seg, batch, ox, oy, oz);
  return (int)cudaGetLastError();
}
