// Kernel K2: the verifier's fused field algebra as a tape interpreter.
//
// Replaces halo2_aggregation_tpu/plonk/fa_fused.py::_fa_kernel (:275-285)
// and its body fa_body (:174-258): per proof lane, x^n by k squarings, the
// Lagrange evaluations and 1/(x^n - 1) by Fermat inversion, every gate,
// permutation and lookup expression, the y-fold and the vanishing
// division.  The TPU kernel traced those formulas into Mosaic code per vk;
// here the program is data, recorded once per vk from plonk/protocol.py
// (plonk/protocol_ops.py::TapeOps), so one nvcc build serves every vk.
//
// Shape: one thread per proof; every thread walks the same tape, so the
// instruction stream is uniform (no divergence) and the tape and constants
// are broadcast reads that stay in cache.  Registers live in device memory
// as [register][lane][limb]; the tape's liveness-based slot reuse keeps them
// to a few dozen per lane.  No padding: B need not be a multiple of anything.
//
// What bounds it on the H100: latency of one thread's dependent chain of
// Fr Montgomery products.  Six Fermat inversions of ~380 products each
// dominate the few hundred products of the expressions, and at B = 128 only
// four warps exist, so the card is nearly idle; overlapping the inversions
// (batch inversion, or one lane per inversion) is for a later change.
#include <cuda_runtime.h>

#include "fa_tape.cuh"

namespace {

using namespace h2a;

__global__ void fa_tape_kernel(const int32_t* __restrict__ tape, int n_instr,
                               const uint32_t* __restrict__ consts,
                               const uint32_t* __restrict__ in, int n_in,
                               uint32_t* tmp,
                               const int32_t* __restrict__ out_regs,
                               int n_out, uint32_t* __restrict__ out,
                               int lanes) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  TapeRegs R{consts, in, tmp, n_in, lanes, lane};
  fa_tape_lane(tape, n_instr, R, out_regs, n_out, out);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int h2a_fa_tape(const int32_t* tape, int n_instr,
                           const uint32_t* consts, const uint32_t* in,
                           int n_in, uint32_t* tmp, const int32_t* out_regs,
                           int n_out, uint32_t* out, int lanes, void* stream) {
  if (lanes <= 0) return 0;
  const int threads = 32;
  fa_tape_kernel<<<(lanes + threads - 1) / threads, threads, 0,
                   (cudaStream_t)stream>>>(tape, n_instr, consts, in, n_in,
                                           tmp, out_regs, n_out, out, lanes);
  return (int)cudaGetLastError();
}
