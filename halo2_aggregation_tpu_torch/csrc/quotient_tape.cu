// Kernel K6: the quotient numerator on one coset, one thread per row.
//
// Replaces halo2_aggregation_tpu/plonk/quotient_device.py::_build_tile_fn's
// kernel (:803-902, run by `run` :923 from `run_coset` :947): for every row
// i of the coset {shift * omega^i}, the gate, permutation and lookup
// expressions of plonk/protocol.py, the y-fold, and the product with
// 1/(shift^n - 1).  The TPU kernel traced those formulas into Mosaic code per
// constraint system and fetched each rotated leaf as a neighbour tile plus
// two lane rolls; here the formulas are a tape recorded once per constraint
// system (plonk/quotient_program.py), interpreted by the loop K2 uses, and a
// rotation is an index offset into the resident evaluation stack.
//
// Temporaries: per thread, in a local array of QT_MAX_TEMPS elements (the
// aggregation circuit's tape needs 28).  Local memory is allocated for the
// resident threads only, so it is bounded by the card's thread slots
// (132 SMs x 2048 threads x 2 KB), not by n; no launch is split into row
// chunks.
//
// What bounds it on the H100: the ~130 Montgomery products per row and the
// temporaries' traffic.  Every instruction reads two and writes one 32-byte
// register, about 23 KB a row, 48 GB a coset at k = 21 if all of it reached
// device memory; measured at 8.7 ms a coset there (NVIDIA H100 80GB HBM3,
// 700 W: 31 G products/s), so L1 and L2 serve most of it.  The leaf reads
// (2.6 GB of distinct bytes a coset) come last.  Keeping the temporaries in
// registers needs per-constraint-system code (a later change).
#include <cuda_runtime.h>

#include "quotient_tape.cuh"

namespace {

using namespace h2a;

__global__ void quotient_tape_kernel(const int32_t* __restrict__ tape,
                                     int n_instr,
                                     const uint32_t* __restrict__ consts,
                                     const int32_t* __restrict__ in_src,
                                     const int32_t* __restrict__ in_rot,
                                     int n_in,
                                     const uint32_t* __restrict__ stack,
                                     const uint32_t* __restrict__ x,
                                     const uint32_t* __restrict__ uniforms,
                                     uint32_t n, int out_reg,
                                     uint32_t* __restrict__ out) {
  uint32_t row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  Fe tmp[QT_MAX_TEMPS];
  QuotientRegs R{consts, in_src, in_rot, stack, x, uniforms, n_in, n, row, tmp};
  store_fe(out + (size_t)row * NL, quotient_lane(tape, n_instr, R, out_reg));
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  The
// caller checks n_temps <= QT_MAX_TEMPS.
extern "C" int h2a_quotient_tape(const int32_t* tape, int n_instr,
                                 const uint32_t* consts, const int32_t* in_src,
                                 const int32_t* in_rot, int n_in,
                                 const uint32_t* stack, const uint32_t* x,
                                 const uint32_t* uniforms, int n, int out_reg,
                                 uint32_t* out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  quotient_tape_kernel<<<(n + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
      tape, n_instr, consts, in_src, in_rot, n_in, stack, x, uniforms,
      (uint32_t)n, out_reg, out);
  return (int)cudaGetLastError();
}
