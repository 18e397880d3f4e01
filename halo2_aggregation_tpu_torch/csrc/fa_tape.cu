// Kernel K2: the verifier's fused field algebra as a tape interpreter.
//
// Replaces halo2_aggregation_tpu/plonk/fa_fused.py::_fa_kernel (:275-285)
// and its body fa_body (:174-258): per proof lane, x^n by k squarings, the
// Lagrange evaluations and 1/(x^n - 1), every gate, permutation and lookup
// expression, the y-fold and the vanishing division.  The TPU kernel traced
// those formulas into Mosaic code per vk; here the program is data, recorded
// once per vk from plonk/protocol.py (plonk/protocol_ops.py::TapeOps), so
// one nvcc build serves every vk.
//
// What bounds it on the H100: the latency of one thread's chain of dependent
// Fr products.  A batch is 128 lanes, four warps on a card with 528 warp
// schedulers, so the time is the chain's length times the latency of one
// product; a thread holds one carry chain at a time, so its products do not
// overlap.
//
// What the design does about it: a shorter chain and nothing but products
// on it.  The program (plonk/fa_fused.py::fa_program) inverts its eight
// denominators with one Fermat chain (Montgomery's trick), itself a
// sliding-window exponentiation (field.cuh::fe_inv), so a lane runs about
// 425 products where eight bit-serial inversions made it 3,100.  One thread a
// proof walks the tape; every thread walks the same one, so the instruction
// stream is uniform.  The tape, the constants and the block's register file
// (inputs and temporaries, [register][limb][lane]) live in dynamic shared
// memory, sized from the tape at launch: an instruction costs no access to
// device memory, and each input is read from it once.  No padding: B need
// not be a multiple of anything.
#include <cuda_runtime.h>

#include "fa_tape.cuh"

namespace {

using namespace h2a;

constexpr int kLanes = 32;  // lanes a block: one warp
constexpr size_t kMaxShared = 232448;  // bytes a block may use on sm_90

__global__ void fa_tape_kernel(const int32_t* __restrict__ tape, int n_instr,
                               const uint32_t* __restrict__ consts,
                               int n_consts, const uint32_t* __restrict__ in,
                               int n_in, const int32_t* __restrict__ out_regs,
                               int n_out, uint32_t* __restrict__ out,
                               int lanes) {
  extern __shared__ uint32_t sm[];
  int32_t* s_tape = reinterpret_cast<int32_t*>(sm);
  uint32_t* s_consts = sm + 4 * n_instr;
  uint32_t* s_regs = s_consts + NL * n_consts;
  for (int i = threadIdx.x; i < 4 * n_instr; i += blockDim.x) s_tape[i] = tape[i];
  for (int i = threadIdx.x; i < NL * n_consts; i += blockDim.x)
    s_consts[i] = consts[i];
  __syncthreads();
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  SharedTapeRegs R{s_consts, s_regs, (int)blockDim.x, (int)threadIdx.x};
  fa_tape_lane_shared(s_tape, n_instr, R, in, n_in, lanes, lane, out_regs,
                      n_out, out);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a tape whose register file does not fit in a
// block's shared memory.
extern "C" int h2a_fa_tape(const int32_t* tape, int n_instr,
                           const uint32_t* consts, int n_consts,
                           const uint32_t* in, int n_in, int n_tmp,
                           const int32_t* out_regs, int n_out, uint32_t* out,
                           int lanes, void* stream) {
  if (lanes <= 0) return 0;
  size_t bytes =
      4 * fa_tape_shared_words(n_instr, n_consts, n_in, n_tmp, kLanes);
  if (bytes > kMaxShared) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fa_tape_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fa_tape_kernel<<<(lanes + kLanes - 1) / kLanes, kLanes, bytes,
                   (cudaStream_t)stream>>>(tape, n_instr, consts, n_consts, in,
                                           n_in, out_regs, n_out, out, lanes);
  return (int)cudaGetLastError();
}
