// Kernels K3 (forward NTT, DIT) and K4 (inverse NTT, DIF) over a batch of
// Fr columns: the k stages of a size-2^k transform in ceil(k / 7) launches,
// each a pass of up to 7 consecutive stages on tiles held in shared memory.
//
// K3 replaces halo2_aggregation_tpu/ops/ntt_pallas.py::_local_kernel (:117)
// and ::_gstage_sp_kernel (:147), driven by ntt_batched_u8 (:251) and
// _run_gstages (:206): bit-reversed coefficients in, natural-order
// evaluations out.  K4 replaces ::_local_dif_kernel (:308) and
// ::_gstage_dif_sp_kernel (:339), driven by intt_batched_u8 (:367):
// natural-order evaluations in, bit-reversed coefficients out, times 1/n
// (multiplied in as the last pass stores its tiles).  The TPU's split
// (stages 0-6 in a tile, then one global kernel a stage), its u8
// limbs-on-sublanes layout and its scalar prefetch are Mosaic's needs and
// are not carried over: here every pass is fused.  The in/out contracts are
// kept.
//
// Layout: a (C, n, 8) int32 stack, each element's 32 bytes contiguous
// (the native engine's (n, 4) u64 Montgomery bytes), canonical in and out.
// Transforms run in place.
//
// Design (ntt.cuh has the index map and the tile code, shared with the host
// build).  ops/ntt.py::pass_plan cuts the k stages into passes of nearly
// equal length r <= 7.  A pass over stages s0 .. s0 + r - 1 works on groups
// of 2^r elements that agree in every other index bit; a block takes 2^c
// neighbouring groups (c <= 2), so each of its global accesses is a run of
// 2^c x 32 contiguous bytes, loads the 2^(r + c) elements into its tile,
// runs the r stages with a barrier between, and stores the tile.  K3 runs
// the passes upward (the first is contiguous), K4 downward (the last is).
// The tile is half-major, so an element moves in two 16-byte accesses and
// the stages at tile bits >= 3 are free of bank conflicts (2-way at tile
// bits 0-2: the first pass's stages 0-2, a later pass's first stage).  The
// grid is column-fastest: blocks in flight
// together hold the same tiles of every column and share their twiddles in
// L2, so the table crosses device memory about once a pass.  Blocks are 128
// threads and tiles at most 16 KB: several blocks an SM overlap one block's
// load and store with the others' stages.
//
// What bounds it on the H100: integer multiply-add throughput.  The stack
// crosses device memory once a pass (3 x 5.23 GB for 39 columns at k = 21;
// a pass with its stages removed takes 1.9 ms), against one Montgomery
// product, one addition and one subtraction a butterfly.  Measured on an
// NVIDIA H100 80GB HBM3 (700 W) at 39 x 2^21: K3 16.6 ms, K4 17.8 ms, from
// 40.1 and 44.3 ms for one launch a stage; PERF.md has the steps between.
#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

using namespace h2a;

constexpr int kPassThreads = 128;

// One block: one tile of one column through every stage of the pass.
// blockIdx.x = tile * cols + column: the blocks in flight together hold the
// same few tiles of every column, whose butterflies use the same twiddles.
template <bool DIF>
__global__ void __launch_bounds__(kPassThreads)
    ntt_pass_kernel(uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                    const uint32_t* __restrict__ scale, NttPass P,
                    uint32_t cols) {
  extern __shared__ __align__(16) uint32_t tile[];
  uint32_t block = blockIdx.x / cols;
  uint32_t* col = x + ((size_t)(blockIdx.x % cols) << P.k) * NL;
  ntt_tile_load(tile, P, block, col, threadIdx.x, blockDim.x);
  ntt_tile_stages<DIF>(tile, P, block, tw, threadIdx.x, blockDim.x);
  ntt_tile_store(tile, P, block, col, scale, threadIdx.x, blockDim.x);
}

bool pass_ok(int k, int s0, int r) {
  return k >= 1 && k <= 30 && s0 >= 0 && r >= 1 && r <= kNttMaxStages &&
         s0 + r <= k;
}

// the widest tile fits the shared memory a block may use without asking
static_assert((NL * sizeof(uint32_t)) << (kNttMaxStages + kNttMaxChunkBits) <=
                  48 * 1024,
              "a tile over 48 KB needs cudaFuncSetAttribute");

}  // namespace

// Stages s0 .. s0 + r - 1 of a size-2^k transform over `cols` columns of x,
// in place, in one launch: DIT upward (K3) if dif == 0, DIF downward (K4)
// otherwise.  tw holds the natural-order powers omega^0 .. omega^(n/2 - 1)
// of the transform's root.  Where scale is not null every element is
// multiplied by *scale (8 words) as it is stored.  Launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int h2a_ntt_pass(uint32_t* x, const uint32_t* tw,
                            const uint32_t* scale, int cols, int k, int s0,
                            int r, int dif, void* stream) {
  if (cols <= 0) return 0;
  if (!pass_ok(k, s0, r)) return (int)cudaErrorInvalidValue;
  NttPass P{k, s0, r, ntt_pass_chunk_bits(k, s0, r)};
  size_t bytes = ((size_t)NL * sizeof(uint32_t)) << (P.r + P.c);
  unsigned blocks = (unsigned)cols << (k - P.r - P.c);
  cudaStream_t st = (cudaStream_t)stream;
  if (dif) {
    ntt_pass_kernel<true><<<blocks, kPassThreads, bytes, st>>>(
        x, tw, scale, P, (uint32_t)cols);
  } else {
    ntt_pass_kernel<false><<<blocks, kPassThreads, bytes, st>>>(
        x, tw, scale, P, (uint32_t)cols);
  }
  return (int)cudaGetLastError();
}

// The blocks of the pass kernel one SM holds at `tile_bytes` of shared
// memory a block, and the card's SM count, from the runtime.
extern "C" int h2a_ntt_occupancy(int dif, int tile_bytes, int* blocks_per_sm,
                                 int* sms) {
  cudaError_t err =
      dif ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                blocks_per_sm, ntt_pass_kernel<true>, kPassThreads,
                (size_t)tile_bytes)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                blocks_per_sm, ntt_pass_kernel<false>, kPassThreads,
                (size_t)tile_bytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     device);
}
