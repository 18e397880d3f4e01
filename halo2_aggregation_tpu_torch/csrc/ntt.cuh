// Radix-2 NTT butterflies, the fused passes' index maps and tile code, and
// the power series' tables and element for kernels K3 (forward NTT), K4
// (inverse NTT) and K5 (pow_series).  Shared by the CUDA kernels (ntt.cu, ew.cu) and the
// host build (host_shim.cpp).
//
// Counterpart of the butterfly math and index maps of
// halo2_aggregation_tpu/ops/ntt_pallas.py (:100-112, :117-176, :308-363),
// without its 128-lane tiling: a stage is n/2 independent butterflies, and
// a butterfly's pair and twiddle are pure functions of (k, s, t).
//
// Twiddles come from one natural-order table of omega^0 .. omega^(n/2 - 1)
// (omega^-1 for the inverse): the twiddle of pair j in stage s is
// omega^(j n / 2^(s+1)), entry j << (k - 1 - s).
//
// A pass (NttPass) runs r consecutive stages s0 .. s0 + r - 1 on tiles of
// 2^(r + c) elements: 2^c neighbouring groups of the 2^r elements that
// agree in every index bit outside s0 .. s0 + r - 1.  ntt_tile_index maps a
// tile slot to its element, ntt_tile_load / _stages / _store are the body
// of a block, written over a plain array so that the host build runs a
// pass block by block with the same code.
#pragma once

#include "field.cuh"

namespace h2a {

struct NttPair {
  uint32_t lo, hi, tw;  // element indices of the pair, twiddle table index
};

// Butterfly t (0 <= t < n/2) of stage s (0 <= s < k) of a size-2^k
// transform: pair (lo, lo + 2^s), lo = the t-th index with bit s clear.
H2A_HD NttPair ntt_pair(int k, int s, uint32_t t) {
  uint32_t half = 1u << s;
  uint32_t j = t & (half - 1);
  uint32_t lo = ((t >> s) << (s + 1)) | j;
  return NttPair{lo, lo + half, j << (k - 1 - s)};
}

// Decimation in time (K3): (lo, hi) -> (lo + w hi, lo - w hi).  Stages run
// s = 0 .. k-1 and take bit-reversed input to natural-order output.
H2A_HD void dit_butterfly(Fe& lo, Fe& hi, const Fe& w) {
  Fe t = fe_mul<Fr>(hi, w);
  hi = fe_sub<Fr>(lo, t);
  lo = fe_add<Fr>(lo, t);
}

// Decimation in frequency (K4): (lo, hi) -> (lo + hi, (lo - hi) w).  Stages
// run s = k-1 .. 0 and take natural-order input to bit-reversed output,
// which is exactly K3's input.
H2A_HD void dif_butterfly(Fe& lo, Fe& hi, const Fe& w) {
  Fe d = fe_sub<Fr>(lo, hi);
  lo = fe_add<Fr>(lo, hi);
  hi = fe_mul<Fr>(d, w);
}

// The k-bit reversal of i < 2^k (0 for k == 0).
H2A_HD uint32_t bit_reverse(uint32_t i, int k) {
#ifdef __CUDA_ARCH__
  return k ? __brev(i) >> (32 - k) : 0u;
#else
  uint32_t r = 0;
  for (int b = 0; b < k; b++) r |= ((i >> b) & 1u) << (k - 1 - b);
  return r;
#endif
}

#ifdef __CUDACC__
// One element as two 16-byte accesses.  Element addresses are 32-byte
// aligned: tensors start 256-byte aligned and elements are 32 bytes.
__device__ __forceinline__ Fe ld_fe(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 a = q[0], b = q[1];
  Fe r;
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
  return r;
}

__device__ __forceinline__ void st_fe(uint32_t* p, const Fe& r) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(r.v[0], r.v[1], r.v[2], r.v[3]);
  q[1] = make_uint4(r.v[4], r.v[5], r.v[6], r.v[7]);
}
#endif

// One element of a (.., 8) array in device or host memory.
H2A_HD Fe fe_load(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  return ld_fe(p);
#else
  Fe r;
  for (int i = 0; i < NL; i++) r.v[i] = p[i];
  return r;
#endif
}

H2A_HD void fe_store(uint32_t* p, const Fe& r) {
#ifdef __CUDA_ARCH__
  st_fe(p, r);
#else
  for (int i = 0; i < NL; i++) p[i] = r.v[i];
#endif
}

// ---------------------------------------------------------------------------
// the power series out[i] = start * base^idx(i), i < 2^k (kernel K5)
// ---------------------------------------------------------------------------
//
// i = hi 2^m + lo with m = ceil(k / 2), and out[i] = TA[lo] * TB[hi]:
//   natural order   TA[lo] = start base^lo,
//                   TB[hi] = base^(hi 2^m);
//   bit-reversed    TA[lo] = start base^(rev_m(lo) 2^(k-m)),
//                   TB[hi] = base^rev_(k-m)(hi),
// since rev_k(i) = rev_m(lo) 2^(k-m) + rev_(k-m)(hi).  The squares
// sq[1 + j] = base^(2^j), j < k, come from the host with sq[0] = start, so
// an entry is at most ceil(k / 2) products over them.  The tables lie in
// one array: TA's 2^m entries, then TB's 2^(k-m).

H2A_HD int pow_series_low_bits(int k) { return (k + 1) / 2; }

H2A_HD uint32_t pow_series_table_len(int k) {
  int m = pow_series_low_bits(k);
  return (1u << m) + (1u << (k - m));
}

// Entry e of the tables.
H2A_HD Fe pow_series_table_entry(const uint32_t* sq, int k, int bitrev,
                                 uint32_t e) {
  int m = pow_series_low_bits(k);
  bool low = e < (1u << m);
  uint32_t j = low ? e : e - (1u << m);
  int bits = low ? m : k - m;
  uint32_t x = bitrev ? bit_reverse(j, bits) : j;
  // the square of TA's bit 0 and of TB's
  int off = low ? (bitrev ? k - m : 0) : (bitrev ? 0 : m);
  Fe acc = low ? fe_load(sq) : fe_one<Fr>();
  for (int b = 0; b < bits; b++)
    if ((x >> b) & 1u) acc = fe_mul<Fr>(acc, fe_load(sq + (size_t)(1 + off + b) * NL));
  return acc;
}

// Element i of the series from the tables: one product.
H2A_HD Fe pow_series_element(const uint32_t* tables, int k, uint32_t i) {
  int m = pow_series_low_bits(k);
  Fe a = fe_load(tables + (size_t)(i & ((1u << m) - 1)) * NL);
  Fe b = fe_load(tables + (size_t)((1u << m) + (i >> m)) * NL);
  return fe_mul<Fr>(a, b);
}

// ---------------------------------------------------------------------------
// fused passes
// ---------------------------------------------------------------------------

// Most stages a pass fuses, and most low index bits a tile adds so that its
// global accesses are runs of 2^c elements (2^c x 32 contiguous bytes).
// ops/ntt.py mirrors both (R_MAX, C_MAX) and the two functions below.
constexpr int kNttMaxStages = 7;
constexpr int kNttMaxChunkBits = 2;

// Stages s0 .. s0 + r - 1 of a size-2^k transform, on tiles of 2^(r + c)
// elements.
struct NttPass {
  int k, s0, r, c;
};

// The c of a pass: the index bits below s0 when there are any (then the
// tile's runs are 2^c neighbours below the stages' bits), else the bits
// above the group (the tile is 2^(r + c) contiguous elements); as many as
// kNttMaxChunkBits where the transform has them.
H2A_HD int ntt_pass_chunk_bits(int k, int s0, int r) {
  int room = s0 > 0 ? s0 : k - r;
  return room < kNttMaxChunkBits ? room : kNttMaxChunkBits;
}

// Element index of slot u (0 <= u < 2^(r + c)) of tile `block`
// (0 <= block < 2^(k - r - c)).  With low = c if s0 > 0, else 0: the slot's
// low `low` bits are the element's, the slot's other bits sit at bit s0 of
// the element, and the block's bits fill the rest, low part first.  Stage
// s of the pass pairs slots that differ in slot bit s - s0 + low.
H2A_HD uint32_t ntt_tile_index(const NttPass& P, uint32_t block, uint32_t u) {
  int low = P.s0 > 0 ? P.c : 0;
  int mid = P.s0 - low;           // block bits between the run and the stages
  int top = P.s0 + P.r + P.c - low;  // first element bit above the slot's
  uint32_t idx = (u & ((1u << low) - 1)) | ((u >> low) << P.s0);
  idx |= (block & ((1u << mid) - 1)) << low;
  return idx | ((block >> mid) << top);  // top <= k < 32
}

// The tile is half-major: words 4h .. 4h + 3 of slot u are the 16 bytes at
// tile[(h * elems + u) * 4], h = 0, 1, so a thread moves an element in two
// 16-byte accesses and threads on neighbouring slots hit neighbouring
// shared-memory banks (8 threads cover all 32).  The tile is 16-byte
// aligned.
H2A_HD Fe ntt_tile_get(const uint32_t* tile, uint32_t elems, uint32_t u) {
  Fe r;
#ifdef __CUDA_ARCH__
  const uint4* q = reinterpret_cast<const uint4*>(tile);
  uint4 a = q[u], b = q[elems + u];
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
#else
  for (int l = 0; l < NL; l++)
    r.v[l] = tile[((size_t)(l / 4) * elems + u) * 4 + l % 4];
#endif
  return r;
}

H2A_HD void ntt_tile_put(uint32_t* tile, uint32_t elems, uint32_t u,
                         const Fe& r) {
#ifdef __CUDA_ARCH__
  uint4* q = reinterpret_cast<uint4*>(tile);
  q[u] = make_uint4(r.v[0], r.v[1], r.v[2], r.v[3]);
  q[elems + u] = make_uint4(r.v[4], r.v[5], r.v[6], r.v[7]);
#else
  for (int l = 0; l < NL; l++)
    tile[((size_t)(l / 4) * elems + u) * 4 + l % 4] = r.v[l];
#endif
}

// Between two steps of a tile every thread of the block must have finished
// the earlier one; the host build runs a block in one thread.
#ifdef __CUDA_ARCH__
#define H2A_TILE_SYNC() __syncthreads()
#else
#define H2A_TILE_SYNC() ((void)0)
#endif

// Thread `thread` of `nthreads` loads its share of tile `block` of column
// `col` (2^k elements).
H2A_HD void ntt_tile_load(uint32_t* tile, const NttPass& P, uint32_t block,
                          const uint32_t* col, uint32_t thread,
                          uint32_t nthreads) {
  uint32_t elems = 1u << (P.r + P.c);
  for (uint32_t u = thread; u < elems; u += nthreads)
    ntt_tile_put(tile, elems, u,
                 fe_load(col + (size_t)ntt_tile_index(P, block, u) * NL));
}

// The pass's r stages on a loaded tile: upward from s0 with the DIT
// butterfly (K3), downward from s0 + r - 1 with the DIF butterfly (K4).
// The twiddle of a butterfly comes from its element index, as in ntt_pair:
// entry (lo mod 2^s) << (k - 1 - s) of tw.
template <bool DIF>
H2A_HD void ntt_tile_stages(uint32_t* tile, const NttPass& P, uint32_t block,
                            const uint32_t* tw, uint32_t thread,
                            uint32_t nthreads) {
  uint32_t elems = 1u << (P.r + P.c), half = elems >> 1;
  int low = P.s0 > 0 ? P.c : 0;
  for (int i = 0; i < P.r; i++) {
    int s = DIF ? P.s0 + P.r - 1 - i : P.s0 + i;
    int bit = s - P.s0 + low;
    H2A_TILE_SYNC();
    for (uint32_t t = thread; t < half; t += nthreads) {
      uint32_t lo = ((t >> bit) << (bit + 1)) | (t & ((1u << bit) - 1));
      uint32_t hi = lo + (1u << bit);
      uint32_t j = ntt_tile_index(P, block, lo) & ((1u << s) - 1);
      Fe w = fe_load(tw + ((size_t)j << (P.k - 1 - s)) * NL);
      Fe a = ntt_tile_get(tile, elems, lo), b = ntt_tile_get(tile, elems, hi);
      if (DIF) {
        dif_butterfly(a, b, w);
      } else {
        dit_butterfly(a, b, w);
      }
      ntt_tile_put(tile, elems, lo, a);
      ntt_tile_put(tile, elems, hi, b);
    }
  }
  H2A_TILE_SYNC();
}

// Stores the tile back; every element times *scale where scale is not
// null (K4's 1/n, in its last pass).
H2A_HD void ntt_tile_store(const uint32_t* tile, const NttPass& P,
                           uint32_t block, uint32_t* col,
                           const uint32_t* scale, uint32_t thread,
                           uint32_t nthreads) {
  uint32_t elems = 1u << (P.r + P.c);
  Fe sc = scale ? fe_load(scale) : fe_zero();
  for (uint32_t u = thread; u < elems; u += nthreads) {
    Fe v = ntt_tile_get(tile, elems, u);
    if (scale) v = fe_mul<Fr>(v, sc);
    fe_store(col + (size_t)ntt_tile_index(P, block, u) * NL, v);
  }
}

}  // namespace h2a
