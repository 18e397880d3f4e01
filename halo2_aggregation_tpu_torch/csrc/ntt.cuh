// Radix-2 NTT butterflies, stage index maps and the power-series element
// for kernels K3 (forward NTT), K4 (inverse NTT) and K5 (pow_series).
// Shared by the CUDA kernels (ntt.cu, ew.cu) and the host build
// (host_shim.cpp).
//
// Counterpart of the butterfly math and index maps of
// halo2_aggregation_tpu/ops/ntt_pallas.py (:100-112, :117-176, :308-363),
// without its 128-lane tiling: a stage is n/2 independent butterflies, and
// a butterfly's pair and twiddle are pure functions of (k, s, t).
//
// Twiddles come from one natural-order table of omega^0 .. omega^(n/2 - 1)
// (omega^-1 for the inverse): the twiddle of pair j in stage s is
// omega^(j n / 2^(s+1)), entry j << (k - 1 - s).
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

// The k-bit reversal of i (k >= 1).
H2A_HD uint32_t bit_reverse(uint32_t i, int k) {
#ifdef __CUDA_ARCH__
  return __brev(i) >> (32 - k);
#else
  uint32_t r = 0;
  for (int b = 0; b < k; b++) r |= ((i >> b) & 1u) << (k - 1 - b);
  return r;
#endif
}

// start * base^e for an exponent of `bits` bits, by square-and-multiply
// from the low bit (Montgomery in and out, canonical).
H2A_HD Fe fe_pow_times(const Fe& start, const Fe& base, uint32_t e,
                       int bits) {
  Fe acc = start, sq = base;
  for (int b = 0; b < bits; b++) {
    if ((e >> b) & 1u) acc = fe_mul<Fr>(acc, sq);
    sq = fe_sqr<Fr>(sq);
  }
  return acc;
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

}  // namespace h2a
