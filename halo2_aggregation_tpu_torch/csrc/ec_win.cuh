// One lane of the windowed scalar multiplication (kernel K1), cut in two
// halves by the GLV endomorphism.  Shared by the CUDA kernel (ec_win.cu)
// and the host build (host_shim.cpp).
//
// BN254's G1 has cofactor 1 and phi(x, y) = (beta x, y) acts on it as
// multiplication by lambda, so s P = s1 P + s2 phi(P) with s = s1 + s2
// lambda (mod r) and |s1|, |s2| of about 128 bits.  Each half is a 4-bit
// windowed ladder of GLV_WINDOWS windows over signed digits and a table of
// 8 entries, run by its own thread; the first thread adds the two results.  phi is [lambda] only on the curve: the
// points must be on it.
#pragma once

#include "curve.cuh"

namespace h2a {

constexpr int GLV_WINDOWS = 33;  // 4-bit windows of a half: 132 bits

// The constants of the split, 7 numbers of 8 little-endian 32-bit limbs, as
// ops/ec_kernels.py::glv_constants makes them from the lattice basis
// (a1, b1), (a2, b2) of oracle/glv.py:
//   [0], [1]  g1, g2 = |round(2^256 b2 / det)|, |round(-2^256 b1 / det)|
//   [2], [3]  the factors of c1, c2 in s1, mod 2^256: -+a1, -+a2
//   [4], [5]  the factors of c1, c2 in s2, mod 2^256: -+b1, -+b2
//   [6]       beta, Montgomery Fq

// The high 256 bits of the 512-bit product a b.
H2A_HD void mul_hi_256(uint32_t r[NL], const uint32_t a[NL],
                       const uint32_t b[NL]) {
  uint32_t t[2 * NL];
#pragma unroll
  for (int i = 0; i < 2 * NL; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; j++) {
      c = (uint64_t)t[i + j] + (uint64_t)a[i] * b[j] + (c >> 32);
      t[i + j] = (uint32_t)c;
    }
    t[i + NL] = (uint32_t)(c >> 32);
  }
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = t[NL + i];
}

// acc += a b mod 2^256.
H2A_HD void mad_lo_256(uint32_t acc[NL], const uint32_t a[NL],
                       const uint32_t b[NL]) {
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL - i; j++) {
      c = (uint64_t)acc[i + j] + (uint64_t)a[i] * b[j] + (c >> 32);
      acc[i + j] = (uint32_t)c;
    }
  }
}

// s mod r for any s < 2^256 < 6 r: 4 r, 2 r and r taken off where they fit.
H2A_HD void reduce_mod_r(uint32_t s[NL]) {
  uint32_t p[NL];
  load_p<Fr>(p);
#pragma unroll
  for (int sh = 2; sh >= 0; --sh) {
    uint32_t m[NL], d[NL];
#pragma unroll
    for (int j = 0; j < NL; j++)
      m[j] = (p[j] << sh) | ((j && sh) ? p[j - 1] >> (32 - sh) : 0u);
    if (!sub_limbs(d, s, m)) {
      for (int j = 0; j < NL; j++) s[j] = d[j];
    }
  }
}

// Half h (0 or 1) of the split of the plain scalar s: writes |s_h| to mag
// and returns whether s_h is negative.  With c_i = floor(s g_i / 2^256),
// s1 = s - c1 a1 - c2 a2 and s2 = -c1 b1 - c2 b2, computed mod 2^256 (the
// halves are far smaller, so the top bit is the sign).  s1 + s2 lambda = s
// (mod r) holds whatever the c_i are; their rounding only moves the halves
// by a basis vector: they stay below 2^130, inside the GLV_WINDOWS windows.
H2A_HD bool glv_half_scalar(uint32_t mag[NL], const uint32_t s_in[NL],
                            const uint32_t* consts, int h) {
  uint32_t s[NL], c1[NL], c2[NL];
  for (int j = 0; j < NL; j++) s[j] = s_in[j];
  reduce_mod_r(s);
  mul_hi_256(c1, s, consts);
  mul_hi_256(c2, s, consts + NL);
  for (int j = 0; j < NL; j++) mag[j] = h ? 0u : s[j];
  const uint32_t* k = consts + (2 + 2 * h) * NL;
  mad_lo_256(mag, c1, k);
  mad_lo_256(mag, c2, k + NL);
  bool neg = (mag[NL - 1] >> 31) != 0;
  if (neg) {
    uint32_t zero[NL];
    for (int j = 0; j < NL; j++) zero[j] = 0;
    sub_limbs(mag, zero, mag);
  }
  return neg;
}

// m * P for m < 2^130 (limbs 0 .. 4 of mag), with signed digits and half
// the table.  m + 0x88..8 (33 nibbles of 8) has nibbles n_w with m = sum
// (n_w - 8) 16^w: digits in [-8, 7], and none above window 32 while the
// top nibble of m is at most 6.  table[k] = k*P for k = 1 .. 8 (4 doublings,
// 3 adds; entry 0 is the identity, which jac_add absorbs, so a zero digit
// needs no special case); a negative digit adds the entry with Y negated.
// Then, from the top window down: 4 doublings and one table add.  The first
// window skips its doublings, which act on the identity.
H2A_HD Jac ec_win_half(const Jac& P, const uint32_t mag[NL]) {
  Jac table[9];
  table[0] = jac_identity();
  table[1] = P;
  for (int k = 2; k < 9; k++)
    table[k] = (k & 1) ? jac_add(table[k - 1], P) : jac_double(table[k >> 1]);
  uint32_t rec[5];
  uint64_t c = 0;
  for (int j = 0; j < 5; j++) {
    c = (uint64_t)mag[j] + (j < 4 ? 0x88888888u : 0x8u) + (c >> 32);
    rec[j] = (uint32_t)c;
  }
  Jac acc = jac_identity();
  for (int w = GLV_WINDOWS - 1; w >= 0; --w) {
    if (w != GLV_WINDOWS - 1) {
#pragma unroll 1
      for (int i = 0; i < 4; i++) acc = jac_double(acc);
    }
    int d = (int)((rec[w >> 3] >> ((w & 7) * 4)) & 15u) - 8;
    Jac t = table[d < 0 ? -d : d];
    if (d < 0) t.y = fe_neg<Fq>(t.y);
    acc = jac_add(acc, t);
  }
  return acc;
}

// Thread h's share of s * P: s1 * P (h == 0) or s2 * phi(P) (h == 1), for a
// plain scalar s < 2^256.  A negative half negates Y; phi multiplies the
// Jacobian X by beta.
H2A_HD Jac ec_glv_half(const Jac& P, const uint32_t s[NL],
                       const uint32_t* consts, int h) {
  uint32_t mag[NL];
  bool neg = glv_half_scalar(mag, s, consts, h);
  Jac Q = P;
  if (h) Q.x = fe_mul<Fq>(Q.x, load_fe(consts + 6 * NL));
  if (neg) Q.y = fe_neg<Fq>(Q.y);
  return ec_win_half(Q, mag);
}

// The two halves' sum, the identity canonical as (1, 1, 0).
H2A_HD Jac ec_glv_finish(const Jac& a, const Jac& b) {
  Jac r = jac_add(a, b);
  if (fe_is_zero(r.z)) r = jac_identity();
  return r;
}

#ifdef __CUDACC__
// The block size of a lane-serial launch (K1, K8) of `needed` threads: one
// warp while the launch is less than two waves of the block the occupancy
// call gives for `kernel` (small blocks spread a short launch evenly over
// the SMs: K1 at 2^14 lanes on an H100 0.98 ms against 1.50 with that
// block), above that the occupancy call's block, capped at 256 threads (K1
// at 2^17 lanes 7.83 ms against 8.37 with its 384).
template <class Kernel>
int choose_lane_block(Kernel kernel, long long needed, int* threads) {
  int min_grid = 0, block = 0;
  cudaError_t err =
      cudaOccupancyMaxPotentialBlockSize(&min_grid, &block, kernel, 0, 0);
  if (err != cudaSuccess) return (int)err;
  *threads = needed < 2ll * min_grid * block ? 32 : (block < 256 ? block : 256);
  return 0;
}
#endif

}  // namespace h2a
