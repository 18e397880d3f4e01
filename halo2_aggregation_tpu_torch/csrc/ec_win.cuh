// One lane of the 4-bit windowed scalar multiplication (kernel K1).
// Shared by the CUDA kernel (ec_win.cu) and the host build (host_shim.cpp).
#pragma once

#include "curve.cuh"

namespace h2a {

constexpr int EC_WINDOWS = 64;  // 4-bit windows over a 256-bit scalar

// s * P for a plain (non-Montgomery) scalar s of 8 little-endian 32-bit
// limbs.  table[k] = k*P (evens by doubling, odds by adding P; entry 0 is
// the identity, which jac_add absorbs, so a zero window needs no special
// case).  Then, from the top window down: 4 doublings and one table add.
// The first window skips its doublings, which act on the identity.
H2A_HD Jac ec_win_lane(const Jac& P, const uint32_t s[NL]) {
  Jac table[16];
  table[0] = jac_identity();
  table[1] = P;
  for (int k = 2; k < 16; k++)
    table[k] = (k & 1) ? jac_add(table[k - 1], P) : jac_double(table[k >> 1]);
  Jac acc = jac_identity();
  for (int w = EC_WINDOWS - 1; w >= 0; --w) {
    if (w != EC_WINDOWS - 1) {
#pragma unroll 1
      for (int i = 0; i < 4; i++) acc = jac_double(acc);
    }
    uint32_t d = (s[w >> 3] >> ((w & 7) * 4)) & 15u;
    acc = jac_add(acc, table[d]);
  }
  if (fe_is_zero(acc.z)) acc = jac_identity();
  return acc;
}

}  // namespace h2a
