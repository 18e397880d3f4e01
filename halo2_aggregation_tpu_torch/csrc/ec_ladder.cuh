// One lane of the bit-serial double-and-add scalar multiplication (kernel
// K8).  Shared by the CUDA kernel (ec_ladder.cu) and the host build
// (host_shim.cpp).
#pragma once

#include "curve.cuh"

namespace h2a {

constexpr int EC_LADDER_MAX_BITS = 256;

// s * P for the low `nbits` bits of a plain (non-Montgomery) scalar s of 8
// little-endian 32-bit limbs: from bit nbits - 1 down to 0, one doubling,
// then jac_add(acc, P) where the bit is set (ec_pallas.py::_ladder_kernel,
// :317-351, which selects instead of branching).  The identity comes out as
// (1, 1, 0).
H2A_HD Jac ec_ladder_lane(const Jac& P, const uint32_t s[NL], int nbits) {
  Jac acc = jac_identity();
  for (int bit = nbits - 1; bit >= 0; --bit) {
    acc = jac_double(acc);
    if ((s[bit >> 5] >> (bit & 31)) & 1u) acc = jac_add(acc, P);
  }
  if (fe_is_zero(acc.z)) acc = jac_identity();
  return acc;
}

}  // namespace h2a
