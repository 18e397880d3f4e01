// One lane of kernel K8: the scalar multiplication as one joint double-and-
// add over the two halves of K1's GLV split (Shamir's trick).  Shared by the
// CUDA kernel (ec_ladder.cu) and the host build (host_shim.cpp).
//
// s P = s1 P + s2 phi(P) with s = s1 + s2 lambda (mod r) and |s1|, |s2| below
// 2^130 (ec_win.cuh::glv_half_scalar).  With the signs folded into the
// addends, P' = +-P and Q' = +-phi(P), one doubling a bit of the longer half
// and one add of the addend the bit pair selects: none, P', Q' or P' + Q'.
// The selection is word-wise, not a branch, so every lane of a warp runs the
// same instructions.  phi is [lambda] only on the curve: the points must be
// on it.  On such points (G1 has prime order r) a round's add never meets
// the accumulator's own addend or its negation for halves from the split:
// that needs halves v + (2 e1, 2 e2) for a nonzero lattice vector v of the
// split (s1 + s2 lambda = 0 mod r), and the split of such a small s = 2 e1
// + 2 e2 lambda is (2 e1, 2 e2) itself.  jac_add_mixed's doubling and
// identity branches stay for halves given directly (the tests force both).
#pragma once

#include "ec_win.cuh"

namespace h2a {

constexpr int EC_LADDER_MAX_BITS = 256;

// a where take, else b, word by word.
H2A_HD Fe fe_select(bool take, const Fe& a, const Fe& b) {
  uint32_t m = 0u - (uint32_t)take;
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = (a.v[i] & m) | (b.v[i] & ~m);
  return r;
}

H2A_HD bool mag_bit(const uint32_t m[NL], int bit) {
  return (m[bit >> 5] >> (bit & 31)) & 1u;
}

// The bit length of m (0 for m == 0).
H2A_HD int mag_bits(const uint32_t m[NL]) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < NL; j++) {
#ifdef __CUDA_ARCH__
    if (m[j]) n = 32 * j + 32 - __clz(m[j]);
#else
    if (m[j]) n = 32 * j + 32 - __builtin_clz(m[j]);
#endif
  }
  return n;
}

// s1 P + s2 phi(P) for the halves s_h = (neg_h ? -1 : 1) m_h, m_h < 2^256
// (below 2^130 from the split).  The addends P' and P' + Q' are made affine
// by one inversion of Z_P' Z_(P'+Q') (Q' is then (beta x, +-y)), so that
// every round's add is a mixed one, 11 products against a full add's 16:
// from the top bit of the longer half down, one doubling and one mixed add
// of the addend the pair of bits selects.  The identity comes out as
// (1, 1, 0), the coordinates canonical.
H2A_HD Jac ec_ladder_rounds(const Jac& P, const uint32_t m1[NL], bool neg1,
                            const uint32_t m2[NL], bool neg2, const Fe& beta) {
  int b1 = mag_bits(m1), b2 = mag_bits(m2);
  int top = b1 > b2 ? b1 : b2;
  if (top == 0 || fe_is_zero(P.z)) return jac_identity();
  Jac P1 = P, Q1 = P;
  if (neg1) P1.y = fe_neg<Fq>(P1.y);
  Q1.x = fe_mul<Fq>(P.x, beta);
  if (neg2) Q1.y = fe_neg<Fq>(Q1.y);
  // P' + Q' = (+-1 +-lambda) P is never the identity and P' != Q' (lambda !=
  // +-1 mod r): jac_add takes its generic branch
  Jac S = jac_add(P1, Q1);
  Fe inv = fe_inv<Fq>(fe_mul<Fq>(P1.z, S.z));
  Fe ip = fe_mul<Fq>(inv, S.z), is = fe_mul<Fq>(inv, P1.z);
  Fe ip2 = fe_sqr<Fq>(ip), is2 = fe_sqr<Fq>(is);
  Fe x1 = fe_mul<Fq>(P1.x, ip2), y1 = fe_mul<Fq>(P1.y, fe_mul<Fq>(ip2, ip));
  Fe xs = fe_mul<Fq>(S.x, is2), ys = fe_mul<Fq>(S.y, fe_mul<Fq>(is2, is));
  Fe x2 = fe_mul<Fq>(x1, beta);
  Fe y2 = neg1 != neg2 ? fe_neg<Fq>(y1) : y1;
  // the first pair is nonzero: the accumulator starts there, affine
  int bit = top - 1;
  bool u = mag_bit(m1, bit), v = mag_bit(m2, bit);
  Jac acc{fe_select(u, fe_select(v, xs, x1), x2),
          fe_select(u, fe_select(v, ys, y1), y2), fe_one<Fq>()};
#pragma unroll 1
  for (--bit; bit >= 0; --bit) {
    acc = jac_double(acc);
    u = mag_bit(m1, bit);
    v = mag_bit(m2, bit);
    if (u || v)
      acc = jac_add_mixed(acc, fe_select(u, fe_select(v, xs, x1), x2),
                          fe_select(u, fe_select(v, ys, y1), y2));
  }
  if (fe_is_zero(acc.z)) acc = jac_identity();
  return acc;
}

// (s mod 2^nbits) P for a plain (non-Montgomery) scalar s of 8 little-endian
// 32-bit limbs, 1 <= nbits <= 256.  G1 has cofactor 1, so this is
// ((s mod 2^nbits) mod r) P: the masked scalar is reduced and split as K1
// splits it (consts: ec_win.cuh's 7 constants), then the rounds run.
H2A_HD Jac ec_ladder_lane(const Jac& P, const uint32_t s_in[NL], int nbits,
                          const uint32_t* consts) {
  uint32_t s[NL], m1[NL], m2[NL];
#pragma unroll
  for (int j = 0; j < NL; j++) {
    int keep = nbits - 32 * j;  // bits of limb j below nbits
    s[j] = s_in[j] & (keep >= 32 ? ~0u : keep <= 0 ? 0u : (1u << keep) - 1);
  }
  bool neg1 = glv_half_scalar(m1, s, consts, 0);
  bool neg2 = glv_half_scalar(m2, s, consts, 1);
  return ec_ladder_rounds(P, m1, neg1, m2, neg2, load_fe(consts + 6 * NL));
}

}  // namespace h2a
