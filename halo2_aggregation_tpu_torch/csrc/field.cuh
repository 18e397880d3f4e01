// BN254 Fq / Fr arithmetic for the port's kernels: 8 x 32-bit limbs,
// little-endian, Montgomery form with R = 2^256, values canonical in [0, p).
//
// Counterpart of the limb primitives in halo2_aggregation_tpu/ops/ec_pallas.py
// (:71-314), which work on 32 x 8-bit limbs in a redundant [0, 2p) form
// because the TPU's vector unit has no wide multiply.  Here every product is
// a 32 x 32 -> 64-bit multiply-add, in the CIOS style of
// native/h2a_native.cpp (mont_mul, :98), and every result is canonical, so a
// zero test is a plain all-limbs-zero test.
//
// Every function is __host__ __device__: nvcc builds the kernels from this
// header, and g++ builds the same code into a host library for the CPU
// tests (csrc/host_shim.cpp).
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define H2A_HD __host__ __device__ __forceinline__
#else
#define H2A_HD inline
#endif

namespace h2a {

constexpr int NL = 8;  // 32-bit limbs per element

struct Fe {
  uint32_t v[NL];
};

// Field parameters as scalar constants (usable in device code without
// relaxed-constexpr): the modulus, -p^-1 mod 2^32 and R mod p (one).
struct Fq {
  static constexpr uint32_t P0 = 0xd87cfd47u, P1 = 0x3c208c16u,
                            P2 = 0x6871ca8du, P3 = 0x97816a91u,
                            P4 = 0x8181585du, P5 = 0xb85045b6u,
                            P6 = 0xe131a029u, P7 = 0x30644e72u;
  static constexpr uint32_t INV = 0xe4866389u;
  static constexpr uint32_t O0 = 0xc58f0d9du, O1 = 0xd35d438du,
                            O2 = 0xf5c70b3du, O3 = 0x0a78eb28u,
                            O4 = 0x7879462cu, O5 = 0x666ea36fu,
                            O6 = 0x9a07df2fu, O7 = 0x0e0a77c1u;
};

struct Fr {
  static constexpr uint32_t P0 = 0xf0000001u, P1 = 0x43e1f593u,
                            P2 = 0x79b97091u, P3 = 0x2833e848u,
                            P4 = 0x8181585du, P5 = 0xb85045b6u,
                            P6 = 0xe131a029u, P7 = 0x30644e72u;
  static constexpr uint32_t INV = 0xefffffffu;
  static constexpr uint32_t O0 = 0x4ffffffbu, O1 = 0xac96341cu,
                            O2 = 0x9f60cd29u, O3 = 0x36fc7695u,
                            O4 = 0x7879462eu, O5 = 0x666ea36fu,
                            O6 = 0x9a07df2fu, O7 = 0x0e0a77c1u;
};

template <class F>
H2A_HD void load_p(uint32_t p[NL]) {
  p[0] = F::P0; p[1] = F::P1; p[2] = F::P2; p[3] = F::P3;
  p[4] = F::P4; p[5] = F::P5; p[6] = F::P6; p[7] = F::P7;
}

template <class F>
H2A_HD Fe fe_one() {
  Fe r;
  r.v[0] = F::O0; r.v[1] = F::O1; r.v[2] = F::O2; r.v[3] = F::O3;
  r.v[4] = F::O4; r.v[5] = F::O5; r.v[6] = F::O6; r.v[7] = F::O7;
  return r;
}

H2A_HD Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = 0;
  return r;
}

H2A_HD bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) acc |= a.v[i];
  return acc == 0;
}

// r = a - b over 256 bits; returns the borrow out (0 or 1).
H2A_HD uint32_t sub_limbs(uint32_t r[NL], const uint32_t a[NL],
                          const uint32_t b[NL]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t d = (uint64_t)a[i] - b[i] - borrow;
    r[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

// r = a + b over 256 bits; returns the carry out (0 or 1).
H2A_HD uint32_t add_limbs(uint32_t r[NL], const uint32_t a[NL],
                          const uint32_t b[NL]) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    c = (uint64_t)a[i] + b[i] + (c >> 32);
    r[i] = (uint32_t)c;
  }
  return (uint32_t)(c >> 32);
}

// a, b canonical: a + b < 2p < 2^255, so one conditional subtraction.
template <class F>
H2A_HD Fe fe_add(const Fe& a, const Fe& b) {
  uint32_t p[NL];
  load_p<F>(p);
  Fe s, d;
  add_limbs(s.v, a.v, b.v);
  uint32_t borrow = sub_limbs(d.v, s.v, p);
  return borrow ? s : d;
}

template <class F>
H2A_HD Fe fe_sub(const Fe& a, const Fe& b) {
  uint32_t p[NL];
  load_p<F>(p);
  Fe d;
  if (sub_limbs(d.v, a.v, b.v)) add_limbs(d.v, d.v, p);
  return d;
}

template <class F>
H2A_HD Fe fe_neg(const Fe& a) {
  return fe_sub<F>(fe_zero(), a);
}

// CIOS Montgomery product a * b / 2^256 mod p (native/h2a_native.cpp:98 with
// 32-bit words).  Every partial sum t + a*b + carry fits in 64 bits.
template <class F>
H2A_HD Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t p[NL];
  load_p<F>(p);
  uint32_t t[NL + 2];
#pragma unroll
  for (int j = 0; j < NL + 2; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; j++) {
      c = (uint64_t)t[j] + (uint64_t)a.v[j] * b.v[i] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[NL] + (c >> 32);
    t[NL] = (uint32_t)c;
    t[NL + 1] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * F::INV;
    c = (uint64_t)t[0] + (uint64_t)m * p[0];
#pragma unroll
    for (int j = 1; j < NL; j++) {
      c = (uint64_t)t[j] + (uint64_t)m * p[j] + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = (uint64_t)t[NL] + (c >> 32);
    t[NL - 1] = (uint32_t)c;
    t[NL] = t[NL + 1] + (uint32_t)(c >> 32);
  }
  // t < 2p: one conditional subtraction makes it canonical
  Fe r, d;
#pragma unroll
  for (int j = 0; j < NL; j++) r.v[j] = t[j];
  uint32_t borrow = sub_limbs(d.v, r.v, p);
  return (t[NL] || !borrow) ? d : r;
}

template <class F>
H2A_HD Fe fe_sqr(const Fe& a) {
  return fe_mul<F>(a, a);
}

// Fermat inverse a^(p-2) in the Montgomery domain; 0 maps to 0.  The
// exponent is p with its low limb less 2 (both moduli have P0 >= 2).
template <class F>
H2A_HD Fe fe_inv(const Fe& a) {
  uint32_t e[NL];
  load_p<F>(e);
  e[0] -= 2;
  Fe acc = fe_one<F>();
  for (int bit = 253; bit >= 0; --bit) {
    acc = fe_sqr<F>(acc);
    if ((e[bit >> 5] >> (bit & 31)) & 1u) acc = fe_mul<F>(acc, a);
  }
  return acc;
}

}  // namespace h2a
