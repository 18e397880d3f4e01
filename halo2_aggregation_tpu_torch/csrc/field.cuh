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
// tests (csrc/host_shim.cpp).  On the card the product, the sum and the
// difference keep their carries in the flag register (fe_mul_cc, fe_add_cc,
// fe_sub_cc: a kernel that does one product is 216 instructions, 123 of
// them 64-bit-wide multiply-adds); the portable bodies stay for g++ and as
// the reference of the tests, which also run the flag forms with the flag
// in a variable.  Measured on an NVIDIA H100 80GB HBM3 (700 W), every
// kernel gained by it, the lane-serial ones 3x: PERF.md has the table.
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

H2A_HD Fe load_fe(const uint32_t* src) {
  Fe a;
#pragma unroll
  for (int i = 0; i < NL; i++) a.v[i] = src[i];
  return a;
}

H2A_HD void store_fe(uint32_t* dst, const Fe& a) {
#pragma unroll
  for (int i = 0; i < NL; i++) dst[i] = a.v[i];
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

// ---------------------------------------------------------------------------
// The carry flag.  On the device each function below is one PTX instruction
// that reads and/or writes CC.CF, so a 256-bit sum costs one instruction a
// limb and a 32 x 32 -> 64-bit multiply-add two (which ptxas pairs into one
// wide multiply-add with carry); a chain is a run of them in program order
// with nothing else that touches the flag between (the compiler itself
// emits no such instruction).  The host build keeps the flag in `Carry`, so
// g++ runs the very chains the card runs (csrc/host_shim.cpp).
// ---------------------------------------------------------------------------

struct Carry {
  uint32_t cf = 0;  // unused on the device
};

H2A_HD uint32_t cc_out(Carry& f, uint64_t s) {
  f.cf = (uint32_t)(s >> 32) & 1u;  // a sum's carry, a difference's borrow
  return (uint32_t)s;
}

H2A_HD uint32_t mul_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}

// name(f, a, b[, c]): the PTX instruction on the device, `expr` elsewhere.
#ifdef __CUDA_ARCH__
#define H2A_CC3(name, ptx, expr)                                  \
  H2A_HD uint32_t name(Carry& f, uint32_t a, uint32_t b) {        \
    uint32_t r;                                                   \
    asm volatile(ptx " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));  \
    return r;                                                     \
  }
#define H2A_CC4(name, ptx, expr)                                          \
  H2A_HD uint32_t name(Carry& f, uint32_t a, uint32_t b, uint32_t c) {    \
    uint32_t r;                                                           \
    asm volatile(ptx " %0, %1, %2, %3;"                                   \
                 : "=r"(r)                                                \
                 : "r"(a), "r"(b), "r"(c));                               \
    return r;                                                             \
  }
#else
#define H2A_CC3(name, ptx, expr) \
  H2A_HD uint32_t name(Carry& f, uint32_t a, uint32_t b) { return expr; }
#define H2A_CC4(name, ptx, expr)                                       \
  H2A_HD uint32_t name(Carry& f, uint32_t a, uint32_t b, uint32_t c) { \
    return expr;                                                       \
  }
#endif
H2A_CC3(add_cc, "add.cc.u32", cc_out(f, (uint64_t)a + b))            // carry out
H2A_CC3(addc_cc, "addc.cc.u32", cc_out(f, (uint64_t)a + b + f.cf))   // carry in, out
H2A_CC3(addc, "addc.u32", a + b + f.cf)                              // carry in
H2A_CC3(sub_cc, "sub.cc.u32", cc_out(f, (uint64_t)a - b))            // borrow out
H2A_CC3(subc_cc, "subc.cc.u32", cc_out(f, (uint64_t)a - b - f.cf))   // borrow in, out
H2A_CC3(subc, "subc.u32", a - b - f.cf)                              // borrow in
// lo(a b) + c and hi(a b) + c, with the carry in (madc) and out (.cc)
H2A_CC4(mad_lo_cc, "mad.lo.cc.u32", cc_out(f, (uint64_t)(uint32_t)(a * b) + c))
H2A_CC4(madc_lo_cc, "madc.lo.cc.u32", cc_out(f, (uint64_t)(uint32_t)(a * b) + c + f.cf))
H2A_CC4(madc_hi_cc, "madc.hi.cc.u32", cc_out(f, (uint64_t)mul_hi(a, b) + c + f.cf))
H2A_CC4(madc_hi, "madc.hi.u32", mul_hi(a, b) + c + f.cf)
#undef H2A_CC3
#undef H2A_CC4

// a + b mod p on the flag: one chain for the sum, one for the trial
// subtraction of p.  a, b canonical: a + b < 2p < 2^255, no carry out.
template <class F>
H2A_HD Fe fe_add_cc(const Fe& a, const Fe& b) {
  uint32_t p[NL];
  load_p<F>(p);
  Carry f;
  Fe s, d;
  s.v[0] = add_cc(f, a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < NL - 1; j++) s.v[j] = addc_cc(f, a.v[j], b.v[j]);
  s.v[NL - 1] = addc(f, a.v[NL - 1], b.v[NL - 1]);
  d.v[0] = sub_cc(f, s.v[0], p[0]);
#pragma unroll
  for (int j = 1; j < NL; j++) d.v[j] = subc_cc(f, s.v[j], p[j]);
  uint32_t borrow = subc(f, 0, 0);
  return borrow ? s : d;
}

// a - b mod p on the flag: the difference, then p added back under the
// borrow's mask.
template <class F>
H2A_HD Fe fe_sub_cc(const Fe& a, const Fe& b) {
  uint32_t p[NL];
  load_p<F>(p);
  Carry f;
  Fe d;
  d.v[0] = sub_cc(f, a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < NL; j++) d.v[j] = subc_cc(f, a.v[j], b.v[j]);
  uint32_t mask = subc(f, 0, 0);  // all ones after a borrow
  d.v[0] = add_cc(f, d.v[0], p[0] & mask);
#pragma unroll
  for (int j = 1; j < NL - 1; j++) d.v[j] = addc_cc(f, d.v[j], p[j] & mask);
  d.v[NL - 1] = addc(f, d.v[NL - 1], p[NL - 1] & mask);
  return d;
}

// a, b canonical: a + b < 2p < 2^255, so one conditional subtraction.
template <class F>
H2A_HD Fe fe_add(const Fe& a, const Fe& b) {
#ifdef __CUDA_ARCH__
  return fe_add_cc<F>(a, b);
#else
  uint32_t p[NL];
  load_p<F>(p);
  Fe s, d;
  add_limbs(s.v, a.v, b.v);
  uint32_t borrow = sub_limbs(d.v, s.v, p);
  return borrow ? s : d;
#endif
}

template <class F>
H2A_HD Fe fe_sub(const Fe& a, const Fe& b) {
#ifdef __CUDA_ARCH__
  return fe_sub_cc<F>(a, b);
#else
  uint32_t p[NL];
  load_p<F>(p);
  Fe d;
  if (sub_limbs(d.v, a.v, b.v)) add_limbs(d.v, d.v, p);
  return d;
#endif
}

template <class F>
H2A_HD Fe fe_neg(const Fe& a) {
  return fe_sub<F>(fe_zero(), a);
}

// acc += (x[0] + x[2] 2^64 + x[4] 2^128 + x[6] 2^192) y over acc's 8 limbs:
// each 64-bit product lands on its own pair of limbs, one chain through
// all four.  Leaves the carry out of limb 7 in the flag.
H2A_HD void cc_mad_pairs(Carry& f, uint32_t acc[NL], const uint32_t* x,
                         uint32_t y) {
  acc[0] = mad_lo_cc(f, x[0], y, acc[0]);
  acc[1] = madc_hi_cc(f, x[0], y, acc[1]);
#pragma unroll
  for (int j = 2; j < NL; j += 2) {
    acc[j] = madc_lo_cc(f, x[j], y, acc[j]);
    acc[j + 1] = madc_hi_cc(f, x[j], y, acc[j + 1]);
  }
}

// The same CIOS product as fe_mul's portable body below, with its carries in
// the flag.  The running sum T is kept as two 8-limb numbers, T = even + odd
// 2^32: the products of a's (and p's) even limbs go to `even`, those of the
// odd limbs to `odd`, so every 64-bit product is added to an aligned pair of
// limbs and no 64-bit carry word passes from step to step.  Per limb b_i of
// b: T += a b_i; m = T mod 2^32 times -1/p; T += m p; T /= 2^32.  The
// division swaps the roles: the old `odd` is the new `even`, and the old
// `even` (its limb 0 now zero) moves down two limbs to become the new
// `odd`, its limb 1 added into the new even's limb 0.  T < 2^288 inside a
// step and T < 2p after it, so neither number outgrows its limbs: the carry
// out of even's limb 7 goes into odd's limb 7, and odd has no carry out.
template <class F>
H2A_HD Fe fe_mul_cc(const Fe& a, const Fe& b) {
  uint32_t p[NL];
  load_p<F>(p);
  uint32_t even[NL], odd[NL];
  Carry f;
  // step 0: T = a b_0 + m p
#pragma unroll
  for (int j = 0; j < NL; j += 2) {
    uint64_t e = (uint64_t)a.v[j] * b.v[0], o = (uint64_t)a.v[j + 1] * b.v[0];
    even[j] = (uint32_t)e;
    even[j + 1] = (uint32_t)(e >> 32);
    odd[j] = (uint32_t)o;
    odd[j + 1] = (uint32_t)(o >> 32);
  }
  uint32_t m = even[0] * F::INV;
  cc_mad_pairs(f, odd, p + 1, m);
  cc_mad_pairs(f, even, p, m);
  odd[NL - 1] = addc(f, odd[NL - 1], 0);
#pragma unroll
  for (int i = 1; i < NL; i++) {
    // e: last step's odd, this step's even; o: last step's even (limb 0
    // zero), which becomes this step's odd
    uint32_t* e = (i & 1) ? odd : even;
    uint32_t* o = (i & 1) ? even : odd;
    uint32_t bi = b.v[i];
    e[0] = add_cc(f, e[0], o[1]);
    // o = (o >> 64) + (a_1 + a_3 2^64 + ..) b_i + the carry of the line above
#pragma unroll
    for (int j = 0; j < NL - 2; j += 2) {
      o[j] = madc_lo_cc(f, a.v[j + 1], bi, o[j + 2]);
      o[j + 1] = madc_hi_cc(f, a.v[j + 1], bi, o[j + 3]);
    }
    o[NL - 2] = madc_lo_cc(f, a.v[NL - 1], bi, 0);
    o[NL - 1] = madc_hi(f, a.v[NL - 1], bi, 0);
    cc_mad_pairs(f, e, a.v, bi);
    o[NL - 1] = addc(f, o[NL - 1], 0);
    m = e[0] * F::INV;
    cc_mad_pairs(f, o, p + 1, m);
    cc_mad_pairs(f, e, p, m);
    o[NL - 1] = addc(f, o[NL - 1], 0);
  }
  // after step 7 `odd` was the step's even (limb 0 zero) and `even` its odd:
  // T = even + (odd >> 32) < 2p
  Fe r, d;
  r.v[0] = add_cc(f, even[0], odd[1]);
#pragma unroll
  for (int j = 1; j < NL - 1; j++) r.v[j] = addc_cc(f, even[j], odd[j + 1]);
  r.v[NL - 1] = addc(f, even[NL - 1], 0);
  d.v[0] = sub_cc(f, r.v[0], p[0]);
#pragma unroll
  for (int j = 1; j < NL; j++) d.v[j] = subc_cc(f, r.v[j], p[j]);
  uint32_t borrow = subc(f, 0, 0);
  return borrow ? r : d;
}

// CIOS Montgomery product a * b / 2^256 mod p (native/h2a_native.cpp:98 with
// 32-bit words).  Every partial sum t + a*b + carry fits in 64 bits.  The
// card runs the carry-flag form above; g++ this portable one, which is also
// the reference the tests hold the other to.
template <class F>
H2A_HD Fe fe_mul(const Fe& a, const Fe& b) {
#ifdef __CUDA_ARCH__
  return fe_mul_cc<F>(a, b);
#else
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
#endif
}

template <class F>
H2A_HD Fe fe_sqr(const Fe& a) {
  return fe_mul<F>(a, a);
}

// Fermat inverse a^(p-2) in the Montgomery domain; 0 maps to 0.  The
// exponent is p with its low limb less 2 (both moduli have P0 >= 2), taken
// from the top with a sliding window of 4 bits: the odd powers a, a^3, ..
// a^15 (8 products), one squaring a bit, and one product a window (a window
// starts and ends on a set bit): 312 products for Fr and 311 for Fq, where
// one bit at a time took 381 and 364.
template <class F>
H2A_HD Fe fe_inv(const Fe& a) {
  uint32_t e[NL];
  load_p<F>(e);
  e[0] -= 2;
  Fe odd[8];
  odd[0] = a;
  Fe a2 = fe_sqr<F>(a);
#pragma unroll 1
  for (int i = 1; i < 8; i++) odd[i] = fe_mul<F>(odd[i - 1], a2);
  Fe acc = fe_one<F>();
  int bit = 253;
#pragma unroll 1
  while (bit >= 0) {
    if (!((e[bit >> 5] >> (bit & 31)) & 1u)) {
      acc = fe_sqr<F>(acc);
      --bit;
      continue;
    }
    int lo = bit < 3 ? 0 : bit - 3;
    while (!((e[lo >> 5] >> (lo & 31)) & 1u)) ++lo;
    uint32_t w = 0;
    for (int j = bit; j >= lo; --j) {
      w = (w << 1) | ((e[j >> 5] >> (j & 31)) & 1u);
      acc = fe_sqr<F>(acc);
    }
    acc = fe_mul<F>(acc, odd[w >> 1]);
    bit = lo - 1;
  }
  return acc;
}

}  // namespace h2a
