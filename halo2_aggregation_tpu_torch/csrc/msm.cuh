// The per-thread parts of the bucket MSM (kernels K7 and K9), shared by the
// CUDA kernels (msm.cu) and the host build (host_shim.cpp).
//
// sum_i s_i * P_i over affine points P_i (Montgomery Fq) is split into
// windows of the scalars' digits.  One thread owns one (window w, chunk c):
// it streams the points i = c, c + C, c + 2C, ... past its private buckets,
// adding P_i into bucket |d| (digit d of s_i in window w), then folds the
// buckets into sum_m m * bucket_m.  The chunks' folds are summed per window
// and the windows are joined by Horner: acc = 2^bits * acc + window_sum.
//
// Digits are uint8, one row of n per window ((n_win, n) row-major):
// * signed (K7): 52 windows of 5 bits, d in [-16, 15] encoded as
//   |d| | (d < 0) << 5 (ops/msm.py::signed_windows); a negative digit adds
//   (x, -y) into bucket |d| with the mixed add;
// * unsigned (K9): 64 windows of 4 bits, d in [0, 15]; the full jac_add with
//   the point lifted to z = 1, as the TPU kernel does.
// Digit 0 is skipped: it is what the TPU kernels' dump bucket did.
#pragma once

#include "curve.cuh"

namespace h2a {

template <bool SIGNED>
struct MsmKind {
  static constexpr int WINDOWS = SIGNED ? 52 : 64;
  static constexpr int BITS = SIGNED ? 5 : 4;
  static constexpr int BUCKETS = SIGNED ? 16 : 15;  // live buckets, |d| >= 1
};

// One element of an (n, 8) limb array.
H2A_HD Fe msm_load(const uint32_t* p) {
  Fe r;
#ifdef __CUDA_ARCH__
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 a = q[0], b = q[1];
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
#else
  for (int i = 0; i < NL; i++) r.v[i] = p[i];
#endif
  return r;
}

// The bucket pass and fold of thread (w, c): `dig` is window w's row of n
// digits.  Returns sum_{m >= 1} m * bucket_m, by running and suffix sums
// from the top bucket down (ec_pallas.py:571-601: 2 full adds a bucket).
template <bool SIGNED>
H2A_HD Jac msm_chunk(const uint32_t* xs, const uint32_t* ys,
                     const uint8_t* dig, uint32_t n, uint32_t c, uint32_t C) {
  constexpr int NB = MsmKind<SIGNED>::BUCKETS;
  Jac b[NB];
  for (int m = 0; m < NB; m++) b[m] = jac_identity();
  for (uint32_t i = c; i < n; i += C) {
    uint32_t e = dig[i];
    uint32_t mag = SIGNED ? (e & 31u) : e;
    if (mag == 0) continue;
    Fe x = msm_load(xs + (size_t)i * NL);
    Fe y = msm_load(ys + (size_t)i * NL);
    if (SIGNED) {
      if (e >> 5) y = fe_neg<Fq>(y);
      b[mag - 1] = jac_add_mixed(b[mag - 1], x, y);
    } else {
      b[mag - 1] = jac_add(b[mag - 1], Jac{x, y, fe_one<Fq>()});
    }
  }
  Jac run = jac_identity(), tot = jac_identity();
  for (int m = NB - 1; m >= 0; --m) {
    run = jac_add(run, b[m]);
    tot = jac_add(tot, run);
  }
  return tot;
}

// Horner across windows, high to low: acc = 2^bits * acc + wsum[w].
// Canonical identity (1, 1, 0) when the sum is the identity.
H2A_HD Jac msm_horner(const Jac* wsum, int n_win, int bits) {
  Jac acc = jac_identity();
  for (int w = n_win - 1; w >= 0; --w) {
    for (int i = 0; i < bits; i++) acc = jac_double(acc);
    acc = jac_add(acc, wsum[w]);
  }
  if (fe_is_zero(acc.z)) acc = jac_identity();
  return acc;
}

}  // namespace h2a
