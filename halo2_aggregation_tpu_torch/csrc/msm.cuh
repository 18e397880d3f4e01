// The per-thread parts of the bucket MSM (kernels K7 and K9), shared by the
// CUDA kernels (msm.cu) and the host build (host_shim.cpp).
//
// sum_i s_i * P_i over affine points P_i (Montgomery Fq) is split into
// windows of the scalars' digits.  One thread owns one (window w, chunk c):
// the contiguous points [c * L, min(n, (c + 1) * L)) with L = ceil(n / C).
// It works in three steps, none of which keeps a bucket in local memory:
//
// 1. msm_sort_chunk: a counting sort of the chunk by digit magnitude.  One
//    pass over the chunk's digits fills a histogram (NB + 1 counters, in
//    shared memory on the card), a prefix sum turns it into bucket starts,
//    a second pass writes each nonzero point's offset within the chunk
//    (and its sign, bit 15) into the thread's slice of `order`, a uint16
//    scratch of (n_win, n): magnitude 1 first, the top bucket last.
// 2. msm_walk: the thread reads `order` back and adds the points of one
//    magnitude after another into ONE accumulator in registers.  Where the
//    magnitude changes, the finished bucket sum is parked in the thread's
//    slice of `bsums` (scratch in device memory, (n_win, C, NB) points) and
//    the accumulator starts again at the identity.  Every lane of a warp
//    makes one add an iteration until its chunk is used up, so lanes
//    diverge only by the chunks' counts of zero digits.
// 3. msm_fold: sum_m m * bucket_m by running and suffix sums from the top
//    bucket down (ec_pallas.py:571-601: 2 full adds a bucket), over the
//    parked sums; an empty bucket is the identity.
// The chunks' folds are summed per window and the windows are joined by
// Horner: acc = 2^bits * acc + window_sum (msm_horner).
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

#ifdef __CUDACC__
#define H2A_HD_NOINLINE __host__ __device__ __noinline__
#else
#define H2A_HD_NOINLINE __attribute__((noinline))
#endif

namespace h2a {

template <bool SIGNED>
struct MsmKind {
  static constexpr int WINDOWS = SIGNED ? 52 : 64;
  static constexpr int BITS = SIGNED ? 5 : 4;
  static constexpr int BUCKETS = SIGNED ? 16 : 15;  // live buckets, |d| >= 1
};

constexpr uint32_t kMsmMaxChunk = 1u << 15;  // offsets take 15 bits of `order`
constexpr uint32_t kMsmSignBit = 1u << 15;
constexpr int kJacWords = 3 * NL;

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

H2A_HD void msm_store(uint32_t* p, const Fe& a) {
#ifdef __CUDA_ARCH__
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  q[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
#else
  for (int i = 0; i < NL; i++) p[i] = a.v[i];
#endif
}

H2A_HD Jac msm_load_jac(const uint32_t* p) {
  return Jac{msm_load(p), msm_load(p + NL), msm_load(p + 2 * NL)};
}

H2A_HD void msm_store_jac(uint32_t* p, const Jac& a) {
  msm_store(p, a.x);
  msm_store(p + NL, a.y);
  msm_store(p + 2 * NL, a.z);
}

// The full add as a call: the folds make two a bucket, which is too rare to
// pay for another inlined body (and its doubling) in the kernel's code.
static H2A_HD_NOINLINE Jac msm_jac_add(const Jac& p, const Jac& q) {
  return jac_add(p, q);
}

// Step 1 for the chunk whose digits are dig[0 .. len) (len <= 2^15).  `cnt`
// holds NB + 1 counters `stride` words apart (a thread's column of a shared
// array on the card), zeroed here.  Writes order[0 .. total) and returns
// total, the chunk's count of nonzero digits; on return cnt[m * stride] is
// the END of magnitude m's run in `order` (so cnt[(m - 1) * stride] is its
// start, and cnt[0] is 0).
template <bool SIGNED>
H2A_HD uint32_t msm_sort_chunk(const uint8_t* dig, uint32_t len, uint16_t* order,
                               uint32_t* cnt, uint32_t stride) {
  constexpr int NB = MsmKind<SIGNED>::BUCKETS;
  for (int m = 0; m <= NB; m++) cnt[m * stride] = 0;
  for (uint32_t j = 0; j < len; j++) {
    uint32_t mag = SIGNED ? (dig[j] & 31u) : dig[j];
    cnt[mag * stride] += 1;
  }
  uint32_t total = 0;  // starts: cnt[m] = sum of the counts below m
  for (int m = 1; m <= NB; m++) {
    uint32_t k = cnt[m * stride];
    cnt[m * stride] = total;
    total += k;
  }
  cnt[0] = 0;
  for (uint32_t j = 0; j < len; j++) {
    uint32_t e = dig[j];
    uint32_t mag = SIGNED ? (e & 31u) : e;
    if (mag == 0) continue;
    uint32_t pos = cnt[mag * stride]++;
    order[pos] = (uint16_t)(j | ((SIGNED && (e >> 5)) ? kMsmSignBit : 0u));
  }
  return total;
}

// One point of the chunk, as the walks take it: its coordinates, with y
// negated for a negative digit, and its magnitude.  The magnitude is read
// from the digit again: a walk that took the runs' ends from the sort's
// counters instead ran K7 no faster and K9 3 % slower on an H100 at 2^21.
struct MsmPoint {
  Fe x, y;
  uint32_t mag;
};

template <bool SIGNED>
H2A_HD MsmPoint msm_fetch(const uint32_t* xs, const uint32_t* ys, const uint8_t* dig,
                          uint32_t entry) {
  uint32_t j = entry & (kMsmSignBit - 1);
  MsmPoint p;
  p.x = msm_load(xs + (size_t)j * NL);
  p.y = msm_load(ys + (size_t)j * NL);
  p.mag = SIGNED ? (dig[j] & 31u) : dig[j];
  if (SIGNED && (entry & kMsmSignBit)) p.y = fe_neg<Fq>(p.y);
  return p;
}

template <bool SIGNED>
H2A_HD Jac msm_add_point(const Jac& acc, const MsmPoint& p) {
  if (SIGNED) return jac_add_mixed(acc, p.x, p.y);
  return jac_add(acc, Jac{p.x, p.y, fe_one<Fq>()});
}

// Step 2: xs, ys, dig point at the chunk's first point; `bsums` at the
// thread's NB parked bucket sums.  Returns the mask of the magnitudes met
// (bit m); a magnitude not met has no sum parked.
template <bool SIGNED>
H2A_HD uint32_t msm_walk(const uint32_t* xs, const uint32_t* ys, const uint8_t* dig,
                         const uint16_t* order, uint32_t total, uint32_t* bsums) {
  if (total == 0) return 0;
  uint32_t met = 0, cur = 0;
  Jac acc = jac_identity();
  for (uint32_t pos = 0; pos < total; pos++) {
    MsmPoint p = msm_fetch<SIGNED>(xs, ys, dig, order[pos]);
    if (p.mag != cur) {
      if (cur != 0) {
        msm_store_jac(bsums + (size_t)(cur - 1) * kJacWords, acc);
        met |= 1u << cur;
        acc = jac_identity();
      }
      cur = p.mag;
    }
    acc = msm_add_point<SIGNED>(acc, p);
  }
  msm_store_jac(bsums + (size_t)(cur - 1) * kJacWords, acc);
  return met | (1u << cur);
}

// Step 3 over the parked sums of the magnitudes in `met`.
template <bool SIGNED>
H2A_HD Jac msm_fold(const uint32_t* bsums, uint32_t met) {
  constexpr int NB = MsmKind<SIGNED>::BUCKETS;
  Jac run = jac_identity(), tot = jac_identity();
#pragma unroll 1
  for (int m = NB; m >= 1; --m) {
    if ((met >> m) & 1u)
      run = msm_jac_add(run, msm_load_jac(bsums + (size_t)(m - 1) * kJacWords));
    tot = msm_jac_add(tot, run);
  }
  return tot;
}

// Thread (w, c) whole: `dig` is window w's row of n digits, `order` window
// w's row of the scratch, `bsums` the thread's NB parked sums.  Returns
// sum_{m >= 1} m * bucket_m over the chunk's points.
template <bool SIGNED>
H2A_HD Jac msm_chunk(const uint32_t* xs, const uint32_t* ys, const uint8_t* dig,
                     uint32_t n, uint32_t c, uint32_t L, uint16_t* order,
                     uint32_t* bsums, uint32_t* cnt, uint32_t stride) {
  uint32_t lo = c * L;
  if (lo >= n) return jac_identity();
  uint32_t len = (n - lo < L) ? n - lo : L;
  xs += (size_t)lo * NL;
  ys += (size_t)lo * NL;
  dig += lo;
  order += lo;
  uint32_t total = msm_sort_chunk<SIGNED>(dig, len, order, cnt, stride);
  uint32_t met = msm_walk<SIGNED>(xs, ys, dig, order, total, bsums);
  return msm_fold<SIGNED>(bsums, met);
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
