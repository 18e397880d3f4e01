// The per-thread code of the segmented Jacobian sum (jac_sum.cu), shared
// with the host build (host_shim.cpp).
//
// JS_WIDTH threads share one (batch element, segment): thread t adds the
// segment's lanes t, t + JS_WIDTH, ... in series, then a tree over the
// threads' partial sums halves their number log2(JS_WIDTH) times.  A thread
// with no lane holds the identity, which jac_add absorbs (Z = 0 returns the
// other operand); equal points take its doubling branch and a point with
// its negation its cancelling branch.
#pragma once

#include "curve.cuh"

namespace h2a {

constexpr int JS_WIDTH = 32;  // threads a (batch element, segment): one warp

// The lanes of every batch element: coordinate arrays of 8-limb elements,
// element (b, lane) at word b * batch_stride + lane * lane_stride.
struct JacLanes {
  const uint32_t* x;
  const uint32_t* y;
  const uint32_t* z;
  size_t batch_stride;
  size_t lane_stride;
};

H2A_HD Jac jac_lane_load(const JacLanes& L, size_t b, size_t lane) {
  size_t off = b * L.batch_stride + lane * L.lane_stride;
  return Jac{load_fe(L.x + off), load_fe(L.y + off), load_fe(L.z + off)};
}

// Thread t's partial sum: lanes lo + t, lo + t + JS_WIDTH, ... below hi of
// batch element b.
H2A_HD Jac jac_sum_partial(const JacLanes& L, size_t b, int lo, int hi, int t) {
  Jac acc = jac_identity();
  for (int i = lo + t; i < hi; i += JS_WIDTH)
    acc = jac_add(acc, jac_lane_load(L, b, (size_t)i));
  return acc;
}

// One level of the tree over sh[0 .. 2 s): thread t < s takes in sh[t + s].
H2A_HD void jac_sum_level(Jac* sh, int t, int s) {
  if (t < s) sh[t] = jac_add(sh[t], sh[t + s]);
}

// The identity comes out as (1, 1, 0).
H2A_HD Jac jac_sum_finish(const Jac& a) {
  return fe_is_zero(a.z) ? jac_identity() : a;
}

}  // namespace h2a
