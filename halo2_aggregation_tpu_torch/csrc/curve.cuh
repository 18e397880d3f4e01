// BN254 G1 in Jacobian coordinates over Montgomery Fq (Z == 0 is the
// identity).  The formulas are those of halo2_aggregation_tpu/ops/curve_ops.py
// (jac_double: dbl-2009-l; jac_add: add-2007-bl with the same edge cases),
// taken with branches instead of selects: the edge cases are rare on real
// lanes, so a diverging warp pays for them seldom, while a branchless add
// would pay a full doubling on every call.
#pragma once

#include "field.cuh"

namespace h2a {

struct Jac {
  Fe x, y, z;
};

H2A_HD Jac jac_identity() {
  Jac r;
  r.x = fe_one<Fq>();
  r.y = fe_one<Fq>();
  r.z = fe_zero();
  return r;
}

// dbl-2009-l; Z = 0 maps to Z3 = 2*Y*Z = 0, so the identity needs no test.
H2A_HD Jac jac_double(const Jac& p) {
  Fe A = fe_sqr<Fq>(p.x);
  Fe B = fe_sqr<Fq>(p.y);
  Fe C = fe_sqr<Fq>(B);
  Fe t = fe_sqr<Fq>(fe_add<Fq>(p.x, B));
  Fe D = fe_sub<Fq>(fe_sub<Fq>(t, A), C);
  D = fe_add<Fq>(D, D);
  Fe E = fe_add<Fq>(fe_add<Fq>(A, A), A);
  Fe F = fe_sqr<Fq>(E);
  Jac r;
  r.x = fe_sub<Fq>(F, fe_add<Fq>(D, D));
  Fe C8 = fe_add<Fq>(C, C);
  C8 = fe_add<Fq>(C8, C8);
  C8 = fe_add<Fq>(C8, C8);
  r.y = fe_sub<Fq>(fe_mul<Fq>(E, fe_sub<Fq>(D, r.x)), C8);
  r.z = fe_mul<Fq>(fe_add<Fq>(p.y, p.y), p.z);
  return r;
}

// p + q: p == O -> q; q == O -> p; p == q -> 2p; p == -q -> O.
H2A_HD Jac jac_add(const Jac& p, const Jac& q) {
  if (fe_is_zero(p.z)) return q;
  if (fe_is_zero(q.z)) return p;
  Fe z1z1 = fe_sqr<Fq>(p.z);
  Fe z2z2 = fe_sqr<Fq>(q.z);
  Fe u1 = fe_mul<Fq>(p.x, z2z2);
  Fe u2 = fe_mul<Fq>(q.x, z1z1);
  Fe s1 = fe_mul<Fq>(p.y, fe_mul<Fq>(q.z, z2z2));
  Fe s2 = fe_mul<Fq>(q.y, fe_mul<Fq>(p.z, z1z1));
  Fe h = fe_sub<Fq>(u2, u1);
  Fe r = fe_sub<Fq>(s2, s1);
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) return jac_double(p);
    return jac_identity();
  }
  Fe h2 = fe_sqr<Fq>(h);
  Fe h3 = fe_mul<Fq>(h2, h);
  Fe u1h2 = fe_mul<Fq>(u1, h2);
  Jac o;
  o.x = fe_sub<Fq>(fe_sub<Fq>(fe_sqr<Fq>(r), h3), fe_add<Fq>(u1h2, u1h2));
  o.y = fe_sub<Fq>(fe_mul<Fq>(r, fe_sub<Fq>(u1h2, o.x)), fe_mul<Fq>(s1, h3));
  o.z = fe_mul<Fq>(fe_mul<Fq>(p.z, q.z), h);
  return o;
}

// p + (x2, y2, 1): the Jacobian + affine add of
// halo2_aggregation_tpu/ops/ec_pallas.py::_jac_add_mixed (:284-314), 11
// products against jac_add's 16.  The affine operand is never the identity
// (the MSM skips zero digits).  Edge cases: p == O -> (x2, y2, 1);
// h == r == 0 (p == q) -> 2p; h == 0, r != 0 (p == -q) -> O.
H2A_HD Jac jac_add_mixed(const Jac& p, const Fe& x2, const Fe& y2) {
  if (fe_is_zero(p.z)) return Jac{x2, y2, fe_one<Fq>()};
  Fe z1z1 = fe_sqr<Fq>(p.z);
  Fe u2 = fe_mul<Fq>(x2, z1z1);
  Fe s2 = fe_mul<Fq>(y2, fe_mul<Fq>(p.z, z1z1));
  Fe h = fe_sub<Fq>(u2, p.x);
  Fe r = fe_sub<Fq>(s2, p.y);
  if (fe_is_zero(h)) {
    if (fe_is_zero(r)) return jac_double(p);
    return jac_identity();
  }
  Fe h2 = fe_sqr<Fq>(h);
  Fe h3 = fe_mul<Fq>(h2, h);
  Fe u1h2 = fe_mul<Fq>(p.x, h2);
  Jac o;
  o.x = fe_sub<Fq>(fe_sub<Fq>(fe_sqr<Fq>(r), h3), fe_add<Fq>(u1h2, u1h2));
  o.y = fe_sub<Fq>(fe_mul<Fq>(r, fe_sub<Fq>(u1h2, o.x)), fe_mul<Fq>(p.y, h3));
  o.z = fe_mul<Fq>(p.z, h);
  return o;
}

}  // namespace h2a
