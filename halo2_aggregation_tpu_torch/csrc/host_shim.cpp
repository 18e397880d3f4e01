// Host build of the kernels' arithmetic: g++ compiles the same headers the
// CUDA kernels use, so the CPU tests check K1's and K2's per-lane code
// without a card (tests/test_torch_host_core.py).  Not part of the CUDA
// library.  Layouts match the kernels': elements are 8 x 32-bit limbs.
#include "ec_win.cuh"
#include "fa_tape.cuh"

using namespace h2a;

namespace {

Fe load(const uint32_t* src) {
  Fe a;
  for (int i = 0; i < NL; i++) a.v[i] = src[i];
  return a;
}

void store(uint32_t* dst, const Fe& a) {
  for (int i = 0; i < NL; i++) dst[i] = a.v[i];
}

}  // namespace

extern "C" {

// field: 0 = Fq, 1 = Fr.  out[i] = a[i] * b[i] (Montgomery).
void h2a_host_mont_mul(int field, const uint32_t* a, const uint32_t* b,
                       uint32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    Fe x = load(a + NL * i), y = load(b + NL * i);
    store(out + NL * i, field ? fe_mul<Fr>(x, y) : fe_mul<Fq>(x, y));
  }
}

// Points are (n, 3, 8): x, y, z per point.
void h2a_host_jac_add(const uint32_t* p, const uint32_t* q, uint32_t* out,
                      int n) {
  for (int i = 0; i < n; i++) {
    const uint32_t* a = p + 3 * NL * i;
    const uint32_t* b = q + 3 * NL * i;
    Jac P{load(a), load(a + NL), load(a + 2 * NL)};
    Jac Q{load(b), load(b + NL), load(b + 2 * NL)};
    Jac r = jac_add(P, Q);
    uint32_t* o = out + 3 * NL * i;
    store(o, r.x);
    store(o + NL, r.y);
    store(o + 2 * NL, r.z);
  }
}

void h2a_host_ec_win(const uint32_t* px, const uint32_t* py,
                     const uint32_t* pz, const uint32_t* scalars,
                     uint32_t* ox, uint32_t* oy, uint32_t* oz, int n) {
  for (int i = 0; i < n; i++) {
    size_t off = (size_t)NL * i;
    Jac P{load(px + off), load(py + off), load(pz + off)};
    Jac r = ec_win_lane(P, scalars + off);
    store(ox + off, r.x);
    store(oy + off, r.y);
    store(oz + off, r.z);
  }
}

void h2a_host_fa_tape(const int32_t* tape, int n_instr, const uint32_t* consts,
                      const uint32_t* in, int n_in, uint32_t* tmp,
                      const int32_t* out_regs, int n_out, uint32_t* out,
                      int lanes) {
  for (int lane = 0; lane < lanes; lane++) {
    TapeRegs R{consts, in, tmp, n_in, lanes, lane};
    fa_tape_lane(tape, n_instr, R, out_regs, n_out, out);
  }
}

}  // extern "C"
