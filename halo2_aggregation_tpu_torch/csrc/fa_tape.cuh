// One lane of the field-algebra tape interpreter (kernel K2).  Shared by the
// CUDA kernel (fa_tape.cu) and the host build (host_shim.cpp).
//
// A tape is a straight-line Fr program recorded from plonk/protocol.py's
// formulas by plonk/protocol_ops.py::TapeOps: rows of (op, dst, a, b).
// Operand encoding: r < 0 names constant -r-1; 0 <= r < n_in names input r;
// r >= n_in names temporary r - n_in.  dst is always a temporary.  Inputs
// and temporaries are laid out [register][lane][limb].
#pragma once

#include "field.cuh"

namespace h2a {

enum TapeOp { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_NEG = 3, OP_INV = 4 };

struct TapeRegs {
  const uint32_t* consts;  // (n_consts, 8) Montgomery Fr
  const uint32_t* in;      // (n_in, lanes, 8)
  uint32_t* tmp;           // (n_tmp, lanes, 8)
  int n_in;
  int lanes;
  int lane;

  H2A_HD const uint32_t* addr(int r) const {
    if (r < 0) return consts + (size_t)(-r - 1) * NL;
    if (r < n_in) return in + ((size_t)r * lanes + lane) * NL;
    return tmp + ((size_t)(r - n_in) * lanes + lane) * NL;
  }

  H2A_HD Fe load(int r) const {
    const uint32_t* src = addr(r);
    Fe a;
#pragma unroll
    for (int i = 0; i < NL; i++) a.v[i] = src[i];
    return a;
  }

  H2A_HD void store(int r, const Fe& a) const {
    uint32_t* dst = tmp + ((size_t)(r - n_in) * lanes + lane) * NL;
#pragma unroll
    for (int i = 0; i < NL; i++) dst[i] = a.v[i];
  }
};

// Runs the tape for one lane, then copies the n_out output registers to
// out (n_out, lanes, 8).
H2A_HD void fa_tape_lane(const int32_t* tape, int n_instr, const TapeRegs& R,
                         const int32_t* out_regs, int n_out, uint32_t* out) {
  for (int k = 0; k < n_instr; k++) {
    const int32_t* ins = tape + 4 * k;
    Fe a = R.load(ins[2]);
    Fe r;
    switch (ins[0]) {
      case OP_ADD: r = fe_add<Fr>(a, R.load(ins[3])); break;
      case OP_SUB: r = fe_sub<Fr>(a, R.load(ins[3])); break;
      case OP_MUL: r = fe_mul<Fr>(a, R.load(ins[3])); break;
      case OP_NEG: r = fe_neg<Fr>(a); break;
      default: r = fe_inv<Fr>(a); break;
    }
    R.store(ins[1], r);
  }
  for (int o = 0; o < n_out; o++) {
    Fe a = R.load(out_regs[o]);
    uint32_t* dst = out + ((size_t)o * R.lanes + R.lane) * NL;
#pragma unroll
    for (int i = 0; i < NL; i++) dst[i] = a.v[i];
  }
}

}  // namespace h2a
