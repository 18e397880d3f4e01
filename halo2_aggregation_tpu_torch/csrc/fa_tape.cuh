// The tape interpreter shared by kernels K2 (fa_tape.cu) and K6
// (quotient_tape.cu), and by the host build (host_shim.cpp).
//
// A tape is a straight-line Fr program recorded from plonk/protocol.py's
// formulas by plonk/protocol_ops.py::TapeOps: rows of (op, dst, a, b).
// Operand encoding: r < 0 names constant -r-1; 0 <= r < n_in names input r;
// r >= n_in names temporary r - n_in.  dst is always a temporary.
//
// `tape_run` is the instruction loop, a template over the register file:
// a register file has `Fe load(int r) const` and `void store(int r, const
// Fe&) const`.  K2's `TapeRegs` keeps inputs and temporaries in device
// memory as [register][lane][limb]; K6's `QuotientRegs` (quotient_tape.cuh)
// reads its inputs from a resident column stack and keeps its temporaries
// per thread.
#pragma once

#include "field.cuh"

namespace h2a {

enum TapeOp { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_NEG = 3, OP_INV = 4 };

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

// Runs every instruction of the tape over the register file R.
template <class Regs>
H2A_HD void tape_run(const int32_t* tape, int n_instr, const Regs& R) {
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
}

// K2's register file: inputs and temporaries laid out [register][lane][limb].
struct TapeRegs {
  const uint32_t* consts;  // (n_consts, 8) Montgomery Fr
  const uint32_t* in;      // (n_in, lanes, 8)
  uint32_t* tmp;           // (n_tmp, lanes, 8)
  int n_in;
  int lanes;
  int lane;

  H2A_HD Fe load(int r) const {
    if (r < 0) return load_fe(consts + (size_t)(-r - 1) * NL);
    if (r < n_in) return load_fe(in + ((size_t)r * lanes + lane) * NL);
    return load_fe(tmp + ((size_t)(r - n_in) * lanes + lane) * NL);
  }

  H2A_HD void store(int r, const Fe& a) const {
    store_fe(tmp + ((size_t)(r - n_in) * lanes + lane) * NL, a);
  }
};

// K2's lane: runs the tape, then copies the n_out output registers to
// out (n_out, lanes, 8).
H2A_HD void fa_tape_lane(const int32_t* tape, int n_instr, const TapeRegs& R,
                         const int32_t* out_regs, int n_out, uint32_t* out) {
  tape_run(tape, n_instr, R);
  for (int o = 0; o < n_out; o++) {
    store_fe(out + ((size_t)o * R.lanes + R.lane) * NL, R.load(out_regs[o]));
  }
}

}  // namespace h2a
