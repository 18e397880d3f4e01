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
// Fe&) const`.  K2's `SharedTapeRegs` keeps the inputs and temporaries of a
// block's lanes in shared memory as [register][limb][lane]; `TapeRegs`
// keeps them in device memory as [register][lane][limb] (the host build's
// reference for the other two); K6's `QuotientRegs` (quotient_tape.cuh)
// reads its inputs from a resident column stack and keeps its temporaries
// per thread.
#pragma once

#include "field.cuh"

namespace h2a {

enum TapeOp { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_NEG = 3, OP_INV = 4 };

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

// A register file in device memory: inputs and temporaries laid out
// [register][lane][limb].
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

// A lane over TapeRegs: runs the tape, then copies the n_out output
// registers to out (n_out, lanes, 8).
H2A_HD void fa_tape_lane(const int32_t* tape, int n_instr, const TapeRegs& R,
                         const int32_t* out_regs, int n_out, uint32_t* out) {
  tape_run(tape, n_instr, R);
  for (int o = 0; o < n_out; o++) {
    store_fe(out + ((size_t)o * R.lanes + R.lane) * NL, R.load(out_regs[o]));
  }
}

// K2's register file: the inputs (registers 0 .. n_in - 1) and temporaries
// of a block's lanes in shared memory, word (register, limb, lane) at
// (register * 8 + limb) * lanes + lane, so a warp's 32 lanes read 32
// neighbouring words; constants as (n_consts, 8).
struct SharedTapeRegs {
  const uint32_t* consts;
  uint32_t* regs;
  int lanes;  // lanes of the block
  int lane;   // this thread's lane in the block

  H2A_HD Fe load(int r) const {
    if (r < 0) return load_fe(consts + (size_t)(-r - 1) * NL);
    Fe a;
    const uint32_t* src = regs + (size_t)r * NL * lanes + lane;
#pragma unroll
    for (int i = 0; i < NL; i++) a.v[i] = src[(size_t)i * lanes];
    return a;
  }

  H2A_HD void store(int r, const Fe& a) const {
    uint32_t* dst = regs + (size_t)r * NL * lanes + lane;
#pragma unroll
    for (int i = 0; i < NL; i++) dst[(size_t)i * lanes] = a.v[i];
  }
};

// The words of shared memory a block of `lanes` lanes needs: the tape, the
// constants, then the register file.
H2A_HD size_t fa_tape_shared_words(int n_instr, int n_consts, int n_in,
                                   int n_tmp, int lanes) {
  return (size_t)4 * n_instr + (size_t)NL * n_consts +
         (size_t)(n_in + n_tmp) * NL * lanes;
}

// K2's lane: reads its n_in inputs from `in` (n_in, total, 8) once, runs the
// tape over R, then copies the n_out output registers to out
// (n_out, total, 8); `lane` is the lane's index among the `total`.
H2A_HD void fa_tape_lane_shared(const int32_t* tape, int n_instr,
                                const SharedTapeRegs& R, const uint32_t* in,
                                int n_in, int total, int lane,
                                const int32_t* out_regs, int n_out,
                                uint32_t* out) {
  for (int r = 0; r < n_in; r++)
    R.store(r, load_fe(in + ((size_t)r * total + lane) * NL));
  tape_run(tape, n_instr, R);
  for (int o = 0; o < n_out; o++)
    store_fe(out + ((size_t)o * total + lane) * NL, R.load(out_regs[o]));
}

}  // namespace h2a
