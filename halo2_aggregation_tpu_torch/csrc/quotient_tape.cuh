// One row of the quotient numerator (kernel K6): the tape interpreter of
// fa_tape.cuh over a second register file.  Shared by the CUDA kernel
// (quotient_tape.cu) and the host build (host_shim.cpp).
//
// Inputs of the quotient tape (plonk/quotient_program.py) are described by
// one (src, rot) pair each:
//   src >= 0   column `src` of the resident (C, n, 8) evaluation stack,
//              read at row (row + rot) mod n: a rotation is an index offset,
//              wrapping around the coset, and no rotated copy exists;
//   src == -1  the coset point x_row = shift * omega^row, from an (n, 8)
//              column;
//   src <= -2  per-launch uniform -src-2 (theta, beta, gamma, y, 1/(shift^n-1)).
// Temporaries live per thread in `tmp` (at most QT_MAX_TEMPS of them).
#pragma once

#include "fa_tape.cuh"

namespace h2a {

constexpr int QT_MAX_TEMPS = 64;

struct QuotientRegs {
  const uint32_t* consts;    // (n_consts, 8) Montgomery Fr
  const int32_t* in_src;     // (n_in,)
  const int32_t* in_rot;     // (n_in,)
  const uint32_t* stack;     // (C, n, 8) coset evaluations
  const uint32_t* x;         // (n, 8) coset points
  const uint32_t* uniforms;  // (n_uniform, 8)
  int n_in;
  uint32_t n;  // rows, a power of two
  uint32_t row;
  Fe* tmp;  // this row's temporaries

  H2A_HD Fe load(int r) const {
    if (r < 0) return load_fe(consts + (size_t)(-r - 1) * NL);
    if (r >= n_in) return tmp[r - n_in];
    int src = in_src[r];
    if (src >= 0) {
      // unsigned wraparound: (row + rot) mod 2^32, then mod n (n | 2^32)
      uint32_t i = (row + (uint32_t)in_rot[r]) & (n - 1);
      return load_fe(stack + ((size_t)src * n + i) * NL);
    }
    if (src == -1) return load_fe(x + (size_t)row * NL);
    return load_fe(uniforms + (size_t)(-src - 2) * NL);
  }

  H2A_HD void store(int r, const Fe& a) const { tmp[r - n_in] = a; }
};

// The quotient numerator of one row: runs the tape and returns register
// out_reg (canonical Montgomery Fr).
H2A_HD Fe quotient_lane(const int32_t* tape, int n_instr,
                        const QuotientRegs& R, int out_reg) {
  tape_run(tape, n_instr, R);
  return R.load(out_reg);
}

}  // namespace h2a
