// Host build of the kernels' arithmetic: g++ compiles the same headers the
// CUDA kernels use, so the CPU tests check K1's, K2's, K6's and K8's per-lane
// code (K1's scalar split and two halves, K2's shared-memory register file,
// K8's joint double-and-add), the segmented sum's per-thread code and tree,
// the NTT butterflies, index maps and fused passes of K3-K4, K5's power
// series, the mixed add and the per-thread bucket pass, fold and Horner of
// K7 and K9 without a card
// (tests/test_torch_host_core.py).  Not part of the CUDA library.  Layouts
// match the kernels': elements are 8 x 32-bit limbs.
#include "ec_ladder.cuh"
#include "ec_win.cuh"
#include "fa_tape.cuh"
#include "jac_sum.cuh"
#include "msm.cuh"
#include "ntt.cuh"
#include "quotient_tape.cuh"

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

// The same product through fe_mul_cc, the form the card runs, with the carry
// flag kept in a variable.
void h2a_host_mont_mul_cc(int field, const uint32_t* a, const uint32_t* b,
                          uint32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    Fe x = load(a + NL * i), y = load(b + NL * i);
    store(out + NL * i, field ? fe_mul_cc<Fr>(x, y) : fe_mul_cc<Fq>(x, y));
  }
}

// out[i] = 1 / a[i] (Montgomery; 0 for 0).
void h2a_host_inv(int field, const uint32_t* a, uint32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    Fe x = load(a + NL * i);
    store(out + NL * i, field ? fe_inv<Fr>(x) : fe_inv<Fq>(x));
  }
}

// sum[i] = a[i] + b[i], diff[i] = a[i] - b[i]: through the portable forms
// (cc == 0) or the carry-flag forms the card runs.
void h2a_host_add_sub(int field, int cc, const uint32_t* a, const uint32_t* b,
                      uint32_t* sum, uint32_t* diff, int n) {
  for (int i = 0; i < n; i++) {
    Fe x = load(a + NL * i), y = load(b + NL * i);
    if (field) {
      store(sum + NL * i, cc ? fe_add_cc<Fr>(x, y) : fe_add<Fr>(x, y));
      store(diff + NL * i, cc ? fe_sub_cc<Fr>(x, y) : fe_sub<Fr>(x, y));
    } else {
      store(sum + NL * i, cc ? fe_add_cc<Fq>(x, y) : fe_add<Fq>(x, y));
      store(diff + NL * i, cc ? fe_sub_cc<Fq>(x, y) : fe_sub<Fq>(x, y));
    }
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

// K1's lane on every lane: the two halves as the kernel's two threads run
// them, then the first thread's add.  consts: the 7 x 8 words of ec_win.cuh.
void h2a_host_ec_win(const uint32_t* px, const uint32_t* py,
                     const uint32_t* pz, const uint32_t* scalars,
                     const uint32_t* consts, uint32_t* ox, uint32_t* oy,
                     uint32_t* oz, int n) {
  for (int i = 0; i < n; i++) {
    size_t off = (size_t)NL * i;
    Jac P{load(px + off), load(py + off), load(pz + off)};
    Jac r = ec_glv_finish(ec_glv_half(P, scalars + off, consts, 0),
                          ec_glv_half(P, scalars + off, consts, 1));
    store(ox + off, r.x);
    store(oy + off, r.y);
    store(oz + off, r.z);
  }
}

// K1's scalar split alone: mags (n, 2, 8) the halves' magnitudes, negs
// (n, 2) their signs (1: negative).
void h2a_host_glv_split(const uint32_t* scalars, const uint32_t* consts,
                        uint32_t* mags, int32_t* negs, int n) {
  for (int i = 0; i < n; i++)
    for (int h = 0; h < 2; h++)
      negs[2 * i + h] = glv_half_scalar(mags + (size_t)(2 * i + h) * NL,
                                        scalars + (size_t)i * NL, consts, h);
}

// The segmented sum as the kernel's warps run it: JS_WIDTH partial sums a
// (segment, batch element), then the tree level by level.  Outputs
// (n_seg, batch, 8).
void h2a_host_jac_segment_sum(const uint32_t* px, const uint32_t* py,
                              const uint32_t* pz, long long batch_stride,
                              long long lane_stride, const int32_t* offsets,
                              int n_seg, int batch, uint32_t* ox, uint32_t* oy,
                              uint32_t* oz) {
  JacLanes L{px, py, pz, (size_t)batch_stride, (size_t)lane_stride};
  Jac sh[JS_WIDTH];
  for (int seg = 0; seg < n_seg; seg++) {
    for (int b = 0; b < batch; b++) {
      for (int t = 0; t < JS_WIDTH; t++)
        sh[t] = jac_sum_partial(L, (size_t)b, offsets[seg], offsets[seg + 1], t);
      for (int s = JS_WIDTH / 2; s > 0; s >>= 1)
        for (int t = 0; t < JS_WIDTH; t++) jac_sum_level(sh, t, s);
      Jac r = jac_sum_finish(sh[0]);
      size_t off = ((size_t)seg * batch + b) * NL;
      store(ox + off, r.x);
      store(oy + off, r.y);
      store(oz + off, r.z);
    }
  }
}

// Points are (n, 3, 8) Jacobian, the affine operands (n, 8) x and y.
void h2a_host_jac_add_mixed(const uint32_t* p, const uint32_t* x2,
                            const uint32_t* y2, uint32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    const uint32_t* a = p + 3 * NL * i;
    Jac P{load(a), load(a + NL), load(a + 2 * NL)};
    Jac r = jac_add_mixed(P, load(x2 + NL * i), load(y2 + NL * i));
    uint32_t* o = out + 3 * NL * i;
    store(o, r.x);
    store(o + NL, r.y);
    store(o + 2 * NL, r.z);
  }
}

// K8's lane on every lane.  consts: the 7 x 8 words of ec_win.cuh.
void h2a_host_ec_ladder(const uint32_t* px, const uint32_t* py,
                        const uint32_t* pz, const uint32_t* scalars,
                        const uint32_t* consts, uint32_t* ox, uint32_t* oy,
                        uint32_t* oz, int n, int nbits) {
  for (int i = 0; i < n; i++) {
    size_t off = (size_t)NL * i;
    Jac P{load(px + off), load(py + off), load(pz + off)};
    Jac r = ec_ladder_lane(P, scalars + off, nbits, consts);
    store(ox + off, r.x);
    store(oy + off, r.y);
    store(oz + off, r.z);
  }
}

// K8's rounds alone on given halves: mags (n, 2, 8) their magnitudes, negs
// (n, 2) their signs (1: negative), beta Montgomery Fq.
void h2a_host_ec_ladder_rounds(const uint32_t* px, const uint32_t* py,
                               const uint32_t* pz, const uint32_t* mags,
                               const int32_t* negs, const uint32_t* beta,
                               uint32_t* ox, uint32_t* oy, uint32_t* oz,
                               int n) {
  for (int i = 0; i < n; i++) {
    size_t off = (size_t)NL * i;
    Jac P{load(px + off), load(py + off), load(pz + off)};
    const uint32_t* m = mags + 2 * off;
    Jac r = ec_ladder_rounds(P, m, negs[2 * i], m + NL, negs[2 * i + 1],
                             load(beta));
    store(ox + off, r.x);
    store(oy + off, r.y);
    store(oz + off, r.z);
  }
}

// The counting sort of chunk c (of C contiguous chunks) of one window's row
// of n digits, as thread (w, c) of K7 (is_signed) or K9 runs it: order
// (chunk length) uint16 entries, of which the first `return value` are
// written, and ends (buckets + 1): ends[m] the end of magnitude m's run.
int h2a_host_msm_sort(int is_signed, const uint8_t* dig, int n, int c, int C,
                      uint16_t* order, uint32_t* ends) {
  uint32_t L = ((uint32_t)n + C - 1) / C, lo = (uint32_t)c * L;
  if (lo >= (uint32_t)n) return 0;
  uint32_t len = ((uint32_t)n - lo < L) ? (uint32_t)n - lo : L;
  return (int)(is_signed ? msm_sort_chunk<true>(dig + lo, len, order, ends, 1)
                         : msm_sort_chunk<false>(dig + lo, len, order, ends, 1));
}

// Sort, walk and fold of every thread (w, c) of K7 (is_signed) or K9 over C
// contiguous chunks: partials (n_win, C, 3, 8) from digits (n_win, n) and
// points xs, ys (n, 8), with scratch order (n_win, n) uint16 and bsums
// (n_win, C, buckets, 3, 8).
void h2a_host_msm_partials(int is_signed, const uint32_t* xs, const uint32_t* ys,
                           const uint8_t* digits, int n, int C,
                           uint16_t* order, uint32_t* bsums,
                           uint32_t* partials) {
  int n_win = is_signed ? MsmKind<true>::WINDOWS : MsmKind<false>::WINDOWS;
  int nb = is_signed ? MsmKind<true>::BUCKETS : MsmKind<false>::BUCKETS;
  uint32_t L = ((uint32_t)n + C - 1) / C;
  uint32_t cnt[MsmKind<true>::BUCKETS + 1];
  for (int w = 0; w < n_win; w++) {
    for (int c = 0; c < C; c++) {
      const uint8_t* dig = digits + (size_t)w * n;
      uint16_t* ord = order + (size_t)w * n;
      uint32_t* bs = bsums + ((size_t)w * C + c) * nb * kJacWords;
      Jac r = is_signed ? msm_chunk<true>(xs, ys, dig, n, c, L, ord, bs, cnt, 1)
                        : msm_chunk<false>(xs, ys, dig, n, c, L, ord, bs, cnt, 1);
      msm_store_jac(partials + ((size_t)w * C + c) * kJacWords, r);
    }
  }
}

// Horner across windows over (n_win, 3, 8) window sums; out (3, 8).
void h2a_host_msm_horner(int is_signed, const uint32_t* wsums, uint32_t* out) {
  int n_win = is_signed ? MsmKind<true>::WINDOWS : MsmKind<false>::WINDOWS;
  int bits = is_signed ? MsmKind<true>::BITS : MsmKind<false>::BITS;
  Jac ws[MsmKind<false>::WINDOWS];
  for (int w = 0; w < n_win; w++) {
    const uint32_t* a = wsums + 3 * NL * w;
    ws[w] = Jac{load(a), load(a + NL), load(a + 2 * NL)};
  }
  Jac r = msm_horner(ws, n_win, bits);
  store(out, r.x);
  store(out + NL, r.y);
  store(out + 2 * NL, r.z);
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

// K2 as its blocks run it: `block` lanes a block, their register file
// [register][limb][lane] in a buffer that stands for the shared memory.
void h2a_host_fa_tape_shared(const int32_t* tape, int n_instr,
                             const uint32_t* consts, const uint32_t* in,
                             int n_in, int n_tmp, const int32_t* out_regs,
                             int n_out, uint32_t* out, int lanes, int block) {
  uint32_t* regs = new uint32_t[(size_t)(n_in + n_tmp) * NL * block];
  for (int lane = 0; lane < lanes; lane++) {
    SharedTapeRegs R{consts, regs, block, lane % block};
    fa_tape_lane_shared(tape, n_instr, R, in, n_in, lanes, lane, out_regs,
                        n_out, out);
  }
  delete[] regs;
}

// Stage s of a size-2^k transform over `cols` columns of x (cols, n, 8), in
// place, through ntt_pair and the DIT (dif == 0) or DIF butterfly: one
// stage at a time, the reference that the fused passes below are held to.
void h2a_host_ntt_stage(uint32_t* x, const uint32_t* tw, int cols, int k,
                        int s, int dif) {
  for (int c = 0; c < cols; c++) {
    uint32_t* col = x + ((size_t)c << k) * NL;
    for (uint32_t t = 0; t < (1u << (k - 1)); t++) {
      NttPair p = ntt_pair(k, s, t);
      Fe lo = load(col + (size_t)p.lo * NL), hi = load(col + (size_t)p.hi * NL);
      Fe w = load(tw + (size_t)p.tw * NL);
      if (dif) {
        dif_butterfly(lo, hi, w);
      } else {
        dit_butterfly(lo, hi, w);
      }
      store(col + (size_t)p.lo * NL, lo);
      store(col + (size_t)p.hi * NL, hi);
    }
  }
}

// Stages s0 .. s0 + r - 1 of a size-2^k transform over `cols` columns of x,
// in place, as the blocks of K3's (dif == 0) or K4's pass kernel run them:
// tile by tile through ntt_tile_load, ntt_tile_stages and ntt_tile_store,
// every element times *scale at the store where scale is not null.
// Returns 2^c, the elements of a tile's contiguous runs.
int h2a_host_ntt_pass(uint32_t* x, const uint32_t* tw, const uint32_t* scale,
                      int cols, int k, int s0, int r, int dif) {
  NttPass P{k, s0, r, ntt_pass_chunk_bits(k, s0, r)};
  uint32_t* tile = new uint32_t[(size_t)NL << (P.r + P.c)];
  for (int c = 0; c < cols; c++) {
    uint32_t* col = x + ((size_t)c << k) * NL;
    for (uint32_t block = 0; block < (1u << (k - P.r - P.c)); block++) {
      ntt_tile_load(tile, P, block, col, 0, 1);
      if (dif) {
        ntt_tile_stages<true>(tile, P, block, tw, 0, 1);
      } else {
        ntt_tile_stages<false>(tile, P, block, tw, 0, 1);
      }
      ntt_tile_store(tile, P, block, col, scale, 0, 1);
    }
  }
  delete[] tile;
  return 1 << P.c;
}

// out[block][u] = ntt_tile_index of every slot of every tile of the pass:
// 2^k entries.
void h2a_host_ntt_tile_indices(int k, int s0, int r, uint32_t* out) {
  NttPass P{k, s0, r, ntt_pass_chunk_bits(k, s0, r)};
  uint32_t elems = 1u << (P.r + P.c);
  for (uint32_t block = 0; block < (1u << (k - P.r - P.c)); block++)
    for (uint32_t u = 0; u < elems; u++)
      out[(size_t)block * elems + u] = ntt_tile_index(P, block, u);
}

// out[i] = start * base^idx(i), i < 2^k, as K5's two launches run it: every
// entry of the tables from sq = (start, base, base^2, .. base^(2^(k-1))),
// then every element from the tables.
void h2a_host_pow_series(uint32_t* out, const uint32_t* sq, int k,
                         int bitrev) {
  uint32_t len = pow_series_table_len(k);
  uint32_t* tables = new uint32_t[(size_t)len * NL];
  for (uint32_t e = 0; e < len; e++)
    store(tables + (size_t)e * NL, pow_series_table_entry(sq, k, bitrev, e));
  for (uint32_t i = 0; i < (1u << k); i++)
    store(out + (size_t)i * NL, pow_series_element(tables, k, i));
  delete[] tables;
}

// K6's lane on the listed rows: out[j] = quotient numerator of rows[j].
void h2a_host_quotient_rows(const int32_t* tape, int n_instr,
                            const uint32_t* consts, const int32_t* in_src,
                            const int32_t* in_rot, int n_in,
                            const uint32_t* stack, const uint32_t* x,
                            const uint32_t* uniforms, int n, int out_reg,
                            const int32_t* rows, int n_rows, uint32_t* out) {
  Fe tmp[QT_MAX_TEMPS];
  for (int j = 0; j < n_rows; j++) {
    QuotientRegs R{consts, in_src, in_rot, stack, x, uniforms,
                   n_in, (uint32_t)n, (uint32_t)rows[j], tmp};
    store(out + (size_t)j * NL, quotient_lane(tape, n_instr, R, out_reg));
  }
}

}  // extern "C"
