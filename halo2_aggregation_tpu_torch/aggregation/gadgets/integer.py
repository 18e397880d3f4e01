"""IntegerChip: non-native Fq arithmetic inside an Fr circuit (RNS limbs).

Re-design of halo2wrong's `IntegerChip`/`Rns` surface (SURVEY.md §2b) with
the reference's exact limb layout — 4 x 68-bit limbs per Fq element
(`reference/examples/simple-example.rs:396-397`) — so the aggregation
circuit's public-input format matches the reference (`point_to_scalars`,
simple-example.rs:535-548).

Soundness scheme (standard CRT argument, re-derived):

* every AssignedInteger carries per-limb integer bounds (`max_vals` —
  halo2wrong's `Rns` overflow analysis made explicit in Python ints).
* a product relation  x*y = q*p + res  is enforced by
    (1) the native identity mod r (one main-gate row over the recomposed
        native values), and
    (2) the limb identity mod 2^272, via two 136-bit super-columns with
        signed carries v0, v1.
  This pins the integer identity because |x*y - q*p - res| < 2^511 while
  r * 2^272 > 2^525.
* signed carries c are committed as shifted cells s = c + 2^bits which are
  range-checked to bits+1 bits; the shift constants fold into the row's
  constant term, so nothing negative ever reaches the lookup table.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ...fields import Q as WRONG_P
from ...fields import R
from .main_gate import AssignedValue, Ctx, MainGate, Term
from .range_chip import RangeChip

BIT_LEN_LIMB = 68
NLIMBS_NN = 4
B = 1 << BIT_LEN_LIMB
B2 = 1 << (2 * BIT_LEN_LIMB)
#: strong-invariant limb bounds: value < 2^255
LIMB_BITS_STRONG = [68, 68, 68, 51]
#: quotient limb bounds: q < 2^256
QUOT_BITS = [68, 68, 68, 52]

P_LIMBS = [(WRONG_P >> (BIT_LEN_LIMB * i)) & (B - 1) for i in range(NLIMBS_NN)]


def value_to_limbs(v: int) -> List[int]:
    """Decompose a value < 2^272 into 4 x 68-bit limbs."""
    assert 0 <= v < (1 << 272)
    return [(v >> (BIT_LEN_LIMB * i)) & (B - 1) for i in range(NLIMBS_NN)]


def limbs_to_value(limbs) -> int:
    return sum(int(l) << (BIT_LEN_LIMB * i) for i, l in enumerate(limbs))


def _aux_for_sub(y_max_vals) -> List[int]:
    """Limb vector a with sum(a_i B^i) = k*p (some k) and a_i >= y_max_i,
    so x - y + a has non-negative limbs and unchanged residue mod p."""
    k = 1
    while k < 64:
        a = value_to_limbs(k * WRONG_P) if k * WRONG_P < (1 << 272) else None
        if a is None:
            break
        # borrow downward: raise low limbs by B, paying from the next limb
        ok = True
        for i in range(NLIMBS_NN - 1):
            while a[i] < y_max_vals[i]:
                a[i] += B
                a[i + 1] -= 1
            if a[i + 1] < 0:
                ok = False
                break
        if ok and a[NLIMBS_NN - 1] >= y_max_vals[NLIMBS_NN - 1]:
            return a
        k *= 2
    raise AssertionError("no aux found — reduce the subtrahend first")


@dataclass
class AssignedInteger:
    """4 limb cells + a native recomposition cell + static per-limb bounds
    (exclusive upper bounds on the limb's integer value)."""

    limbs: List[AssignedValue]
    native: AssignedValue
    max_vals: List[int]

    def value(self) -> Optional[int]:
        if any(l.value is None for l in self.limbs):
            return None
        return limbs_to_value([l.value for l in self.limbs])

    def max_value(self) -> int:
        return sum((m - 1) << (BIT_LEN_LIMB * i) for i, m in enumerate(self.max_vals)) + 1

    def is_strong(self) -> bool:
        return all(m <= (1 << b) for m, b in zip(self.max_vals, LIMB_BITS_STRONG))


class IntegerChip:
    def __init__(self, main_gate: MainGate, range_chip: RangeChip):
        self.mg = main_gate
        self.rc = range_chip

    # -- plumbing -----------------------------------------------------------
    def _native_of_limbs(self, ctx, limb_cells) -> AssignedValue:
        val = None
        if all(c.value is not None for c in limb_cells):
            val = limbs_to_value([c.value for c in limb_cells]) % R
        terms = [
            Term.from_assigned(c, pow(B, i, R)) for i, c in enumerate(limb_cells)
        ]
        terms.append(Term.unassigned(val, R - 1))
        cells = self.mg.combine(ctx, terms)
        return cells[4]

    def combine_chain(self, ctx, terms: List[Term], constant: int = 0):
        """Assert sum(coeff_i * value_i) + constant = 0 across as many
        5-wire rows as needed (running partial sums in wire e)."""
        mg = self.mg
        pending = list(terms)
        acc = None  # AssignedValue partial
        first = True
        while True:
            take = 4 if acc is None else 3
            row_terms = pending[:take]
            pending = pending[take:]
            if acc is not None:
                row_terms = row_terms + [Term.from_assigned(acc, 1)]
            if not pending:
                mg.combine(ctx, row_terms, constant=constant if first else constant)
                return
            # partial = sum of this row's terms (+ constant on first row)
            pv = None
            if all(t.value is not None or t.coeff == 0 for t in row_terms):
                pv = (
                    sum((t.value or 0) * t.coeff for t in row_terms)
                    + (constant if first else 0)
                ) % R
            row = row_terms + [Term.unassigned(pv, R - 1)]
            cells = mg.combine(
                ctx, row, constant=constant if first else 0
            )
            acc = cells[len(row_terms)]
            constant = 0
            first = False

    def _signed_carry_cell(self, ctx, c_value: Optional[int], bits: int):
        """Commit a signed carry |c| < 2^bits as the shifted, range-checked
        cell s = c + 2^bits; returns (s_cell, shift)."""
        shift = 1 << bits
        sv = None if c_value is None else c_value + shift
        if sv is not None:
            assert 0 <= sv < (1 << (bits + 1)), f"carry {c_value} exceeds 2^{bits}"
        s = self.rc.range_check(ctx, sv, bits + 1)
        return s, shift

    # -- assignment ---------------------------------------------------------
    def assign_integer(self, ctx: Ctx, value: Optional[int]) -> AssignedInteger:
        limbs_v = None if value is None else value_to_limbs(value % WRONG_P)
        cells = []
        for i in range(NLIMBS_NN):
            lv = None if limbs_v is None else limbs_v[i]
            cells.append(self.rc.range_check(ctx, lv, LIMB_BITS_STRONG[i]))
        native = self._native_of_limbs(ctx, cells)
        return AssignedInteger(cells, native, [1 << b for b in LIMB_BITS_STRONG])

    def assign_constant(self, ctx: Ctx, value: int) -> AssignedInteger:
        limbs_v = value_to_limbs(value % WRONG_P)
        cells = [self.mg.assign_constant(ctx, lv) for lv in limbs_v]
        native = self._native_of_limbs(ctx, cells)
        return AssignedInteger(cells, native, [lv + 1 for lv in limbs_v])

    def assign_from_cells(self, ctx: Ctx, limb_cells) -> AssignedInteger:
        out = [
            self.rc.range_check_assigned(ctx, c, b)
            for c, b in zip(limb_cells, LIMB_BITS_STRONG)
        ]
        native = self._native_of_limbs(ctx, out)
        return AssignedInteger(out, native, [1 << b for b in LIMB_BITS_STRONG])

    # -- linear ops ----------------------------------------------------------
    def add(self, ctx, x: AssignedInteger, y: AssignedInteger) -> AssignedInteger:
        cells, maxes = [], []
        for i in range(NLIMBS_NN):
            cells.append(self.mg.add(ctx, x.limbs[i], y.limbs[i]))
            m = x.max_vals[i] + y.max_vals[i]
            assert m < 1 << 100
            maxes.append(m)
        native = self.mg.add(ctx, x.native, y.native)
        return AssignedInteger(cells, native, maxes)

    def sub(self, ctx, x: AssignedInteger, y: AssignedInteger) -> AssignedInteger:
        aux = _aux_for_sub(y.max_vals)
        cells, maxes = [], []
        for i in range(NLIMBS_NN):
            v = None
            if x.limbs[i].value is not None and y.limbs[i].value is not None:
                v = x.limbs[i].value - y.limbs[i].value + aux[i]
                assert v >= 0
            (_, _, c, *_r) = self.mg.combine(
                ctx,
                [
                    Term.from_assigned(x.limbs[i], 1),
                    Term.from_assigned(y.limbs[i], R - 1),
                    Term.unassigned(None if v is None else v % R, R - 1),
                ],
                constant=aux[i] % R,
            )
            cells.append(c)
            maxes.append(x.max_vals[i] + aux[i])
        aux_nat = limbs_to_value(aux) % R
        nv = None
        if x.native.value is not None and y.native.value is not None:
            nv = (x.native.value - y.native.value + aux_nat) % R
        (_, _, nc, *_r) = self.mg.combine(
            ctx,
            [
                Term.from_assigned(x.native, 1),
                Term.from_assigned(y.native, R - 1),
                Term.unassigned(nv, R - 1),
            ],
            constant=aux_nat,
        )
        return AssignedInteger(cells, nc, maxes)

    def neg(self, ctx, x: AssignedInteger) -> AssignedInteger:
        return self.sub(ctx, self.assign_constant(ctx, 0), x)

    # -- reduction -----------------------------------------------------------
    def reduce(self, ctx, x: AssignedInteger) -> AssignedInteger:
        """x -> z, z = x mod p (witnessed), x = u*p + z over the integers:
        4 limb-column rows with shifted signed carries."""
        V = x.max_value()
        u_bits = max((V // WRONG_P).bit_length() + 1, 2)
        assert u_bits <= 68, "value too large to reduce in one step"
        xv = x.value()
        if xv is None:
            u_v, z_limbs = None, [None] * 4
        else:
            z_v = xv % WRONG_P
            u_v = (xv - z_v) // WRONG_P
            z_limbs = value_to_limbs(z_v)
        u = self.rc.range_check(ctx, u_v, u_bits)
        z_cells = [
            self.rc.range_check(ctx, z_limbs[i], LIMB_BITS_STRONG[i])
            for i in range(NLIMBS_NN)
        ]
        # per-limb: x_i - u*p_i - z_i + c_{i-1} - B*c_i = 0
        carry_cell, carry_val, carry_shift = None, 0, 0
        carry_bound = 1
        for i in range(NLIMBS_NN):
            is_last = i == NLIMBS_NN - 1
            if xv is not None:
                t = x.limbs[i].value - u_v * P_LIMBS[i] - z_limbs[i] + carry_val
                if is_last:
                    assert t == 0
                    c_v = None
                else:
                    assert t % B == 0
                    c_v = t // B
            else:
                c_v = None
            terms = [
                Term.from_assigned(x.limbs[i], 1),
                Term.from_assigned(u, (-P_LIMBS[i]) % R),
                Term.from_assigned(z_cells[i], R - 1),
            ]
            const = 0
            if carry_cell is not None:
                terms.append(Term.from_assigned(carry_cell, 1))
                const -= carry_shift
            if not is_last:
                # carry bound: |c| <= (max_x_i + u_max*p_i + B + prev)/B
                bound = (
                    x.max_vals[i] + (1 << u_bits) * P_LIMBS[i] + carry_bound
                ) // B + 2
                cb = max(bound.bit_length() + 1, 2)
                carry_cell, carry_shift = self._signed_carry_cell(ctx, c_v, cb)
                carry_val = c_v if c_v is not None else None
                carry_bound = 1 << cb
                terms.append(Term.from_assigned(carry_cell, (-B) % R))
                const += B * carry_shift
            self.combine_chain(ctx, terms, constant=const % R)
        return AssignedInteger(
            z_cells,
            self._native_of_limbs(ctx, z_cells),
            [1 << b for b in LIMB_BITS_STRONG],
        )

    def _ensure_strong(self, ctx, x: AssignedInteger) -> AssignedInteger:
        return x if x.is_strong() else self.reduce(ctx, x)

    # -- multiplication -------------------------------------------------------
    def mul(self, ctx, x: AssignedInteger, y: AssignedInteger) -> AssignedInteger:
        """res = x*y mod p (fresh witness) via the CRT scheme."""
        return self._mul_core(ctx, x, y, None)

    def assert_mul_equals(
        self, ctx, x: AssignedInteger, y: AssignedInteger, c: AssignedInteger
    ):
        """Constrain x*y = c (mod p) against an existing assigned integer c
        — the workhorse for EC slope constraints (one mul-sized constraint,
        no canonical reductions)."""
        self._mul_core(ctx, x, y, c)

    def _mul_core(self, ctx, x, y, res_in) -> AssignedInteger:
        """Enforce x*y + k*p = q*p + res over the integers.  The constant
        offset k = ceil(res_max/p) keeps the quotient witness q
        non-negative even when res > x*y (possible when res is a
        caller-supplied integer rather than a fresh reduced witness)."""
        x = self._ensure_strong(ctx, x)
        y = self._ensure_strong(ctx, y)
        xv, yv = x.value(), y.value()

        res_max = WRONG_P if res_in is None else res_in.max_value()
        assert res_max < 1 << 268, "res bound too large for the kp offset"
        k_off = (res_max + WRONG_P - 1) // WRONG_P
        kp = k_off * WRONG_P
        kp_limbs = value_to_limbs(kp)

        res_known = res_in is None or res_in.value() is not None
        if xv is None or yv is None or not res_known:
            q_limbs = res_limbs = [None] * 4
        else:
            prod = xv * yv
            if res_in is None:
                res_v = prod % WRONG_P
                res_limbs = value_to_limbs(res_v)
            else:
                res_v = res_in.value()
                assert (prod - res_v) % WRONG_P == 0, "mul relation violated"
                res_limbs = [l.value for l in res_in.limbs]
            q_v = (prod + kp - res_v) // WRONG_P
            assert 0 <= q_v < 1 << 256, f"quotient out of range ({q_v.bit_length()} bits)"
            q_limbs = value_to_limbs(q_v)
        q_cells = [
            self.rc.range_check(ctx, q_limbs[i], QUOT_BITS[i]) for i in range(4)
        ]
        if res_in is None:
            res_cells = [
                self.rc.range_check(ctx, res_limbs[i], LIMB_BITS_STRONG[i])
                for i in range(4)
            ]
            res_native = self._native_of_limbs(ctx, res_cells)
        else:
            res_cells = res_in.limbs
            res_native = res_in.native
        q_native = self._native_of_limbs(ctx, q_cells)

        # (1) native identity: x_nat*y_nat + kp - q_nat*p - res_nat = 0
        self.mg.combine(
            ctx,
            [
                Term.from_assigned(x.native, 0),
                Term.from_assigned(y.native, 0),
                Term.from_assigned(q_native, (-WRONG_P) % R),
                Term.from_assigned(res_native, R - 1),
            ],
            mul_ab=1,
            constant=kp % R,
        )

        # (2) limb identity mod 2^272 via two 136-bit super-columns
        m = {}
        for i in range(4):
            for j in range(4 - i):
                m[(i, j)] = self.mg.mul(ctx, x.limbs[i], y.limbs[j])

        def tval(pairs, qws, rws, const):
            if q_limbs[0] is None:
                return None
            s = const
            for (i, j), w in pairs:
                s += m[(i, j)].value * w
            for qi, w in qws:
                s -= q_limbs[qi] * w
            for ri, w in rws:
                s -= res_limbs[ri] * w
            return s

        # super-column 0: t0 + B*t1 + (kp0 + B*kp1) = v0 * 2^136
        c0 = kp_limbs[0] + B * kp_limbs[1]
        u0 = tval(
            [((0, 0), 1), ((0, 1), B), ((1, 0), B)],
            [(0, P_LIMBS[0] + B * P_LIMBS[1]), (1, B * P_LIMBS[0])],
            [(0, 1), (1, B)],
            c0,
        )
        v0_v = None if u0 is None else u0 // B2
        if u0 is not None:
            assert u0 % B2 == 0
        v0_cell, v0_shift = self._signed_carry_cell(ctx, v0_v, 72)
        terms0 = (
            [Term.from_assigned(m[(0, 0)], 1)]
            + [Term.from_assigned(m[(0, 1)], B % R), Term.from_assigned(m[(1, 0)], B % R)]
            + [
                Term.from_assigned(q_cells[0], (-(P_LIMBS[0] + B * P_LIMBS[1])) % R),
                Term.from_assigned(q_cells[1], (-(B * P_LIMBS[0])) % R),
            ]
            + [
                Term.from_assigned(res_cells[0], R - 1),
                Term.from_assigned(res_cells[1], (-B) % R),
            ]
            + [Term.from_assigned(v0_cell, (-B2) % R)]
        )
        self.combine_chain(ctx, terms0, constant=(B2 * v0_shift + c0) % R)

        # super-column 1: v0 + t2 + B*t3 + (kp2 + B*kp3) = v1 * 2^136
        c1 = kp_limbs[2] + B * kp_limbs[3]
        u1 = tval(
            [
                ((0, 2), 1),
                ((1, 1), 1),
                ((2, 0), 1),
                ((0, 3), B),
                ((1, 2), B),
                ((2, 1), B),
                ((3, 0), B),
            ],
            [
                (0, P_LIMBS[2] + B * P_LIMBS[3]),
                (1, P_LIMBS[1] + B * P_LIMBS[2]),
                (2, P_LIMBS[0] + B * P_LIMBS[1]),
                (3, B * P_LIMBS[0]),
            ],
            [(2, 1), (3, B)],
            c1,
        )
        if u1 is not None:
            u1 += v0_v
            assert u1 % B2 == 0
        v1_v = None if u1 is None else u1 // B2
        v1_cell, v1_shift = self._signed_carry_cell(ctx, v1_v, 76)
        terms1 = (
            [
                Term.from_assigned(m[(0, 2)], 1),
                Term.from_assigned(m[(1, 1)], 1),
                Term.from_assigned(m[(2, 0)], 1),
                Term.from_assigned(m[(0, 3)], B % R),
                Term.from_assigned(m[(1, 2)], B % R),
                Term.from_assigned(m[(2, 1)], B % R),
                Term.from_assigned(m[(3, 0)], B % R),
            ]
            + [
                Term.from_assigned(q_cells[0], (-(P_LIMBS[2] + B * P_LIMBS[3])) % R),
                Term.from_assigned(q_cells[1], (-(P_LIMBS[1] + B * P_LIMBS[2])) % R),
                Term.from_assigned(q_cells[2], (-(P_LIMBS[0] + B * P_LIMBS[1])) % R),
                Term.from_assigned(q_cells[3], (-(B * P_LIMBS[0])) % R),
            ]
            + [
                Term.from_assigned(res_cells[2], R - 1),
                Term.from_assigned(res_cells[3], (-B) % R),
            ]
            + [
                Term.from_assigned(v0_cell, 1),
                Term.from_assigned(v1_cell, (-B2) % R),
            ]
        )
        self.combine_chain(
            ctx, terms1, constant=(B2 * v1_shift - v0_shift + c1) % R
        )

        if res_in is None:
            return AssignedInteger(
                res_cells, res_native, [1 << b for b in LIMB_BITS_STRONG]
            )
        return res_in

    def square(self, ctx, x):
        return self.mul(ctx, x, x)

    # -- division / inversion -------------------------------------------------
    def div(self, ctx, x: AssignedInteger, y: AssignedInteger) -> AssignedInteger:
        """z = x/y mod p: witness z, then constrain mul(z, y) == x mod p,
        plus y invertibility via witness w with y*w = 1."""
        x = self._ensure_strong(ctx, x)
        y = self._ensure_strong(ctx, y)
        xv, yv = x.value(), y.value()
        if xv is None or yv is None:
            z_v = w_v = None
        else:
            yinv = pow(yv % WRONG_P, -1, WRONG_P)
            z_v = xv * yinv % WRONG_P
            w_v = yinv
        w = self.assign_integer(ctx, w_v)
        yw = self.mul(ctx, y, w)
        self.assert_equal_to_constant(ctx, yw, 1)
        z = self.assign_integer(ctx, z_v)
        zy = self.mul(ctx, z, y)
        self.assert_equal(ctx, zy, x)
        return z

    def invert(self, ctx, y: AssignedInteger) -> AssignedInteger:
        return self.div(ctx, self.assign_constant(ctx, 1), y)

    # -- equality -------------------------------------------------------------
    def reduce_strict(self, ctx, x: AssignedInteger) -> AssignedInteger:
        """Reduce to the canonical representative z < p: reduce(), then
        assert z <= p-1 via a witnessed borrow-chain subtraction
        d = (p-1) - z with per-limb borrow bits:
            z_i + d_i - pm1_i - B*b_i + b_{i-1} = 0,   b_3 = 0,
        each d_i range-checked < B, so d >= 0 and z <= p-1 exactly."""
        z = self.reduce(ctx, x)
        zv = z.value()
        pm1 = value_to_limbs(WRONG_P - 1)
        if zv is None:
            d_limbs = [None] * 4
            borrows = [None] * 3
        else:
            assert zv < WRONG_P
            d_limbs, borrows = [], []
            borrow = 0
            for i in range(NLIMBS_NN):
                d = pm1[i] - z.limbs[i].value - borrow
                borrow = 0
                if d < 0:
                    d += B
                    borrow = 1
                d_limbs.append(d)
                if i < 3:
                    borrows.append(borrow)
            assert borrow == 0
        b_cells = [self.mg.assign_bit(ctx, b) for b in borrows]
        for i in range(NLIMBS_NN):
            d_cell = self.rc.range_check(ctx, d_limbs[i], BIT_LEN_LIMB)
            terms = [
                Term.from_assigned(z.limbs[i], 1),
                Term.from_assigned(d_cell, 1),
            ]
            if i < 3:
                terms.append(Term.from_assigned(b_cells[i], (-B) % R))
            if i > 0:
                terms.append(Term.from_assigned(b_cells[i - 1], 1))
            self.mg.combine(ctx, terms, constant=(-pm1[i]) % R)
        return z

    def assert_equal(self, ctx, x: AssignedInteger, y: AssignedInteger):
        """Equality mod p via canonical forms + limb copy equality."""
        xs = self.reduce_strict(ctx, x)
        ys = self.reduce_strict(ctx, y)
        for i in range(NLIMBS_NN):
            self.mg.assert_equal(ctx, xs.limbs[i], ys.limbs[i])

    def assert_equal_to_constant(self, ctx, x: AssignedInteger, c: int):
        xs = self.reduce_strict(ctx, x)
        limbs = value_to_limbs(c % WRONG_P)
        for i in range(NLIMBS_NN):
            self.mg.assert_equal_to_constant(ctx, xs.limbs[i], limbs[i])
