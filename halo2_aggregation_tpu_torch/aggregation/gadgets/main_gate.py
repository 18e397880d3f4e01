"""MainGate: the universal 5-wire arithmetic gate.

Our re-design of halo2wrong's `MainGate` (the reference's workhorse, used
at every arithmetic step — SURVEY.md §2b): five advice wires a..e and one
constraint

    qa*a + qb*b + qc*c + qd*d + qe*e + qab*(a*b) + qcd*(c*d) + qconst = 0

Every helper (add/sub/mul/div/combine/assign) is one row.  Witness values
are Python ints (None in keygen mode), mirroring the reference's
`transcript: None` shape-only duality (SURVEY.md §1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

from ...fields import R
from ...plonk.circuit import Assignment, Column, ConstraintSystem, Rotation


class AssignedValue(NamedTuple):
    """A committed cell: (column, row) plus its witness value (None during
    keygen)."""

    column: Column
    row: int
    value: Optional[int]


class Term(NamedTuple):
    """One wire slot of a combine row."""

    assigned: Optional[AssignedValue]  # copy-constrain to this cell
    value: Optional[int]  # witness value to place
    coeff: int  # selector coefficient

    @staticmethod
    def from_assigned(av: AssignedValue, coeff: int) -> "Term":
        return Term(av, av.value, coeff % R)

    @staticmethod
    def unassigned(value: Optional[int], coeff: int) -> "Term":
        return Term(None, None if value is None else value % R, coeff % R)

    @staticmethod
    def zero() -> "Term":
        return Term(None, 0, 0)


@dataclass
class MainGateConfig:
    wires: tuple  # 5 advice columns a..e
    q: tuple  # 5 fixed columns qa..qe
    qab: Column
    qcd: Column
    qconst: Column


class Ctx:
    """Row cursor over an Assignment — the analog of the reference's
    `(region, offset)` pair threaded through every chip call."""

    def __init__(self, assignment: Assignment, offset: int = 0):
        self.assignment = assignment
        self.offset = offset

    def next_row(self) -> int:
        r = self.offset
        self.offset += 1
        return r


class MainGate:
    def __init__(self, config: MainGateConfig):
        self.config = config

    @staticmethod
    def configure(cs: ConstraintSystem) -> MainGateConfig:
        wires = tuple(cs.advice_column() for _ in range(5))
        for w in wires:
            cs.enable_equality(w)
        q = tuple(cs.fixed_column() for _ in range(5))
        qab = cs.fixed_column()
        qcd = cs.fixed_column()
        qconst = cs.fixed_column()

        def gate(m: ConstraintSystem):
            a, b, c, d, e = (m.query_advice(w, Rotation.cur()) for w in wires)
            qa, qb, qc, qd, qe = (m.query_fixed(x, Rotation.cur()) for x in q)
            f_ab = m.query_fixed(qab, Rotation.cur())
            f_cd = m.query_fixed(qcd, Rotation.cur())
            f_const = m.query_fixed(qconst, Rotation.cur())
            return [
                qa * a
                + qb * b
                + qc * c
                + qd * d
                + qe * e
                + f_ab * (a * b)
                + f_cd * (c * d)
                + f_const
            ]

        cs.create_gate("main_gate", gate)
        return MainGateConfig(wires, q, qab, qcd, qconst)

    # ------------------------------------------------------------------
    def combine(
        self,
        ctx: Ctx,
        terms,
        constant: int = 0,
        mul_ab: int = 0,
        mul_cd: int = 0,
    ):
        """Emit one row: sum(coeff_i * wire_i) + mul_ab*a*b + mul_cd*c*d +
        constant = 0.  Returns the 5 assigned wire cells."""
        cfg = self.config
        asg = ctx.assignment
        row = ctx.next_row()
        terms = list(terms) + [Term.zero()] * (5 - len(terms))
        assert len(terms) == 5
        out = []
        for wi, t in enumerate(terms):
            val = t.value
            asg.assign_advice(cfg.wires[wi], row, val)
            if t.assigned is not None:
                asg.copy(cfg.wires[wi], row, t.assigned.column, t.assigned.row)
            asg.assign_fixed(cfg.q[wi], row, t.coeff)
            out.append(AssignedValue(cfg.wires[wi], row, val))
        asg.assign_fixed(cfg.qab, row, mul_ab % R)
        asg.assign_fixed(cfg.qcd, row, mul_cd % R)
        asg.assign_fixed(cfg.qconst, row, constant % R)
        return out

    # -- one-row helpers ------------------------------------------------
    def assign_value(self, ctx: Ctx, value: Optional[int]) -> AssignedValue:
        (a, *_rest) = self.combine(ctx, [Term.unassigned(value, 0)])
        return a

    def assign_constant(self, ctx: Ctx, c: int) -> AssignedValue:
        c = c % R
        (a, *_r) = self.combine(ctx, [Term.unassigned(c, 1)], constant=-c)
        return a

    def add(self, ctx, x: AssignedValue, y: AssignedValue) -> AssignedValue:
        z = None if x.value is None or y.value is None else (x.value + y.value) % R
        (_, _, c, *_r) = self.combine(
            ctx,
            [
                Term.from_assigned(x, 1),
                Term.from_assigned(y, 1),
                Term.unassigned(z, R - 1),
            ],
        )
        return c

    def sub(self, ctx, x: AssignedValue, y: AssignedValue) -> AssignedValue:
        z = None if x.value is None or y.value is None else (x.value - y.value) % R
        (_, _, c, *_r) = self.combine(
            ctx,
            [
                Term.from_assigned(x, 1),
                Term.from_assigned(y, R - 1),
                Term.unassigned(z, R - 1),
            ],
        )
        return c

    def add_constant(self, ctx, x: AssignedValue, c: int) -> AssignedValue:
        z = None if x.value is None else (x.value + c) % R
        (_, _, cc, *_r) = self.combine(
            ctx,
            [Term.from_assigned(x, 1), Term.zero(), Term.unassigned(z, R - 1)],
            constant=c,
        )
        return cc

    def mul(self, ctx, x: AssignedValue, y: AssignedValue) -> AssignedValue:
        z = None if x.value is None or y.value is None else x.value * y.value % R
        (_, _, c, *_r) = self.combine(
            ctx,
            [
                Term.from_assigned(x, 0),
                Term.from_assigned(y, 0),
                Term.unassigned(z, R - 1),
            ],
            mul_ab=1,
        )
        return c

    def mul_by_constant(self, ctx, x: AssignedValue, c: int) -> AssignedValue:
        z = None if x.value is None else x.value * c % R
        (_, _, cc, *_r) = self.combine(
            ctx,
            [Term.from_assigned(x, c), Term.zero(), Term.unassigned(z, R - 1)],
        )
        return cc

    def neg(self, ctx, x: AssignedValue) -> AssignedValue:
        return self.mul_by_constant(ctx, x, R - 1)

    def div(self, ctx, x: AssignedValue, y: AssignedValue) -> AssignedValue:
        """z = x / y, constrained by z*y = x plus y != 0 (witnessed
        inverse) — sound where the reference's `div` is."""
        if x.value is None or y.value is None:
            z = None
            yinv = None
        else:
            yinv = pow(y.value, -1, R)
            z = x.value * yinv % R
        # row 1: y * yinv = 1  (forces y != 0)
        self.combine(
            ctx,
            [Term.from_assigned(y, 0), Term.unassigned(yinv, 0)],
            constant=R - 1,
            mul_ab=1,
        )
        # row 2: z * y - x = 0
        (a, _, c, *_r) = self.combine(
            ctx,
            [
                Term.unassigned(z, 0),
                Term.from_assigned(y, 0),
                Term.from_assigned(x, R - 1),
            ],
            mul_ab=1,
        )
        return a

    def assign_bit(self, ctx, value: Optional[int]) -> AssignedValue:
        """b*(b-1) = 0: place b in a and b, qab=1, qa=-1, copy a==b."""
        b = None if value is None else value % R
        (a, bb, *_r) = self.combine(
            ctx,
            [Term.unassigned(b, R - 1), Term.unassigned(b, 0)],
            mul_ab=1,
        )
        ctx.assignment.copy(a.column, a.row, bb.column, bb.row)
        return a

    def assert_equal(self, ctx, x: AssignedValue, y: AssignedValue):
        ctx.assignment.copy(x.column, x.row, y.column, y.row)

    def assert_equal_to_constant(self, ctx, x: AssignedValue, c: int):
        self.combine(ctx, [Term.from_assigned(x, 1)], constant=-c)

    def expose_public(self, ctx, x: AssignedValue, instance_col: Column, row: int):
        ctx.assignment.copy(x.column, x.row, instance_col, row)
