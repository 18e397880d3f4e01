"""RangeChip: limb range checks via one shared 2^17 lookup table.

Re-design of halo2wrong's `RangeChip` (SURVEY.md §2b): a value of
`bits` bits is decomposed into 17-bit chunks placed on the main-gate wires
a..d of dedicated range rows; a fixed `q_range` column gates four lookup
arguments (one per wire) into the shared table, and the same main-gate row
constrains the weighted recomposition.  Partial chunks of s < 17 bits are
checked with the scaling trick: BOTH the raw chunk `cv` and the scaled
chunk `sv = cv * 2^(17-s)` are looked up, and a main-gate row pins
`sv = cv * 2^(17-s)`.  Since cv < 2^17 the product never wraps mod r, so
sv < 2^17 forces cv < 2^s — one table serves every width (halo2wrong's
`overflow_lengths` tables collapse into this).

Soundness note (round-2 fix): looking up only sv and recomposing with
coefficient 2^(17i)/2^(17-s) was UNDERCONSTRAINED — sv was never forced to
be a multiple of 2^(17-s), so cv = sv * scale^{-1} mod r could be any field
element.  The raw chunk is now a first-class looked-up cell; see
tests/test_gadgets.py::test_range_check_malicious_partial_chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ...fields import R
from ...plonk.circuit import (
    Assignment,
    Column,
    ConstraintSystem,
    Rotation,
    TableColumn,
)
from .main_gate import AssignedValue, Ctx, MainGate, Term

LOOKUP_BITS = 17  # table size 2^17 -> outer circuits need k >= 18


@dataclass
class RangeConfig:
    q_range: Column  # fixed gate for the 4 wire lookups
    table: TableColumn


class RangeChip:
    def __init__(self, main_gate: MainGate, config: RangeConfig):
        self.main_gate = main_gate
        self.config = config

    @staticmethod
    def configure(cs: ConstraintSystem, main_gate_cfg) -> RangeConfig:
        q_range = cs.fixed_column()
        table = cs.lookup_table_column()
        for wire in main_gate_cfg.wires[:4]:
            cs.lookup(
                lambda m, w=wire: [
                    (
                        m.query_fixed(q_range, Rotation.cur())
                        * m.query_advice(w, Rotation.cur()),
                        table,
                    )
                ]
            )
        return RangeConfig(q_range, table)

    def load_table(self, assignment: Assignment):
        t = assignment.table()
        for i in range(1 << LOOKUP_BITS):
            t.assign_cell(self.config.table, i, i)

    def range_check(
        self, ctx: Ctx, value: Optional[int], bits: int
    ) -> AssignedValue:
        """Assign `value` and constrain value < 2^bits.  Chunks of 17 bits,
        up to 4 per row; the scaling trick handles the partial top chunk.
        Returns the assigned (recomposed) value cell."""
        mg = self.main_gate
        nfull, rem = divmod(bits, LOOKUP_BITS)
        nchunks = nfull + (1 if rem else 0)
        if nchunks > 4:
            # recurse: value = lo (4 chunks) + hi * 2^68, one combine row
            lo_bits = 4 * LOOKUP_BITS
            lo_v = None if value is None else value & ((1 << lo_bits) - 1)
            hi_v = None if value is None else value >> lo_bits
            lo = self.range_check(ctx, lo_v, lo_bits)
            hi = self.range_check(ctx, hi_v, bits - lo_bits)
            cells = mg.combine(
                ctx,
                [
                    Term.from_assigned(lo, 1),
                    Term.from_assigned(hi, 1 << lo_bits),
                    Term.unassigned(value, R - 1),
                ],
            )
            return cells[2]
        chunks = None
        if value is not None:
            assert 0 <= value < (1 << bits), f"{value} exceeds {bits} bits"
            chunks = [
                (value >> (LOOKUP_BITS * i)) & ((1 << LOOKUP_BITS) - 1)
                for i in range(nchunks)
            ]
        terms = []
        for i in range(nchunks):
            cv = None if chunks is None else chunks[i]
            if i == nchunks - 1 and rem:
                # Partial top chunk of `rem` bits: emit one extra looked-up
                # row pinning sv = cv * 2^(17-rem).  sv on wire a and cv on
                # wire b are both looked up (q_range on), so sv < 2^17 and
                # cv < 2^17; then cv*scale < 2^34 < r never wraps, and
                # sv < 2^17 forces cv < 2^rem.  The raw chunk cv is then
                # copy-used in the recomposition row at its plain weight.
                scale = 1 << (LOOKUP_BITS - rem)
                sv = None if cv is None else cv * scale
                srow = mg.combine(
                    ctx,
                    [Term.unassigned(sv, 1), Term.unassigned(cv, R - scale)],
                )
                ctx.assignment.assign_fixed(self.config.q_range, srow[0].row, 1)
                terms.append(Term.from_assigned(srow[1], 1 << (LOOKUP_BITS * i)))
            else:
                terms.append(Term.unassigned(cv, 1 << (LOOKUP_BITS * i)))
        while len(terms) < 4:
            terms.append(Term.zero())
        terms.append(Term.unassigned(value, R - 1))  # wire e: the value
        cells = mg.combine(ctx, terms)
        # turn on the wire lookups for this row
        ctx.assignment.assign_fixed(self.config.q_range, cells[0].row, 1)
        return cells[4]

    def range_check_assigned(self, ctx: Ctx, av: AssignedValue, bits: int):
        out = self.range_check(ctx, av.value, bits)
        self.main_gate.assert_equal(ctx, out, av)
        return out
