"""Constrained Poseidon sponge gadget — in-circuit Fiat-Shamir.

This is the soundness upgrade OVER the reference: its transcript chip
witnesses challenges unconstrained (`reference/src/transcript.rs:62-65`,
"USE THIS CHIP WITH CAUTION"), so its aggregation circuit proves "the
verifier algebra accepts under these witnessed challenges".  With this
gadget the challenges are COMPUTED by main-gate rows from the absorbed
commitment cells — the circuit statement becomes "the inner proof
verifies", full stop.

Must match oracle/poseidon.py bit-for-bit (pinned by tests/test_poseidon.py).
Row costs per permutation: 3 (round-0 constants) + 8 full rounds x (9
S-box + 3 MDS) + 57 partial rounds x (3 S-box + 3 MDS) = 441 rows; the
next round's constants fold into each MDS row's qconst.  A full verifier
transcript is ~100 permutations ~= 45K rows — noise against the 4.5M-row
verifier (Blake2b in-circuit would be millions of rows; that asymmetry is
why Poseidon exists).
"""

from __future__ import annotations

from typing import List, Optional

from ...fields import R
from ...oracle.poseidon import (
    R_F,
    R_P,
    RATE,
    T,
    _h2f,
    mds_matrix,
    round_constants,
)
from .main_gate import AssignedValue, Ctx, MainGate, Term


class PoseidonGadget:
    def __init__(self, mg: MainGate):
        self.mg = mg
        self.rc = round_constants()
        self.mds = mds_matrix()

    def _sbox(self, ctx: Ctx, x: AssignedValue) -> AssignedValue:
        mg = self.mg
        x2 = mg.mul(ctx, x, x)
        x4 = mg.mul(ctx, x2, x2)
        return mg.mul(ctx, x4, x)

    def _mds_row(self, ctx: Ctx, u: List[AssignedValue], i: int, rc_next: int) -> AssignedValue:
        """out_i = sum_j M[i][j] * u_j + rc_next, one combine row."""
        out_v: Optional[int] = 0
        for j in range(T):
            if u[j].value is None:
                out_v = None
                break
            out_v = (out_v + self.mds[i][j] * u[j].value) % R
        if out_v is not None:
            out_v = (out_v + rc_next) % R
        terms = [Term.from_assigned(u[j], self.mds[i][j]) for j in range(T)]
        terms.append(Term.unassigned(out_v, R - 1))
        (_, _, _, d, *_rest) = self.mg.combine(ctx, terms, constant=rc_next)
        return d

    def permute(self, ctx: Ctx, state: List[AssignedValue]) -> List[AssignedValue]:
        """One Poseidon permutation over assigned state cells (values track
        oracle.permute exactly; None-safe for keygen shape)."""
        mg = self.mg
        assert len(state) == T
        half = R_F // 2
        # round-0 constants
        s = [
            mg.add_constant(ctx, state[j], self.rc[j]) for j in range(T)
        ]
        r = 0
        total = R_F + R_P
        for phase, rounds in ((0, half), (1, R_P), (2, half)):
            for _ in range(rounds):
                if phase == 1:
                    u = [self._sbox(ctx, s[0])] + s[1:]
                else:
                    u = [self._sbox(ctx, x) for x in s]
                nxt = []
                for i in range(T):
                    rc_next = (
                        self.rc[(r + 1) * T + i] if r + 1 < total else 0
                    )
                    nxt.append(self._mds_row(ctx, u, i, rc_next))
                s = nxt
                r += 1
        return s


class PoseidonSpongeChip:
    """Duplex sponge over assigned cells — mirrors
    oracle.poseidon.PoseidonSponge (rate 2, capacity 1, same iv and
    flush/padding discipline)."""

    def __init__(self, mg: MainGate, ctx: Ctx, tag: bytes = b"H2A-Transcript"):
        self.mg = mg
        self.gadget = PoseidonGadget(mg)
        zero = mg.assign_constant(ctx, 0)
        iv = mg.assign_constant(ctx, _h2f(b"iv" + tag, 0))
        self.state = [zero, zero, iv]
        self.buf: List[AssignedValue] = []

    def absorb(self, av: AssignedValue):
        self.buf.append(av)

    def _flush(self, ctx: Ctx):
        for i in range(0, len(self.buf), RATE):
            block = self.buf[i : i + RATE]
            st = list(self.state)
            for j, v in enumerate(block):
                st[j] = self.mg.add(ctx, st[j], v)
            self.state = self.gadget.permute(ctx, st)
        self.buf = []

    def squeeze(self, ctx: Ctx) -> AssignedValue:
        self._flush(ctx)
        out = self.state[0]
        self.state = self.gadget.permute(ctx, self.state)
        return out
