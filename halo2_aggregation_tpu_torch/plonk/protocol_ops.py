"""`ScalarOps` backends for `plonk/protocol.py`'s formulas in the port.

* `TorchLimbOps`: Fr values as `(..., 8)` port tensors in Montgomery form
  (the counterpart of `protocol.py::LimbOps`, `:119-144`).
* `TapeOps`: records the formulas as a straight-line program (a `Tape`)
  instead of computing them.  Kernel K2 (`csrc/fa_tape.cu`) interprets the
  tape; `run_tape` interprets it over any backend, which is K2's plain
  version with `TorchLimbOps` and a host check with `IntInvOps`.  So
  `protocol.py` stays the single source of the formulas, as it is for the
  TPU kernel (`plonk/fa_fused.py:12-19` of the JAX package).

Besides `ScalarOps`' add/sub/mul/neg/constant/scale, every backend here
has `inv` (Fermat; 0 maps to 0), one macro-op on the tape.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields import R
from ..ops import field_ops as fo
from .protocol import IntOps, ScalarOps

OP_ADD, OP_SUB, OP_MUL, OP_NEG, OP_INV = range(5)  # csrc/fa_tape.cuh TapeOp
_BINARY = (OP_ADD, OP_SUB, OP_MUL)


class TorchLimbOps(ScalarOps):
    """Fr in Montgomery form on `(..., 8)` tensors; values broadcast."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._consts = {}

    def constant(self, v):
        v %= R
        if v not in self._consts:
            self._consts[v] = fo.FR.to_mont_tensor([v], self.device)[0]
        return self._consts[v]

    def add(self, a, b):
        return fo.add(a, b, fo.FR)

    def sub(self, a, b):
        return fo.sub(a, b, fo.FR)

    def mul(self, a, b):
        return fo.mont_mul(a, b, fo.FR)

    def neg(self, a):
        return fo.neg(a, fo.FR)

    def inv(self, a):
        return fo.inv(a, fo.FR)


class IntInvOps(IntOps):
    """Host ints mod r with the Fermat inverse (0 -> 0)."""

    def inv(self, a):
        return pow(a, R - 2, R)


@dataclass
class Tape:
    """A straight-line Fr program.

    `instrs` rows are (op, dst, a, b).  Register r < 0 is constant -r-1 (a
    plain int in `consts`); 0 <= r < n_inputs is an input; r >= n_inputs is
    temporary r - n_inputs.  `outputs` are register indices."""

    n_inputs: int
    n_temps: int
    instrs: np.ndarray  # (n_instr, 4) int32
    consts: list
    outputs: list
    _device_arrays: dict = field(default_factory=dict, repr=False)

    def device_arrays(self, device):
        """(instrs, Montgomery consts, outputs) as tensors on `device`, made
        once per device."""
        device = torch.device(device)
        if device not in self._device_arrays:
            self._device_arrays[device] = (
                torch.from_numpy(self.instrs).to(device),
                fo.FR.to_mont_tensor(self.consts, device),
                torch.tensor(self.outputs, dtype=torch.int32, device=device),
            )
        return self._device_arrays[device]


class TapeOps(ScalarOps):
    """Records formulas; handles are value ids (inputs 0..n-1, then one per
    instruction) or, for constants, -(index + 1)."""

    def __init__(self, n_inputs: int):
        self.n_inputs = n_inputs
        self._ops = []  # (op, a, b); result id = n_inputs + position
        self._const_ids = {}
        self._consts = []

    def inputs(self) -> list:
        return list(range(self.n_inputs))

    def _emit(self, op, a, b=0):
        self._ops.append((op, a, b))
        return self.n_inputs + len(self._ops) - 1

    def constant(self, v):
        v %= R
        if v not in self._const_ids:
            self._const_ids[v] = -(len(self._consts) + 1)
            self._consts.append(v)
        return self._const_ids[v]

    def add(self, a, b):
        return self._emit(OP_ADD, a, b)

    def sub(self, a, b):
        return self._emit(OP_SUB, a, b)

    def mul(self, a, b):
        return self._emit(OP_MUL, a, b)

    def neg(self, a):
        return self._emit(OP_NEG, a)

    def inv(self, a):
        return self._emit(OP_INV, a)

    def finish(self, outputs) -> Tape:
        """Drop dead instructions and give the live values temporaries,
        reusing a temporary once its value has no later use (an operand's
        slot may become the destination: the interpreter reads operands
        before it writes)."""
        S = self.n_inputs
        live = set(outputs)
        keep = []
        for pos in range(len(self._ops) - 1, -1, -1):
            vid = S + pos
            if vid in live:
                op, a, b = self._ops[pos]
                keep.append(pos)
                live.add(a)
                if op in _BINARY:
                    live.add(b)
        keep.reverse()

        last_use = {}
        for k, pos in enumerate(keep):
            op, a, b = self._ops[pos]
            for v in (a, b) if op in _BINARY else (a,):
                last_use[v] = k
        pinned = set(outputs)

        slot_of = {}
        free = []
        n_temps = 0

        def reg(v):
            return v if v < S else S + slot_of[v]

        rows = []
        for k, pos in enumerate(keep):
            op, a, b = self._ops[pos]
            operands = (a, b) if op in _BINARY else (a,)
            row = [op, 0, reg(a), reg(b) if op in _BINARY else 0]
            for v in set(operands):
                if v >= S and last_use[v] == k and v not in pinned:
                    heapq.heappush(free, slot_of[v])
            if free:
                slot = heapq.heappop(free)
            else:
                slot = n_temps
                n_temps += 1
            slot_of[S + pos] = slot
            row[1] = S + slot
            rows.append(row)
        return Tape(
            n_inputs=S,
            n_temps=n_temps,
            instrs=np.asarray(rows, dtype=np.int32).reshape(-1, 4),
            consts=list(self._consts),
            outputs=[reg(v) if v >= 0 else v for v in outputs],
        )


def run_tape(tape: Tape, inputs: list, ops) -> list:
    """Interpret `tape` over the backend `ops` (which needs `inv`);
    `inputs` are ops values in input order.  Returns the output values."""
    S = tape.n_inputs
    consts = [ops.constant(c) for c in tape.consts]
    temps = [None] * tape.n_temps

    def get(r):
        if r < 0:
            return consts[-r - 1]
        return inputs[r] if r < S else temps[r - S]

    for op, dst, a, b in tape.instrs.tolist():
        x = get(a)
        if op == OP_ADD:
            v = ops.add(x, get(b))
        elif op == OP_SUB:
            v = ops.sub(x, get(b))
        elif op == OP_MUL:
            v = ops.mul(x, get(b))
        elif op == OP_NEG:
            v = ops.neg(x)
        elif op == OP_INV:
            v = ops.inv(x)
        else:
            raise ValueError(f"bad tape op {op}")
        temps[dst - S] = v
    return [get(r) for r in tape.outputs]

