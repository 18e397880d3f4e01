"""Kernel K6: the quotient numerator on one coset, as a tape.

Counterpart of the quotient formulas of
`halo2_aggregation_tpu/plonk/quotient_device.py`: the XLA `slab_fn`
(`:657-717`) and the Pallas tile kernel's body (`:844-896`).  Per row i of
the coset {shift * omega^i}: the gate, permutation and lookup expressions of
`plonk/protocol.py`, the y-fold and the product with 1/(shift^n - 1).

`quotient_program` writes the steps once over any `ScalarOps` backend.
`quotient_tape(cs)` records it with `TapeOps` into a `QuotientTape`: the tape
and, per tape input, where a row finds it (a column of the resident
evaluation stack at a rotation, the coset point, or a uniform).
`quotient_tape_eval` runs it in the CUDA kernel (`csrc/quotient_tape.cu`)
on CUDA tensors; `quotient_tape_eval_plain` runs it with `TorchLimbOps`
over the leaves gathered at (rows + rot) mod n, for any row set.
`leaf_schedule` is a copy of the JAX module's (that module imports jax).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import build
from ..ops.limbs import NL
from .protocol import (
    LookupEvals,
    PermutationSetEvals,
    fold_y,
    gate_expressions,
    lookup_expressions,
    permutation_expressions,
)
from .protocol_ops import Tape, TapeOps, TorchLimbOps, run_tape
from .verifier import num_perm_chunks

UNIFORMS = ("theta", "beta", "gamma", "y", "vinv")
QT_MAX_TEMPS = 64  # csrc/quotient_tape.cuh
X_SRC = -1  # tape input source of the coset point (quotient_tape.cuh)
ROW_CHUNK = 1 << 14  # rows per plain-version step


def leaf_schedule(cs, bf: int, num_chunks: int):
    """The stable, deduplicated (key, rot) leaf order and the distinct-key
    order derived from it (`quotient_device.py::leaf_schedule`, :116-156)."""
    sched: list = []
    seen = set()

    def add(key, rot):
        if (key, rot) not in seen:
            seen.add((key, rot))
            sched.append((key, rot))

    for c, rot in cs.advice_queries:
        add(("advice", c.index), rot.value)
    for c, rot in cs.fixed_queries:
        add(("fixed", c.index), rot.value)
    for c, rot in cs.instance_queries:
        add(("instance", c.index), rot.value)
    for i in range(len(cs.permutation_columns)):
        add(("sigma", i), 0)
    for ci in range(num_chunks):
        add(("perm_z", ci), 0)
        add(("perm_z", ci), 1)
        if ci < num_chunks - 1:
            add(("perm_z", ci), -(bf + 1))
    for li in range(len(cs.lookups)):
        add(("lookup_z", li), 0)
        add(("lookup_z", li), 1)
        add(("lookup_a", li), 0)
        add(("lookup_a", li), -1)
        add(("lookup_s", li), 0)
    add(("l0", 0), 0)
    add(("llast", 0), 0)
    add(("lblind", 0), 0)
    key_order = []
    seen_k = set()
    for key, _ in sched:
        if key not in seen_k:
            seen_k.add(key)
            key_order.append(key)
    return sched, key_order


def quotient_program(ops, cs, leaf, x, theta, beta, gamma, y, vinv):
    """The quotient numerator of one row over `ops`: `leaf(key, rot)` gives
    a leaf's value, the rest are the row's coset point and the challenges.
    The formulas of `quotient_device.py` `slab_fn` (:657-717)."""
    bf = cs.blinding_factors()
    chunk_len = cs.degree() - 2
    num_chunks = num_perm_chunks(cs)
    adv = [leaf(("advice", c.index), rot.value) for c, rot in cs.advice_queries]
    fix = [leaf(("fixed", c.index), rot.value) for c, rot in cs.fixed_queries]
    inst = [leaf(("instance", c.index), rot.value) for c, rot in cs.instance_queries]
    sigma = [leaf(("sigma", i), 0) for i in range(len(cs.permutation_columns))]
    l0, llast, lblind = (leaf((name, 0), 0) for name in ("l0", "llast", "lblind"))

    exprs = gate_expressions(ops, cs, adv, fix, inst)
    perm_sets = [
        PermutationSetEvals(
            z=leaf(("perm_z", ci), 0),
            z_next=leaf(("perm_z", ci), 1),
            z_last=leaf(("perm_z", ci), -(bf + 1)) if ci < num_chunks - 1 else None,
        )
        for ci in range(num_chunks)
    ]
    exprs += permutation_expressions(
        ops, cs, perm_sets, sigma, adv, fix, inst, l0, llast, lblind, beta, gamma, x, chunk_len,
    )
    for li, arg in enumerate(cs.lookups):
        ev = LookupEvals(
            z=leaf(("lookup_z", li), 0),
            z_next=leaf(("lookup_z", li), 1),
            a_prime=leaf(("lookup_a", li), 0),
            a_prime_prev=leaf(("lookup_a", li), -1),
            s_prime=leaf(("lookup_s", li), 0),
        )
        exprs += lookup_expressions(
            ops, ev, arg, l0, llast, lblind, theta, beta, gamma, adv, fix, inst,
        )
    return ops.mul(fold_y(ops, exprs, y), vinv)


@dataclass
class QuotientTape:
    """The recorded quotient program.  Tape inputs are the schedule's leaves
    in order, then x, then `UNIFORMS`.  `sources` holds one (src, rot) row
    per input: src >= 0 is a column of the evaluation stack (a `key_order`
    index) read at rotation rot, `X_SRC` the coset point, src <= -2 uniform
    -src-2."""

    tape: Tape
    sources: np.ndarray  # (n_inputs, 2) int32
    _device_arrays: dict = field(default_factory=dict, repr=False)

    def device_arrays(self, device):
        """(src, rot) columns as int32 tensors on `device`, made once."""
        device = torch.device(device)
        if device not in self._device_arrays:
            src = torch.from_numpy(np.ascontiguousarray(self.sources[:, 0])).to(device)
            rot = torch.from_numpy(np.ascontiguousarray(self.sources[:, 1])).to(device)
            self._device_arrays[device] = (src, rot)
        return self._device_arrays[device]


def quotient_tape(cs) -> QuotientTape:
    """`quotient_program` recorded for the constraint system `cs`."""
    schedule, key_order = leaf_schedule(cs, cs.blinding_factors(), num_perm_chunks(cs))
    slot = {key: i for i, key in enumerate(key_order)}
    sources = [(slot[key], rot) for key, rot in schedule]
    sources.append((X_SRC, 0))
    sources += [(-2 - u, 0) for u in range(len(UNIFORMS))]
    ops = TapeOps(len(sources))
    handles = ops.inputs()
    leaves = dict(zip(schedule, handles))
    x, *uniforms = handles[len(schedule):]
    out = quotient_program(ops, cs, lambda key, rot: leaves[(key, rot)], x, *uniforms)
    tape = ops.finish([out])
    if tape.n_temps > QT_MAX_TEMPS:
        raise ValueError(f"quotient tape needs {tape.n_temps} temporaries, K6 holds {QT_MAX_TEMPS}")
    return QuotientTape(tape=tape, sources=np.asarray(sources, dtype=np.int32).reshape(-1, 2))


def _check_inputs(qt: QuotientTape, stack, x, uniforms):
    C, n = stack.shape[0], stack.shape[1]
    if n & (n - 1):
        raise ValueError(f"n = {n} is not a power of two")
    for name, t, shape in (
        ("stack", stack, (C, n, NL)),
        ("x", x, (n, NL)),
        ("uniforms", uniforms, (len(UNIFORMS), NL)),
    ):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape} int32, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.device != stack.device:
            raise ValueError(f"{name} on {t.device}, stack on {stack.device}")
    if int(qt.sources[:, 0].max()) >= C:
        raise ValueError(f"tape reads column {int(qt.sources[:, 0].max())}, stack holds {C}")
    return n


def quotient_tape_eval_plain(qt: QuotientTape, stack, x, uniforms, rows, chunk: int = ROW_CHUNK) -> torch.Tensor:
    """Plain version of K6 on the rows `rows` (an int64 tensor), `chunk`
    rows at a time: the tape run with `TorchLimbOps` over the leaves
    gathered at (row + rot) mod n.  Returns (len(rows), 8)."""
    n = _check_inputs(qt, stack, x, uniforms)
    ops = TorchLimbOps(stack.device)
    rows = rows.to(stack.device)
    outs = []
    for i in range(0, rows.shape[0], chunk):
        r = rows[i : i + chunk]
        inputs = []
        for src, rot in qt.sources.tolist():
            if src >= 0:
                inputs.append(stack[src, (r + rot) & (n - 1)])
            elif src == X_SRC:
                inputs.append(x[r])
            else:
                inputs.append(uniforms[-src - 2])
        (out,) = run_tape(qt.tape, inputs, ops)
        outs.append(out.expand(r.shape[0], NL))
    return torch.cat(outs)


def quotient_tape_eval(qt: QuotientTape, stack, x, uniforms) -> torch.Tensor:
    """The quotient numerator of every row: (C, n, 8) coset evaluations in
    `key_order`, (n, 8) coset points and (5, 8) Montgomery uniforms ->
    (n, 8) canonical Montgomery.  A CUDA stack launches K6 (or raises); a
    CPU stack runs the plain version."""
    n = _check_inputs(qt, stack, x, uniforms)
    device = stack.device
    if device.type == "cpu":
        return quotient_tape_eval_plain(qt, stack, x, uniforms, torch.arange(n))
    if device.type != "cuda":
        raise ValueError(f"quotient_tape_eval: unsupported device {device}")
    lib = build.load_library()
    tape = qt.tape
    instrs, consts, outputs = tape.device_arrays(device)
    src, rot = qt.device_arrays(device)
    out = torch.empty((n, NL), dtype=torch.int32, device=device)
    rc = lib.h2a_quotient_tape(
        instrs.data_ptr(), instrs.shape[0], consts.data_ptr(), src.data_ptr(), rot.data_ptr(),
        tape.n_inputs, stack.data_ptr(), x.data_ptr(), uniforms.data_ptr(), n,
        tape.outputs[0], out.data_ptr(), build.stream_ptr(device),
    )
    build.check(rc, "h2a_quotient_tape")
    quotient_tape_eval.launches += 1
    return out


quotient_tape_eval.launches = 0
