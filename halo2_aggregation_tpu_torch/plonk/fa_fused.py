"""Kernel K2: the batched verifier's fused field algebra.

Counterpart of `halo2_aggregation_tpu/plonk/fa_fused.py`: per proof, x^n
by k squarings, the 2 + bf Lagrange evaluations and 1/(x^n - 1), every
gate, permutation and lookup expression, the y-fold and the vanishing
division.  Outputs `(h_eval, x^n, x^n - 1)` are canonical Montgomery Fr,
bit-identical to `verifier_tpu.field_algebra`'s.  The JAX body inverts each
of its 3 + bf denominators by a Fermat chain of its own; here `batch_inv`
inverts them together with one chain (Montgomery's trick), which gives the
same outputs in every case, the zero denominators included (see
`fa_program`).

`fa_program` writes the steps once over a `ScalarOps` backend with `inv`,
calling `plonk/protocol.py`'s formulas; `fa_program_e` adds the verifier's
e-lane scalar as a fourth output.  `fa_tape` records either with `TapeOps`;
`fa_tape_eval` runs the tape in the CUDA interpreter (`csrc/fa_tape.cu`),
`fa_tape_eval_plain` with `TorchLimbOps`.  `fa_schedule`/`fa_gather` are
copies of the JAX module's (it imports jax).
"""

from __future__ import annotations

import torch

from ..fields import MONT_R, R
from ..ops import build
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


def fa_schedule(vk):
    """Ordered tags of the program's scalar inputs."""
    cs = vk.cs
    num_chunks = num_perm_chunks(cs)
    tags = [("x",), ("theta",), ("beta",), ("gamma",), ("y",)]
    tags += [("inst", i) for i in range(len(cs.instance_queries))]
    tags += [("adv", i) for i in range(len(cs.advice_queries))]
    tags += [("fix", i) for i in range(len(cs.fixed_queries))]
    tags += [("sigma", i) for i in range(len(cs.permutation_columns))]
    for ci in range(num_chunks):
        tags += [("perm_z", ci), ("perm_zn", ci)]
        if ci < num_chunks - 1:
            tags.append(("perm_zl", ci))
    for li in range(len(cs.lookups)):
        tags += [("lk_z", li), ("lk_zn", li), ("lk_a", li), ("lk_ap", li), ("lk_s", li)]
    return tuple(tags)


def fa_gather(vk, b):
    """VerifierBatch -> list of (B, 8) tensors in fa_schedule order."""
    num_chunks = num_perm_chunks(vk.cs)
    out = [b.x, b.theta, b.beta, b.gamma, b.y]
    out += list(b.inst_evals)
    out += list(b.adv_evals)
    out += list(b.fix_evals)
    out += list(b.sigma_evals)
    for ci in range(num_chunks):
        ps = b.perm_sets[ci]
        out += [ps.z, ps.z_next]
        if ci < num_chunks - 1:
            out.append(ps.z_last)
    for lv in b.lookup_evs:
        out += [lv.z, lv.z_next, lv.a_prime, lv.a_prime_prev, lv.s_prime]
    return out


def batch_inv(ops, values: list) -> list:
    """The inverses of `values` with ONE `ops.inv` (Montgomery's trick):
    the prefix products, the inverse of the last, then back down: 3 (n - 1)
    products and one inversion for n values.  With `inv(0) = 0`, one zero
    among the values makes EVERY inverse zero."""
    prefix = [values[0]]
    for v in values[1:]:
        prefix.append(ops.mul(prefix[-1], v))
    acc = ops.inv(prefix[-1])
    out = [None] * len(values)
    for i in range(len(values) - 1, 0, -1):
        out[i] = ops.mul(acc, prefix[i - 1])
        acc = ops.mul(acc, values[i])
    out[0] = acc
    return out


def fa_program(ops, vk, vals: dict):
    """Steps 20-24 of the verifier over `ops` (a ScalarOps with `inv`);
    `vals` maps fa_schedule tags to values.  Returns (h_eval, xn, xn - 1),
    the formulas of JAX `fa_body` (`plonk/fa_fused.py:174-258`).

    The 2 + bf Lagrange denominators and x^n - 1 are inverted together by
    `batch_inv`.  That changes no output, the zero cases included: a
    denominator n (x - w^i) is zero only where x^n = 1, and x^n - 1 = 0
    makes every Lagrange numerator (x^n - 1) w^i zero and h_eval = fold *
    inv(0) = 0 with separate inversions too; with one inversion every
    inverse is zero then, and the same products are zero."""
    cs = vk.cs
    n = vk.n
    omega_inv = pow(vk.omega, -1, R)
    bf = cs.blinding_factors()
    chunk_len = cs.degree() - 2
    num_chunks = num_perm_chunks(cs)
    x = vals[("x",)]

    xn = x
    for _ in range(vk.k):
        xn = ops.mul(xn, xn)
    xn_sub_one = ops.sub(xn, ops.constant(1))

    # l_i(x) = w^i (x^n - 1) / (n (x - w^i)), i = 0, -1, ..., -(bf + 1)
    numers, denoms = [], []
    w_pow = 1
    for _ in range(2 + bf):
        numers.append(ops.mul(xn_sub_one, ops.constant(w_pow)))
        denoms.append(ops.mul(ops.sub(x, ops.constant(w_pow)), ops.constant(n)))
        w_pow = w_pow * omega_inv % R
    *denom_invs, vanishing_inv = batch_inv(ops, denoms + [xn_sub_one])
    l_evals = [ops.mul(a, b) for a, b in zip(numers, denom_invs)]
    l_evals.reverse()
    l_last = l_evals[0]
    l_blind = l_evals[1]
    for i in range(2, 1 + bf):
        l_blind = ops.add(l_blind, l_evals[i])
    l_0 = l_evals[1 + bf]

    adv = [vals[("adv", i)] for i in range(len(cs.advice_queries))]
    fix = [vals[("fix", i)] for i in range(len(cs.fixed_queries))]
    inst = [vals[("inst", i)] for i in range(len(cs.instance_queries))]
    sigma = [vals[("sigma", i)] for i in range(len(cs.permutation_columns))]
    perm_sets = [
        PermutationSetEvals(
            z=vals[("perm_z", ci)],
            z_next=vals[("perm_zn", ci)],
            z_last=vals[("perm_zl", ci)] if ci < num_chunks - 1 else None,
        )
        for ci in range(num_chunks)
    ]
    exprs = gate_expressions(ops, cs, adv, fix, inst)
    exprs += permutation_expressions(
        ops, cs, perm_sets, sigma, adv, fix, inst,
        l_0, l_last, l_blind, vals[("beta",)], vals[("gamma",)], x, chunk_len,
    )
    for li, arg in enumerate(cs.lookups):
        ev = LookupEvals(
            z=vals[("lk_z", li)],
            z_next=vals[("lk_zn", li)],
            a_prime=vals[("lk_a", li)],
            a_prime_prev=vals[("lk_ap", li)],
            s_prime=vals[("lk_s", li)],
        )
        exprs += lookup_expressions(
            ops, ev, arg, l_0, l_last, l_blind,
            vals[("theta",)], vals[("beta",)], vals[("gamma",)], adv, fix, inst,
        )

    h_eval = ops.mul(fold_y(ops, exprs, vals[("y",)]), vanishing_inv)
    return h_eval, xn, xn_sub_one


E_TAGS = (("h_coeff",), ("known",))  # fa_program_e's inputs after fa_schedule's


def fa_program_e(ops, vk, vals: dict):
    """`fa_program` and the verifier's e-lane scalar: returns (h_eval, xn,
    xn - 1, e), e = -(known + h_coeff * h_eval) * 2^-256.  `vals` also maps
    `E_TAGS` to the two vectors of the h_eval linearization
    (`verifier_device.fast_prep_gathered`).  The Montgomery form of e is
    the PLAIN value of -(known + h_coeff * h_eval): the limbs the
    scalar-mul takes, what `from_mont` of that value gives."""
    h_eval, xn, xn_sub_one = fa_program(ops, vk, vals)
    eval_multi = ops.add(ops.mul(vals[("h_coeff",)], h_eval), vals[("known",)])
    e = ops.mul(ops.neg(eval_multi), ops.constant(pow(MONT_R, -1, R)))
    return h_eval, xn, xn_sub_one, e


_TAPES = {}


def fa_tape(vk, e_scalar: bool = False) -> Tape:
    """`fa_program` recorded for `vk` (kept per vk hash), or with
    `e_scalar` `fa_program_e`: two more inputs, one more output."""
    key = (vk.hash_scalar(), e_scalar)
    if key not in _TAPES:
        schedule = fa_schedule(vk) + (E_TAGS if e_scalar else ())
        ops = TapeOps(len(schedule))
        program = fa_program_e if e_scalar else fa_program
        outs = program(ops, vk, dict(zip(schedule, ops.inputs())))
        _TAPES[key] = ops.finish(list(outs))
    return _TAPES[key]


def fa_tape_eval_plain(tape: Tape, inputs: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: (S, B, 8) inputs -> (n_out, B, 8) outputs."""
    ops = TorchLimbOps(inputs.device)
    outs = run_tape(tape, list(inputs), ops)
    return torch.stack([o.expand(inputs.shape[1:]) for o in outs])


LANES_PER_BLOCK = 32  # csrc/fa_tape.cu::kLanes
MAX_SHARED_BYTES = 232448  # a block's shared memory on sm_90 (227 KB)


def shared_bytes(tape: Tape) -> int:
    """Shared memory a block of K2 needs for `tape`: the tape, the
    constants and the register file of its lanes
    (`csrc/fa_tape.cuh::fa_tape_shared_words`)."""
    words = 4 * tape.instrs.shape[0] + 8 * len(tape.consts)
    return 4 * (words + (tape.n_inputs + tape.n_temps) * 8 * LANES_PER_BLOCK)


def fa_tape_eval(tape: Tape, inputs: torch.Tensor) -> torch.Tensor:
    """Run `tape` on (S, B, 8) int32 Montgomery Fr inputs; returns the
    (n_out, B, 8) outputs.  A CUDA tensor launches K2 (or raises); a CPU
    tensor runs the plain version."""
    S, B = tape.n_inputs, inputs.shape[1]
    if inputs.dtype != torch.int32 or tuple(inputs.shape) != (S, B, 8):
        raise ValueError(f"inputs: expected ({S}, B, 8) int32, got {inputs.dtype} {tuple(inputs.shape)}")
    if not inputs.is_contiguous():
        raise ValueError("inputs are not contiguous")
    device = inputs.device
    if device.type == "cpu":
        return fa_tape_eval_plain(tape, inputs)
    if device.type != "cuda":
        raise ValueError(f"fa_tape_eval: unsupported device {device}")
    shared = shared_bytes(tape)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(
            f"fa_tape_eval: the tape's register file needs {shared} bytes of shared memory a block, "
            f"more than {MAX_SHARED_BYTES}"
        )
    lib = build.load_library()
    instrs, consts, outputs = tape.device_arrays(device)
    out = torch.empty((len(tape.outputs), B, 8), dtype=torch.int32, device=device)
    rc = lib.h2a_fa_tape(
        instrs.data_ptr(), instrs.shape[0], consts.data_ptr(), len(tape.consts),
        inputs.data_ptr(), S, tape.n_temps, outputs.data_ptr(),
        len(tape.outputs), out.data_ptr(), B, build.stream_ptr(device),
    )
    build.check(rc, "h2a_fa_tape")
    fa_tape_eval.launches += 1
    return out


fa_tape_eval.launches = 0


def field_algebra_fused(vk, b, B: int, h_coeff_mont=None, known_mont=None):
    """(h_eval, x^n, x^n - 1) as (B, 8) canonical Montgomery Fr tensors for
    the VerifierBatch `b`, through K2 on CUDA tensors.  With the two (B, 8)
    Montgomery vectors of the h_eval linearization, a fourth output: the
    e-lane's scalar -(known + h_coeff * h_eval) as (B, 8) plain limbs."""
    e_scalar = h_coeff_mont is not None
    inputs = torch.stack(fa_gather(vk, b) + ([h_coeff_mont, known_mont] if e_scalar else []))
    if inputs.shape[1] != B:
        raise ValueError(f"batch holds {inputs.shape[1]} proofs, expected {B}")
    return tuple(fa_tape_eval(fa_tape(vk, e_scalar), inputs))
