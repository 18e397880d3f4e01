"""Kernel K2: the batched verifier's fused field algebra.

Counterpart of `halo2_aggregation_tpu/plonk/fa_fused.py`: per proof, x^n
by k squarings, the 2 + bf Lagrange evaluations and 1/(x^n - 1) by Fermat
inversion, every gate, permutation and lookup expression, the y-fold and
the vanishing division.  Outputs `(h_eval, x^n, x^n - 1)` are canonical
Montgomery Fr, bit-identical to `verifier_tpu.field_algebra`'s.

`fa_program` writes the steps once over a `ScalarOps` backend with `inv`,
calling `plonk/protocol.py`'s formulas.  `fa_tape` records it with
`TapeOps`; `fa_tape_eval` runs the tape in the CUDA interpreter
(`csrc/fa_tape.cu`), `fa_tape_eval_plain` with `TorchLimbOps`.
`fa_schedule`/`fa_gather` are copies of the JAX module's (it imports jax).
"""

from __future__ import annotations

import torch

from ..fields import R
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


def fa_program(ops, vk, vals: dict):
    """Steps 20-24 of the verifier over `ops` (a ScalarOps with `inv`);
    `vals` maps fa_schedule tags to values.  Returns (h_eval, xn, xn - 1),
    the formulas of JAX `fa_body` (`plonk/fa_fused.py:174-258`)."""
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
    l_evals = []
    w_pow = 1
    for _ in range(2 + bf):
        numer = ops.mul(xn_sub_one, ops.constant(w_pow))
        denom = ops.mul(ops.sub(x, ops.constant(w_pow)), ops.constant(n))
        l_evals.append(ops.mul(numer, ops.inv(denom)))
        w_pow = w_pow * omega_inv % R
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

    h_eval = ops.mul(fold_y(ops, exprs, vals[("y",)]), ops.inv(xn_sub_one))
    return h_eval, xn, xn_sub_one


_TAPES = {}


def fa_tape(vk) -> Tape:
    """fa_program recorded for `vk` (kept per vk hash)."""
    key = vk.hash_scalar()
    if key not in _TAPES:
        schedule = fa_schedule(vk)
        ops = TapeOps(len(schedule))
        outs = fa_program(ops, vk, dict(zip(schedule, ops.inputs())))
        _TAPES[key] = ops.finish(list(outs))
    return _TAPES[key]


def fa_tape_eval_plain(tape: Tape, inputs: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: (S, B, 8) inputs -> (n_out, B, 8) outputs."""
    ops = TorchLimbOps(inputs.device)
    outs = run_tape(tape, list(inputs), ops)
    return torch.stack([o.expand(inputs.shape[1:]) for o in outs])


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
    lib = build.load_library()
    instrs, consts, outputs = tape.device_arrays(device)
    tmp = torch.empty((max(tape.n_temps, 1), B, 8), dtype=torch.int32, device=device)
    out = torch.empty((len(tape.outputs), B, 8), dtype=torch.int32, device=device)
    rc = lib.h2a_fa_tape(
        instrs.data_ptr(), instrs.shape[0], consts.data_ptr(),
        inputs.data_ptr(), S, tmp.data_ptr(), outputs.data_ptr(),
        len(tape.outputs), out.data_ptr(), B, build.stream_ptr(device),
    )
    build.check(rc, "h2a_fa_tape")
    fa_tape_eval.launches += 1
    return out


fa_tape_eval.launches = 0


def field_algebra_fused(vk, b, B: int):
    """(h_eval, x^n, x^n - 1) as (B, 8) canonical Montgomery Fr tensors for
    the VerifierBatch `b`, through K2 on CUDA tensors."""
    inputs = torch.stack(fa_gather(vk, b))
    if inputs.shape[1] != B:
        raise ValueError(f"batch holds {inputs.shape[1]} proofs, expected {B}")
    return tuple(fa_tape_eval(fa_tape(vk), inputs))
