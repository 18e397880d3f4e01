"""State carried over from the JAX package into the port.

The vk, `pk`, `Params`, assignments and proofs are shared host objects,
so only the JAX package's limb arrays need converting: its `VerifierBatch`
(with numpy or jax array leaves), its point and scalar arrays, the
quotient engine's coefficient columns, the NTT plan's twiddle tables and
the resident SRS of `Params._device_points`, from `(..., 32)` 8-bit limbs
to the port's `(..., 8)` 32-bit limbs.
Montgomery form is the same (R = 2^256), so this is repacking (and, for
the quotient columns, the bit-reversal permutation) only.  Nothing here
imports jax: the JAX objects are read by attribute and through
`np.asarray`.
"""

from __future__ import annotations

import numpy as np
import torch

from halo2_aggregation_tpu.plonk.protocol import LookupEvals, PermutationSetEvals

from .device import resolve_device
from .ops.curve_ops import AffinePoint, JacPoint
from .ops.limbs import jax_to_port
from .ops.ntt import bit_reverse_indices
from .plonk.verifier_device import VerifierBatch


def scalars_from_jax(arr, device) -> torch.Tensor:
    """JAX `(..., 32)` limb array -> port `(..., 8)` tensor (same values)."""
    return torch.from_numpy(jax_to_port(np.asarray(arr))).to(resolve_device(device))


def points_from_jax(p, device) -> JacPoint:
    """JAX `JacPoint` (x, y, z of (..., 32)) -> port JacPoint."""
    return JacPoint(*(scalars_from_jax(c, device) for c in (p.x, p.y, p.z)))


def srs_from_jax(points, device="cpu") -> AffinePoint:
    """The JAX package's resident SRS, `kzg.Params._device_points` (an
    `AffinePoint` of (n, 32) Montgomery 8-bit limbs and (n,) infinity
    flags, `plonk/kzg.py:139-150`) -> the port's `DeviceSRS.points` (the
    same values as (n, 8) limbs)."""
    device = resolve_device(device)
    inf = torch.from_numpy(np.asarray(points.inf).astype(bool)).to(device)
    return AffinePoint(scalars_from_jax(points.x, device), scalars_from_jax(points.y, device), inf)


def from_jax_batch(jb, device) -> VerifierBatch:
    """JAX `verifier_tpu.VerifierBatch` -> the port's VerifierBatch."""

    def S(a):
        return None if a is None else scalars_from_jax(a, device)

    def P(p):
        return points_from_jax(p, device)

    return VerifierBatch(
        theta=S(jb.theta),
        beta=S(jb.beta),
        gamma=S(jb.gamma),
        y=S(jb.y),
        x=S(jb.x),
        v=S(jb.v),
        u=S(jb.u),
        inst_evals=[S(a) for a in jb.inst_evals],
        adv_evals=[S(a) for a in jb.adv_evals],
        fix_evals=[S(a) for a in jb.fix_evals],
        r_eval=S(jb.r_eval),
        sigma_evals=[S(a) for a in jb.sigma_evals],
        perm_sets=[
            PermutationSetEvals(z=S(ps.z), z_next=S(ps.z_next), z_last=S(ps.z_last))
            for ps in jb.perm_sets
        ],
        lookup_evs=[
            LookupEvals(
                z=S(lv.z),
                z_next=S(lv.z_next),
                a_prime=S(lv.a_prime),
                a_prime_prev=S(lv.a_prime_prev),
                s_prime=S(lv.s_prime),
            )
            for lv in jb.lookup_evs
        ],
        inst_comms=[P(p) for p in jb.inst_comms],
        adv_comms=[P(p) for p in jb.adv_comms],
        lookups_permuted=[(P(a), P(s)) for a, s in jb.lookups_permuted],
        perm_z_comms=[P(p) for p in jb.perm_z_comms],
        lookup_z_comms=[P(p) for p in jb.lookup_z_comms],
        r_comm=P(jb.r_comm),
        h_comms=[P(p) for p in jb.h_comms],
        w_comms=[P(p) for p in jb.w_comms],
    )


def quotient_columns_from_jax(dq_jax) -> torch.Tensor:
    """The JAX `DeviceQuotient`'s CPU-path `store` (packed (n, 32) u8
    natural-order Montgomery coefficient columns,
    `quotient_device.py:408,446-448`) -> the port's resident (C, n, 8)
    stack: the same columns in `key_order`, coefficients bit-reversed
    (`DeviceQuotient.finalize_coefficients` takes it)."""
    cols = [np.asarray(dq_jax.store[key], dtype=np.uint8) for key in dq_jax.key_order]
    stack = np.ascontiguousarray(np.stack(cols)).view("<i4").reshape(len(cols), dq_jax.n, 8)
    return torch.from_numpy(np.ascontiguousarray(stack[:, bit_reverse_indices(dq_jax.k)]))


def twiddles_from_jax(plan, device="cpu") -> torch.Tensor:
    """JAX `ops/ntt.py::NttPlan.stage_twiddles` ((2^s, 32) 8-bit limbs per
    stage s) -> the port's one natural-order table of root powers,
    (n/2, 8) (`ops/ntt.py::NttTables`).  The last stage's table is that
    table; every other stage's must be its stride-2^(k-1-s) slice, and a
    plan whose tables disagree raises."""
    stages = [jax_to_port(np.asarray(t)) for t in plan.stage_twiddles]
    table = stages[-1]
    k = len(stages)
    for s, t in enumerate(stages):
        if not np.array_equal(t, table[:: 1 << (k - 1 - s)]):
            raise ValueError(f"stage {s} table is not a slice of the last stage's")
    return torch.from_numpy(np.ascontiguousarray(table)).to(resolve_device(device))
